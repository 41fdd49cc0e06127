"""The compute over ``model`` of the port's placed training step, one
process, no collectives: each ``model`` rank's share of a layer, run in
turn with ``f`` and ``g`` as identities, summed over the ranks as the
collectives would sum them, against the same layer on one rank (whose
attention and MLP the training tests hold to JAX's).

* Attention over local heads (:func:`repro_torch.models.attention.
  _attention_local`): the ranks' partial outputs sum to the layer's
  output; their gradients of ``x`` and of KV weights that come whole
  (``Hkv`` not dividing over ``model``) sum to the layer's, and each
  rank's gradient of its heads of ``wq``/``wo`` is the layer's gradient
  of those heads.  Query and KV heads split together (4 over 4), GQA with
  one KV head (4 over 1: both ranks read it), and KV heads read by
  unequal numbers of a rank's query heads (6 over 3: one KV head per query
  head), with RoPE and a sliding window.
* The MLP split on its hidden dim (:func:`repro_torch.models.mlp.mlp`):
  the same sums, gated and not.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.models import attention as att
from repro_torch.models.mlp import init_mlp, mlp

N = 2  # model ranks
# float32 sums in another order (the ranks' partial sums added last)
ATOL, RTOL = 1e-5, 1e-5


class Alone:
    """One ``model`` rank's axis with its collectives as identities (the
    caller sums the ranks' results), holding the leaves ``local`` as its
    pieces."""

    def __init__(self, index, local):
        self.n, self.index, self.local = N, index, frozenset(local)

    def f(self, x):
        return x

    def g(self, x):
        return x


def _cut(x, dim, r):
    return x.chunk(N, dim=dim)[r].detach().clone().requires_grad_()


def _grads(out, c, leaves):
    return torch.autograd.grad((out * c).sum(), leaves)


@pytest.mark.parametrize("heads,kv_heads,window",
                         [(4, 4, 0), (4, 1, 0), (6, 3, 5)])
def test_local_heads_sum_to_the_layer(heads, kv_heads, window):
    cfg = dataclasses.replace(reduced_config("minitron-4b"), d_model=48,
                              num_heads=heads, num_kv_heads=kv_heads,
                              head_dim=8, qkv_bias=True)
    gen = torch.Generator().manual_seed(heads * 10 + kv_heads)
    p = att.init_attention(gen, cfg)
    for b in ("bq", "bk", "bv"):
        p[b] = torch.randn(p[b].shape, generator=gen) * 0.1
    rng = np.random.default_rng(0)
    B, T = 2, 12
    x = torch.from_numpy(rng.standard_normal((B, T, cfg.d_model))
                         .astype(np.float32)).requires_grad_()
    c = torch.from_numpy(rng.standard_normal((B, T, cfg.d_model))
                         .astype(np.float32))
    pos = torch.arange(T, dtype=torch.int32)[None].expand(B, T)
    full = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    want, _ = att.attention(full, cfg, x, pos, window=window)
    names = sorted(full)
    want_g = dict(zip(["x"] + names, _grads(want, c, [x] + [full[k] for k
                                                           in names])))
    split_kv = kv_heads % N == 0
    got, gx = 0, 0
    gkv = {k: 0 for k in ("wk", "wv", "bk", "bv")}
    for r in range(N):
        local = {}
        for k, v in p.items():
            dim = {"wq": 1, "wo": 0, "bq": 0}.get(k)
            if k in gkv:
                dim = (1 if k[0] == "w" else 0) if split_kv else None
            local[k] = (_cut(v, dim, r) if dim is not None
                        else v.detach().clone().requires_grad_())
        xr = x.detach().clone().requires_grad_()
        pieces = [k for k in local if k in ("wq", "wo", "bq")
                  or (k in gkv and split_kv)]
        out = att._attention_local(local, cfg, xr, pos, window, True, None,
                                   Alone(r, pieces))
        got = got + out.detach()
        lk = sorted(local)
        g = dict(zip(["x"] + lk, _grads(out, c, [xr] + [local[k]
                                                        for k in lk])))
        gx = gx + g["x"]
        for k in ("wq", "wo", "bq"):
            dim = {"wq": 1, "wo": 0, "bq": 0}[k]
            torch.testing.assert_close(
                g[k], want_g[k].chunk(N, dim=dim)[r], atol=ATOL, rtol=RTOL)
        for k in gkv:
            if split_kv:
                torch.testing.assert_close(
                    g[k], want_g[k].chunk(N, dim=1 if k[0] == "w" else 0)[r],
                    atol=ATOL, rtol=RTOL)
            else:
                gkv[k] = gkv[k] + g[k]
    torch.testing.assert_close(got, want.detach(), atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(gx, want_g["x"], atol=ATOL, rtol=RTOL)
    if not split_kv:
        for k in gkv:
            torch.testing.assert_close(gkv[k], want_g[k], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("gated", [True, False])
def test_split_mlp_sums_to_the_layer(gated):
    cfg = dataclasses.replace(reduced_config("minitron-4b"), d_model=32,
                              d_ff=64, gated_mlp=gated)
    p = init_mlp(torch.Generator().manual_seed(3), cfg)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 5, 32)).astype(np.float32)
                         ).requires_grad_()
    c = torch.from_numpy(rng.standard_normal((2, 5, 32)).astype(np.float32))
    full = {k: v.clone().requires_grad_() for k, v in p.items()}
    want = mlp(full, cfg, x)
    names = sorted(full)
    want_g = dict(zip(["x"] + names, _grads(want, c, [x] + [full[k] for k
                                                           in names])))
    got, gx = 0, 0
    for r in range(N):
        local = {k: _cut(v, 0 if k == "wd" else 1, r) for k, v in p.items()}
        xr = x.detach().clone().requires_grad_()
        out = mlp(local, cfg, xr, Alone(r, local))
        got = got + out.detach()
        lk = sorted(local)
        g = dict(zip(["x"] + lk, _grads(out, c, [xr] + [local[k]
                                                        for k in lk])))
        gx = gx + g["x"]
        for k in lk:
            torch.testing.assert_close(
                g[k], want_g[k].chunk(N, dim=0 if k == "wd" else 1)[r],
                atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got, want.detach(), atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(gx, want_g["x"], atol=ATOL, rtol=RTOL)
