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
* A mixture of experts over its block of experts (expert parallelism,
  :func:`repro_torch.models.moe.moe`): reduced deepseek-moe-16b (4
  experts, top 2, a shared expert split on its hidden dim), both
  dispatches, buckets that drop tokens.  Each rank runs in a thread of its
  own, its ``f`` summing its gradient over the threads as the real
  axis's all-reduce does: the router's path runs in full on every rank,
  so the ``x`` and router gradients would come out ``n`` times too large
  with an ``f`` on the router's input (and one rank's share without one
  on the gate weights), which summing per-rank gradients with
  ``Alone``'s identity ``f`` could not see.  The ranks' outputs sum to
  the layer's; each rank's gradients of ``x`` and the router are the
  layer's, and of its pieces the layer's gradient of those pieces.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.models import attention as att
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.moe import init_moe, moe

N = 2  # model ranks
# float32 sums in another order (the ranks' partial sums added last)
ATOL, RTOL = 1e-5, 1e-5


class Alone:
    """One ``model`` rank's axis with its collectives as identities (the
    caller sums the ranks' results), holding the leaves ``local`` as its
    pieces."""

    rows = False

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


class _Hub:
    """The threads of N simulated ``model`` ranks: :meth:`sum` adds every
    rank's tensor, in rank order, for each of them."""

    def __init__(self):
        self.barrier = threading.Barrier(N, timeout=120)
        self.slots = [None] * N

    def sum(self, index, x):
        self.slots[index] = x
        self.barrier.wait()
        total = self.slots[0]
        for y in self.slots[1:]:
            total = total + y
        self.barrier.wait()
        return total


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, hub, index):
        ctx.hub, ctx.index = hub, index
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.hub.sum(ctx.index, grad), None, None


class Threaded(Alone):
    """:class:`Alone` whose ``f`` sums its gradient over the ranks'
    threads (the real axis's backward all-reduce); ``g`` stays the
    identity (the caller sums the ranks' outputs)."""

    def __init__(self, hub, index, local):
        super().__init__(index, local)
        self.hub = hub

    def f(self, x):
        return _SumGrad.apply(x, self.hub, self.index)

    def holding(self, local):
        return Threaded(self.hub, self.index, local)


#: weight of the load-balance loss in the tests' objective: large, so that
#: a router gradient from that path counted n times would show
AUX_WEIGHT = 0.5


def _moe_pieces(p, r):
    """Rank ``r``'s leaves of a mixture of experts: its block of experts,
    its shared expert's slice of the hidden dim, the router whole."""
    out = {k: _cut(p[k], 0, r) for k in ("wg", "wu", "wd")}
    out["router"] = p["router"].detach().clone().requires_grad_()
    out["shared"] = {k: _cut(v, 0 if k == "wd" else 1, r)
                     for k, v in p["shared"].items()}
    return out


def _flat(tree):
    return [(k, v) for k, v in sorted(tree.items()) if k != "shared"] + [
        ("shared/" + k, v) for k, v in sorted(tree["shared"].items())]


@pytest.mark.parametrize("dispatch", ["global", "grouped"])
def test_expert_parallel_moe_sums_to_the_layer(dispatch):
    cfg = reduced_config("deepseek-moe-16b", moe_dispatch=dispatch,
                         moe_capacity_factor=1.0)
    assert (cfg.num_experts, cfg.top_k, cfg.num_shared_experts) == (4, 2, 1)
    p = init_moe(torch.Generator().manual_seed(4), cfg)
    rng = np.random.default_rng(2)
    B, T = 2, 128
    x = torch.from_numpy(rng.standard_normal((B, T, cfg.d_model))
                         .astype(np.float32)).requires_grad_()
    c = torch.from_numpy(rng.standard_normal((B, T, cfg.d_model))
                         .astype(np.float32))
    full = {k: v.detach().clone().requires_grad_() for k, v in p.items()
            if k != "shared"}
    full["shared"] = {k: v.detach().clone().requires_grad_()
                      for k, v in p["shared"].items()}
    want, want_aux = moe(full, cfg, x)
    names = [k for k, _ in _flat(full)]
    want_g = dict(zip(["x"] + names, torch.autograd.grad(
        (want * c).sum() + AUX_WEIGHT * want_aux,
        [x] + [v for _, v in _flat(full)])))
    if dispatch == "global":
        # the global capacity (from 256 tokens) drops some assignments
        from repro_torch.models.moe import _route, capacity
        _, idx, _, _ = _route(p, cfg, x.detach())
        load = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts)
        assert int(load.max()) > capacity(cfg, B * T)

    hub, results = _Hub(), [None] * N

    def rank(r):
        try:
            local = _moe_pieces(p, r)
            xr = x.detach().clone().requires_grad_()
            tp = Threaded(hub, r, ["wg", "wu", "wd", "shared/wg",
                                   "shared/wu", "shared/wd"])
            out, aux = moe(local, cfg, xr, tp=tp)
            grads = torch.autograd.grad(
                (out * c).sum() + AUX_WEIGHT * aux,
                [xr] + [v for _, v in _flat(local)])
            results[r] = (out.detach(), aux.detach(),
                          dict(zip(["x"] + names, grads)))
        except BaseException as e:    # the other thread must not wait on
            hub.barrier.abort()       # a rank that died
            results[r] = e

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for res in results:
        if isinstance(res, BaseException):
            raise res
    got = sum(res[0] for res in results)
    torch.testing.assert_close(got, want.detach(), atol=ATOL, rtol=RTOL)
    for r, (_, aux, g) in enumerate(results):
        torch.testing.assert_close(aux, want_aux.detach(), atol=0, rtol=0)
        for k in ("x", "router"):
            torch.testing.assert_close(g[k], want_g[k], atol=ATOL, rtol=RTOL,
                                       msg=lambda m: f"rank {r} {k}: {m}")
        for k in names:
            if k == "router":
                continue
            dim = 0 if k in ("wg", "wu", "wd", "shared/wd") else 1
            torch.testing.assert_close(
                g[k], want_g[k].chunk(N, dim=dim)[r], atol=ATOL, rtol=RTOL,
                msg=lambda m: f"rank {r} {k}: {m}")
