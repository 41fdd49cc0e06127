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
* The RG-LRU on its channels (prefill with and without a state, a decode
  step), the mLSTM on its heads (chunkwise over a ragged T, from a state
  whole over ``model``, two decode steps), the sLSTM on its heads, and
  reduced whisper-tiny's encoder layer feeding a decoder block's
  cross-attention, each rank in a thread whose collectives
  (:class:`Collective`: ``f``, ``g``, ``join``, ``psum``) cross the
  threads as the real axis's do: every rank's output and input gradients
  the layer's, each piece's gradient the layer's of that piece, a whole
  leaf's the layer's, and a leaf the layer slices (``sharding._SLICED``)
  summed over the ranks the layer's; each rank's new state its heads (or
  channels) of the layer's.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.dist.sharding import _SLICED
from repro_torch.models import attention as att
from repro_torch.models import mlstm as tm
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


# ---------------------------------------------------------------------------
# the recurrent mixers, an encoder layer and cross-attention on their shards
# ---------------------------------------------------------------------------
class _Join(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, hub, index, dim):
        ctx.hub, ctx.index, ctx.dim = hub, index, dim
        return hub.cat(index, x, dim)

    @staticmethod
    def backward(ctx, grad):
        return (ctx.hub.sum(ctx.index, grad).chunk(N, dim=ctx.dim)[ctx.index],
                None, None, None)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, hub, index):
        ctx.hub, ctx.index = hub, index
        return hub.sum(index, x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.hub.sum(ctx.index, grad), None, None


class _G(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, hub, index):
        return hub.sum(index, x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _CatHub(_Hub):
    def cat(self, index, x, dim):
        self.slots[index] = x
        self.barrier.wait()
        out = torch.cat(list(self.slots), dim=dim)
        self.barrier.wait()
        return out


class Collective(Threaded):
    """A ``model`` rank whose every collective crosses the ranks' threads
    as the real axis's does: ``f`` (its backward sum), ``g`` (the sum, an
    identity backward), ``join`` (the gather, its backward the sum cut to
    this rank's piece) and ``psum`` (the sum both ways).  Each rank's
    output is then the whole layer's."""

    def g(self, x):
        return _G.apply(x, self.hub, self.index)

    def join(self, x, dim):
        return _Join.apply(x, self.hub, self.index, dim)

    def psum(self, x):
        return _Psum.apply(x, self.hub, self.index)

    def holding(self, local):
        return Collective(self.hub, self.index, local)


def _on_threads(fn):
    """``fn(r, hub)`` for each rank in a thread of its own; the results in
    rank order (an exception in any rank raised)."""
    hub, results = _CatHub(), [None] * N

    def rank(r):
        try:
            results[r] = fn(r, hub)
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
    return results


def _leaves(tree, prefix=""):
    """(path, leaf) of a nested dict, in sorted order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _leaves(v, f"{prefix}{k}/")
        else:
            out.append((prefix + k, v))
    return out


def _grad_tree(tree):
    return {k: (_grad_tree(v) if isinstance(v, dict)
                else v.detach().clone().requires_grad_())
            for k, v in tree.items()}


def _pieces(tree, dims, r, prefix=""):
    """Rank ``r``'s leaves: those in ``dims`` (path -> split dim) cut,
    every other whole (a fresh leaf on each rank)."""
    out = {}
    for k, v in tree.items():
        path = prefix + k
        if isinstance(v, dict):
            out[k] = _pieces(v, dims, r, path + "/")
        elif path in dims:
            out[k] = _cut(v, dims[path], r)
        else:
            out[k] = v.detach().clone().requires_grad_()
    return out


def _rand(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


def _check_split(layer, p, dims, x, c, extra=()):
    """``layer(params, xs, tp)`` -> (out, *more) on N thread ranks, each
    with its pieces of ``p`` (``dims``: the leaves split, by path, and
    their dim) against ``layer(p, xs, None)``, ``xs`` the inputs ``x`` (a
    tensor or a tuple of them), each the same on every rank: every rank's
    output and inputs' gradients the layer's, each piece's gradient the
    layer's gradient of that piece, each whole leaf's gradient the
    layer's on every rank but for a leaf the layer slices (a
    ``sharding._SLICED`` name), whose gradients (a slice a rank) summed
    over the ranks are the layer's (the placement sums them).  ``extra``
    (index into ``more``, dim): outputs each rank holds its block of (a
    state's heads)."""
    xs = x if isinstance(x, tuple) else (x,)
    keys = [f"x{i}" for i in range(len(xs))]
    full = _grad_tree(p)
    xw = [v.detach().clone().requires_grad_() for v in xs]
    want, *more = layer(full, xw, None)
    names = [k for k, _ in _leaves(full)]
    want_g = dict(zip(keys + names, torch.autograd.grad(
        (want * c).sum(), xw + [v for _, v in _leaves(full)])))

    def rank(r, hub):
        local = _pieces(p, dims, r)
        xr = [v.detach().clone().requires_grad_() for v in xs]
        out, *got_more = layer(local, xr, Collective(hub, r, dims))
        grads = torch.autograd.grad((out * c).sum(),
                                    xr + [v for _, v in _leaves(local)])
        return (out.detach(), [m.detach() for m in got_more],
                dict(zip(keys + names, grads)))

    results = _on_threads(rank)
    summed = {}
    for r, (out, got_more, g) in enumerate(results):
        torch.testing.assert_close(out, want.detach(), atol=ATOL, rtol=RTOL)
        for k in keys:
            torch.testing.assert_close(g[k], want_g[k], atol=ATOL, rtol=RTOL,
                                       msg=lambda m: f"rank {r} {k}: {m}")
        for i, dim in extra:
            torch.testing.assert_close(
                got_more[i], more[i].detach().chunk(N, dim=dim)[r],
                atol=ATOL, rtol=RTOL, msg=lambda m: f"rank {r} out {i}: {m}")
        for k in names:
            if k in dims:
                torch.testing.assert_close(
                    g[k], want_g[k].chunk(N, dim=dims[k])[r], atol=ATOL,
                    rtol=RTOL, msg=lambda m: f"rank {r} {k}: {m}")
            elif k.split("/")[-1] in _SLICED:
                summed[k] = summed.get(k, 0) + g[k]
            else:
                torch.testing.assert_close(
                    g[k], want_g[k], atol=ATOL, rtol=RTOL,
                    msg=lambda m: f"rank {r} {k}: {m}")
    for k, v in summed.items():
        torch.testing.assert_close(v, want_g[k], atol=ATOL, rtol=RTOL,
                                   msg=lambda m: f"{k} summed: {m}")


def _state_leaves(state):
    return [x for x in state]


@pytest.mark.parametrize("mode", ["prefill", "prefill_state", "decode"])
def test_rglru_channels_sum_to_the_layer(mode):
    """An RG-LRU on its channels (``w_in``/``w_gate`` on columns, ``w_out``
    on rows, its per-channel leaves and gate columns sliced): with a state
    (whole, each rank its channels' slice of it) and without, and one
    decode step."""
    from repro_torch.models import rglru as rg
    cfg = reduced_config("recurrentgemma-9b")
    p = rg.init_rglru(torch.Generator().manual_seed(7), cfg)
    rng = np.random.default_rng(3)
    for k in ("conv_b", "ba", "bx"):
        p[k] = _rand(rng, p[k].shape, 0.1)
    B, T = 2, 1 if mode == "decode" else 11
    w = cfg.rnn_width
    x = _rand(rng, (B, T, cfg.d_model))
    c = _rand(rng, (B, T, cfg.d_model))
    st = rg.RGLRUState(_rand(rng, (B, w), 0.5),
                       _rand(rng, (B, cfg.conv_width - 1, w), 0.5))

    def layer(params, xx, tp):
        s = st if mode != "prefill" else None
        if tp is not None and s is not None:
            s = rg.RGLRUState(s.h.chunk(N, 1)[tp.index],
                              s.conv.chunk(N, 2)[tp.index])
        fn = rg.rglru_decode if mode == "decode" else rg.rglru
        out, new = fn(params, cfg, xx[0], s, tp)
        return out, new.h, new.conv

    _check_split(layer, p, {"w_in": 1, "w_gate": 1, "w_out": 0}, x, c,
                 extra=[(0, 1), (1, 2)])


_MLSTM_PIECES = {"w_up": 1, "w_gate": 1, "wq": 1, "wk": 1, "wv": 1,
                 "w_if": 1, "w_down": 0}


@pytest.mark.parametrize("mode", ["chunkwise", "chunkwise_state", "decode"])
def test_mlstm_heads_sum_to_the_layer(mode):
    """An mLSTM on its heads (``w_up``/``w_gate`` on the inner width, the
    head projections and ``w_if`` on heads, ``w_down`` on rows; ``xm``
    joined over the ranks; ``ln_out``'s statistic summed over them):
    chunkwise over a ragged T, from a state whole over ``model`` (each rank
    its heads of it), and two decode steps; each rank's new state its
    heads of the layer's."""
    cfg = reduced_config("xlstm-125m")
    p = tm.init_mlstm(torch.Generator().manual_seed(8), cfg)
    rng = np.random.default_rng(4)
    p["ln_out"] = _rand(rng, p["ln_out"].shape, 0.3)
    di, H, hd = tm._heads(cfg)
    assert H % N == 0 and H * hd == di
    B, T = 2, 2 if mode == "decode" else 13
    x = _rand(rng, (B, T, cfg.d_model))
    c = _rand(rng, (B, T, cfg.d_model))
    st = tm.MLSTMState(_rand(rng, (B, H, hd, hd), 0.3),
                       _rand(rng, (B, H, hd), 0.3))

    def layer(params, xx, tp):
        if mode == "decode":
            out, new = tm.mlstm_decode(params, cfg, xx[0], st, tp)
        else:
            out, new = tm.mlstm_chunkwise(
                params, cfg, xx[0], st if mode == "chunkwise_state" else None,
                tp)
        return out, new.C, new.n

    _check_split(layer, p, _MLSTM_PIECES, x, c, extra=[(0, 1), (1, 1)])


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_heads_sum_to_the_layer(with_state):
    """An sLSTM on its heads (``wx_s`` and ``wr`` on heads, ``w_down`` on
    rows, ``b`` and ``ln_out`` sliced, the norm's statistic summed over the
    ranks), from zeros and from a state whole over ``model``."""
    cfg = reduced_config("xlstm-125m")
    p = tm.init_slstm(torch.Generator().manual_seed(9), cfg)
    rng = np.random.default_rng(5)
    p["b"] = _rand(rng, p["b"].shape, 0.3)
    p["ln_out"] = _rand(rng, p["ln_out"].shape, 0.3)
    H, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    B, T = 2, 7
    x = _rand(rng, (B, T, cfg.d_model))
    c = _rand(rng, (B, T, cfg.d_model))
    st = tm.SLSTMState(*(_rand(rng, (B, H, hd), 0.3) for _ in range(4)))

    def layer(params, xx, tp):
        out, new = tm.slstm(params, cfg, xx[0], st if with_state else None,
                            tp)
        return (out, *new)

    _check_split(layer, p, {"wx_s": 1, "wr": 0, "w_down": 0}, x, c,
                 extra=[(i, 1) for i in range(4)])


_ATTN_PIECES = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}


def test_encoder_layer_and_cross_attention_sum_to_the_layers():
    """Reduced whisper-tiny: an encoder layer (K6 bidirectional on its
    heads, the non-gated MLP on its hidden slice) whose output feeds a
    decoder block's cross-attention on its heads (``enc_out`` through
    ``f``); the decoder block's self-attention and MLP on their shards
    too.  Every rank's output, ``x``'s and the frames' gradients, each
    piece's and each norm's gradient, against the two blocks on one
    rank."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.blocks import block_apply, init_block
    cfg = reduced_config("whisper-tiny")
    assert cfg.num_heads % N == 0 and cfg.num_kv_heads % N == 0
    gen = torch.Generator().manual_seed(10)
    enc = init_block(gen, tf._encoder_cfg(cfg), "attn")
    dec = init_block(gen, cfg, "attn", cross=True)
    rng = np.random.default_rng(6)
    for tree in (enc, dec):
        for k in [k for k in tree if k.startswith(("ln", "cross_ln"))]:
            tree[k] = _rand(rng, tree[k].shape, 0.3)
    p = {"enc": enc, "dec": dec}
    B, S, T = 2, 12, 5
    frames = _rand(rng, (B, S, cfg.d_model))
    x = _rand(rng, (B, T, cfg.d_model))
    c = _rand(rng, (B, T, cfg.d_model))
    spos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    tpos = torch.arange(T, dtype=torch.int32)[None].expand(B, T)
    dims = {f"{blk}/{part}/{k}": d for blk in ("enc", "dec")
            for part in ("mixer", "cross") for k, d in _ATTN_PIECES.items()
            if not (blk == "enc" and part == "cross")}
    dims.update({f"{blk}/ffn/{k}": (0 if k == "wd" else 1)
                 for blk in ("enc", "dec") for k in p[blk]["ffn"]})

    def parts(tp, blk, names):
        if tp is None:
            return None
        return {k: tp.holding(frozenset(n.split("/")[-1] for n in dims
                                        if n.startswith(f"{blk}/{k}/")))
                for k in names}

    def layer(params, xs, tp):
        xx, fr = xs
        enc_out, _ = block_apply(params["enc"], tf._encoder_cfg(cfg), "attn",
                                 fr, spos, mode="train", causal=False,
                                 tp=parts(tp, "enc", ("mixer", "ffn")))
        out, _ = block_apply(params["dec"], cfg, "attn", xx, tpos,
                             enc_out=enc_out, mode="train",
                             tp=parts(tp, "dec", ("mixer", "cross", "ffn")))
        return (out,)

    _check_split(layer, p, dims, (x, frames), c)
