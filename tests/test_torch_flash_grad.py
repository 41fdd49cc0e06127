"""The gradient of K6 (flash attention) against JAX's autodiff, on CPU.

JAX differentiates its attention, ``_xla_flash`` (blockwise online softmax
over KV blocks, each checkpointed), by autodiff; the port's gradient is
K6b, whose plain version ``attention_bwd_ref`` runs on CPU tensors, from
the row log-sum-exp of ``attention_lse_ref``.  The same numpy inputs and
upstream gradient go through ``jax.vjp`` of ``_xla_flash`` (blocks of 32
columns, so several blocks and a padded last one) and through the port:
``attention_bwd_ref`` called directly, and ``torch.autograd.grad`` through
``flash_attention`` (the autograd function, both halves plain on the
CPU).  Tolerance atol 1e-5, rtol 1e-4 (float32; JAX scales q before the
product, trap T6, and sums in blocks).  The same cases run in bf16 (C14:
bf16 training), the numpy inputs cast to bf16 for both, held to 2**-6 of
each tensor's largest magnitude (``bf16_limit``, derived there).  Each
limit is shown to catch a wrong gradient: the same inputs with one term
of the gradient removed fail it (``test_limits_fail_a_gradient_missing_a
_term``).  The kernels themselves are held against ``attention_bwd_ref``
on the card (``tests/test_torch_gpu.py``), the bf16 route within
``bwd_bf16_margin`` (``BF16_BWD_TOL`` plus ``bwd_bf16_rounding``), which
the last test here checks against the route emulated in plain PyTorch and
against a gradient missing a term.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.models.attention import _xla_flash

from repro_torch.kernels.flash_prefill import ops
from repro_torch.kernels.flash_prefill.ref import (_logits, _p_dx,
                                                   _products,
                                                   attention_bwd_ref,
                                                   attention_lse_ref,
                                                   attention_ref,
                                                   bwd_bf16_margin)

TOL = dict(atol=1e-5, rtol=1e-4)

# B, Hq, Hkv, T, S, D, causal, window, softcap, q's scale: causal; a
# window smaller than T and one larger; softcap 50; GQA 4:1 and 16:1; D 16,
# 64 and 256; bidirectional with T != S; S not a multiple of 64.  At q's
# scale 1 the logits stay below 1, where the softcap's 1 - tanh^2 differs
# from 1 by about 1e-4 and a gradient without it passes every limit; the
# last case scales q by 40, so that the logits reach gemma2-2b's cap of 50
CASES = [
    (2, 4, 4, 64, 64, 16, True, 0, 0.0, 1.0),
    (1, 4, 2, 100, 100, 64, True, 9, 0.0, 1.0),
    (1, 4, 2, 50, 50, 16, True, 64, 0.0, 1.0),
    (1, 8, 2, 70, 70, 64, True, 0, 50.0, 1.0),
    (2, 8, 2, 40, 40, 16, True, 0, 0.0, 1.0),
    (1, 16, 1, 33, 33, 16, True, 5, 50.0, 1.0),
    (1, 2, 1, 40, 40, 256, True, 16, 50.0, 1.0),
    (2, 4, 2, 10, 75, 16, False, 0, 0.0, 1.0),
    (1, 4, 4, 67, 67, 64, True, 0, 50.0, 1.0),
    (1, 4, 2, 48, 48, 64, True, 0, 50.0, 40.0),
]
IDS = [f"B{c[0]}-Hq{c[1]}-Hkv{c[2]}-T{c[3]}-S{c[4]}-D{c[5]}-"
       f"{'causal' if c[6] else 'bidir'}-w{c[7]}-cap{int(c[8])}"
       + (f"-qs{int(c[9])}" if c[9] != 1.0 else "") for c in CASES]
PARAMS = "B,Hq,Hkv,T,S,D,causal,window,cap,qs"


def inputs(seed, B, Hq, Hkv, T, S, D, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v, do = [(rng.standard_normal(s) * 0.5).astype(np.float32)
                   for s in ((B, Hq, T, D), (B, Hkv, S, D), (B, Hkv, S, D),
                             (B, Hq, T, D))]
    return [q * np.float32(q_scale), k, v, do]


def jax_grads(q, k, v, do, causal, window, cap, dtype=jnp.float32):
    """vjp of ``_xla_flash`` in JAX's [B, T, H, D] layout on the inputs cast
    to ``dtype``, returned in the port's [B, H, T, D] as float32."""
    def f(q_, k_, v_):
        return _xla_flash(q_, k_, v_, causal=causal, window=window,
                          attn_cap=cap, block_s=32)

    def tr(x):
        return jnp.asarray(x).astype(dtype).transpose(0, 2, 1, 3)

    def back(x):
        return np.asarray(x.astype(jnp.float32)).transpose(0, 2, 1, 3)

    out, vjp = jax.vjp(f, tr(q), tr(k), tr(v))
    return back(out), [back(g) for g in vjp(tr(do))]


@functools.lru_cache(maxsize=None)
def jax_case(case, dtype):
    """A case's numpy inputs, and JAX's output and gradients on them in
    ``dtype`` ("float32" or "bfloat16"); kept, so that the tests of the
    limits below reuse them."""
    B, Hq, Hkv, T, S, D, causal, window, cap, qs = case
    x = inputs(T + 7 * Hq + D, B, Hq, Hkv, T, S, D, qs)
    out, grads = jax_grads(*x, causal, window, cap,
                           dtype=getattr(jnp, dtype))
    for a in (*x, out, *grads):
        a.setflags(write=False)
    return x, out, grads


@pytest.mark.parametrize(PARAMS, CASES, ids=IDS)
def test_gradient_matches_jax(B, Hq, Hkv, T, S, D, causal, window, cap, qs):
    (q, k, v, do), out_j, grads_j = jax_case(
        (B, Hq, Hkv, T, S, D, causal, window, cap, qs), "float32")
    kw = dict(causal=causal, window=window, softcap=cap)
    tq, tk, tv, tdo = (torch.from_numpy(x.copy()) for x in (q, k, v, do))

    out, lse = attention_lse_ref(tq, tk, tv, **kw)
    np.testing.assert_allclose(out.numpy(), out_j, **TOL)
    for got, want in zip(attention_bwd_ref(tq, tk, tv, out, tdo, lse, **kw),
                         grads_j):
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    o = ops.flash_attention(*leaves, **kw)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    for got, want in zip(torch.autograd.grad(o, leaves, tdo), grads_j):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize(PARAMS, [CASES[1], CASES[5], CASES[7]],
                         ids=[IDS[1], IDS[5], IDS[7]])
def test_plain_backward_equals_autograd_through_attention_ref(
        B, Hq, Hkv, T, S, D, causal, window, cap, qs):
    """``attention_bwd_ref`` is the gradient of ``attention_ref``: the same
    numbers as autograd through it, in float64 to rounding."""
    q, k, v, do = (torch.from_numpy(x).double()
                   for x in inputs(3, B, Hq, Hkv, T, S, D))
    kw = dict(causal=causal, window=window, softcap=cap)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*leaves, **kw), leaves, do)
    out, lse = attention_lse_ref(q, k, v, **kw)
    got = attention_bwd_ref(q, k, v, out, do, lse, **kw)
    for g, w in zip(got, want):
        # attention_bwd_ref computes in float32 whatever the input dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=1e-5)


def test_lse_is_the_row_logsumexp_and_inf_where_a_row_sees_nothing():
    q, k, v, _ = (torch.from_numpy(x) for x in inputs(5, 1, 2, 2, 6, 6, 8))
    out, lse = attention_lse_ref(q, k, v, causal=True, window=2)
    logits = torch.einsum("bhtd,bhsd->bhts", q, k) / math.sqrt(8)
    i, j = torch.arange(6)[:, None], torch.arange(6)[None, :]
    logits = logits.masked_fill(~((j <= i) & (j > i - 2)), -math.inf)
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1))
    assert torch.equal(out, attention_ref(q, k, v, causal=True, window=2))
    # no column at all: every row's LSE is +inf, so exp(s - lse) is 0
    _, lse_empty = attention_lse_ref(q, k[:, :, :0], v[:, :, :0],
                                     causal=False)
    assert torch.isinf(lse_empty).all() and (lse_empty > 0).all()


def test_without_grad_the_call_is_the_plain_forward():
    q, k, v, _ = (torch.from_numpy(x) for x in inputs(6, 1, 4, 2, 9, 9, 16))
    out = ops.flash_attention(q, k, v, causal=True, window=3, softcap=50.0)
    assert out.grad_fn is None
    assert torch.equal(out, attention_ref(q, k, v, causal=True, window=3,
                                          softcap=50.0))
    with torch.no_grad():
        qg = q.clone().requires_grad_(True)
        assert ops.flash_attention(qg, k, v).grad_fn is None


def bf16_limit(want):
    """|port - JAX| allowed in bf16: 2**-6 of the tensor's largest
    magnitude.  Both start from the same bf16 inputs and round to bf16 at
    different places.  JAX scales q in bf16 before the product (trap T6),
    which moves each logit by up to 2**-9 of itself, and so each P by up
    to 2**-9 of its logit relative; it also rounds P to bf16 for P.V
    (2**-9 of P).  The port's plain versions compute in float32 from the
    bf16 inputs.  Each output is rounded to bf16 on both sides (2**-9 of
    itself).  A gradient entry is a sum over columns whose largest terms
    are at most the tensor's largest magnitude, so these roundings move it
    by a few times 2**-9 of that magnitude; 2**-6 allows eight.  Measured:
    at most 0.48 of this limit over the cases (dk of the 4:4 softcap case,
    T 67).  The same comparison without one term of the gradient misses
    by 12 to 64 times the limit (``test_limits_fail_a_gradient_missing_a
    _term``)."""
    return 2.0**-6 * np.abs(want).max()


@pytest.mark.parametrize(PARAMS, CASES, ids=IDS)
def test_bf16_gradient_matches_jax(B, Hq, Hkv, T, S, D, causal, window, cap,
                                   qs):
    """C14: bf16 inputs through ``FlashAttention`` on the CPU (K6's LSE
    and K6b's plain versions, the halves the card runs as K6's wgmma
    route and K6b's bf16 route) against ``jax.vjp`` of ``_xla_flash`` in
    bf16, output and gradients in bf16."""
    (q, k, v, do), out_j, grads_j = jax_case(
        (B, Hq, Hkv, T, S, D, causal, window, cap, qs), "bfloat16")
    kw = dict(causal=causal, window=window, softcap=cap)
    tq, tk, tv, tdo = (torch.from_numpy(x.copy()).bfloat16()
                       for x in (q, k, v, do))
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    o = ops.flash_attention(*leaves, **kw)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.detach().float().numpy(), out_j, rtol=0,
                               atol=bf16_limit(out_j))
    for got, want in zip(torch.autograd.grad(o, leaves, tdo), grads_j):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=bf16_limit(want))


def plain_bwd(q, k, v, o, do, lse, *, causal, window, softcap,
              round_bf16=False, drop=None):
    """``attention_bwd_ref``'s P, dX and products (ref's ``_p_dx`` and
    ``_products``), (dq, dk, dv) in float32, with two changes for the tests
    below.  ``round_bf16`` rounds P and dX to bf16 before their products,
    as K6b's bf16 route does.  ``drop`` removes one term of the gradient:
    ``"tanh"`` the softcap's ``1 - tanh^2`` from dX, or a pair of slices
    (query rows, KV columns), that block's share of dq (``dq = scale dX K``
    without those entries of dX)."""
    p, dx = _p_dx(q, k, v, o, do, lse, causal, window, softcap)
    if drop == "tanh":
        t = _logits(q, k, causal, window, softcap)[1]
        dx = dx / (1.0 - t * t)
    if round_bf16:
        p, dx = p.bfloat16().float(), dx.bfloat16().float()
    operands = (q.float(), k.float(), do.float(), 1.0 / math.sqrt(q.shape[3]))
    dq, dk, dv = _products(p, dx, *operands)
    if isinstance(drop, tuple):
        dx = dx.clone()
        dx[:, :, drop[0], drop[1]] = 0.0
        dq = _products(p, dx, *operands)[0]
    return dq, dk, dv


#: the first KV tile (32 columns, one of _xla_flash's blocks here) of every
#: query row
FIRST_KV_TILE = (slice(None), slice(0, 32))
#: (case, term removed): a KV tile's share of dq in every case, and the
#: softcap's 1 - tanh^2 in the case whose logits reach the cap
DROPS = [(c, FIRST_KV_TILE) for c in CASES] + [(CASES[-1], "tanh")]
DROP_IDS = [f"{i}-kv_tile" for i in IDS] + [f"{IDS[-1]}-tanh"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,drop", DROPS, ids=DROP_IDS)
def test_limits_fail_a_gradient_missing_a_term(case, drop, dtype):
    """Each limit above catches a wrong gradient.  The port's plain
    gradient on a case's inputs passes the dtype's limit against JAX's
    (TOL in float32, ``bf16_limit`` in bf16, each gradient rounded to the
    dtype as the port returns it), and the same gradient with one term
    removed does not: dq without the first KV tile's share, or, where the
    logits reach the cap, dX without the softcap's ``1 - tanh^2``."""
    B, Hq, Hkv, T, S, D, causal, window, cap, qs = case
    (q, k, v, do), _, grads_j = jax_case(case, dtype)
    kw = dict(causal=causal, window=window, softcap=cap)
    tq, tk, tv, tdo = (torch.from_numpy(x.copy()).to(getattr(torch, dtype))
                       for x in (q, k, v, do))
    o, lse = attention_lse_ref(tq, tk, tv, **kw)

    def within(got):
        for g, w in zip(got, grads_j):
            g = g.to(tq.dtype).float().numpy()
            if dtype == "float32":
                ok = np.allclose(g, w, **TOL)
            else:
                ok = bool((np.abs(g - w) <= bf16_limit(w)).all())
            if not ok:
                return False
        return True

    assert within(plain_bwd(tq, tk, tv, o, tdo, lse, **kw))
    assert not within(plain_bwd(tq, tk, tv, o, tdo, lse, **kw, drop=drop))


@pytest.mark.parametrize("D,window,cap,q_scale,drop", [
    (64, 0, 0.0, 1.0, "kv_tile"),
    (256, 700, 50.0, 1.0, "kv_tile"),
    (256, 700, 50.0, 8.0, "tanh"),
])
def test_bf16_rounding_bound_holds_rounding_and_catches_a_missing_term(
        D, window, cap, q_scale, drop):
    """``bwd_bf16_rounding`` bounds the rounding of P and dX (the bf16
    route emulated in plain PyTorch stays within it, T 1024) and is tight
    enough to see a wrong sum: the same result without one term is outside
    it.  The terms: one KV tile's share (64 columns) of the last query
    tile's dq (measured about 70 times the bound's size over its limit,
    where the limit's worst-case form, 2**-8 times the sum of the terms'
    magnitudes, grows with the number of terms), and the softcap's
    ``1 - tanh^2`` with q scaled so that the logits reach the cap."""
    B, Hq, Hkv, T = 1, 4, 2, 1024
    g = torch.Generator().manual_seed(D)
    q, k, v, do = (torch.randn(s, generator=g)
                   for s in ((B, Hq, T, D), (B, Hkv, T, D), (B, Hkv, T, D),
                             (B, Hq, T, D)))
    q, k, v, do = ((q * q_scale).bfloat16(), k.bfloat16(), v.bfloat16(),
                   do.bfloat16())
    kw = dict(causal=True, window=window, softcap=cap)
    o, lse = attention_lse_ref(q, k, v, **kw)
    want = attention_bwd_ref(q, k, v, o, do, lse, **kw)
    got = plain_bwd(q, k, v, o, do, lse, **kw, round_bf16=True)
    assert bwd_bf16_margin([x.bfloat16() for x in got], want,
                           q, k, v, o, do, lse, **kw) <= 1.0
    if drop == "kv_tile":
        drop = (slice(T - 64, T), slice(T - 6 * 64, T - 5 * 64))
    wrong = plain_bwd(q, k, v, o, do, lse, **kw, round_bf16=True, drop=drop)
    assert bwd_bf16_margin([x.bfloat16() for x in wrong], want,
                           q, k, v, o, do, lse, **kw) > 1.0
