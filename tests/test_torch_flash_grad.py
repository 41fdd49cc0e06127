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
product, trap T6, and sums in blocks).  The kernel pair itself is held
against ``attention_bwd_ref`` on the card (``tests/test_torch_gpu.py``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.models.attention import _xla_flash

from repro_torch.kernels.flash_prefill import ops
from repro_torch.kernels.flash_prefill.ref import (attention_bwd_ref,
                                                   attention_lse_ref,
                                                   attention_ref)

TOL = dict(atol=1e-5, rtol=1e-4)

# B, Hq, Hkv, T, S, D, causal, window, softcap: causal; a window smaller
# than T and one larger; softcap 50; GQA 4:1 and 16:1; D 16, 64 and 256;
# bidirectional with T != S; S not a multiple of 64
CASES = [
    (2, 4, 4, 64, 64, 16, True, 0, 0.0),
    (1, 4, 2, 100, 100, 64, True, 9, 0.0),
    (1, 4, 2, 50, 50, 16, True, 64, 0.0),
    (1, 8, 2, 70, 70, 64, True, 0, 50.0),
    (2, 8, 2, 40, 40, 16, True, 0, 0.0),
    (1, 16, 1, 33, 33, 16, True, 5, 50.0),
    (1, 2, 1, 40, 40, 256, True, 16, 50.0),
    (2, 4, 2, 10, 75, 16, False, 0, 0.0),
    (1, 4, 4, 67, 67, 64, True, 0, 50.0),
]
IDS = [f"B{c[0]}-Hq{c[1]}-Hkv{c[2]}-T{c[3]}-S{c[4]}-D{c[5]}-"
       f"{'causal' if c[6] else 'bidir'}-w{c[7]}-cap{int(c[8])}"
       for c in CASES]


def inputs(seed, B, Hq, Hkv, T, S, D):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.5).astype(np.float32)
            for s in ((B, Hq, T, D), (B, Hkv, S, D), (B, Hkv, S, D),
                      (B, Hq, T, D))]


def jax_grads(q, k, v, do, causal, window, cap):
    """vjp of ``_xla_flash`` in JAX's [B, T, H, D] layout, returned in the
    port's [B, H, T, D]."""
    def f(q_, k_, v_):
        return _xla_flash(q_, k_, v_, causal=causal, window=window,
                          attn_cap=cap, block_s=32)

    tr = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    out, vjp = jax.vjp(f, tr(q), tr(k), tr(v))
    grads = vjp(tr(do))
    return (np.asarray(out).transpose(0, 2, 1, 3),
            [np.asarray(g).transpose(0, 2, 1, 3) for g in grads])


@pytest.mark.parametrize("B,Hq,Hkv,T,S,D,causal,window,cap", CASES, ids=IDS)
def test_gradient_matches_jax(B, Hq, Hkv, T, S, D, causal, window, cap):
    q, k, v, do = inputs(T + 7 * Hq + D, B, Hq, Hkv, T, S, D)
    kw = dict(causal=causal, window=window, softcap=cap)
    out_j, grads_j = jax_grads(q, k, v, do, causal, window, cap)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))

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


@pytest.mark.parametrize("B,Hq,Hkv,T,S,D,causal,window,cap",
                         [CASES[1], CASES[5], CASES[7]],
                         ids=[IDS[1], IDS[5], IDS[7]])
def test_plain_backward_equals_autograd_through_attention_ref(
        B, Hq, Hkv, T, S, D, causal, window, cap):
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
        # the plain versions compute in float32 whatever the input dtype
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
