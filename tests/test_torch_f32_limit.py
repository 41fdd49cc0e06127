"""The limit that K6's float32 route is held to at capped logits
(``ref.fwd_f32_rounding``), shown to pass every float32 evaluation of the
attention and to fail the evaluations that are not float32's.

The inputs are those of ``tests/test_torch_gpu.py``'s
``test_flash_prefill_softcap_bends_the_logits`` (gemma2-2b's layer: B 1,
Hq 8, Hkv 4, T = S = 512, D 256, softcap 50, q scaled by 12, so that the
logits, about N(0, 12^2), reach the cap; windows 0 and 200), drawn here
with numpy.  Each evaluation is held against ``attention_ref`` on float64
copies by ``fwd_f32_margin``: the largest ``|got - exact|`` over the limit,
at most 1 to pass.

Within the limit: the float32 plain version (about 0.14 of it), JAX's
float32 ``attention_ref`` and a CPU emulation of the split-TF32 route
(about 0.17): each float32 operand is split into ``hi = tf32(x)`` (the low
13 mantissa bits masked off, as the tensor core reads a float32) and
``lo = tf32(x - hi)``, each product is ``hi.hi + hi.lo + lo.hi`` in float32
and the sums are float32's, for Q K^T and for P V.  Over it: the same
emulation without one correction product (``hi.hi + hi.lo``, about 55
times the limit), the uncapped plain version (thousands) and a bf16
evaluation (inputs and P rounded to bf16, sums in float32; hundreds), so
the limit is no wider than a float32 route's own rounding and sees the
cap."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.kernels.flash_prefill.ref import attention_ref as jax_attention_ref

from repro_torch.kernels.flash_prefill.ref import (
    attention_ref, fwd_f32_margin, fwd_f32_rounding)

B, HQ, HKV, T, D, CAP, Q_SCALE = 1, 8, 4, 512, 256, 50.0, 12.0


@functools.lru_cache(maxsize=None)
def inputs():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, HQ, T, D), dtype=np.float32) * Q_SCALE
    k, v = (rng.standard_normal((B, HKV, T, D), dtype=np.float32)
            for _ in range(2))
    return q, k, v


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor core reads a float32: its low 13 mantissa bits
    dropped (truncated toward zero)."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_matmul(a: torch.Tensor, b: torch.Tensor, terms: int
                 ) -> torch.Tensor:
    """``a @ b`` by split-TF32: ``hi.hi + hi.lo + lo.hi`` with ``terms``
    3, ``hi.hi + hi.lo`` with 2.  A product of two tf32 values is exact in
    float32, so each matmul of them is that product summed in float32;
    the correction products sum apart from ``hi.hi``, as the kernel's
    do."""
    ha, hb = tf32(a), tf32(b)
    la, lb = tf32(a - ha), tf32(b - hb)
    corr = ha @ lb
    if terms == 3:
        corr = corr + la @ hb
    return ha @ hb + corr


def emulated(q, k, v, window, *, terms=3, bf16=False):
    """Causal attention with the softcap, its two products by
    :func:`split_matmul` (or, with ``bf16``, on inputs and P rounded to
    bf16), everything else in float32."""
    G = HQ // HKV
    kf, vf = (x.repeat_interleave(G, 1) for x in (k, v))
    if bf16:
        q, kf, vf = (x.bfloat16().float() for x in (q, kf, vf))
        y = q @ kf.transpose(-1, -2)
    else:
        y = split_matmul(q, kf.transpose(-1, -2), terms)
    s = torch.tanh(y * (1.0 / math.sqrt(D)) / CAP) * CAP
    i, j = torch.arange(T)[:, None], torch.arange(T)[None, :]
    seen = (j <= i) & ((j > i - window) if window else True)
    s = s.masked_fill(~seen, -math.inf)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    if bf16:
        o = e.bfloat16().float() @ vf
    else:
        o = split_matmul(e, vf, terms)
    return o / e.sum(-1, keepdim=True)


def evaluation(name, window):
    q, k, v = (torch.from_numpy(x) for x in inputs())
    kw = dict(causal=True, window=window, softcap=CAP)
    if name == "plain":
        return attention_ref(q, k, v, **kw)
    if name == "jax":
        return torch.from_numpy(np.array(jax_attention_ref(
            *(jnp.asarray(x) for x in inputs()), **kw)))
    if name == "split3":
        return emulated(q, k, v, window)
    if name == "split2":
        return emulated(q, k, v, window, terms=2)
    if name == "uncapped":
        return attention_ref(q, k, v, **dict(kw, softcap=0.0))
    return emulated(q, k, v, window, bf16=True)


@pytest.mark.parametrize("window", [0, 200])
@pytest.mark.parametrize("name,within", [
    ("plain", True), ("jax", True), ("split3", True), ("split2", False),
    ("uncapped", False), ("bf16", False)])
def test_f32_limit_passes_float32_and_fails_the_rest(name, within, window):
    q, k, v = (torch.from_numpy(x) for x in inputs())
    got = evaluation(name, window)
    assert got.dtype == torch.float32 and got.shape == (B, HQ, T, D)
    margin = fwd_f32_margin(got, q, k, v, causal=True, window=window,
                            softcap=CAP)
    assert (margin <= 1.0) == within, f"{name}: {margin} of the limit"


def test_f32_limit_is_a_float64_bound_of_the_right_shape():
    """The limit is positive and finite everywhere, and float64 (it must
    resolve errors far below float32's spacing); ``attention_ref`` on
    float64 inputs computes in float64 (the exact answer differs from the
    float32 plain version)."""
    q, k, v = (torch.from_numpy(x) for x in inputs())
    kw = dict(causal=True, window=200, softcap=CAP)
    bound = fwd_f32_rounding(q, k, v, **kw)
    assert bound.dtype == torch.float64 and bound.shape == (B, HQ, T, D)
    assert bool((bound > 0).all()) and bool(torch.isfinite(bound).all())
    exact = attention_ref(q.double(), k.double(), v.double(), **kw)
    assert exact.dtype == torch.float64
    assert not torch.equal(exact, attention_ref(q, k, v, **kw).double())
