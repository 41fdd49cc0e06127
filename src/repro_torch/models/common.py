"""Shared model primitives: norm, RoPE, softcap, initializers (port of
``repro.models.common``).

The initializers draw from a ``torch.Generator`` with the distributions of
the JAX initializers (a truncated normal scaled by fan-in, a normal of std
0.02); the numbers differ from ``jax.random``'s, so tests that compare the
two packages move weights across with
:func:`repro_torch.convert.params_from_numpy` instead.
"""
from __future__ import annotations

import math

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 that scales by ``1 + scale``, cast back to
    ``x``'s dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Rotary position embedding, **pair-interleaved**: the pairs are
    (2i, 2i+1), not the split halves of most PyTorch code.

    ``x`` [..., T, H, D] or [..., T, D], ``positions`` i32[..., T]."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., None].float() * freqs             # [..., T, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() == positions.dim() + 2:                     # head dim present
        cos, sin = cos[..., None, :], sin[..., None, :]
    xp = x.float().reshape(*x.shape[:-1], half, 2)
    x1, x2 = xp[..., 0], xp[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


def _fill_trunc_normal(t: torch.Tensor, gen: torch.Generator,
                       lo: float = -2.0, hi: float = 2.0) -> torch.Tensor:
    """In place: a standard normal truncated to [lo, hi], by inverting the
    CDF of a uniform draw (float32 ``t``)."""
    cdf_lo = 0.5 * (1.0 + math.erf(lo / math.sqrt(2.0)))
    cdf_hi = 0.5 * (1.0 + math.erf(hi / math.sqrt(2.0)))
    t.uniform_(2.0 * cdf_lo - 1.0, 2.0 * cdf_hi - 1.0, generator=gen)
    t.erfinv_().mul_(math.sqrt(2.0))
    return t.clamp_(lo, hi)


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init on ``gen``'s device."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    _fill_trunc_normal(t, gen).mul_(1.0 / math.sqrt(shape[in_axis]))
    return t.to(dtype)


def embed_init(gen: torch.Generator, shape,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return t.normal_(0.0, 0.02, generator=gen).to(dtype)
