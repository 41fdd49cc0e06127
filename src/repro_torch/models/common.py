"""Shared model primitives: norm, RoPE, softcap, initializers and the
cross-entropy loss (port of ``repro.models.common``).

The initializers draw from a ``torch.Generator`` with the distributions of
the JAX initializers (a truncated normal scaled by fan-in, a normal of std
0.02); the numbers differ from ``jax.random``'s, so tests that compare the
two packages move weights across with
:func:`repro_torch.convert.params_from_numpy` instead.
"""
from __future__ import annotations

import math
from typing import Optional

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


#: logits a chunk of :func:`cross_entropy_loss` holds at once (256 MB of
#: float32): the only [rows, V] temporaries besides the gradient
CE_CHUNK_ELEMS = 1 << 26


class _RowCrossEntropy(torch.autograd.Function):
    """Per-row ``lse - logit[label] + z lse^2`` of float32 logits [N, V],
    the cap (``cap tanh(x / cap)``) applied first when ``cap > 0``.
    Chunks of rows bound every temporary; only the logits and the row
    LSE are saved, and the backward writes the logits' gradient chunk by
    chunk into one tensor."""

    @staticmethod
    def forward(ctx, logits, labels, z_loss, cap):
        N, V = logits.shape
        rows = max(1, CE_CHUNK_ELEMS // max(V, 1))
        lse = torch.empty((N,), dtype=torch.float32, device=logits.device)
        ll = torch.empty_like(lse)
        for i in range(0, N, rows):
            c = softcap(logits[i:i + rows], cap)
            lse[i:i + rows] = torch.logsumexp(c, dim=-1)
            ll[i:i + rows] = c.gather(1, labels[i:i + rows, None])[:, 0]
        ctx.save_for_backward(logits, labels, lse)
        ctx.z_loss, ctx.cap = z_loss, cap
        loss = lse - ll
        return loss + z_loss * lse ** 2 if z_loss > 0 else loss

    @staticmethod
    def backward(ctx, grad_rows):
        logits, labels, lse = ctx.saved_tensors
        z_loss, cap = ctx.z_loss, ctx.cap
        N, V = logits.shape
        rows = max(1, CE_CHUNK_ELEMS // max(V, 1))
        # d loss_row / d s_j = p_j (1 + 2 z lse) - [j == label]
        gp = grad_rows * (1.0 + 2.0 * z_loss * lse) if z_loss > 0 \
            else grad_rows
        out = torch.empty_like(logits)
        for i in range(0, N, rows):
            x = logits[i:i + rows]
            t = torch.tanh(x / cap) if cap > 0 else None
            s = t * cap if cap > 0 else x
            d = torch.exp(s - lse[i:i + rows, None]) * gp[i:i + rows, None]
            d.scatter_add_(1, labels[i:i + rows, None],
                           -grad_rows[i:i + rows, None])
            if t is not None:
                d = d * (1.0 - t * t)
            out[i:i + rows] = d
        return out, None, None, None


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       z_loss: float = 1e-4,
                       cap: float = 0.0,
                       count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token cross-entropy with a z-loss ``z_loss * lse^2`` (PaLM), in
    float32: ``logits`` [..., V], ``labels`` int [...]; with ``mask`` the
    weighted sum over ``max(count, 1)``, where ``count`` is the mask's sum
    (``mask.sum()`` unless given: a caller that holds only some rows of
    the batch passes the whole batch's), else the mean.

    ``cap > 0`` applies the final softcap to ``logits`` first, inside the
    loss, so that no capped copy of the logits is kept (the JAX package
    caps in ``forward`` and passes the capped logits; the numbers are the
    same).  The LSE is taken in chunks of rows: at gemma2-2b's vocabulary
    a [4096, 256000] float32 logit tensor is 4.2 GB, and neither the
    forward nor the backward makes a second one besides the gradient."""
    V = logits.shape[-1]
    flat = logits.reshape(-1, V).float()
    loss = _RowCrossEntropy.apply(flat, labels.reshape(-1).long(), z_loss,
                                  cap)
    if mask is not None:
        m = mask.reshape(-1).to(loss.dtype)
        count = m.sum() if count is None else count.to(loss.dtype)
        return (loss * m).sum() / torch.clamp(count, min=1.0)
    return loss.mean()
