"""GQA attention with RoPE, softcap and a KV cache (port of
``repro.models.attention``, the prefill and decode modes).

* prefill (``fill_cache``): K6, the flash prefill kernel
  (:func:`repro_torch.kernels.flash_prefill.ops.flash_attention`), over the
  prompt, and its K/V written into the cache.  This is the Pallas dispatch
  the JAX module describes; JAX itself computes the same function with
  ``_xla_flash``.
* decode (``cache``): K/V appended at ``cache_len``, then plain tensor code
  over the cache prefix, as the JAX package leaves decode to XLA.

The public functions keep the JAX layout ``[B, T, H, D]``; the call to K6
transposes to its ``[B, H, T, D]``.

``span`` (a host int) is one more than the largest position of the pass:
no row can see a cache column at or past it.  Decode reads only the first
``span`` columns, which changes nothing (the others are masked), and when
``span`` exceeds the cache the writes past its end are dropped.
``inplace=True`` writes the new K/V into the given cache; the default
writes into a copy and leaves the given cache as it was, as JAX does.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_prefill.ops import flash_attention
from repro_torch.models.common import dense_init, rope, softcap

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype = torch.float32) -> dict:
    d, hd, nq, nkv = cfg.d_model, cfg.hd, cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": dense_init(gen, (d, nq, hd), dtype=dtype),
        "wk": dense_init(gen, (d, nkv, hd), dtype=dtype),
        "wv": dense_init(gen, (d, nkv, hd), dtype=dtype),
        "wo": dense_init(gen, (nq, hd, d), in_axis=1, dtype=dtype),
    }
    if cfg.qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((nq, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((nkv, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((nkv, hd), dtype=dtype, device=dev)
    return p


class KVCache(NamedTuple):
    k: torch.Tensor        # [B, L, Hkv, D]
    v: torch.Tensor        # [B, L, Hkv, D]


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` [B, T, d] times ``w`` [d, H, D] -> [B, T, H, D]."""
    d, H, D = w.shape
    return (x @ w.reshape(d, H * D)).view(*x.shape[:-1], H, D)


def _project_qkv(params: dict, cfg: ModelConfig, x: torch.Tensor):
    q, k, v = (_proj(x, params[w]) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return q, k, v


def _write(buf: torch.Tensor, positions: torch.Tensor, val: torch.Tensor,
           span: int, inplace: bool) -> torch.Tensor:
    """``buf[b, positions[b, t]] = val[b, t]``.  Trap T2: JAX writes with
    ``mode="drop"``, so a position at or past the cache length L writes
    nothing; torch would raise, so those lanes are masked out (a host sync,
    only when ``span`` says some position lies past L)."""
    if not inplace:
        buf = buf.clone()
    B, T = positions.shape
    bidx = torch.arange(B, device=buf.device)[:, None].expand(B, T)
    pos = positions.long()
    val = val.to(buf.dtype)
    if span <= buf.shape[1]:
        buf[bidx, pos] = val
    else:
        keep = pos < buf.shape[1]
        buf[bidx[keep], pos[keep]] = val[keep]
    return buf


def _decode_attend(cfg: ModelConfig, q: torch.Tensor, cache: KVCache,
                   cache_len: torch.Tensor, positions: torch.Tensor,
                   span: int, out_dtype: torch.dtype) -> torch.Tensor:
    """``q`` [B, T, Hq, D] over the cache prefix -> [B, T, Hq, D].

    Trap T6: ``q`` is scaled in its own dtype before the product, the
    logits are float32 (products of the operands accumulated in float32),
    and the probabilities are normalised, ``p / l``, in the cache's dtype
    before the P V product — all as in the JAX decode."""
    B, T, Hq, D = q.shape
    Hkv = cache.k.shape[2]
    L = min(span, cache.k.shape[1])
    k, v = cache.k[:, :L].float(), cache.v[:, :L].float()
    qf = q.reshape(B, T, Hkv, Hq // Hkv, D) * torch.tensor(
        1.0 / math.sqrt(D), dtype=q.dtype)
    logits = torch.einsum("bthgd,bshd->bthgs", qf.float(), k)
    if cfg.attn_softcap > 0:
        logits = softcap(logits, cfg.attn_softcap)
    cols = torch.arange(L, device=q.device)[None, None, :]
    mask = (cols < (cache_len + T)[:, None, None]) \
        & (cols <= positions[..., None])                        # causal
    logits = logits.masked_fill(~mask[:, :, None, None, :], NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = (p / p.sum(-1, keepdim=True)).to(cache.v.dtype).float()
    out = torch.einsum("bthgs,bshd->bthgd", p, v)
    return out.reshape(B, T, Hq, D).to(out_dtype)


def attention(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,                       # [B, T, d]
    positions: torch.Tensor,               # i32[B, T], cache_len + t
    *,
    span: int,
    cache: Optional[KVCache] = None,
    cache_len: Optional[torch.Tensor] = None,   # i32[B] tokens in cache
    fill_cache: Optional[KVCache] = None,        # prefill: write K/V here
    inplace: bool = False,
) -> Tuple[torch.Tensor, KVCache]:
    """Causal global attention (block kind ``attn``).  Returns (out
    [B, T, d], updated cache).  Exactly one of ``fill_cache`` (prefill) and
    ``cache`` (decode) is given."""
    if (fill_cache is None) == (cache is None):
        raise ValueError("attention: pass fill_cache (prefill) or cache "
                         "(decode)")
    q, k, v = _project_qkv(params, cfg, x)
    if cfg.rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    B, T, Hq, D = q.shape
    old = cache if fill_cache is None else fill_cache
    new = KVCache(_write(old.k, positions, k, span, inplace),
                  _write(old.v, positions, v, span, inplace))
    if fill_cache is not None:
        out = flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=True,
            softcap=cfg.attn_softcap).transpose(1, 2)
    else:
        out = _decode_attend(cfg, q, new, cache_len, positions, span,
                             x.dtype)
    y = out.reshape(B, T, Hq * D) @ params["wo"].reshape(Hq * D, -1)
    return y, new
