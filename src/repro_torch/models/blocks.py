"""Residual block: norm -> mixer -> (+residual) -> norm -> ffn (port of
``repro.models.blocks`` for the dense attention family).

Only block kind ``attn`` with a dense MLP is ported.  The other kinds
(``local`` ring caches, ``mlstm``, ``slstm``, ``rglru``), MoE feed-forwards
and decoder cross-attention raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import KVCache, attention, init_attention
from repro_torch.models.common import rms_norm
from repro_torch.models.mlp import init_mlp, mlp


def _require_dense_attn(cfg: ModelConfig, kind: str) -> None:
    if kind != "attn":
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (only 'attn')")
    if cfg.num_experts > 0:
        raise NotImplementedError("MoE feed-forward is not ported yet")


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               dtype: torch.dtype = torch.float32) -> dict:
    _require_dense_attn(cfg, kind)
    d, dev = cfg.d_model, gen.device
    p = {"ln1": torch.zeros((d,), dtype=dtype, device=dev),
         "mixer": init_attention(gen, cfg, dtype=dtype)}
    if cfg.post_norms:
        p["ln1_post"] = torch.zeros((d,), dtype=dtype, device=dev)
    if cfg.d_ff > 0:
        p["ln2"] = torch.zeros((d,), dtype=dtype, device=dev)
        p["ffn"] = init_mlp(gen, cfg, dtype=dtype)
        if cfg.post_norms:
            p["ln2_post"] = torch.zeros((d,), dtype=dtype, device=dev)
    return p


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: Optional[torch.device] = None) -> KVCache:
    _require_dense_attn(cfg, kind)
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def block_apply(params: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                positions: torch.Tensor, *, cache: KVCache, span: int,
                cache_len: Optional[torch.Tensor] = None,
                mode: str = "prefill",
                inplace: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """One block in ``mode`` prefill or decode.  Returns (x', cache')."""
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode {mode!r}: the port serves prefill and decode")
    _require_dense_attn(cfg, kind)
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if mode == "prefill":
        h, new_cache = attention(params["mixer"], cfg, h, positions,
                                 span=span, fill_cache=cache,
                                 inplace=inplace)
    else:
        h, new_cache = attention(params["mixer"], cfg, h, positions,
                                 span=span, cache=cache, cache_len=cache_len,
                                 inplace=inplace)
    if cfg.post_norms:
        h = rms_norm(h, params["ln1_post"], cfg.norm_eps)
    x = x + h
    if "ffn" in params:
        h = mlp(params["ffn"], cfg, rms_norm(x, params["ln2"], cfg.norm_eps))
        if cfg.post_norms:
            h = rms_norm(h, params["ln2_post"], cfg.norm_eps)
        x = x + h
    return x, new_cache
