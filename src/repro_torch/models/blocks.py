"""Residual block: norm -> mixer -> (+residual) -> norm -> ffn/moe (port of
``repro.models.blocks`` for the attention families).

Block kinds ``attn`` (global attention over a ``KVCache``) and ``local``
(sliding-window attention over a ring cache, ``LocalKVCache``; both in
:mod:`repro_torch.models.attention`), each with a dense MLP or a mixture
of experts (:mod:`repro_torch.models.moe`).  The recurrent kinds
(``mlstm``, ``slstm``, ``rglru``) and decoder cross-attention raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch._tensor import I32
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (KVCache, LocalKVCache,
                                          _local_ring_decode,
                                          _prefill_local_ring, attention,
                                          init_attention)
from repro_torch.models.common import rms_norm
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.moe import init_moe, moe

ATTENTION_KINDS = ("attn", "local")


Cache = Union[KVCache, LocalKVCache]


def _require_ported(kind: str) -> None:
    if kind not in ATTENTION_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (only "
            f"{', '.join(map(repr, ATTENTION_KINDS))})")


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               dtype: torch.dtype = torch.float32) -> dict:
    _require_ported(kind)
    d, dev = cfg.d_model, gen.device
    p = {"ln1": torch.zeros((d,), dtype=dtype, device=dev),
         "mixer": init_attention(gen, cfg, dtype=dtype)}
    if cfg.post_norms:
        p["ln1_post"] = torch.zeros((d,), dtype=dtype, device=dev)
    if cfg.d_ff > 0 or cfg.num_experts > 0:
        p["ln2"] = torch.zeros((d,), dtype=dtype, device=dev)
        p["ffn"] = (init_moe(gen, cfg, dtype=dtype) if cfg.num_experts > 0
                    else init_mlp(gen, cfg, dtype=dtype))
        if cfg.post_norms:
            p["ln2_post"] = torch.zeros((d,), dtype=dtype, device=dev)
    return p


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: Optional[torch.device] = None) -> Cache:
    _require_ported(kind)
    L = cache_len
    if kind == "local":
        L = min(cfg.local_window or cache_len, cache_len)
    shape = (batch, L, cfg.num_kv_heads, cfg.hd)
    k = torch.zeros(shape, dtype=dtype, device=device)
    v = torch.zeros(shape, dtype=dtype, device=device)
    if kind == "attn":
        return KVCache(k, v)
    # pos stays int32 whatever the cache's dtype
    return LocalKVCache(k, v, torch.full((batch, L), -1, dtype=I32,
                                         device=device))


def block_apply(params: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                positions: torch.Tensor, *, cache: Cache, span: int,
                cache_len: Optional[torch.Tensor] = None,
                mode: str = "prefill",
                inplace: bool = False) -> Tuple[torch.Tensor, Cache]:
    """One block in ``mode`` prefill or decode.  Returns (x', cache').  A
    mixture of experts' auxiliary loss is dropped: serving never reads it,
    in either package."""
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode {mode!r}: the port serves prefill and decode")
    _require_ported(kind)
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if kind == "local" and mode == "prefill":
        h, new_cache = _prefill_local_ring(params["mixer"], cfg, h, positions,
                                           cache, inplace)
    elif kind == "local":
        h, new_cache = _local_ring_decode(params["mixer"], cfg, h, positions,
                                          cache, span, inplace)
    elif mode == "prefill":
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
        h = rms_norm(x, params["ln2"], cfg.norm_eps)
        if cfg.num_experts > 0:
            h, _ = moe(params["ffn"], cfg, h)
        else:
            h = mlp(params["ffn"], cfg, h)
        if cfg.post_norms:
            h = rms_norm(h, params["ln2_post"], cfg.norm_eps)
        x = x + h
    return x, new_cache
