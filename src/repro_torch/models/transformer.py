"""The decoder LM's serving passes: prefill and decode (port of the serving
half of ``repro.models.transformer``).

Parameters are a plain dict of tensors: ``embed`` [V, d], ``layers`` (a
list with one block dict per layer, in depth order — the JAX package stacks
them as ``sb/l{i}`` over superblocks and runs ``lax.scan``; a Python loop
over the list replaces the scan), ``final_norm`` [d] and, for untied
embeddings, ``unembed`` [V, d].  The cache is a list with one
:class:`repro_torch.models.attention.KVCache` per layer.

Encoder-decoder and frontend configs are not ported yet and raise.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import KVCache
from repro_torch.models.blocks import block_apply, init_block, init_block_cache
from repro_torch.models.common import embed_init, rms_norm, softcap


def _kinds(cfg: ModelConfig) -> List[str]:
    pat = cfg.layer_pattern
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def _require_decoder_only(cfg: ModelConfig) -> None:
    if cfg.encoder_layers > 0 or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and frontend models are not "
            "ported yet")


def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random weights from ``gen`` (on ``gen``'s device) with the JAX
    initializers' distributions."""
    _require_decoder_only(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype),
        "layers": [init_block(gen, cfg, kind, dtype) for kind in _kinds(cfg)],
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                       dtype)
    return params


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device=None) -> List[KVCache]:
    return [init_block_cache(cfg, kind, batch, cache_len, dtype, device)
            for kind in _kinds(cfg)]


def _serve_pass(params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: List[KVCache], cache_len: torch.Tensor, mode: str,
                span: int, inplace: bool
                ) -> Tuple[torch.Tensor, List[KVCache]]:
    """Embed, run every block, norm and unembed the **last** position only.

    Trap T3: the JAX pass unembeds every position and ``prefill`` keeps the
    last; at full width that is a [16, 2048, 256000] float32 tensor (33 GB).
    The norm is per position, so unembedding the last one alone gives the
    same logits."""
    _require_decoder_only(cfg)
    B, T = tokens.shape
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model, dtype=x.dtype).sqrt()
    positions = cache_len[:, None] + torch.arange(
        T, dtype=cache_len.dtype, device=x.device)[None]
    new_cache = []
    for bp, kind, c in zip(params["layers"], _kinds(cfg), cache):
        x, c = block_apply(bp, cfg, kind, x, positions, cache=c, span=span,
                           cache_len=cache_len, mode=mode, inplace=inplace)
        new_cache.append(c)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = x @ params.get("unembed", params["embed"]).T
    if cfg.final_softcap > 0:
        logits = softcap(logits.float(), cfg.final_softcap)
    return logits, new_cache


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: List[KVCache], cache_len: torch.Tensor, *,
                inplace: bool = False, span: Optional[int] = None
                ) -> Tuple[torch.Tensor, List[KVCache]]:
    """One decode step (``tokens`` i32[B, T], T = 1 for greedy decode)
    over the caches.  Returns (logits of the last position [B, 1, V],
    cache').  ``inplace=True`` appends to the given caches; otherwise they
    are left as they were.  ``span`` is ``cache_len.max() + T``; a caller
    that knows it on the host passes it, else one host sync reads it."""
    if span is None:
        span = int(cache_len.max()) + tokens.shape[1]
    return _serve_pass(params, cfg, tokens, cache, cache_len, "decode",
                       span, inplace)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: List[KVCache], *, inplace: bool = False):
    """Fill empty caches with a prompt through K6.  Returns (last_logits
    [B, 1, V], cache', lengths i32[B])."""
    B, T = tokens.shape
    zeros = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
    logits, cache = _serve_pass(params, cfg, tokens, cache, zeros, "prefill",
                                T, inplace)
    return logits, cache, zeros + T
