"""Residual block: norm -> mixer -> (+residual) -> cross-attention ->
norm -> ffn/moe (port of ``repro.models.blocks``).

Mixer kinds: ``attn`` (global attention over a ``KVCache``), ``local``
(sliding-window attention over a ring cache, ``LocalKVCache``; both in
:mod:`repro_torch.models.attention`), ``rglru`` (:mod:`repro_torch.models.
rglru`), ``mlstm`` and ``slstm`` (:mod:`repro_torch.models.mlstm`).  A
recurrent kind's "cache" is its state now (``RGLRUState``, ``MLSTMState``,
``SLSTMState``, float32 whatever the cache dtype); a pass returns a new
state and never writes into the one it was given.  ``attn``, ``local`` and
``rglru`` blocks carry a dense MLP or a mixture of experts
(:mod:`repro_torch.models.moe`), the xLSTM kinds none.  An encoder-decoder's
decoder blocks carry a cross-attention sublayer (``cross_ln``, ``cross``).

Modes: ``prefill`` and ``decode`` serve; ``train`` is JAX's cache-free mode
(a training forward, and the encoder with ``causal=False``): every kind
runs there, attention through K6 with its window, and the block returns
the mixture of experts' auxiliary loss in place of a cache.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch

from repro_torch._tensor import I32
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (KVCache, LocalKVCache,
                                          _local_ring_decode,
                                          _prefill_local_ring, attention,
                                          init_attention)
from repro_torch.models.common import rms_norm
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.mlstm import (MLSTMState, SLSTMState, init_mlstm,
                                      init_slstm, mlstm_chunkwise,
                                      mlstm_decode, mlstm_init_state, slstm,
                                      slstm_init_state)
from repro_torch.models.moe import init_moe, moe
from repro_torch.models.rglru import (RGLRUState, init_rglru, rglru,
                                      rglru_decode, rglru_init_state)

Cache = Union[KVCache, LocalKVCache, RGLRUState, MLSTMState, SLSTMState]
RECURRENT_STATES = (RGLRUState, MLSTMState, SLSTMState)


def _uses_mlp(cfg: ModelConfig, kind: str) -> bool:
    return kind in ("attn", "local", "rglru") and (cfg.d_ff > 0
                                                   or cfg.num_experts > 0)


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               dtype: torch.dtype = torch.float32,
               cross: bool = False) -> dict:
    d, dev = cfg.d_model, gen.device
    p = {"ln1": torch.zeros((d,), dtype=dtype, device=dev)}
    if kind in ("attn", "local"):
        p["mixer"] = init_attention(gen, cfg, dtype=dtype)
    elif kind == "mlstm":
        p["mixer"] = init_mlstm(gen, cfg, dtype=dtype)
    elif kind == "slstm":
        p["mixer"] = init_slstm(gen, cfg, dtype=dtype)
    elif kind == "rglru":
        p["mixer"] = init_rglru(gen, cfg, dtype=dtype)
    else:
        raise ValueError(kind)
    if cfg.post_norms:
        p["ln1_post"] = torch.zeros((d,), dtype=dtype, device=dev)
    if cross:
        p["cross_ln"] = torch.zeros((d,), dtype=dtype, device=dev)
        p["cross"] = init_attention(gen, cfg, dtype=dtype)
    if _uses_mlp(cfg, kind):
        p["ln2"] = torch.zeros((d,), dtype=dtype, device=dev)
        p["ffn"] = (init_moe(gen, cfg, dtype=dtype) if cfg.num_experts > 0
                    else init_mlp(gen, cfg, dtype=dtype))
        if cfg.post_norms:
            p["ln2_post"] = torch.zeros((d,), dtype=dtype, device=dev)
    return p


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: Optional[torch.device] = None) -> Cache:
    if kind == "mlstm":
        return mlstm_init_state(cfg, batch, device)
    if kind == "slstm":
        return slstm_init_state(cfg, batch, device)
    if kind == "rglru":
        return rglru_init_state(cfg, batch, device)
    if kind not in ("attn", "local"):
        raise ValueError(kind)
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


def _mixer(params: dict, cfg: ModelConfig, kind: str, h: torch.Tensor,
           positions: torch.Tensor, cache: Optional[Cache], span: Optional[int],
           cache_len: Optional[torch.Tensor], mode: str, causal: bool,
           inplace: bool) -> Tuple[torch.Tensor, Optional[Cache]]:
    if kind == "rglru":
        fn = rglru_decode if mode == "decode" else rglru
        return fn(params, cfg, h, cache)
    if kind == "mlstm":
        fn = mlstm_decode if mode == "decode" else mlstm_chunkwise
        return fn(params, cfg, h, cache)
    if kind == "slstm":
        return slstm(params, cfg, h, cache)
    if mode == "train":
        window = cfg.local_window if kind == "local" else 0
        return attention(params, cfg, h, positions, causal=causal,
                         window=window)
    if kind == "local" and mode == "prefill":
        return _prefill_local_ring(params, cfg, h, positions, cache, inplace)
    if kind == "local":
        return _local_ring_decode(params, cfg, h, positions, cache, span,
                                  inplace)
    if mode == "prefill":
        return attention(params, cfg, h, positions, span=span,
                         fill_cache=cache, inplace=inplace)
    return attention(params, cfg, h, positions, span=span, cache=cache,
                     cache_len=cache_len, inplace=inplace)


def block_apply(params: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                positions: torch.Tensor, *, cache: Optional[Cache] = None,
                span: Optional[int] = None,
                cache_len: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None,
                mode: str = "prefill", causal: bool = True,
                inplace: bool = False, group=None
                ) -> Tuple[torch.Tensor, Any]:
    """One block in ``mode`` prefill, decode or train.  Returns (x',
    cache') when serving, where a mixture of experts' auxiliary loss is
    dropped (serving never reads it, in either package), and (x', aux) in
    train mode, which has no cache: ``aux`` is the load-balance loss
    (a float32 scalar tensor) of a mixture of experts, else ``0.0``.  The
    cross-attention sublayer attends over ``enc_out``; with none it falls
    back to ``x`` itself, as JAX's does (trap C13).  ``group``: the ranks
    that split a training batch's rows, for a mixture of experts'
    statistics of the whole batch (:func:`repro_torch.models.moe.moe`)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    h, new_cache = _mixer(params["mixer"], cfg, kind, h, positions, cache,
                          span, cache_len, mode, causal, inplace)
    if cfg.post_norms:
        h = rms_norm(h, params["ln1_post"], cfg.norm_eps)
    x = x + h
    if "cross" in params:
        h = rms_norm(x, params["cross_ln"], cfg.norm_eps)
        h, _ = attention(params["cross"], cfg, h, positions, causal=False,
                         x_kv=enc_out, use_rope=False)
        x = x + h
    aux = 0.0
    if "ffn" in params:
        h = rms_norm(x, params["ln2"], cfg.norm_eps)
        if cfg.num_experts > 0:
            h, aux = moe(params["ffn"], cfg, h, group)
        else:
            h = mlp(params["ffn"], cfg, h)
        if cfg.post_norms:
            h = rms_norm(h, params["ln2_post"], cfg.norm_eps)
        x = x + h
    return x, (aux if mode == "train" else new_cache)
