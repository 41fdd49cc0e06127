"""The LM (port of ``repro.models.transformer``) for every family of the
zoo: the training forward and loss (:func:`forward`, :func:`loss_fn`) and
the serving passes (:func:`prefill`, :func:`decode_step`).

Parameters are a plain dict of tensors: ``embed`` [V, d], ``layers`` (a
list with one block dict per layer, in depth order — the JAX package stacks
them as ``sb/l{i}`` over superblocks and runs ``lax.scan``; a Python loop
over the list replaces the scan), ``final_norm`` [d] and, for untied
embeddings, ``unembed`` [V, d].  An encoder-decoder (whisper) adds
``encoder`` (``layers``, JAX's ``encoder/sb/l0`` unstacked, and
``final_norm``), and its decoder blocks carry cross-attention.  The cache
is a list with one entry per layer: a
:class:`repro_torch.models.attention.KVCache` for a global attention
layer, a :class:`repro_torch.models.attention.LocalKVCache` ring for a
local one, a recurrent layer's state (float32) for ``rglru``, ``mlstm``
and ``slstm``.

Frontends, as in JAX: a VLM's precomputed patch embeddings are a prefix
of the prompt (``prefill(frontend_embeds=)``, lengths ``T + Nf``); an
encoder-decoder's precomputed frame embeddings go through the encoder
(:func:`_run_encoder`), whose output every decode step takes
(``decode_step(enc_out=)``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._tensor import I32
from repro_torch.ckpt.manager import tree_flatten
from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import (Cache, block_apply, init_block,
                                       init_block_cache)
from repro_torch.models.common import (cross_entropy_loss, embed_init,
                                      rms_norm, softcap)


def _kinds(cfg: ModelConfig) -> List[str]:
    pat = cfg.layer_pattern
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def _is_encdec(cfg: ModelConfig) -> bool:
    return cfg.encoder_layers > 0


def prefix_len(cfg: ModelConfig,
               frontend_embeds: Optional[torch.Tensor]) -> int:
    """Positions a prefill puts before the prompt: a VLM's patches (an
    encoder-decoder's frames go to its encoder instead)."""
    if frontend_embeds is None or _is_encdec(cfg):
        return 0
    return frontend_embeds.shape[1]


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, num_experts=0, post_norms=False)


def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random weights from ``gen`` (on ``gen``'s device) with the JAX
    initializers' distributions."""
    dev = gen.device
    cross = _is_encdec(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype),
        "layers": [init_block(gen, cfg, kind, dtype, cross=cross)
                   for kind in _kinds(cfg)],
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                       dtype)
    if cross:
        enc_cfg = _encoder_cfg(cfg)
        params["encoder"] = {
            "layers": [init_block(gen, enc_cfg, "attn", dtype)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                      device=dev),
        }
    return params


def param_count(params) -> int:
    return sum(x.numel() for x in tree_flatten(params))


def _take(tree, *path):
    """The parameters at ``path`` as they are: :func:`loss_fn`'s default
    ``gather``."""
    return tree


def _run_encoder(params, cfg: ModelConfig, enc_x: torch.Tensor,
                 gather=_take) -> torch.Tensor:
    """The encoder over frame embeddings ``enc_x`` [B, S, d]: fixed
    sinusoidal positions, then the bidirectional stack (K6 with
    ``causal=False`` in every layer; RoPE when the config has it, as in
    JAX), then the final norm."""
    B, S, d = enc_x.shape
    pos = torch.arange(S, dtype=I32, device=enc_x.device)
    half = d // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=enc_x.device)
                      * -math.log(10_000.0) / half)
    ang = pos[:, None].float() * freqs[None, :]
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(enc_x.dtype)
    x = enc_x + pe[None]
    positions = pos[None].expand(B, S)
    enc_cfg = _encoder_cfg(cfg)
    for i, bp in enumerate(params["encoder"]["layers"]):
        x, _ = block_apply(gather(bp, "encoder", "layers", i), enc_cfg,
                           "attn", x, positions, mode="train", causal=False)
    return rms_norm(x, gather(params["encoder"]["final_norm"], "encoder",
                              "final_norm"), cfg.norm_eps)


def _hidden(params, cfg: ModelConfig, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor], remat: bool,
            gather=_take, group=None) -> Tuple[torch.Tensor, Any]:
    """The training forward up to the final norm: (x [B, T_total, d], the
    summed auxiliary loss of every layer).

    ``remat=True`` checkpoints each layer (``torch.utils.checkpoint``,
    non-reentrant): the backward recomputes a layer's activations from its
    input, as JAX's ``jax.checkpoint`` per superblock does; the numbers are
    the same, only memory differs.  An attention layer's K6 runs again in
    the recompute, so a training step launches K6 twice per attention
    layer and K6b once.

    ``gather(subtree, *path)`` gives the parameters at ``path`` just
    before their use (a layer's inside its checkpoint, so the recompute
    calls it again): :meth:`repro_torch.dist.sharding.Placement.gather`
    on a sharded state, the subtree itself by default.  ``group`` (a
    :class:`repro_torch.dist.sharding.BatchGroup`) says that ``tokens``
    are this rank's rows of a batch split over ranks: a mixture of
    experts reads the whole batch's statistics over it."""
    B = tokens.shape[0]
    x = gather(params["embed"], "embed")[tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model, dtype=x.dtype).sqrt()
    enc_out = None
    if _is_encdec(cfg):
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: forward "
                             "needs its frame embeddings (frontend_embeds), "
                             "as in the JAX package")
        enc_out = _run_encoder(params, cfg, frontend_embeds, gather)
    elif cfg.frontend != "none" and frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    T = x.shape[1]
    positions = torch.arange(T, dtype=I32, device=x.device)[None].expand(B, T)
    aux = 0.0
    for i, (bp, kind) in enumerate(zip(params["layers"], _kinds(cfg))):
        def layer(h, bp=bp, kind=kind, i=i):
            return block_apply(gather(bp, "layers", i), cfg, kind, h,
                               positions, enc_out=enc_out, mode="train",
                               group=group)
        if remat:
            x, a = checkpoint(layer, x, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = layer(x)
        aux = aux + a
    return rms_norm(x, gather(params["final_norm"], "final_norm"),
                    cfg.norm_eps), aux


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            frontend_embeds: Optional[torch.Tensor] = None,
            remat: bool = True) -> Tuple[torch.Tensor, Any]:
    """Teacher-forced forward: (logits [B, T_total, V], aux loss).  Embed
    (times ``sqrt(d)`` with ``embed_scale``), a VLM's patch embeddings as a
    prefix, an encoder-decoder's frames through the encoder, every layer
    in train mode, the final norm, the tied or untied unembed and the
    final softcap (float32)."""
    x, aux = _hidden(params, cfg, tokens, frontend_embeds, remat)
    logits = x @ params.get("unembed", params["embed"]).T
    if cfg.final_softcap > 0:
        logits = softcap(logits.float(), cfg.final_softcap)
    return logits, aux


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: bool = True, gather=_take, group=None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross-entropy over the text region (a VLM's prefix
    masked) plus ``0.01 * aux``: (loss, {"ce", "aux"}).

    Only the positions that predict a token are unembedded (the norm is
    per position, so their logits are :func:`forward`'s), and the final
    softcap is applied inside :func:`~repro_torch.models.common.
    cross_entropy_loss`, which keeps no capped copy of the logits.
    ``gather`` and ``group`` are :func:`_hidden`'s.  Over a ``group`` of
    ``n`` ranks that split the batch's rows, the loss is ``n`` times this
    rank's share of the whole batch's (the mask's sum is the whole
    batch's), so that its mean over the ranks is the whole batch's loss,
    as JAX's GSPMD step computes it."""
    tokens = batch["tokens"]
    fe = batch.get("frontend")
    x, aux = _hidden(params, cfg, tokens, fe, remat, gather, group)
    nf = prefix_len(cfg, fe)
    x = x[:, nf:nf + tokens.shape[1] - 1]
    name = "unembed" if "unembed" in params else "embed"
    logits = x @ gather(params[name], name).T
    mask = batch.get("loss_mask")
    mask = mask[:, 1:] if mask is not None else None
    count = None
    if group is not None:
        mask = mask if mask is not None else torch.ones_like(
            tokens[:, 1:], dtype=torch.float32)
        count = group.rows(mask.float().sum()).sum()
    ce = cross_entropy_loss(logits, tokens[:, 1:], mask,
                            cap=cfg.final_softcap, count=count)
    if group is not None:
        ce = ce * group.n
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device=None) -> List[Cache]:
    return [init_block_cache(cfg, kind, batch, cache_len, dtype, device)
            for kind in _kinds(cfg)]


def _serve_pass(params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: List[Cache], cache_len: torch.Tensor, mode: str,
                span: int, inplace: bool,
                enc_out: Optional[torch.Tensor] = None,
                frontend_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[Cache]]:
    """Embed (a VLM's patch embeddings first), run every block, norm and
    unembed the **last** position only.

    Trap T3: the JAX pass unembeds every position and ``prefill`` keeps the
    last; at full width that is a [16, 2048, 256000] float32 tensor (33 GB).
    The norm is per position, so unembedding the last one alone gives the
    same logits; a prefix changes nothing there."""
    B, T = tokens.shape
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model, dtype=x.dtype).sqrt()
    if (cfg.frontend != "none" and not _is_encdec(cfg)
            and frontend_embeds is not None):
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
        T = x.shape[1]
    positions = cache_len[:, None] + torch.arange(
        T, dtype=cache_len.dtype, device=x.device)[None]
    new_cache = []
    for bp, kind, c in zip(params["layers"], _kinds(cfg), cache):
        x, c = block_apply(bp, cfg, kind, x, positions, cache=c, span=span,
                           cache_len=cache_len, enc_out=enc_out, mode=mode,
                           inplace=inplace)
        new_cache.append(c)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = x @ params.get("unembed", params["embed"]).T
    if cfg.final_softcap > 0:
        logits = softcap(logits.float(), cfg.final_softcap)
    return logits, new_cache


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: List[Cache], cache_len: torch.Tensor, *,
                enc_out: Optional[torch.Tensor] = None,
                inplace: bool = False, span: Optional[int] = None
                ) -> Tuple[torch.Tensor, List[Cache]]:
    """One decode step (``tokens`` i32[B, T], T = 1 for greedy decode)
    over the caches, an encoder-decoder's cross-attention over ``enc_out``.
    Returns (logits of the last position [B, 1, V], cache').
    ``inplace=True`` appends to the given KV caches; otherwise they are
    left as they were.  A recurrent state is never written: the pass
    returns a new one.  ``span`` is ``cache_len.max() + T``; a caller that
    knows it on the host passes it, else one host sync reads it."""
    if span is None:
        span = int(cache_len.max()) + tokens.shape[1]
    return _serve_pass(params, cfg, tokens, cache, cache_len, "decode",
                       span, inplace, enc_out=enc_out)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: List[Cache], *,
            frontend_embeds: Optional[torch.Tensor] = None,
            inplace: bool = False):
    """Fill empty caches with a prompt through K6.  Returns (last_logits
    [B, 1, V], cache', lengths i32[B]).  A VLM's ``frontend_embeds``
    [B, Nf, d] are a prefix of the prompt and the lengths are ``T + Nf``;
    an encoder-decoder's are its frames, which the encoder runs over (a
    caller that decodes runs :func:`_run_encoder` for ``enc_out``, as
    JAX's callers do).  An encoder-decoder with no frames raises (JAX
    fails there too, on ``None``: trap C13)."""
    B, T = tokens.shape
    enc_out, fe = None, frontend_embeds
    if _is_encdec(cfg):
        if frontend_embeds is None:
            raise ValueError(
                f"{cfg.name} is an encoder-decoder: prefill needs its frame "
                "embeddings (frontend_embeds); the JAX package fails here "
                "too (trap C13)")
        enc_out, fe = _run_encoder(params, cfg, frontend_embeds), None
    total = T + prefix_len(cfg, frontend_embeds)
    zeros = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
    logits, cache = _serve_pass(params, cfg, tokens, cache, zeros, "prefill",
                                total, inplace, enc_out=enc_out,
                                frontend_embeds=fe)
    return logits, cache, zeros + total
