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
    """The parameters at ``path`` as they are: the gather of a state that
    is not placed."""
    return tree


def _take_local(tree, *path):
    """:func:`_take` for a layer that computes on its shards: the whole
    parameters, no model axis."""
    return tree, None


def _block_params(placement, bp: dict, prefix: tuple, kind: str
                  ) -> Tuple[dict, dict]:
    """The parameters of the layer at ``prefix`` (``("layers", i)``, or
    ``("encoder", "layers", i)``) from this rank's shards, and the model
    axes of its parts that compute on their shards: the mixer of a kind
    in ``placement.local_mixers`` (every kind: attention on its heads,
    the RG-LRU on its channels, the mLSTM and sLSTM on their heads),
    cross-attention on its heads, and the feed-forward part (a dense MLP,
    or a mixture of experts on its block of experts and its shared
    expert's hidden slice, the router whole), gathered by the placement's
    ``gather_local`` (split over ``model`` where the specs split them),
    the norms whole."""
    local = {"cross", "ffn"}
    if kind in placement.local_mixers:
        local.add("mixer")
    params, tp = {}, {}
    for k in sorted(bp):
        if k in local:
            params[k], tp[k] = placement.gather_local(bp[k], *prefix, k)
        else:
            params[k] = placement.gather(bp[k], *prefix, k)
    return params, tp


def _embed(emb: torch.Tensor, cfg: ModelConfig, tokens: torch.Tensor,
           tp=None) -> torch.Tensor:
    """The token embeddings from the table ``emb``, times ``sqrt(d)`` with
    ``embed_scale``.  With ``tp`` the table is this rank's ``V / n``
    vocabulary rows of one split over ``model``: each rank looks up the
    tokens in its rows and writes zeros for the others, and ``tp.g`` sums
    the ranks' lookups (each row comes from one rank: the sum is
    exact)."""
    if tp is not None:
        V = emb.shape[0]
        ids = tokens.long() - tp.index * V
        here = (ids >= 0) & (ids < V)
        x = tp.g(torch.where(here[..., None], emb[ids.clamp(0, V - 1)],
                             torch.zeros((), dtype=emb.dtype,
                                         device=emb.device)))
    else:
        x = emb[tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model, dtype=x.dtype).sqrt()
    return x


def _run_encoder(params, cfg: ModelConfig, enc_x: torch.Tensor,
                 placement=None) -> torch.Tensor:
    """The encoder over frame embeddings ``enc_x`` [B, S, d]: fixed
    sinusoidal positions, then the bidirectional stack (K6 with
    ``causal=False`` in every layer; RoPE when the config has it, as in
    JAX), then the final norm.  ``placement`` (a
    :class:`repro_torch.dist.sharding.Placement` or ``ServePlacement``)
    says that ``params`` are this rank's shards and ``enc_x`` its rows:
    each layer's attention and MLP compute on their shards over ``model``
    (:func:`_block_params`), and the output is the same on every ``model``
    rank."""
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
        p, tp = (_block_params(placement, bp, ("encoder", "layers", i),
                               "attn")
                 if placement is not None else (bp, None))
        x, _ = block_apply(p, enc_cfg, "attn", x, positions, mode="train",
                           causal=False, tp=tp)
    gather = placement.gather if placement is not None else _take
    return rms_norm(x, gather(params["encoder"]["final_norm"], "encoder",
                              "final_norm"), cfg.norm_eps)


def _hidden(params, cfg: ModelConfig, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor], remat: bool,
            embed: torch.Tensor, placement=None, group=None,
            embed_tp=None) -> Tuple[torch.Tensor, Any]:
    """The training forward up to the final norm: (x [B, T_total, d], the
    summed auxiliary loss of every layer).

    ``remat=True`` checkpoints each layer (``torch.utils.checkpoint``,
    non-reentrant): the backward recomputes a layer's activations from its
    input, as JAX's ``jax.checkpoint`` per superblock does; the numbers are
    the same, only memory differs.  An attention layer's K6 runs again in
    the recompute, so a training step launches K6 twice per attention
    layer and K6b once.

    ``embed`` is the embedding table as the caller holds it (on a placed
    state, gathered by :func:`loss_fn`, once for a tied table's two
    uses), and ``embed_tp`` the model axis when it came as this rank's
    vocabulary rows.  ``placement`` (a
    :class:`repro_torch.dist.sharding.Placement`) says that ``params``
    are this rank's shards: each part of a layer is gathered just before
    its use (inside the layer's checkpoint, so the recompute gathers
    again), the mixers, cross-attention and the feed-forward parts (a
    dense MLP, a mixture of experts on this rank's block of experts), and
    an encoder's layers, like the embedding, over every axis but
    ``model``, computing on their shards over it (:func:`_block_params`,
    :func:`_embed`), the norms whole.
    ``group`` (a :class:`repro_torch.dist.sharding.BatchGroup`) says that
    ``tokens`` are this rank's rows of a batch split over ranks: a
    mixture of experts reads the whole batch's statistics over
    it."""
    B = tokens.shape[0]
    gather = placement.gather if placement is not None else _take
    x = _embed(embed, cfg, tokens, embed_tp)
    enc_out = None
    if _is_encdec(cfg):
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: forward "
                             "needs its frame embeddings (frontend_embeds), "
                             "as in the JAX package")
        enc_out = _run_encoder(params, cfg, frontend_embeds, placement)
    elif cfg.frontend != "none" and frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    T = x.shape[1]
    positions = torch.arange(T, dtype=I32, device=x.device)[None].expand(B, T)
    aux = 0.0
    for i, (bp, kind) in enumerate(zip(params["layers"], _kinds(cfg))):
        def layer(h, bp=bp, kind=kind, i=i):
            p, tp = (_block_params(placement, bp, ("layers", i), kind)
                     if placement is not None else (bp, None))
            return block_apply(p, cfg, kind, h, positions, enc_out=enc_out,
                               mode="train", group=group, tp=tp)
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
    x, aux = _hidden(params, cfg, tokens, frontend_embeds, remat,
                     params["embed"])
    logits = x @ params.get("unembed", params["embed"]).T
    if cfg.final_softcap > 0:
        logits = softcap(logits.float(), cfg.final_softcap)
    return logits, aux


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: bool = True, placement=None, group=None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross-entropy over the text region (a VLM's prefix
    masked) plus ``0.01 * aux``: (loss, {"ce", "aux"}).

    Only the positions that predict a token are unembedded (the norm is
    per position, so their logits are :func:`forward`'s), and the final
    softcap is applied inside :func:`~repro_torch.models.common.
    cross_entropy_loss`, which keeps no capped copy of the logits.
    ``placement`` and ``group`` are :func:`_hidden`'s; where the placement
    splits the (un)embedding over ``model`` by vocabulary, each rank
    unembeds into its slice of the vocabulary and the loss is the
    vocab-parallel one (the same on every ``model`` rank).  Over a
    ``group`` of
    ``n`` ranks that split the batch's rows, the loss is ``n`` times this
    rank's share of the whole batch's (the mask's sum is the whole
    batch's), so that its mean over the ranks is the whole batch's loss,
    as JAX's GSPMD step computes it."""
    tokens = batch["tokens"]
    fe = batch.get("frontend")
    gather = (placement.gather_local if placement is not None
              else _take_local)
    # a tied table is gathered once, for the lookup and the unembedding
    # (one gradient for it, reduced once)
    emb, emb_tp = gather(params["embed"], "embed")
    x, aux = _hidden(params, cfg, tokens, fe, remat, emb, placement, group,
                     emb_tp)
    nf = prefix_len(cfg, fe)
    x = x[:, nf:nf + tokens.shape[1] - 1]
    w, tp = emb, emb_tp
    if "unembed" in params:
        w, tp = gather(params["unembed"], "unembed")
    if tp is not None:
        x = tp.f(x)
    logits = x @ w.T
    mask = batch.get("loss_mask")
    mask = mask[:, 1:] if mask is not None else None
    count = None
    if group is not None:
        mask = mask if mask is not None else torch.ones_like(
            tokens[:, 1:], dtype=torch.float32)
        count = group.rows(mask.float().sum()).sum()
    ce = cross_entropy_loss(logits, tokens[:, 1:], mask,
                            cap=cfg.final_softcap, count=count, tp=tp)
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
                frontend_embeds: Optional[torch.Tensor] = None,
                placement=None) -> Tuple[torch.Tensor, List[Cache]]:
    """Embed (a VLM's patch embeddings first), run every block, norm and
    unembed the **last** position only.

    Trap T3: the JAX pass unembeds every position and ``prefill`` keeps the
    last; at full width that is a [16, 2048, 256000] float32 tensor (33 GB).
    The norm is per position, so unembedding the last one alone gives the
    same logits; a prefix changes nothing there.

    ``placement`` (a :class:`repro_torch.dist.sharding.ServePlacement`)
    says that ``params`` and ``cache`` are this rank's shards and
    ``tokens`` its rows.  Each layer's parts that compute on their shards
    over ``model`` (:func:`_block_params`: the attention and RG-LRU
    mixers on their cache shards, the xLSTM mixers on their heads of
    their state, cross-attention, a dense MLP, a mixture's block of
    experts) take their pieces, the rest is gathered at use; a cache
    leaf the mixer does not keep is gathered before the layer and cut
    back to the shard after it, and an xLSTM state's heads are gathered
    after it (``cache_in``, ``cache_out``); a mixture of experts reads the whole
    batch's statistics.  Where the (un)embedding is split on its
    vocabulary, the lookup is vocab-parallel (:func:`_embed`) and the
    logits are this rank's ``V / n`` columns ``[B, 1, V / n]`` (the
    placement's ``vocab`` axis; the final softcap is elementwise)."""
    gather = placement.param if placement is not None else _take
    take_local = (placement.gather_local if placement is not None
                  else _take_local)
    group = placement.group if placement is not None else None
    B, T = tokens.shape
    # a tied table is taken once, for the lookup and the unembedding
    emb, emb_tp = take_local(params["embed"], "embed")
    x = _embed(emb, cfg, tokens, emb_tp)
    if (cfg.frontend != "none" and not _is_encdec(cfg)
            and frontend_embeds is not None):
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
        T = x.shape[1]
    positions = cache_len[:, None] + torch.arange(
        T, dtype=cache_len.dtype, device=x.device)[None]
    new_cache = []
    for i, (bp, kind, c) in enumerate(zip(params["layers"], _kinds(cfg),
                                          cache)):
        if placement is not None:
            p, tp = _block_params(placement, bp, ("layers", i), kind)
            full = placement.cache_in(c, i, tp.get("mixer"))
        else:
            p, tp, full = bp, None, c
        x, new = block_apply(p, cfg, kind, x, positions, cache=full,
                             span=span, cache_len=cache_len, enc_out=enc_out,
                             mode=mode, inplace=inplace, group=group, tp=tp)
        new_cache.append(placement.cache_out(new, c, i, tp.get("mixer"))
                         if placement is not None else new)
    x = rms_norm(x[:, -1:], gather(params["final_norm"], "final_norm"),
                 cfg.norm_eps)
    w, tp = emb, emb_tp
    if "unembed" in params:
        w, tp = take_local(params["unembed"], "unembed")
    logits = x @ w.T
    if cfg.final_softcap > 0:
        logits = softcap(logits.float(), cfg.final_softcap)
    return logits, new_cache


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: List[Cache], cache_len: torch.Tensor, *,
                enc_out: Optional[torch.Tensor] = None,
                inplace: bool = False, span: Optional[int] = None,
                placement=None) -> Tuple[torch.Tensor, List[Cache]]:
    """One decode step (``tokens`` i32[B, T], T = 1 for greedy decode)
    over the caches, an encoder-decoder's cross-attention over ``enc_out``.
    Returns (logits of the last position [B, 1, V], or this rank's
    vocabulary columns on a placed state, cache').
    ``inplace=True`` appends to the given KV caches; otherwise they are
    left as they were.  A recurrent state is never written: the pass
    returns a new one.  ``span`` is ``cache_len.max() + T``; a caller that
    knows it on the host passes it, else one host sync reads it (trap
    "host reads under FakeTensorMode": a dry run passes it).
    ``placement``: :func:`_serve_pass`'s, with this rank's rows of
    ``tokens``, ``cache_len`` and ``enc_out``."""
    if span is None:
        span = int(cache_len.max()) + tokens.shape[1]
    return _serve_pass(params, cfg, tokens, cache, cache_len, "decode",
                       span, inplace, enc_out=enc_out, placement=placement)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: List[Cache], *,
            frontend_embeds: Optional[torch.Tensor] = None,
            inplace: bool = False, placement=None):
    """Fill empty caches with a prompt through K6.  Returns (last_logits
    [B, 1, V], cache', lengths i32[B]).  A VLM's ``frontend_embeds``
    [B, Nf, d] are a prefix of the prompt and the lengths are ``T + Nf``;
    an encoder-decoder's are its frames, which the encoder runs over (a
    caller that decodes runs :func:`_run_encoder` for ``enc_out``, as
    JAX's callers do).  An encoder-decoder with no frames raises (JAX
    fails there too, on ``None``: trap C13).  ``placement``:
    :func:`_serve_pass`'s, with this rank's rows of ``tokens`` and
    ``frontend_embeds``."""
    B, T = tokens.shape
    enc_out, fe = None, frontend_embeds
    if _is_encdec(cfg):
        if frontend_embeds is None:
            raise ValueError(
                f"{cfg.name} is an encoder-decoder: prefill needs its frame "
                "embeddings (frontend_embeds); the JAX package fails here "
                "too (trap C13)")
        enc_out, fe = _run_encoder(params, cfg, frontend_embeds,
                                   placement), None
    total = T + prefix_len(cfg, frontend_embeds)
    zeros = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
    logits, cache = _serve_pass(params, cfg, tokens, cache, zeros, "prefill",
                                total, inplace, enc_out=enc_out,
                                frontend_embeds=fe, placement=placement)
    return logits, cache, zeros + total
