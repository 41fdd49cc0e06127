"""GQA attention with RoPE, softcap and a KV cache (port of
``repro.models.attention``, the prefill and decode modes, and of the
local ring of ``repro.models.blocks``).

* prefill (``fill_cache``): K6, the flash prefill kernel
  (:func:`repro_torch.kernels.flash_prefill.ops.flash_attention`), over the
  prompt, and its K/V written into the cache.  This is the Pallas dispatch
  the JAX module describes; JAX itself computes the same function with
  ``_xla_flash``.
* decode (``cache``): K/V appended at ``cache_len``, then plain tensor code
  over the cache prefix, as the JAX package leaves decode to XLA.
* no cache (JAX's train mode: every layer of a training forward, an
  encoder layer, decoder cross-attention over the encoder's output): K6
  as well, with the layer's window (``local``), bidirectional for the
  encoder and cross-attention (``causal=False``).  Under autograd K6 is
  the forward of an autograd function whose backward is K6b, the
  hand-written gradient kernel
  (:class:`repro_torch.kernels.flash_prefill.ops.FlashAttention`).

The public functions keep the JAX layout ``[B, T, H, D]``; the call to K6
transposes to its ``[B, H, T, D]``.

**Local heads** (train mode on a placed state, ``tp``: the
:class:`repro_torch.dist.sharding.ModelAxis` of the step, as JAX's GSPMD
step computes a layer split on heads).  When ``wq`` comes split on its
heads (``Hq / n`` of them on each of the ``n`` ``model`` ranks), this rank
projects its query heads, runs K6 (and K6b in the backward) over them
and the KV heads they read, and multiplies by its rows of ``wo``: a
partial ``[B, T, d]`` that ``tp.g`` sums over the ranks.  Global query
head ``h`` reads KV head ``h // (Hq / Hkv)``; where ``wk``/``wv`` come
whole (``Hkv`` does not divide over ``model``), this rank takes the KV
heads its query heads read, and their gradient is summed over the ranks
(``tp.f`` on the weights).  With ``attn_hd_shard`` (the head dim split)
the placement gathers the layer whole and it runs as on one rank.

``span`` (a host int) is one more than the largest position of the pass:
no row can see a cache column at or past it.  Decode reads only the first
``span`` columns, which changes nothing (the others are masked), and when
``span`` exceeds the cache the writes past its end are dropped.
``inplace=True`` writes the new K/V into the given cache; the default
writes into a copy and leaves the given cache as it was, as JAX does.

Block kind ``local`` (sliding-window attention) keeps a ring,
:class:`LocalKVCache`, of ``W = min(local_window, L)`` slots: position
``p`` lives in slot ``p % W``, and ``pos`` records which position each
slot holds (-1 for an empty one), as in the JAX package.
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


class LocalKVCache(NamedTuple):
    k: torch.Tensor        # [B, W, Hkv, D] ring buffer
    v: torch.Tensor        # [B, W, Hkv, D]
    pos: torch.Tensor      # i32[B, W] position held by each slot (-1 empty)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` [B, T, d] times ``w`` [d, H, D] -> [B, T, H, D]."""
    d, H, D = w.shape
    return (x @ w.reshape(d, H * D)).view(*x.shape[:-1], H, D)


def _project_qkv(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor,
                 x_kv: Optional[torch.Tensor] = None,
                 use_rope: Optional[bool] = None):
    """q of ``x``, k and v of ``x_kv`` (``x`` when None), each
    [B, T, H, D].  RoPE at ``positions`` when ``use_rope`` (the config's
    ``rope`` when None) and there is no ``x_kv``, as in JAX."""
    rotate = (cfg.rope if use_rope is None else use_rope) and x_kv is None
    x_kv = x if x_kv is None else x_kv
    q = _proj(x, params["wq"])
    k, v = _proj(x_kv, params["wk"]), _proj(x_kv, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if rotate:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _flash(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, window: int, causal: bool = True) -> torch.Tensor:
    """K6 in the JAX layout, ``q`` [B, T, Hq, D] over ``k``/``v``
    [B, S, Hkv, D] (the kernel's is [B, H, T, D]), with ``window`` and the
    config's softcap."""
    return flash_attention(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), causal=causal, window=window,
        softcap=cfg.attn_softcap).transpose(1, 2)


def _local_kv(params: dict, cfg: ModelConfig, h0: int, hq: int, tp):
    """``params`` with ``wk``/``wv``/``bk``/``bv`` cut to the KV heads that
    query heads ``[h0, h0 + hq)`` read, when they came whole: their KV
    heads in order when each is read by as many consecutive query heads
    (GQA kept), else one KV head per query head.  The whole weights pass
    ``tp.f``: each rank's gradient of them is its heads' share."""
    G = cfg.num_heads // cfg.num_kv_heads
    if "wk" in tp.local:
        return params                   # split with the query heads
    want = [(h0 + j) // G for j in range(hq)]
    lo, n = want[0], want[-1] - want[0] + 1
    if hq % n == 0 and want == [lo + j // (hq // n) for j in range(hq)]:
        idx = list(range(lo, lo + n))
    else:
        idx = want
    sel = torch.tensor(idx, device=params["wk"].device)
    out = dict(params)
    for name, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
        if name in params:
            out[name] = tp.f(params[name]).index_select(dim, sel)
    return out


def _attention_local(params: dict, cfg: ModelConfig, x: torch.Tensor,
                     positions: torch.Tensor, window: int, causal: bool,
                     use_rope: Optional[bool], tp) -> torch.Tensor:
    """Train-mode self-attention over this rank's query heads (see the
    module docstring): the whole ``[B, T, d]`` output, summed over the
    ``model`` ranks by ``tp.g``."""
    hq = params["wq"].shape[1]
    params = _local_kv(params, cfg, tp.index * hq, hq, tp)
    q, k, v = _project_qkv(params, cfg, tp.f(x), positions,
                           use_rope=use_rope)
    out = _flash(cfg, q, k, v, window=window, causal=causal)
    return tp.g(_out_proj(params, out))


def _out_proj(params: dict, out: torch.Tensor) -> torch.Tensor:
    """``out`` [B, T, Hq, D] times ``wo`` [Hq, D, d] -> [B, T, d]."""
    B, T, Hq, D = out.shape
    return out.reshape(B, T, Hq * D) @ params["wo"].reshape(Hq * D, -1)


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


def _decode_attend(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, mask: torch.Tensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """``q`` [B, T, Hq, D] over the cache columns ``k``/``v`` [B, L, Hkv,
    D] that ``mask`` [B, T, L] lets each row see -> [B, T, Hq, D].

    Trap T6: ``q`` is scaled in its own dtype before the product, the
    logits are float32 (products of the operands accumulated in float32),
    and the probabilities are normalised, ``p / l``, in the cache's dtype
    before the P V product — all as in the JAX decode."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    qf = q.reshape(B, T, Hkv, Hq // Hkv, D) * torch.tensor(
        1.0 / math.sqrt(D), dtype=q.dtype)
    logits = torch.einsum("bthgd,bshd->bthgs", qf.float(), k.float())
    if cfg.attn_softcap > 0:
        logits = softcap(logits, cfg.attn_softcap)
    logits = logits.masked_fill(~mask[:, :, None, None, :], NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = (p / p.sum(-1, keepdim=True)).to(v.dtype).float()
    out = torch.einsum("bthgs,bshd->bthgd", p, v.float())
    return out.reshape(B, T, Hq, D).to(out_dtype)


def _global_attend(cfg: ModelConfig, q: torch.Tensor, cache: KVCache,
                   cache_len: torch.Tensor, positions: torch.Tensor,
                   span: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Decode over the first ``min(span, L)`` cache columns: a row sees
    the columns below its sequence's length and at or before its own
    position."""
    T = q.shape[1]
    L = min(span, cache.k.shape[1])
    cols = torch.arange(L, device=q.device)[None, None, :]
    mask = (cols < (cache_len + T)[:, None, None]) \
        & (cols <= positions[..., None])                        # causal
    return _decode_attend(cfg, q, cache.k[:, :L], cache.v[:, :L], mask,
                          out_dtype)


def attention(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,                       # [B, T, d]
    positions: torch.Tensor,               # i32[B, T], cache_len + t
    *,
    span: Optional[int] = None,
    cache: Optional[KVCache] = None,
    cache_len: Optional[torch.Tensor] = None,   # i32[B] tokens in cache
    fill_cache: Optional[KVCache] = None,        # prefill: write K/V here
    inplace: bool = False,
    causal: bool = True,
    x_kv: Optional[torch.Tensor] = None,         # cross-attention source
    use_rope: Optional[bool] = None,
    window: int = 0,
    tp=None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Global attention (block kind ``attn``).  Returns (out [B, T, d],
    updated cache).  Modes, as in JAX:

    * prefill (``fill_cache``) and decode (``cache``), causal, need
      ``span``;
    * neither cache (train mode: a training forward's layer, an encoder
      layer, a cross-attention sublayer): K6 over ``x_kv`` (``x`` when
      None) with ``window`` (a ``local`` layer's ``cfg.local_window``, as
      JAX's ``attention(kind="local")``), causal only when ``causal`` and
      no ``x_kv``, no cache (None is returned for it).  A decode step's
      cross-attention is a K6 call with T = 1.  With ``tp`` and ``wq``
      split on its heads (``"wq" in tp.local``), over this rank's
      heads (the module docstring)."""
    if fill_cache is None and cache is None:
        if tp is not None and x_kv is None and "wq" in tp.local:
            return _attention_local(params, cfg, x, positions, window,
                                    causal, use_rope, tp), None
        q, k, v = _project_qkv(params, cfg, x, positions, x_kv, use_rope)
        out = _flash(cfg, q, k, v, window=window,
                     causal=causal and x_kv is None)
        return _out_proj(params, out), None
    if fill_cache is not None and cache is not None:
        raise ValueError("attention: pass fill_cache (prefill) or cache "
                         "(decode), not both")
    q, k, v = _project_qkv(params, cfg, x, positions)
    old = cache if fill_cache is None else fill_cache
    new = KVCache(_write(old.k, positions, k, span, inplace),
                  _write(old.v, positions, v, span, inplace))
    if fill_cache is not None:
        out = _flash(cfg, q, k, v, window=0)
    else:
        out = _global_attend(cfg, q, new, cache_len, positions, span,
                             x.dtype)
    return _out_proj(params, out), new


def _local_ring_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                       positions: torch.Tensor, cache: LocalKVCache,
                       span: int, inplace: bool
                       ) -> Tuple[torch.Tensor, LocalKVCache]:
    """A decode pass of local attention over the ring: position ``p``'s
    K/V overwrite slot ``p % W``, then each row attends over the slots
    that hold a position inside its window.

    JAX reads all ``W`` slots.  Before the ring wraps (``span <= W``) slot
    ``s`` holds position ``s`` or nothing, so no row can see a slot at or
    past ``span``: only the first ``min(span, W)`` are read, as the global
    path reads only ``span`` columns.  A ring sliced to its first ``L``
    slots is the same ring while every position written is below ``L``,
    since then ``p % L == p % W``."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    W = cache.k.shape[1]
    slot = positions % W          # in [0, W), so JAX's mode="drop" drops
    cache = LocalKVCache(_write(cache.k, slot, k, W, inplace),   # nothing
                         _write(cache.v, slot, v, W, inplace),
                         _write(cache.pos, slot, positions, W, inplace))
    L = min(span, W)
    cpos = cache.pos[:, None, :L]                             # [B, 1, L]
    rows = positions[..., None]                               # [B, T, 1]
    mask = (cpos >= 0) & (cpos <= rows) & (cpos > rows - cfg.local_window)
    out = _decode_attend(cfg, q, cache.k[:, :L], cache.v[:, :L], mask,
                         x.dtype)
    return _out_proj(params, out), cache


def _prefill_local_ring(params: dict, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor, cache: LocalKVCache,
                        inplace: bool) -> Tuple[torch.Tensor, LocalKVCache]:
    """Prefill a local layer: K6 over the prompt with the window and the
    softcap (the Pallas dispatch the JAX module describes; JAX computes it
    with ``_xla_flash``), and only the last ``W`` positions' K/V kept in
    the ring (earlier ones are out of every later token's window).

    A prefill's positions are ``0 .. T-1``.  JAX sends those before
    ``T - W`` to slot ``W`` with ``mode="drop"``; here only the last
    ``min(T, W)`` tokens are written, each to its own slot."""
    T = positions.shape[1]
    q, k, v = _project_qkv(params, cfg, x, positions)
    W = cache.k.shape[1]
    last = slice(T - min(T, W), T)
    slot = positions[:, last] % W
    cache = LocalKVCache(_write(cache.k, slot, k[:, last], W, inplace),
                         _write(cache.v, slot, v[:, last], W, inplace),
                         _write(cache.pos, slot, positions[:, last], W,
                                inplace))
    out = _flash(cfg, q, k, v, window=cfg.local_window)
    return _out_proj(params, out), cache
