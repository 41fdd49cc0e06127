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
the placement gathers the layer whole and it runs as on one rank.  An
encoder's layers (K6 bidirectional) and cross-attention compute so too,
in training and at serve time: cross-attention's source (the encoder's
output, the same on every ``model`` rank) enters its K/V products through
``tp.f`` (:func:`_kv_source`).

**Local heads at serve time** (prefill and decode on a placed serve state,
``tp`` a :class:`repro_torch.dist.sharding.ServeAxis`, as JAX's decode and
prefill cells compute on ``cache_shardings``' specs).  Where the KV heads
divide over ``model`` (``tp.kv == "heads"``), this rank projects its
query and KV heads, runs K6 over them at prefill, writes their K/V into
its cache shard in place, attends over them at decode, and multiplies by
its rows of ``wo``; ``tp.g`` sums.  Where they do not
(``tp.kv == "seq"``: the cache split on positions, a ring on slots, over
``model``), the KV weights come whole: prefill runs K6 over this rank's
query heads and the KV heads they read, and writes every KV head's K/V
at the positions of its block; decode gathers the query heads over the
ranks, attends over its block with the softmax's max, sum and ``P V``
reduced over the ranks (:func:`_decode_attend`), and keeps its own heads
for ``wo``.

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
import torch.distributed as dist

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


def _kv_index(cfg: ModelConfig, h0: int, hq: int) -> list:
    """The KV heads that query heads ``[h0, h0 + hq)`` read: in order when
    each is read by as many consecutive query heads (GQA kept), else one
    KV head per query head."""
    G = cfg.num_heads // cfg.num_kv_heads
    want = [(h0 + j) // G for j in range(hq)]
    lo, n = want[0], want[-1] - want[0] + 1
    if hq % n == 0 and want == [lo + j // (hq // n) for j in range(hq)]:
        return list(range(lo, lo + n))
    return want


def _local_kv(params: dict, cfg: ModelConfig, h0: int, hq: int, tp):
    """``params`` with ``wk``/``wv``/``bk``/``bv`` cut to the KV heads that
    query heads ``[h0, h0 + hq)`` read (:func:`_kv_index`), when they came
    whole.  The whole weights pass ``tp.f``: each rank's gradient of them
    is its heads' share."""
    if "wk" in tp.local:
        return params                   # split with the query heads
    sel = torch.tensor(_kv_index(cfg, h0, hq), device=params["wk"].device)
    out = dict(params)
    for name, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
        if name in params:
            out[name] = tp.f(params[name]).index_select(dim, sel)
    return out


def _kv_source(x_kv: torch.Tensor, tp) -> torch.Tensor:
    """Cross-attention's source (the encoder's output, the same on every
    ``model`` rank) where it enters the column-split K/V products: through
    ``tp.f``, so that its gradient is summed over the ranks."""
    return tp.f(x_kv)


def _attention_local(params: dict, cfg: ModelConfig, x: torch.Tensor,
                     positions: torch.Tensor, window: int, causal: bool,
                     use_rope: Optional[bool], tp,
                     x_kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Train-mode attention over this rank's query heads (see the module
    docstring), self-attention or, with ``x_kv``, cross-attention: the
    whole ``[B, T, d]`` output, summed over the ``model`` ranks by
    ``tp.g``."""
    hq = params["wq"].shape[1]
    params = _local_kv(params, cfg, tp.index * hq, hq, tp)
    q, k, v = _project_qkv(params, cfg, tp.f(x), positions,
                           None if x_kv is None else _kv_source(x_kv, tp),
                           use_rope=use_rope)
    out = _flash(cfg, q, k, v, window=window,
                 causal=causal and x_kv is None)
    return tp.g(_out_proj(params, out))


def _out_proj(params: dict, out: torch.Tensor) -> torch.Tensor:
    """``out`` [B, T, Hq, D] times ``wo`` [Hq, D, d] -> [B, T, d]."""
    B, T, Hq, D = out.shape
    return out.reshape(B, T, Hq * D) @ params["wo"].reshape(Hq * D, -1)


def _write(buf: torch.Tensor, positions: torch.Tensor, val: torch.Tensor,
           span: int, inplace: bool, lo: int = 0) -> torch.Tensor:
    """``buf[b, positions[b, t] - lo] = val[b, t]``, ``lo`` the first
    position (or slot) of this rank's block of a cache split on dim 1 (0
    when it is not).  Trap T2: JAX writes with ``mode="drop"``, so a
    position at or past the cache length L writes nothing; torch would
    raise, so those lanes are masked out, and so are the lanes off this
    rank's block (a host sync, only when ``lo`` or ``span`` says some
    lane lies off ``buf``)."""
    if not inplace:
        buf = buf.clone()
    B, T = positions.shape
    bidx = torch.arange(B, device=buf.device)[:, None].expand(B, T)
    pos = positions.long() - lo
    val = val.to(buf.dtype)
    if lo == 0 and span <= buf.shape[1]:
        buf[bidx, pos] = val
    else:
        keep = (pos >= 0) & (pos < buf.shape[1])
        buf[bidx[keep], pos[keep]] = val[keep]
    return buf


def _seq(tp) -> bool:
    """Whether the layer's K/V cache is this rank's block of positions (or
    ring slots) over ``model`` (``tp.kv == "seq"``)."""
    return tp is not None and tp.kv == "seq"


def _block(tp, n: int) -> int:
    """The first global position (or slot) of this rank's block of a
    cache split on dim 1 into blocks of ``n``; 0 when not split."""
    return tp.index * n if _seq(tp) else 0


def _whole(tp, n: int) -> int:
    """The length of dim 1 of a cache of which this rank holds ``n``:
    ``n`` over every rank's block when it is split, else ``n``."""
    return n * tp.n if _seq(tp) else n


def _read_cols(span: int, lo: int, n: int, total: int) -> int:
    """How many of this rank's ``n`` columns from global column ``lo`` a
    pass at ``span`` reads: those below ``min(span, total)``, and at
    least one (a column off every row's view is masked, and adds 0)."""
    return min(max(min(span, total) - lo, 1), n)


def _kv_for_flash(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, tp):
    """The K/V heads that K6 reads for this rank's query heads: all of
    ``k``/``v`` when they are split with the query heads (or nothing is
    split), else, on a sequence-split cache whose ``k``/``v`` hold every
    KV head, those its query heads read (:func:`_kv_index`)."""
    if not _seq(tp):
        return k, v
    hq = q.shape[2]
    sel = torch.tensor(_kv_index(cfg, tp.index * hq, hq), device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def _serve_out(params: dict, out: torch.Tensor, tp) -> torch.Tensor:
    """``out`` [B, T, Hq, D] times this rank's rows of ``wo``; with ``tp``
    the partial sums summed over the ``model`` ranks."""
    out = _out_proj(params, out)
    return out if tp is None else tp.g(out)


def _decode_attend(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, mask: torch.Tensor,
                   out_dtype: torch.dtype, tp=None) -> torch.Tensor:
    """``q`` [B, T, Hq, D] over the cache columns ``k``/``v`` [B, L, Hkv,
    D] that ``mask`` [B, T, L] lets each row see -> [B, T, Hq, D].

    Trap T6: ``q`` is scaled in its own dtype before the product, the
    logits are float32 (products of the operands accumulated in float32),
    and the probabilities are normalised, ``p / l``, in the cache's dtype
    before the P V product — all as in the JAX decode.

    With ``tp`` the columns are this rank's block of a cache split on its
    positions over ``model`` (sequence-parallel decode), and ``q`` this
    rank's query heads: every rank's are gathered, since each attends over
    its own block for all of them, and this rank's heads of the output
    are returned.  To keep T6's rounding point there is no rescale of
    partial outputs: the row max is reduced over the ranks (``MAX``), then
    the row sum of ``exp(logit - max)``, then each rank normalises and
    rounds its ``p`` and the partial ``P V`` sums are reduced.  The
    function is the one-rank function; only the order of the two sums
    differs."""
    if tp is not None:
        q = tp.gather(q, 2)
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    qf = q.reshape(B, T, Hkv, Hq // Hkv, D) * torch.tensor(
        1.0 / math.sqrt(D), dtype=q.dtype)
    logits = torch.einsum("bthgd,bshd->bthgs", qf.float(), k.float())
    if cfg.attn_softcap > 0:
        logits = softcap(logits, cfg.attn_softcap)
    logits = logits.masked_fill(~mask[:, :, None, None, :], NEG_INF)
    top = logits.amax(-1, keepdim=True)
    if tp is not None:
        top = tp.reduce(top, dist.ReduceOp.MAX)
    p = torch.exp(logits - top)
    total = p.sum(-1, keepdim=True)
    if tp is not None:
        total = tp.reduce(total)
    p = (p / total).to(v.dtype).float()
    out = torch.einsum("bthgs,bshd->bthgd", p, v.float()).reshape(
        B, T, Hq, D)
    if tp is not None:
        out = tp.reduce(out).chunk(tp.n, dim=2)[tp.index]
    return out.to(out_dtype)


def _global_attend(cfg: ModelConfig, q: torch.Tensor, cache: KVCache,
                   cache_len: torch.Tensor, positions: torch.Tensor,
                   span: int, out_dtype: torch.dtype, tp=None
                   ) -> torch.Tensor:
    """Decode over the first ``min(span, L)`` cache columns: a row sees
    the columns below its sequence's length and at or before its own
    position.  On a sequence-split cache (``tp``) this rank reads its
    block's share of them, and the softmax crosses the ranks."""
    T = q.shape[1]
    n = cache.k.shape[1]
    lo = _block(tp, n)
    L = _read_cols(span, lo, n, _whole(tp, n))
    cols = lo + torch.arange(L, device=q.device)[None, None, :]
    mask = (cols < (cache_len + T)[:, None, None]) \
        & (cols <= positions[..., None])                        # causal
    return _decode_attend(cfg, q, cache.k[:, :L], cache.v[:, :L], mask,
                          out_dtype, tp if _seq(tp) else None)


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
        if tp is not None and "wq" in tp.local:
            return _attention_local(params, cfg, x, positions, window,
                                    causal, use_rope, tp, x_kv), None
        q, k, v = _project_qkv(params, cfg, x, positions, x_kv, use_rope)
        out = _flash(cfg, q, k, v, window=window,
                     causal=causal and x_kv is None)
        return _out_proj(params, out), None
    if fill_cache is not None and cache is not None:
        raise ValueError("attention: pass fill_cache (prefill) or cache "
                         "(decode), not both")
    q, k, v = _project_qkv(params, cfg, x, positions)
    old = cache if fill_cache is None else fill_cache
    lo = _block(tp, old.k.shape[1])
    new = KVCache(_write(old.k, positions, k, span, inplace, lo),
                  _write(old.v, positions, v, span, inplace, lo))
    if fill_cache is not None:
        out = _flash(cfg, q, *_kv_for_flash(cfg, q, k, v, tp), window=0)
    else:
        out = _global_attend(cfg, q, new, cache_len, positions, span,
                             x.dtype, tp)
    return _serve_out(params, out, tp), new


def _local_ring_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                       positions: torch.Tensor, cache: LocalKVCache,
                       span: int, inplace: bool, tp=None
                       ) -> Tuple[torch.Tensor, LocalKVCache]:
    """A decode pass of local attention over the ring: position ``p``'s
    K/V overwrite slot ``p % W``, then each row attends over the slots
    that hold a position inside its window.

    JAX reads all ``W`` slots.  Before the ring wraps (``span <= W``) slot
    ``s`` holds position ``s`` or nothing, so no row can see a slot at or
    past ``span``: only the first ``min(span, W)`` are read, as the global
    path reads only ``span`` columns.  A ring sliced to its first ``L``
    slots is the same ring while every position written is below ``L``,
    since then ``p % L == p % W``.

    With ``tp`` (:attr:`ServeAxis.kv`) the ring is this rank's KV heads
    (``pos`` whole), or this rank's block of slots (``pos`` too) of every
    KV head: then it writes the slots of its block and attends over them,
    the softmax crossing the ranks (:func:`_decode_attend`)."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    n = cache.k.shape[1]
    W, lo = _whole(tp, n), _block(tp, n)
    slot = positions % W          # in [0, W), so JAX's mode="drop" drops
    cache = LocalKVCache(                                        # nothing
        _write(cache.k, slot, k, W, inplace, lo),
        _write(cache.v, slot, v, W, inplace, lo),
        _write(cache.pos, slot, positions, W, inplace, lo))
    L = _read_cols(span, lo, n, W)
    cpos = cache.pos[:, None, :L]                             # [B, 1, L]
    rows = positions[..., None]                               # [B, T, 1]
    mask = (cpos >= 0) & (cpos <= rows) & (cpos > rows - cfg.local_window)
    out = _decode_attend(cfg, q, cache.k[:, :L], cache.v[:, :L], mask,
                         x.dtype, tp if _seq(tp) else None)
    return _serve_out(params, out, tp), cache


def _prefill_local_ring(params: dict, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor, cache: LocalKVCache,
                        inplace: bool, tp=None
                        ) -> Tuple[torch.Tensor, LocalKVCache]:
    """Prefill a local layer: K6 over the prompt with the window and the
    softcap (the Pallas dispatch the JAX module describes; JAX computes it
    with ``_xla_flash``), and only the last ``W`` positions' K/V kept in
    the ring (earlier ones are out of every later token's window).

    A prefill's positions are ``0 .. T-1``.  JAX sends those before
    ``T - W`` to slot ``W`` with ``mode="drop"``; here only the last
    ``min(T, W)`` tokens are written, each to its own slot.  On a ring
    split on its slots (``tp``) this rank writes those of its block."""
    T = positions.shape[1]
    q, k, v = _project_qkv(params, cfg, x, positions)
    n = cache.k.shape[1]
    W, lo = _whole(tp, n), _block(tp, n)
    last = slice(T - min(T, W), T)
    slot = positions[:, last] % W
    cache = LocalKVCache(
        _write(cache.k, slot, k[:, last], W, inplace, lo),
        _write(cache.v, slot, v[:, last], W, inplace, lo),
        _write(cache.pos, slot, positions[:, last], W, inplace, lo))
    out = _flash(cfg, q, *_kv_for_flash(cfg, q, k, v, tp),
                 window=cfg.local_window)
    return _serve_out(params, out, tp), cache
