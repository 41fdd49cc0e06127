"""The serving engines (port of ``repro.serve.engine``).

**MVServeEngine** serves a model.  Every decode step advances each
sequence's *cache descriptor* (its visible length), a versioned object of
the MVGC store written once per step and timestamped by the decode clock
(``vstore.write_step``); snapshot readers pin a timestamp
(``begin_snapshot``) and read a consistent cross-sequence snapshot of those
lengths (``snapshot_lengths``, the paper's ``search(t)``) while decode keeps
writing, and obsolete descriptor versions are reclaimed by the configured
policy.  The model's cache is updated in place by ``prefill_step`` and
``decode_one`` (the engine owns it; a ServeState handed to them is consumed),
and never by the readers: ``snapshot_score`` scores in a copy.  A recurrent
layer's state (RG-LRU, mLSTM, sLSTM) is replaced by each pass, never
written in place.

**PagedKVEngine** is the paged-KV serving loop with synchronous pressure
reclamation.  ``step`` appends one token per masked sequence.  A failed
append (page pool, table pool or descriptor slab exhausted) is a **pressure
event**: the engine reclaims synchronously — hot-sequence-first descriptor
compaction, then the reachability sweep that recycles pages — and retries
the failed lanes, up to ``max_reclaim_rounds`` times before giving up.  A
post-step watermark crossing triggers the same pass without a failure.
Counters live in one :class:`repro_torch.core.telemetry.ReclaimStats`.
``checkpoint()`` saves the whole engine (the ``PagedKV`` tensors and the
host-side GC state) through :class:`repro_torch.ckpt.manager.CheckpointManager`
and sets ``ckpt_max`` (the highest durably checkpointed timestamp, ``-1`` =
none), which arms the sole-survivor eviction in the reclaim pass;
``restore()`` is its inverse.  The checkpoint format is the JAX engine's.

The engines run on ``device`` (``cuda`` unless the caller passes another);
inputs may be tensors on any device or array-likes and are moved there.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._tensor import I32, DeviceLike, i32, resolve_device
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.mvgc import vstore
from repro_torch.core.mvgc.pool import EMPTY
from repro_torch.core.telemetry import GCConfig, ReclaimStats
from repro_torch.models import transformer as tf
from repro_torch.models.attention import KVCache, LocalKVCache
from repro_torch.mvkv import paged
from repro_torch.serve.forking import ForkDAG


class ServeState(NamedTuple):
    params: Any
    cache: Any                     # per layer: a KV cache, ring or state
    cache_len: torch.Tensor        # i32[B]
    mv: vstore.MVState             # versioned cache descriptors
    last_tokens: torch.Tensor      # i32[B, 1]
    longest: int                   # cache_len.max(), kept on the host


def make_serve_state(cfg: ModelConfig, run: RunConfig, params, batch: int,
                     max_len: int, dtype: torch.dtype = torch.bfloat16,
                     device: DeviceLike = None) -> ServeState:
    dev = resolve_device(device)
    gc = run.gc
    mv = vstore.make_state(
        num_slots=batch, versions_per_slot=gc.versions_per_slot,
        num_reader_lanes=gc.reader_lanes,
        ring_capacity=gc.ring_capacity or max(16, batch * 2), device=dev)
    return ServeState(
        params=params,
        cache=tf.init_cache(cfg, batch, max_len, dtype, dev),
        cache_len=torch.zeros((batch,), dtype=I32, device=dev),
        mv=mv,
        last_tokens=torch.zeros((batch, 1), dtype=I32, device=dev),
        longest=0)


def _greedy(logits: torch.Tensor, tp=None) -> torch.Tensor:
    """Trap T4: ``torch.argmax`` takes the first index on ties, as
    ``jnp.argmax`` does; tokens stay int32.

    With ``tp`` (a placement's ``vocab`` axis) ``logits`` are this rank's
    block of ``V / n`` vocabulary columns, and no rank builds the whole
    row: each takes its block's largest value and its first index there,
    offset by the block's first row; over the ranks the largest value
    wins (a ``MAX``), then among the ranks that hold it the smallest
    global index (a ``MIN``), which is ``torch.argmax``'s first index of
    the whole row, bit for bit (float32 and bf16 values compare exactly
    as float32)."""
    last = logits[:, -1]
    idx = last.argmax(dim=-1)
    if tp is None:
        return idx.to(I32)[:, None]
    V = last.shape[-1]
    best = last.gather(-1, idx[:, None])[:, 0].float()
    top = tp.reduce(best, dist.ReduceOp.MAX)
    glob = idx + tp.index * V
    pick = tp.reduce(torch.where(best == top, glob,
                                 torch.full_like(glob, tp.n * V)),
                     dist.ReduceOp.MIN)
    return pick.to(I32)[:, None]


def prefill_step(state: ServeState, cfg: ModelConfig, run: RunConfig,
                 tokens: torch.Tensor,
                 frontend_embeds: Optional[torch.Tensor] = None,
                 placement=None) -> ServeState:
    """Prefill through K6 into the state's cache (in place), then write one
    descriptor version per sequence.  ``frontend_embeds`` are a VLM's patch
    embeddings (a prefix: the lengths are ``T + Nf``) or an
    encoder-decoder's frames, as in :func:`repro_torch.models.transformer.
    prefill`.

    ``placement`` (a :class:`repro_torch.dist.sharding.ServePlacement`)
    says that ``state`` is this rank's placed state (see
    :func:`decode_one`); every rank passes the whole batch's ``tokens``
    and ``frontend_embeds`` and prefills its rows on its shards over
    ``model``."""
    pl = placement
    rows = pl.rows if pl is not None else (lambda x: x)
    logits, cache, lens = tf.prefill(state.params, cfg, rows(tokens),
                                     state.cache,
                                     frontend_embeds=rows(frontend_embeds),
                                     inplace=True, placement=pl)
    B = tokens.shape[0]
    whole = pl.whole(lens) if pl is not None else lens
    ids = torch.arange(B, dtype=I32, device=lens.device)
    mv, _, _ = vstore.write_step(
        state.mv, ids, whole, torch.ones((B,), dtype=torch.bool,
                                         device=lens.device),
        policy=run.gc.policy)
    return ServeState(state.params, cache, lens, mv,
                      _greedy(logits, pl.vocab if pl is not None else None),
                      tokens.shape[1] + tf.prefix_len(cfg, frontend_embeds))


def reclaim_pass(mv: vstore.MVState, ids: torch.Tensor, new_len: torch.Tensor,
                 ovf: torch.Tensor, deficit: torch.Tensor, policy: str,
                 retry: bool
                 ) -> Tuple[vstore.MVState, torch.Tensor, torch.Tensor]:
    """The gate's pressure branch: reclaim synchronously, hot slots first,
    then, when ``retry`` (a lane's append overflowed its slab), write the
    overflowed lanes again now that the reclaim made room.  Returns
    (mv', lanes still overflowed, versions freed)."""
    B = new_len.shape[0]
    mv, _, n_freed = vstore.reclaim_on_pressure(
        mv, vstore.hot_slots(mv, min(8, B)), deficit, policy=policy)
    ovf_left = ovf
    if retry:
        mv, _, ovf_left = vstore.write_step(mv, ids, new_len, ovf,
                                            policy=policy)
    return mv, ovf_left, n_freed


def cadence_pass(mv: vstore.MVState, policy: str
                 ) -> Tuple[vstore.MVState, torch.Tensor]:
    """The gate's other branch: the policy's cadence pass.  Returns (mv',
    versions freed)."""
    mv, freed_g = vstore.gc_step(mv, policy=policy)
    return mv, (freed_g != EMPTY).sum(dtype=I32)


def decode_one(state: ServeState, cfg: ModelConfig, run: RunConfig,
               enc_out: Optional[torch.Tensor] = None, placement=None
               ) -> Tuple[ServeState, torch.Tensor, torch.Tensor,
                          Dict[str, torch.Tensor]]:
    """One greedy decode step for the whole batch, appending to the cache in
    place (an encoder-decoder's cross-attention over ``enc_out``).  Returns
    (state', new_tokens[B, 1], freed_descriptor_payloads, stats).

    After the descriptor write the capacity gate decides: under pressure (a
    watermark crossed, or a lane's append overflowed its slab) the step
    runs :func:`reclaim_pass` (with the retry of the overflowed lanes);
    otherwise :func:`cadence_pass`.  Trap T5: JAX takes both decisions
    with ``lax.cond`` on the device; here they are read back in one host
    sync (trap "host reads under FakeTensorMode": a dry run's op counter
    explores both answers).  The pass is sized from ``state.longest``,
    with no sync.  ``stats`` are int32 scalars, equal to the JAX
    engine's.

    ``placement`` (a :class:`repro_torch.dist.sharding.ServePlacement`)
    says that ``state`` is this rank's placed state: the parameters and
    cache its shards, ``cache_len``, ``last_tokens`` and ``enc_out`` its
    rows, and the MV store whole.  The model runs on the rank's rows and
    on its shards over ``model`` (``ServePlacement``), its greedy pick
    over the vocabulary's blocks (:func:`_greedy`); the
    store runs on every rank over the whole batch's lengths, gathered over
    the batch axes, so every rank takes the same branch, and the step
    returns on every rank the whole batch's tokens, the stats and the
    ``MVState`` that the one-rank step returns.  Deviation from JAX's
    cell (``mv_shardings``: slots split with the batch): the ring and the
    board take the retirements of every row, and splitting the slots
    would gather those at every write."""
    pl = placement
    policy = run.gc.policy
    logits, cache = tf.decode_step(state.params, cfg, state.last_tokens,
                                   state.cache, state.cache_len,
                                   enc_out=pl.rows(enc_out) if pl is not None
                                   else enc_out, inplace=True,
                                   span=state.longest + 1, placement=pl)
    new_len = state.cache_len + 1
    lens = pl.whole(new_len) if pl is not None else new_len
    B = lens.shape[0]
    ids = torch.arange(B, dtype=I32, device=lens.device)
    ones = torch.ones((B,), dtype=torch.bool, device=lens.device)
    mv, freed_w, ovf = vstore.write_step(state.mv, ids, lens, ones,
                                         policy=policy)
    gate = vstore.capacity_gate(mv)
    trigger, any_ovf = torch.stack(
        [gate.under_pressure.reshape(()), ovf.any()]).tolist()
    if trigger or any_ovf:
        mv, ovf_left, n_freed = reclaim_pass(mv, ids, lens, ovf,
                                             gate.deficit, policy, any_ovf)
        reclaimed = 1
    else:
        mv, n_freed = cadence_pass(mv, policy)
        ovf_left, reclaimed = ovf, 0
    stats = {
        "overflow_lanes": ovf.sum(dtype=I32),
        "retry_failed": ovf_left.sum(dtype=I32),
        "reclaims_triggered": i32(reclaimed, lens.device),
        "versions_reclaimed": n_freed.to(I32),
        "deficit": gate.deficit,
        "live_versions": vstore.live_versions(mv),
        "overflow_count": mv.overflow_count,
        "dropped_retires": mv.dropped_retires,
    }
    nxt = _greedy(logits, pl.vocab if pl is not None else None)
    return (ServeState(state.params, cache, new_len, mv, nxt,
                       state.longest + 1),
            pl.whole(nxt) if pl is not None else nxt, freed_w.reshape(-1),
            stats)


# ---------------------------------------------------------------------------
# snapshot (rtx) interface
# ---------------------------------------------------------------------------
def begin_snapshot(state: ServeState, lane: int
                   ) -> Tuple[ServeState, torch.Tensor]:
    dev = state.cache_len.device
    mv, ts = vstore.begin_snapshot(
        state.mv, torch.tensor([lane], dtype=I32, device=dev),
        torch.tensor([True], device=dev))
    return state._replace(mv=mv), ts[0]


def end_snapshot(state: ServeState, lane: int) -> ServeState:
    dev = state.cache_len.device
    mv = vstore.end_snapshot(state.mv,
                             torch.tensor([lane], dtype=I32, device=dev),
                             torch.tensor([True], device=dev))
    return state._replace(mv=mv)


def snapshot_lengths(state: ServeState, t,
                     seq_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Consistent cross-sequence snapshot: each sequence's visible length
    as of pinned time ``t`` (every sequence when ``seq_ids`` is None), 0
    for a sequence with no version at ``t``, in one launch of the
    version-search kernel (K3's ``value_at``).  JAX's ``snapshot_lengths``
    returns ``(lens, found)`` with EMPTY lengths where not found; every
    caller masks them to 0, which this does in the kernel."""
    return vstore.snapshot_value(state.mv, seq_ids, t)


def _score_prefix(c, span: int):
    """The part of one layer's cache that a pass at ``span`` reads: the
    first ``span`` columns of a global cache; of a local ring, its first
    ``min(span, W)`` slots (``LocalKVCache`` k, v and pos), which are the
    same ring for such a pass (see ``attention._local_ring_decode``); a
    recurrent state whole (the pass returns a new state and leaves it as
    it is)."""
    if isinstance(c, LocalKVCache):
        return LocalKVCache(c.k[:, :span], c.v[:, :span], c.pos[:, :span])
    if isinstance(c, KVCache):
        return KVCache(c.k[:, :span], c.v[:, :span])
    return c


def snapshot_score(state: ServeState, cfg: ModelConfig, tokens: torch.Tensor,
                   t) -> torch.Tensor:
    """Score candidate tokens [B, 1] against the snapshot at ``t``: the
    attention masks use the snapshot lengths, so the result is atomic with
    respect to ongoing decodes.

    Trap T1: the scored tokens' K/V land at position ``lens[b]`` (in a
    local ring, at its slot), which decode may already have filled; JAX
    writes them into a copy of the cache and throws it away.  So does this
    (``inplace=False``), copying only what a pass at these lengths reads
    (:func:`_score_prefix`): ``state`` is left bit-identical.  One host
    sync reads ``span`` (a reader pinned before a new prefill may see more
    than ``state.longest``).

    Trap C10 (a JAX fault, reproduced): a local ring keeps only the last
    ``W`` positions, and decode overwrites a slot whether or not a pinned
    reader's window still covers it, so once the ring wraps a pinned
    snapshot's score changes, in both packages alike.

    Trap C12 (a JAX fault, reproduced): only the lengths are versioned.  A
    recurrent layer's state is its state now, so a reader pinned at ``t``
    scores against the newest state, not the state at ``t``, and its score
    changes with every decode step, in both packages alike.

    Trap C13 (a JAX fault, reproduced): no ``enc_out`` is passed, so an
    encoder-decoder's cross-attention falls back to the scored tokens
    themselves, not the encoder's output, as in JAX."""
    lens = snapshot_lengths(state, t)
    span = int(lens.max()) + tokens.shape[1]
    prefix = [_score_prefix(c, span) for c in state.cache]
    logits, _ = tf.decode_step(state.params, cfg, tokens, prefix, lens,
                               inplace=False, span=span)
    return logits


class MVServeEngine:
    """Prefill, decode and GC with the MVGC policy, snapshot readers, and
    the space report the benchmarks track."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, params, batch: int,
                 max_len: int, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        self.cfg, self.run = cfg, run
        self.device = resolve_device(device)
        self.state = make_serve_state(cfg, run, params, batch, max_len,
                                      dtype, self.device)
        self.last_stats: Dict[str, int] = {}

    def prefill(self, tokens) -> None:
        tokens = torch.as_tensor(tokens, device=self.device).to(I32)
        self.state = prefill_step(self.state, self.cfg, self.run, tokens)

    def step(self) -> torch.Tensor:
        self.state, toks, _, stats = decode_one(self.state, self.cfg,
                                                self.run)
        values = torch.stack([v.reshape(()) for v in stats.values()]).tolist()
        self.last_stats = dict(zip(stats, values))
        return toks

    def pin(self, lane: int) -> int:
        self.state, ts = begin_snapshot(self.state, lane)
        return int(ts)

    def unpin(self, lane: int) -> None:
        self.state = end_snapshot(self.state, lane)

    def lengths_at(self, t: int) -> torch.Tensor:
        return snapshot_lengths(self.state, t)

    def score(self, tokens, t: int) -> torch.Tensor:
        """:func:`snapshot_score` of ``tokens`` [B, 1] at pinned time
        ``t``; the engine's state is not changed."""
        tokens = torch.as_tensor(tokens, device=self.device).to(I32)
        return snapshot_score(self.state, self.cfg, tokens, t)

    def space(self) -> Dict[str, int]:
        return vstore.space_report(self.state.mv)


class PagedKVEngine:
    """Paged-KV serving with the ``freed_pages()`` recycling contract (see
    the module docstring)."""

    def __init__(self, num_seqs: int, num_pages: int, page_size: int,
                 max_pages_per_seq: int, kv_heads: int, head_dim: int, *,
                 gc: Optional[GCConfig] = None, eager_fork: bool = False,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.gc = gc if gc is not None else GCConfig()
        self.gc_policy = self.gc.policy
        self.max_reclaim_rounds = self.gc.max_reclaim_rounds
        self.eager_fork = eager_fork
        self.st = paged.make_paged_kv(
            num_seqs, num_pages, page_size, max_pages_per_seq, kv_heads,
            head_dim, gc=self.gc, dtype=dtype, device=self.device)
        self._freed_pages: List[int] = []
        self.stats = ReclaimStats(unit="pages")
        self.dag = ForkDAG()
        #: highest durably checkpointed timestamp; -1 = no checkpoint.
        self.ckpt_max: int = -1

    # counter names of the BENCH_serve rows
    @property
    def pressure_events(self) -> int:
        return self.stats.pressure_events

    @property
    def reclaims_triggered(self) -> int:
        return self.stats.reclaims_triggered

    @property
    def pages_reclaimed(self) -> int:
        return self.stats.reclaimed

    @property
    def give_ups(self) -> int:
        return self.stats.give_ups

    @property
    def peak_pages(self) -> int:
        return self.stats.peak_live

    @property
    def peak_pages_post_reclaim(self) -> int:
        return self.stats.peak_live_post_reclaim

    @property
    def forks(self) -> int:
        return self.dag.forks

    @property
    def joins(self) -> int:
        return self.dag.joins

    @property
    def releases(self) -> int:
        return self.dag.releases

    # -- helpers ---------------------------------------------------------
    def _ids(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(I32)

    def _mask(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(torch.bool)

    def _free_host(self) -> np.ndarray:
        return self.st.free.cpu().numpy()

    def _note_freed(self, free_before: np.ndarray) -> None:
        newly = np.flatnonzero(self._free_host() & ~free_before)
        self._freed_pages.extend(int(p) for p in newly)

    def _note_peak(self) -> None:
        self.stats.note_live(int(paged.live_pages(self.st)))

    def _under_pressure(self) -> bool:
        return bool(paged.page_pressure(self.st,
                                        self.gc.page_watermark).under_pressure)

    def _reclaim_once(self, extra_deficit: int = 0) -> None:
        gate = paged.page_pressure(self.st, self.gc.page_watermark)
        deficit = max(int(gate.deficit), extra_deficit, 1)
        self.st, pages = paged.reclaim_on_pressure(
            self.st, paged.hot_sequences(self.st, self.gc.hot_k), deficit,
            gc_policy=self.gc_policy)
        freed = int(pages)
        # sole-survivor eviction: idle sequences whose only version is
        # durably checkpointed hold pages no policy can touch
        if self.ckpt_max >= 0 and self._under_pressure():
            self.st, ck_pages, n_ev = paged.evict_checkpointed(
                self.st, self.ckpt_max)
            self.stats.note_ckpt_eviction(int(n_ev), int(ck_pages))
            freed += int(ck_pages)
        self.stats.note_reclaim(freed, int(paged.live_pages(self.st)))

    def _retry(self, op, mask: torch.Tensor, note_peak: bool) -> torch.Tensor:
        """Run ``op(mask)``; on failed lanes reclaim and retry them."""
        self.st, failed = op(mask)
        if note_peak:
            self._note_peak()
        rounds = 0
        while bool(failed.any()) and rounds < self.max_reclaim_rounds:
            self.stats.note_event()
            self._reclaim_once(extra_deficit=int(failed.sum()))
            self.st, failed = op(failed)
            if note_peak:
                self._note_peak()
            rounds += 1
        return failed

    # -- serving ops -----------------------------------------------------
    def step(self, seq_ids, k_new, v_new, mask) -> torch.Tensor:
        """Append one token per masked sequence; reclaim-and-retry on
        pressure.  Returns failed[B] (True = gave up after reclaims)."""
        ids = self._ids(seq_ids)
        k = torch.as_tensor(k_new, device=self.device)
        v = torch.as_tensor(v_new, device=self.device)
        free_before = self._free_host()
        failed = self._retry(
            lambda m: paged.append_tokens(self.st, ids, k, v, m,
                                          gc_policy=self.gc_policy),
            self._mask(mask), note_peak=True)
        # watermark rule: a crossing is itself a trigger event
        if self._under_pressure():
            self.stats.note_event()
            self._reclaim_once()
        self.stats.give_ups += int(failed.sum())
        self._note_freed(free_before)
        return failed

    def _fork_retry(self, src, dst, mask) -> torch.Tensor:
        src, dst = self._ids(src), self._ids(dst)
        free_before = self._free_host()
        failed = self._retry(
            lambda m: paged.fork_sequence(self.st, src, dst, m,
                                          gc_policy=self.gc_policy,
                                          copy_pages=self.eager_fork),
            self._mask(mask), note_peak=True)
        self.stats.give_ups += int(failed.sum())
        self._note_freed(free_before)
        return failed

    def _current_lengths(self, seq_ids: torch.Tensor) -> np.ndarray:
        tbl, has = vstore.current_read(self.st.mv, seq_ids)
        lens = self.st.lengths[tbl.clamp(min=0).long()]
        return torch.where(has, lens, 0).cpu().numpy()

    def fork(self, src_ids, dst_ids, mask) -> torch.Tensor:
        """COW fork of ``src`` into ``dst`` (eager copy with
        ``eager_fork``); the child enters the lineage DAG.  Returns
        failed[B]."""
        failed = self._fork_retry(src_ids, dst_ids, mask)
        ok = self._mask(mask).cpu().numpy() & ~failed.cpu().numpy()
        if ok.any():
            ts = int(self.st.mv.now)
            dst = self._ids(dst_ids)
            lens = self._current_lengths(dst)
            src_np, dst_np = self._ids(src_ids).cpu().numpy(), dst.cpu().numpy()
            for i in np.flatnonzero(ok):
                self.dag.fork(int(src_np[i]), int(dst_np[i]), ts,
                              int(lens[i]))
        return failed

    def join(self, src_ids, dst_ids, mask) -> torch.Tensor:
        """Join child ``src`` back into ``dst`` (a fork write onto the
        target) and release the child slot.  Returns failed[B]."""
        failed = self._fork_retry(src_ids, dst_ids, mask)
        done = self._mask(mask).cpu().numpy() & ~failed.cpu().numpy()
        if done.any():
            self.reset(src_ids, done)
            src_np = self._ids(src_ids).cpu().numpy()
            dst_np = self._ids(dst_ids).cpu().numpy()
            for i in np.flatnonzero(done):
                self.dag.join(int(src_np[i]), int(dst_np[i]))
        return failed

    def release(self, seq_ids, mask) -> torch.Tensor:
        """Release a branch: recycle the slot and drop it from the DAG.
        Returns failed[B]."""
        failed = self.reset(seq_ids, mask)
        done = self._mask(mask).cpu().numpy() & ~failed.cpu().numpy()
        ids_np = self._ids(seq_ids).cpu().numpy()
        for i in np.flatnonzero(done):
            self.dag.release(int(ids_np[i]))
        return failed

    def reset(self, seq_ids, mask) -> torch.Tensor:
        """Recycle finished sequences' slots (empty table version), with
        the same reclaim-and-retry discipline as :meth:`step`."""
        ids = self._ids(seq_ids)
        free_before = self._free_host()
        failed = self._retry(
            lambda m: paged.reset_sequence(self.st, ids, m,
                                           gc_policy=self.gc_policy),
            self._mask(mask), note_peak=False)
        self.stats.give_ups += int(failed.sum())
        self._note_freed(free_before)
        return failed

    def reclaim(self, deficit: Optional[int] = None) -> int:
        """Explicit GC pass, counted as one pressure event.  Returns pages
        freed."""
        free_before = self._free_host()
        before = int(paged.live_pages(self.st))
        self.stats.note_event()
        self._reclaim_once(extra_deficit=0 if deficit is None
                           else int(deficit))
        self._note_freed(free_before)
        return before - int(paged.live_pages(self.st))

    def freed_pages(self) -> List[int]:
        """Drain the handles of pages recycled since the last call."""
        out, self._freed_pages = self._freed_pages, []
        return out

    # -- durability ------------------------------------------------------
    @staticmethod
    def _manager(directory) -> CheckpointManager:
        return (directory if isinstance(directory, CheckpointManager)
                else CheckpointManager(os.fspath(directory)))

    def checkpoint(self, directory: Union[str, os.PathLike,
                                          CheckpointManager],
                   step: Optional[int] = None) -> int:
        """Durably checkpoint the whole engine: the ``PagedKV`` tensors
        (pages, free bitmap, page tables, the full ``MVState`` with retire
        ring and announce board) plus the host-side GC state (stats, fork
        DAG, pending freed-page handles).  Returns the manifest step
        (default: the store clock).  Success arms the sole-survivor rule:
        ``ckpt_max`` advances to the store clock."""
        mgr = self._manager(directory)
        ts = int(self.st.mv.now)
        step = ts if step is None else int(step)
        extra = {
            "stats": dataclasses.asdict(self.stats),
            "dag": self.dag.as_dict(),
            "freed_pages_pending": [int(p) for p in self._freed_pages],
            "ckpt_max": ts,
        }
        mgr.save(step, self.st, extra=extra)
        self.ckpt_max = ts
        return step

    def restore(self, directory: Union[str, os.PathLike, CheckpointManager],
                step: Optional[int] = None) -> int:
        """Inverse of :meth:`checkpoint` (``step=None``: the latest): every
        tensor onto the engine's device, and the stats, DAG, pending frees
        and ``ckpt_max`` from the manifest, so reclamation resumes where
        the saved engine left off.  Returns the step restored."""
        mgr = self._manager(directory)
        if step is None:
            step = mgr.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint manifest under {mgr.dir!r}")
        self.st, extra = mgr.restore(int(step), like=self.st,
                                     device=self.device)
        self.stats = ReclaimStats(**extra.get("stats", {}))
        self.dag = ForkDAG.from_dict(extra.get("dag", {}))
        self._freed_pages = [int(p) for p in
                             extra.get("freed_pages_pending", [])]
        self.ckpt_max = int(extra.get("ckpt_max", -1))
        return int(step)

    # -- snapshot readers ------------------------------------------------
    def pin(self, lane: int) -> int:
        self.st, ts = paged.begin_snapshot(self.st, lane)
        return int(ts)

    def unpin(self, lane: int) -> None:
        self.st = paged.end_snapshot(self.st, lane)

    def view_at(self, t: int, seq_ids=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(page_table[B, MP], lengths[B]) of the snapshot at ``t``."""
        if seq_ids is None:
            seq_ids = torch.arange(self.st.mv.store.ts.shape[0], dtype=I32,
                                   device=self.device)
        return paged.snapshot_view(self.st, self._ids(seq_ids), int(t))

    def space(self) -> Dict[str, int]:
        rep = vstore.space_report(self.st.mv)
        rep["live_pages"] = int(paged.live_pages(self.st))
        rep["free_pages"] = int(self.st.free.sum())
        rep["peak_pages"] = self.peak_pages
        rep["peak_pages_post_reclaim"] = self.peak_pages_post_reclaim
        rep["pages_reclaimed"] = self.pages_reclaimed
        rep["pressure_events"] = self.pressure_events
        rep["reclaims_triggered"] = self.reclaims_triggered
        rep["give_ups"] = self.give_ups
        rep["forks"] = self.forks
        rep["joins"] = self.joins
        rep["releases"] = self.releases
        rep["ckpt_evictions"] = self.stats.ckpt_evictions
        rep["ckpt_pages_freed"] = self.stats.ckpt_freed
        return rep
