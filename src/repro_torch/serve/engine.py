"""The serving engines (port of ``repro.serve.engine``).

**MVServeEngine** serves a model.  Every decode step advances each
sequence's *cache descriptor* (its visible length), a versioned object of
the MVGC store written once per step and timestamped by the decode clock
(``vstore.write_step``); snapshot readers pin a timestamp
(``begin_snapshot``) and read a consistent cross-sequence snapshot of those
lengths (``snapshot_read``, the paper's ``search(t)``) while decode keeps
writing, and obsolete descriptor versions are reclaimed by the configured
policy.  The model's cache is updated in place by ``prefill_step`` and
``decode_one`` (the engine owns it; a ServeState handed to them is consumed),
and never by the readers: ``snapshot_score`` scores in a copy.

**PagedKVEngine** is the paged-KV serving loop with synchronous pressure
reclamation.  ``step`` appends one token per masked sequence.  A failed
append (page pool, table pool or descriptor slab exhausted) is a **pressure
event**: the engine reclaims synchronously — hot-sequence-first descriptor
compaction, then the reachability sweep that recycles pages — and retries
the failed lanes, up to ``max_reclaim_rounds`` times before giving up.  A
post-step watermark crossing triggers the same pass without a failure.
Counters live in one :class:`repro_torch.core.telemetry.ReclaimStats`.
Setting ``ckpt_max`` (the highest durably checkpointed timestamp, ``-1`` =
none) arms the sole-survivor eviction in the reclaim pass.  Taking and
restoring checkpoints is not part of this port yet.

The engines run on ``device`` (``cuda`` unless the caller passes another);
inputs may be tensors on any device or array-likes and are moved there.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._tensor import I32, DeviceLike, i32, resolve_device
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.mvgc import vstore
from repro_torch.core.mvgc.pool import EMPTY
from repro_torch.core.telemetry import GCConfig, ReclaimStats
from repro_torch.models import transformer as tf
from repro_torch.models.attention import KVCache
from repro_torch.mvkv import paged
from repro_torch.serve.forking import ForkDAG


class ServeState(NamedTuple):
    params: Any
    cache: Any                     # list of KVCache, one per layer
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


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """Trap T4: ``torch.argmax`` takes the first index on ties, as
    ``jnp.argmax`` does; tokens stay int32."""
    return logits[:, -1].argmax(dim=-1).to(I32)[:, None]


def prefill_step(state: ServeState, cfg: ModelConfig, run: RunConfig,
                 tokens: torch.Tensor) -> ServeState:
    """Prefill through K6 into the state's cache (in place), then write one
    descriptor version per sequence."""
    logits, cache, lens = tf.prefill(state.params, cfg, tokens, state.cache,
                                     inplace=True)
    B = tokens.shape[0]
    ids = torch.arange(B, dtype=I32, device=lens.device)
    mv, _, _ = vstore.write_step(
        state.mv, ids, lens, torch.ones((B,), dtype=torch.bool,
                                        device=lens.device),
        policy=run.gc.policy)
    return ServeState(state.params, cache, lens, mv, _greedy(logits),
                      tokens.shape[1])


def decode_one(state: ServeState, cfg: ModelConfig, run: RunConfig
               ) -> Tuple[ServeState, torch.Tensor, torch.Tensor,
                          Dict[str, torch.Tensor]]:
    """One greedy decode step for the whole batch, appending to the cache in
    place.  Returns (state', new_tokens[B, 1], freed_descriptor_payloads,
    stats).

    After the descriptor write the capacity gate decides: under pressure (a
    watermark crossed, or a lane's append overflowed its slab) the step
    reclaims synchronously and retries the overflowed lanes; otherwise the
    policy's cadence pass runs.  Trap T5: JAX takes both decisions with
    ``lax.cond`` on the device; here they are read back in one host sync.
    The pass is sized from ``state.longest``, with no sync.  ``stats`` are
    int32 scalars, equal to the JAX engine's."""
    policy = run.gc.policy
    logits, cache = tf.decode_step(state.params, cfg, state.last_tokens,
                                   state.cache, state.cache_len, inplace=True,
                                   span=state.longest + 1)
    new_len = state.cache_len + 1
    B = new_len.shape[0]
    ids = torch.arange(B, dtype=I32, device=new_len.device)
    ones = torch.ones((B,), dtype=torch.bool, device=new_len.device)
    mv, freed_w, ovf = vstore.write_step(state.mv, ids, new_len, ones,
                                         policy=policy)
    gate = vstore.capacity_gate(mv)
    trigger, any_ovf = torch.stack(
        [gate.under_pressure.reshape(()), ovf.any()]).tolist()
    if trigger or any_ovf:
        mv, _, n_freed = vstore.reclaim_on_pressure(
            mv, vstore.hot_slots(mv, min(8, B)), gate.deficit, policy=policy)
        reclaimed = 1
    else:
        mv, freed_g = vstore.gc_step(mv, policy=policy)
        n_freed = (freed_g != EMPTY).sum(dtype=I32)
        reclaimed = 0
    ovf_left = ovf
    if any_ovf:   # retry the overflowed lanes now that the reclaim made room
        mv, _, ovf_left = vstore.write_step(mv, ids, new_len, ovf,
                                            policy=policy)
    stats = {
        "overflow_lanes": ovf.sum(dtype=I32),
        "retry_failed": ovf_left.sum(dtype=I32),
        "reclaims_triggered": i32(reclaimed, new_len.device),
        "versions_reclaimed": n_freed.to(I32),
        "deficit": gate.deficit,
        "live_versions": vstore.live_versions(mv),
        "overflow_count": mv.overflow_count,
        "dropped_retires": mv.dropped_retires,
    }
    nxt = _greedy(logits)
    return (ServeState(state.params, cache, new_len, mv, nxt,
                       state.longest + 1), nxt, freed_w.reshape(-1), stats)


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
                     seq_ids: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Consistent cross-sequence snapshot: each sequence's visible length
    as of pinned time ``t``, through the version-search kernel (K3)."""
    if seq_ids is None:
        seq_ids = torch.arange(state.cache_len.shape[0], dtype=I32,
                               device=state.cache_len.device)
    return vstore.snapshot_read(state.mv, seq_ids, t)


def snapshot_score(state: ServeState, cfg: ModelConfig, tokens: torch.Tensor,
                   t) -> torch.Tensor:
    """Score candidate tokens [B, 1] against the snapshot at ``t``: the
    attention masks use the snapshot lengths, so the result is atomic with
    respect to ongoing decodes.

    Trap T1: the scored tokens' K/V land at position ``lens[b]``, which
    decode may already have filled; JAX writes them into a copy of the
    cache and throws it away.  So does this (``inplace=False``), copying
    only the first ``span`` columns, all that a pass at these lengths
    reads: ``state`` is left bit-identical.  One host sync reads ``span``
    (a reader pinned before a new prefill may see more than
    ``state.longest``)."""
    lens, found = snapshot_lengths(state, t)
    lens = torch.where(found, lens, 0)
    span = int(lens.max()) + tokens.shape[1]
    prefix = [KVCache(c.k[:, :span], c.v[:, :span]) for c in state.cache]
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
        lens, found = snapshot_lengths(self.state, t)
        return torch.where(found, lens, 0)

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
