"""Paged-KV serving loop with synchronous pressure reclamation (port of
``PagedKVEngine`` in ``repro.serve.engine``).

``step`` appends one token per masked sequence.  A failed append (page
pool, table pool or descriptor slab exhausted) is a **pressure event**: the
engine reclaims synchronously — hot-sequence-first descriptor compaction,
then the reachability sweep that recycles pages — and retries the failed
lanes, up to ``max_reclaim_rounds`` times before giving up.  A post-step
watermark crossing triggers the same pass without a failure.  Counters live
in one :class:`repro_torch.core.telemetry.ReclaimStats`.

Setting ``ckpt_max`` (the highest durably checkpointed timestamp, ``-1`` =
none) arms the sole-survivor eviction in the reclaim pass.  Taking and
restoring checkpoints is not part of this port yet.

The engine runs on ``device`` (``cuda`` unless the caller passes another);
inputs may be tensors on any device or array-likes and are moved there.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._tensor import I32, DeviceLike, resolve_device
from repro_torch.core.mvgc import vstore
from repro_torch.core.telemetry import GCConfig, ReclaimStats
from repro_torch.mvkv import paged
from repro_torch.serve.forking import ForkDAG


class PagedKVEngine:
    """Paged-KV serving with the ``freed_pages()`` recycling contract."""

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
