"""Sharded multi-host MVGC: partitioned version store and global-LWM
reclamation (port of ``repro.dist.mvgc``, DESIGN.md §13).

The deployable stack (``core.mvgc.vstore`` slabs governing the
``mvkv.paged`` page pool) scales out by partitioning state, not the
protocol: each host owns its own ``PagedKV`` (its version store, page pool
and announcement board), and the single-host ops run unchanged on each
shard.  Announcement lanes stay host-local: a reader pins on its own
host's board and nothing else moves.

What crosses hosts is one number, the **global low-water mark**.  Each GC
step gathers every host's oldest pin (:func:`lwm_contributions`; a pin-free
host contributes the ``TS_MAX`` identity), ages out hosts whose
announcement is staler than their budget (:func:`age_out_stale`: a stalled
host bounds reclamation for its budget, never blocks it), reduces with
``min`` (:func:`global_lwm`, optionally over the ring of
:mod:`repro_torch.dist.overlap`) and passes the result to every shard's GC
as ``extra_pins``, so no shard reclaims a version pinned by any live host.

**The host dim.**  The JAX engine stacks every leaf with a leading ``[H]``
dim and runs the ops under ``jax.vmap``.  The ops are independent per
host, so :class:`ShardedPagedKVEngine` holds one single-host ``PagedKV``
per host it owns, on ``device``, and runs each op host by host: every host
runs every op, as under ``vmap``, even with no lane masked on it.  It
stacks only where the JAX engine's result is stacked: the board of the
LWM refresh, :meth:`~ShardedPagedKVEngine.pressure` (a ``PressureSignal``
with ``[H]`` fields), the checkpoint files (JAX's ``[H, ...]`` layout,
leaf for leaf) and :meth:`~ShardedPagedKVEngine.stacked`.

**Ranks.**  The engine takes a mesh as JAX's does (a ``DeviceMesh`` from
:func:`repro_torch.launch.mesh.make_gc_mesh`, the default when the
process has a default group).  When the mesh's axis has ``n > 1``
positions, ``n`` divides ``hosts`` and this rank is on it, rank ``r`` of
the axis holds hosts ``[r H/n, (r+1) H/n)`` (``host_stacked_sharding``'s
placement), and the LWM crosses the ranks by ``ring_all_reduce(reduce=
"min")`` over the axis's group; otherwise the rank holds every host and no
ring runs, as JAX keeps the stack unsharded.  The API stays JAX's single
controller's: every rank calls every entry point in the same order with
the full ``[H, ...]`` arguments, and every entry point returns on every
rank what the one-device engine returns (``step``, ``reset``, ``fork``,
``reclaim``, ``pressure``, ``live_pages``, ``space``, ``view_at``,
``host_state``, ``stats``, ``lwm_advances``, the per-host peaks and
reclaims).  A host's reads run on the rank that holds it and cross to the
others (:meth:`~ShardedPagedKVEngine.host_apply`).  Every collective is
gloo's, through host memory (:mod:`repro_torch.dist.overlap`).

Accounting is one :class:`repro_torch.core.telemetry.ReclaimStats` (plus
``stale_lanes_aged`` and ``lwm_advances``), the counters of
``BENCH_dist.json``.  JAX's semantics are reproduced, quirks included: a
retry's deficit floor is the failed-lane count over all hosts, every host
reclaims in every pass, and the retry rounds are counted once per engine
round, not per host.  Host syncs: every LWM refresh reads the reduced
LWM and the aged-lane count (one sync), and every retry decision reads
the failed-lane count; over ranks every gather of per-host values is one
more (``overlap.wire.copies`` counts them).

Trap: **ranks must take the same branch.**  Each decision the JAX engine
takes from a value over all ``[H]`` hosts (the retry loop's failed count
and its deficit floor, the pressure gate, the live sum of the peak, the
pages a reclaim freed) is taken here from that value gathered over the
group, so every rank takes the same branch; a rank that branched alone
would leave its peers waiting at the next collective.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._tensor import I32, DeviceLike, drop_set, resolve_device
from repro_torch.ckpt.manager import (CheckpointManager, tree_flatten,
                                      tree_unflatten)
from repro_torch.core.mvgc.pool import EMPTY, TS_MAX
from repro_torch.core.telemetry import GCConfig, PressureSignal, ReclaimStats
from repro_torch.dist.overlap import (all_gather_cat, broadcast_tree,
                                      ring_all_reduce, wire)
from repro_torch.dist.straggler import StepWatchdog
from repro_torch.launch.mesh import make_gc_mesh
from repro_torch.mvkv import paged


def _tree_map(fn: Callable, *trees):
    """``fn`` over the corresponding tensor leaves of ``trees`` (which share
    one structure), rebuilt in the first tree's structure."""
    leaves = [fn(*xs) for xs in zip(*(tree_flatten(t) for t in trees))]
    return tree_unflatten(trees[0], leaves)


# ---------------------------------------------------------------------------
# host-stacked state
# ---------------------------------------------------------------------------
def stack_states(base, hosts: int):
    """Host-stack a single-host state tree: every tensor leaf gains a
    leading ``[H]`` dim (one identical copy per host)."""
    return _tree_map(lambda x: x[None].repeat((hosts,) + (1,) * x.dim()),
                     base)


def _contributions(slots: torch.Tensor) -> torch.Tensor:
    return torch.where(slots != EMPTY, slots, TS_MAX).min(dim=1).values \
        .to(I32)


def lwm_contributions(st: paged.PagedKV) -> torch.Tensor:
    """i32[H]: each host's LWM contribution from a host-stacked state: the
    oldest timestamp pinned on its announcement board, or the ``TS_MAX``
    sentinel when the board is pin-free (the identity of ``min``, so idle
    hosts drop out of the reduction)."""
    return _contributions(st.mv.board.slots)


def age_out_stale(contrib, ages_s, budget_s
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Straggler tolerance: replace stale hosts' contributions with the
    ``TS_MAX`` sentinel.  A host whose announcement age ``ages_s[H]``
    exceeds ``budget_s`` (a scalar or ``[H]``) is presumed stalled, and its
    pins stop holding back the global LWM.  Returns ``(aged[H], n_aged)``,
    ``n_aged`` counting the stale hosts that held a pin; both on
    ``contrib``'s device."""
    contrib = torch.as_tensor(contrib, dtype=I32)
    dev = contrib.device
    ages = torch.as_tensor(ages_s, dtype=torch.float32).to(dev)
    budget = torch.as_tensor(budget_s, dtype=torch.float32).to(dev) \
        .broadcast_to(ages.shape)
    stale = ages > budget
    aged = torch.where(stale, TS_MAX, contrib)
    n_aged = (stale & (contrib != TS_MAX)).sum(dtype=I32)
    return aged, n_aged


def global_lwm(contrib: torch.Tensor, ring: Optional[Callable] = None
               ) -> torch.Tensor:
    """The global LWM: ``min`` over the per-host contributions, i32[].
    ``ring`` is a ``min`` all-reduce callable (for example
    ``functools.partial(ring_all_reduce, reduce="min", group=g)``) when the
    contributions are spread over ranks; with None the plain reduction
    computes the same value."""
    red = ring(contrib) if ring is not None else contrib
    return red.min().to(I32)


# ---------------------------------------------------------------------------
# sharded serving engine
# ---------------------------------------------------------------------------
class ShardedPagedKVEngine:
    """Multi-host paged-KV serving with global-LWM reclamation.

    ``hosts`` shards, each owning ``num_seqs`` sequences and ``num_pages``
    pool pages, on ``device`` (``cuda`` unless the caller passes another),
    placed over ``mesh`` (module docstring, "Ranks").  The batched entry
    points take ``[H, ...]``-leading arguments (tensors on any device, or
    array-likes).  Every GC-bearing op first refreshes the global LWM
    (contributions -> staleness aging -> min) and passes it to the shard
    ops as ``extra_pins``.  Per-host :class:`StepWatchdog` instances supply
    the staleness budget when ``gc.stale_after_s`` is inf;
    ``virtual_ages_s`` lets tests and benchmarks inject deterministic
    announcement ages instead of the wall clock.  A ``host`` argument is
    an index in ``[-H, H)``."""

    def __init__(self, hosts: int, num_seqs: int, num_pages: int,
                 page_size: int, max_pages_per_seq: int, kv_heads: int,
                 head_dim: int, *, gc: Optional[GCConfig] = None,
                 mesh=None, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        self.gc = gc if gc is not None else GCConfig()
        self.hosts = hosts
        self.device = resolve_device(device)
        if mesh is None and dist.is_initialized():
            mesh = make_gc_mesh(hosts, device=self.device)
        self.mesh = mesh
        #: the mesh axis's group when the hosts are spread over its ranks
        self.group: Optional[dist.ProcessGroup] = None
        self._ring: Optional[Callable] = None
        self.lo, self.hi = 0, hosts       # the hosts this rank holds
        if mesh is not None:
            axis = mesh.mesh_dim_names[0]
            n, coord = mesh.mesh.shape[0], mesh.get_coordinate()
            if n > 1 and hosts % n == 0 and coord is not None:
                self.group = mesh.get_group(axis)
                k = hosts // n
                self.lo, self.hi = coord[0] * k, (coord[0] + 1) * k
                self._ring = functools.partial(ring_all_reduce, reduce="min",
                                               group=self.group)
        self.shards: List[paged.PagedKV] = [
            paged.make_paged_kv(num_seqs, num_pages, page_size,
                                max_pages_per_seq, kv_heads, head_dim, dtype,
                                gc=self.gc, device=self.device)
            for _ in range(self.lo, self.hi)]
        self.watchdogs: List[StepWatchdog] = [StepWatchdog()
                                              for _ in range(hosts)]
        # deterministic announcement ages for tests/benches (None = fresh)
        self.virtual_ages_s: Optional[np.ndarray] = None
        self.stats = ReclaimStats(unit="pages")
        self.lwm_advances = 0
        self._last_lwm = -1
        self.forks = 0
        #: highest durably checkpointed timestamp across the hosts; -1 = no
        #: checkpoint.  Arms the sole-survivor eviction on every shard.
        self.ckpt_max: int = -1
        # the port's own accounting, which the JAX engine does not keep:
        # LWM refreshes, and the per-host split of ``stats.reclaimed`` and
        # of the live peak (read in the host syncs the engine makes anyway)
        self.lwm_refreshes = 0
        self.pages_reclaimed_by_host = [0] * hosts
        self.peak_pages_by_host = [0] * hosts

    # -- hosts and ranks ----------------------------------------------------
    @property
    def local_hosts(self) -> range:
        """The hosts whose shards this rank holds."""
        return range(self.lo, self.hi)

    def _host(self, host: int) -> int:
        if not -self.hosts <= host < self.hosts:
            raise IndexError(f"host {host} of {self.hosts}")
        return host % self.hosts

    def _holds(self, h: int) -> bool:
        return self.lo <= h < self.hi

    def _shard(self, h: int) -> paged.PagedKV:
        return self.shards[h - self.lo]

    def _all(self, local: torch.Tensor) -> torch.Tensor:
        """This rank's ``[h_local, ...]`` rows -> every host's ``[H, ...]``
        on every rank (on the engine's device)."""
        if self.group is None:
            return local
        return all_gather_cat(local, self.group).to(self.device)

    def _all_ints(self, *per_host: List[torch.Tensor]) -> List[List[int]]:
        """Per-host device scalars (one list of this rank's hosts each) ->
        every host's values as Python ints, one list each, in one host
        sync (and one gather over the ranks)."""
        rows = torch.stack([torch.stack([s.reshape(()).to(I32) for s in col])
                            for col in per_host], dim=1)
        rows = wire(rows) if self.group is None else \
            all_gather_cat(wire(rows), self.group)
        return rows.T.tolist()

    def _from(self, h: int, value: Any) -> Any:
        """``value`` as the rank holding host ``h`` computed it, on every
        rank (the others pass anything)."""
        if self.group is None:
            return value
        return broadcast_tree(value, h // (self.hi - self.lo), self.group,
                              self.device)

    def host_apply(self, host: int, fn: Callable[[paged.PagedKV], Any]
                   ) -> Any:
        """``fn(host's shard)`` run on the rank that holds the host (a read
        where the pages are), its result (tensors in tuples, lists and
        dicts, or plain values) on every rank."""
        h = self._host(host)
        return self._from(h, fn(self._shard(h)) if self._holds(h) else None)

    # -- inputs -------------------------------------------------------------
    def _ids(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(I32)

    def _mask(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(torch.bool)

    def _ints(self, *scalars: torch.Tensor) -> List[int]:
        """Device scalars read back in one host sync."""
        return torch.stack([s.reshape(()).to(I32) for s in scalars]).tolist()

    # -- global LWM ---------------------------------------------------------
    def ages_s(self) -> np.ndarray:
        """f32[H] announcement-refresh age per host: the injected virtual
        ages when set, else zero (in a deployment, each host's
        ``HeartbeatFile.age_s``)."""
        if self.virtual_ages_s is not None:
            return np.asarray(self.virtual_ages_s, np.float32)
        return np.zeros((self.hosts,), np.float32)

    def budget_s(self) -> np.ndarray:
        """f32[H] staleness budget per host: ``gc.stale_after_s`` when
        finite, else each host's always-finite ``StepWatchdog.budget_s``."""
        if math.isfinite(self.gc.stale_after_s):
            return np.full((self.hosts,), self.gc.stale_after_s, np.float32)
        return np.asarray([wd.budget_s() for wd in self.watchdogs],
                          np.float32)

    def lwm_pins(self) -> torch.Tensor:
        """One global-LWM refresh: contributions -> staleness aging -> min.
        Returns the per-host ``extra_pins`` ``i32[H, 1]`` (every host gets
        the same LWM) and accounts ``stale_lanes_aged`` and
        ``lwm_advances``.  One host sync.

        Over ranks the ``min`` ring carries the contributions: each rank
        fills its hosts' entries of an ``[H]`` vector and ``TS_MAX`` (the
        identity of ``min``) elsewhere, and after the ring every rank holds
        every host's contribution, so all of them age the same vector and
        take the same LWM and aged-lane count from one collective."""
        self.lwm_refreshes += 1
        slots = torch.stack([s.mv.board.slots for s in self.shards])
        contrib = _contributions(slots)
        if self._ring is not None:
            padded = torch.full((self.hosts,), TS_MAX, dtype=I32,
                                device=self.device)
            padded[self.lo:self.hi] = contrib
            contrib = self._ring(padded)
        aged, n_aged = age_out_stale(contrib, self.ages_s(), self.budget_s())
        lwm = global_lwm(aged)
        n, val = self._ints(n_aged, lwm)
        self.stats.stale_lanes_aged += n
        # an advance is the LWM rising from a real pin (TS_MAX is the
        # pin-free sentinel, not a position); a new, older pin retracks
        if 0 <= self._last_lwm < TS_MAX and val > self._last_lwm:
            self.lwm_advances += 1
        self._last_lwm = val
        return lwm.reshape(1, 1).expand(self.hosts, 1)

    # -- accounting ---------------------------------------------------------
    def _note_peak(self) -> None:
        # same branch on every rank: the sum over every host's live pages
        # at this moment, gathered
        live, = self._all_ints([paged.live_pages(s) for s in self.shards])
        self.peak_pages_by_host = [max(a, b) for a, b in
                                   zip(self.peak_pages_by_host, live)]
        self.stats.note_live(sum(live))

    def _any_pressure(self) -> bool:
        # same branch on every rank: the gate of every host, gathered
        up, = self._all_ints([
            paged.page_pressure(s, self.gc.page_watermark).under_pressure
            for s in self.shards])
        return any(up)

    def _reclaim_once(self, pins: torch.Tensor, extra_deficit: int = 0,
                      deficit: Optional[int] = None) -> None:
        """One reclaim pass on every host, under pressure or not: each
        chases ``max(its gate deficit, 1, extra_deficit)`` pages, or exactly
        ``deficit`` pages when given (no gate, no checkpoint eviction).
        ``extra_deficit`` is the failed-lane count over every host, the
        same on every rank."""
        floor = max(1, extra_deficit)
        pages = []
        for i, st in enumerate(self.shards):
            h = self.lo + i
            want = int(deficit) if deficit is not None else \
                paged.page_pressure(st, self.gc.page_watermark
                                    ).deficit.clamp(min=floor)
            st, freed = paged.reclaim_on_pressure(
                st, paged.hot_sequences(st, self.gc.hot_k), want,
                gc_policy=self.gc.policy, extra_pins=pins[h])
            self.shards[i] = st
            pages.append(freed)
        by_host, = self._all_ints(pages)
        # checkpoint-coupled eviction (DESIGN.md §14): when any host is
        # still under pressure, every host drops its idle sole-survivor
        # sequences that durable storage already holds
        if deficit is None and self.ckpt_max >= 0 and self._any_pressure():
            evicted, ck_pages = [], []
            for i, st in enumerate(self.shards):
                st, freed, n_ev = paged.evict_checkpointed(
                    st, self.ckpt_max, pins[self.lo + i])
                self.shards[i] = st
                evicted.append(n_ev)
                ck_pages.append(freed)
            evicted, ck_by_host = self._all_ints(evicted, ck_pages)
            self.stats.note_ckpt_eviction(sum(evicted), sum(ck_by_host))
            by_host = [a + b for a, b in zip(by_host, ck_by_host)]
        self._note_reclaim(by_host)

    def _note_reclaim(self, by_host: List[int]) -> None:
        # by_host is every host's, gathered: the same on every rank
        for h, n in enumerate(by_host):
            self.pages_reclaimed_by_host[h] += max(0, n)
        self.stats.note_reclaim(sum(by_host), int(self.live_pages()))

    # -- batched serving ops (all args [H, ...]-leading) --------------------
    def _run(self, op, mask: torch.Tensor, pins: torch.Tensor
             ) -> torch.Tensor:
        """``op(h, shard, mask[h], pins[h])`` on every host this rank
        holds; every host's failed[H, B] on every rank."""
        failed = []
        for i in range(len(self.shards)):
            h = self.lo + i
            self.shards[i], f = op(h, self.shards[i], mask[h], pins[h])
            failed.append(f)
        return self._all(torch.stack(failed))

    def _retry(self, op, mask: torch.Tensor, note_peak: bool
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Run ``op`` on every host; while lanes fail, reclaim on every host
        and retry the failed lanes (one shared round counter, a fresh LWM
        before each retry).  Returns (failed[H, B], the last pins, the
        failed-lane count).  ``failed`` is every host's, so the loop's
        count, its deficit floor and its exit are the same on every
        rank."""
        pins = self.lwm_pins()
        failed = self._run(op, mask, pins)
        if note_peak:
            self._note_peak()
        n_failed = int(failed.sum())
        rounds = 0
        while n_failed and rounds < self.gc.max_reclaim_rounds:
            self.stats.note_event()
            self._reclaim_once(pins, extra_deficit=n_failed)
            pins = self.lwm_pins()
            failed = self._run(op, failed, pins)
            if note_peak:
                self._note_peak()
            n_failed = int(failed.sum())
            rounds += 1
        return failed, pins, n_failed

    def step(self, seq_ids, k_new, v_new, mask) -> torch.Tensor:
        """Append one token per masked sequence on every host, with the
        reclaim-and-retry discipline of ``PagedKVEngine.step``; every
        append and reclaim carries the fresh global LWM.  Returns
        failed[H, B]."""
        ids = self._ids(seq_ids)
        k = torch.as_tensor(k_new, device=self.device)
        v = torch.as_tensor(v_new, device=self.device)
        failed, pins, n_failed = self._retry(
            lambda h, st, m, p: paged.append_tokens(
                st, ids[h], k[h], v[h], m, gc_policy=self.gc.policy,
                extra_pins=p),
            self._mask(mask), note_peak=True)
        if self._any_pressure():
            self.stats.note_event()
            self._reclaim_once(pins)
        self.stats.give_ups += n_failed
        return failed

    def reset(self, seq_ids, mask) -> torch.Tensor:
        """Recycle finished sequences on every host (empty table version).
        Returns failed[H, B]."""
        ids = self._ids(seq_ids)
        failed, _, n_failed = self._retry(
            lambda h, st, m, p: paged.reset_sequence(
                st, ids[h], m, gc_policy=self.gc.policy, extra_pins=p),
            self._mask(mask), note_peak=False)
        self.stats.give_ups += n_failed
        return failed

    def fork(self, src_ids, dst_ids, mask) -> torch.Tensor:
        """COW fork on every host (src and dst are host-local sequences).
        Returns failed[H, B]."""
        src, dst, mask = self._ids(src_ids), self._ids(dst_ids), \
            self._mask(mask)
        failed, _, n_failed = self._retry(
            lambda h, st, m, p: paged.fork_sequence(
                st, src[h], dst[h], m, gc_policy=self.gc.policy,
                extra_pins=p),
            mask, note_peak=True)
        self.stats.give_ups += n_failed
        self.forks += int((mask & ~failed).sum())
        return failed

    def reclaim(self, deficit: Optional[int] = None) -> int:
        """Explicit GC pass on every shard against the fresh global LWM.
        ``deficit=None`` chases each shard's gate deficit; a large deficit
        forces the full cold-spill sweep on every shard.  Returns the pages
        freed over all hosts."""
        pins = self.lwm_pins()
        before = int(self.live_pages())
        self._reclaim_once(pins, deficit=deficit)
        return before - int(self.live_pages())

    # -- host-local pins and snapshot reads ---------------------------------
    def _set_lane(self, h: int, lane: int, value) -> None:
        st = self._shard(h)
        one = torch.ones((1,), dtype=torch.bool, device=self.device)
        slots = drop_set(st.mv.board.slots, self._ids([lane]), value, one)
        self.shards[h - self.lo] = st._replace(mv=st.mv._replace(
            board=st.mv.board._replace(slots=slots)))

    def pin(self, host: int, lane: int) -> int:
        """Pin ``host``'s current timestamp on its local board lane,
        written straight into the board of the rank that holds it: the
        announcement never leaves the host; only the LWM reduction sees it.
        Returns the timestamp (on every rank)."""
        h = self._host(host)
        now = None
        if self._holds(h):
            now = self._shard(h).mv.now
            self._set_lane(h, lane, now.reshape(1))
            now = int(now)
        return int(self._from(h, now))

    def unpin(self, host: int, lane: int) -> None:
        h = self._host(host)
        if self._holds(h):
            self._set_lane(h, lane, EMPTY)

    def host_state(self, host: int) -> paged.PagedKV:
        """This host's shard, a plain single-host ``PagedKV``, on every
        rank (over ranks the whole shard crosses: a read that needs part
        of it is cheaper through :meth:`host_apply`)."""
        return self.host_apply(host, lambda st: st)

    def view_at(self, host: int, t: int, seq_ids=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Snapshot-read ``host``'s shard at pinned time ``t``: (page
        tables, visible lengths), ``paged.snapshot_view`` on the shard, run
        where the shard is."""
        def view(local):
            ids = seq_ids
            if ids is None:
                ids = torch.arange(local.mv.store.ts.shape[0], dtype=I32,
                                   device=self.device)
            return paged.snapshot_view(local, self._ids(ids), int(t))
        return tuple(self.host_apply(host, view))

    # -- durability (DESIGN.md §14) ------------------------------------------
    @staticmethod
    def _manager(directory) -> CheckpointManager:
        return (directory if isinstance(directory, CheckpointManager)
                else CheckpointManager(os.fspath(directory)))

    def checkpoint(self, directory, step: Optional[int] = None) -> int:
        """Checkpoint the host-stacked state (the JAX engine's ``[H, ...]``
        files) and the engine's accounting, then advance ``ckpt_max`` to
        the slowest host's clock: a version is durable across the hosts
        only once every shard has passed it.  Over ranks the first rank of
        the group writes, once every rank has gathered the stacked state,
        and every rank returns once the files are there.  Returns the
        manifest step."""
        mgr = self._manager(directory)
        nows, = self._all_ints([s.mv.now for s in self.shards])
        ts = min(nows)
        step = ts if step is None else int(step)
        extra = {
            "stats": dataclasses.asdict(self.stats),
            "forks": self.forks,
            "lwm_advances": self.lwm_advances,
            "last_lwm": self._last_lwm,
            "ckpt_max": ts,
        }
        tree = self.stacked()
        if self.group is None or dist.get_rank(self.group) == 0:
            mgr.save(step, tree, extra=extra)
        if self.group is not None:
            dist.barrier(group=self.group)
        self.ckpt_max = ts
        return step

    def restore(self, directory, step: Optional[int] = None) -> int:
        """Inverse of :meth:`checkpoint` (``step=None``: the latest):
        unstack the saved state into the shards this rank holds and replay
        the accounting.  Returns the step restored."""
        mgr = self._manager(directory)
        if step is None:
            step = mgr.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint manifest under {mgr.dir!r}")
        # one shard has the stacked tree's structure and dtypes
        tree, extra = mgr.restore(int(step), like=self.shards[0],
                                  device=self.device)
        if any(x.dim() == 0 or x.shape[0] != self.hosts
               for x in tree_flatten(tree)):
            raise ValueError(f"checkpoint {step} is not stacked over "
                             f"{self.hosts} hosts")
        self.shards = [_tree_map(lambda x, h=h: x[h].clone(), tree)
                       for h in self.local_hosts]
        self.stats = ReclaimStats(**extra.get("stats", {}))
        self.forks = int(extra.get("forks", 0))
        self.lwm_advances = int(extra.get("lwm_advances", 0))
        self._last_lwm = int(extra.get("last_lwm", -1))
        self.ckpt_max = int(extra.get("ckpt_max", -1))
        return int(step)

    # -- telemetry -----------------------------------------------------------
    def stacked(self) -> paged.PagedKV:
        """A host-stacked copy of the state, every host's on every rank:
        the JAX engine's ``st``."""
        return _tree_map(lambda *xs: self._all(torch.stack(xs)),
                         *self.shards)

    def live_pages(self) -> torch.Tensor:
        live, = self._all_ints([paged.live_pages(s) for s in self.shards])
        return torch.tensor(sum(live), dtype=I32)

    def pressure(self) -> PressureSignal:
        """The capacity gate over all shards: ``PressureSignal`` with
        ``[H]`` fields."""
        sigs = [paged.page_pressure(s, self.gc.page_watermark)
                for s in self.shards]
        return PressureSignal(*(self._all(torch.stack(f))
                                for f in zip(*sigs)))

    def space(self) -> Dict[str, int]:
        """Flat counters for BENCH_dist rows: the ReclaimStats vocabulary
        plus the multi-host fields, as the JAX engine's ``space()``."""
        live, free, up, ovf, dropped = (sum(c) for c in self._all_ints(
            [paged.live_pages(s) for s in self.shards],
            [s.free.sum(dtype=I32) for s in self.shards],
            [paged.page_pressure(s, self.gc.page_watermark).under_pressure
             for s in self.shards],
            [s.mv.overflow_count for s in self.shards],
            [s.mv.dropped_retires for s in self.shards]))
        rep = dict(self.stats.as_row())
        rep["hosts"] = self.hosts
        rep["live_pages"] = live
        rep["free_pages"] = free
        rep["page_pool"] = self.hosts * self.shards[0].free.shape[0]
        rep["under_pressure_hosts"] = up
        rep["lwm"] = self._last_lwm
        rep["lwm_advances"] = self.lwm_advances
        rep["overflows"] = ovf
        rep["dropped_retires"] = dropped
        rep["forks"] = self.forks
        return rep
