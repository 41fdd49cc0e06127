"""Versioned object store: the deployable MVGC facade (port of
``repro.core.mvgc.vstore``).

Bundles the version slabs, announcement board, retire ring and the global
timestamp into one ``MVState`` and exposes the paper's schemes as GC
*policies* over identical state:

* ``ebr``   — free every version whose interval closed before the oldest pin;
* ``steam`` — compact-on-append: sweep the written slots before each write;
* ``dlrt``  — retire-ring flush frees exactly the obsolete retired entries;
* ``slrt``  — ring flush plus a needed-sweep of the implicated slots;
* ``sweep`` — sweep every slab on each GC step.

Every sweep is one launch of the compact kernel's sweep
(:func:`repro_torch.kernels.compact.ops.sweep`) and every snapshot read
goes through version search (:mod:`repro_torch.kernels.version_search.ops`);
on CPU tensors those wrappers run their plain versions.  JAX's ``lax.cond``
becomes a Python ``if`` on a scalar read back from the device.

``extra_pins`` (external announcements, ``TS_MAX`` = no pin) and
``ckpt_max`` (the sole-survivor checkpoint post-pass, ``EMPTY`` = off)
behave as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch._tensor import (I32, DeviceLike, gather_index, i32,
                                 i32_or_int, resolve_device)
from repro_torch.core.mvgc import announce as ann
from repro_torch.core.mvgc import pool, rangetracker as rt
from repro_torch.core.mvgc.needed import sort_announcements
from repro_torch.core.mvgc.pool import EMPTY, TS_MAX, VersionStore
from repro_torch.core.telemetry import PressureSignal
from repro_torch.kernels.compact import ops as compact_ops
from repro_torch.kernels.version_search import ops as search_ops

POLICIES = ("ebr", "steam", "dlrt", "slrt", "sweep")


class MVState(NamedTuple):
    store: VersionStore          # [S, V] version slabs
    board: ann.AnnounceBoard     # [P] reader pins
    ring: rt.RetireRing          # [B] retired intervals (RT policies)
    now: torch.Tensor            # i32[] global timestamp (one tick per step)
    overflow_count: torch.Tensor  # i32[] slab-overflow events
    dropped_retires: torch.Tensor  # i32[] ring-overflow events


def make_state(
    num_slots: int,
    versions_per_slot: int,
    num_reader_lanes: int,
    ring_capacity: int = 0,
    *,
    device: DeviceLike = None,
) -> MVState:
    """An empty MVState on ``device``; a ``ring_capacity`` of 0 sizes the
    retire ring from the slot count."""
    dev = resolve_device(device)
    ring_capacity = ring_capacity or max(64, num_slots // 2)
    return MVState(
        store=pool.make_store(num_slots, versions_per_slot, dev),
        board=ann.make_board(num_reader_lanes, dev),
        ring=rt.make_ring(ring_capacity, dev),
        now=i32(0, dev),
        overflow_count=i32(0, dev),
        dropped_retires=i32(0, dev),
    )


def _empty(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((n,), EMPTY, dtype=I32, device=like.device)


# ---------------------------------------------------------------------------
# Write path
# ---------------------------------------------------------------------------
def write_step(
    state: MVState,
    slot_ids: torch.Tensor,   # i32[K] slots written this step
    payloads: torch.Tensor,   # i32[K] new payload handles
    mask: torch.Tensor,       # bool[K]
    policy: str = "slrt",
    extra_pins: Optional[torch.Tensor] = None,
) -> Tuple[MVState, torch.Tensor, torch.Tensor]:
    """Tick the clock, append versions, retire the overwritten ones into the
    ring (RT policies).  Returns (state', freed_payloads, overflow[K]).
    Slot ids follow JAX's rules (:func:`repro_torch.core.mvgc.pool.write`);
    the ring records ``slot_id * V + v`` from the id as given, as JAX
    does."""
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}")
    freed = _empty(slot_ids.shape[0], slot_ids)
    if policy == "steam":
        state, freed = _sweep_slots(state, slot_ids, mask,
                                    extra_pins=extra_pins)
    now = state.now + 1
    store = state.store
    V = store.ts.shape[1]

    sid = gather_index(slot_ids, store.ts.shape[0])
    rows_ts = store.ts[sid]
    is_cur = (store.succ[sid] == TS_MAX) & (rows_ts != EMPTY)
    had_cur = is_cur.any(dim=1) & mask
    cur_v = pool.first_true(is_cur)
    retired_flat = slot_ids.to(I32) * V + cur_v
    retired_low = torch.gather(rows_ts, 1, cur_v.long()[:, None])[:, 0]

    store, overflow = pool.write(store, slot_ids, now, payloads, mask)
    state = state._replace(
        store=store, now=now,
        overflow_count=state.overflow_count + overflow.sum(dtype=I32))

    if policy in ("dlrt", "slrt"):
        ring, dropped = rt.push(
            state.ring, retired_flat, retired_low,
            now.expand(retired_low.shape), had_cur & ~overflow)
        state = state._replace(
            ring=ring,
            dropped_retires=state.dropped_retires + dropped.sum(dtype=I32))
    return state, freed, overflow


# ---------------------------------------------------------------------------
# Reader path
# ---------------------------------------------------------------------------
def begin_snapshot(state: MVState, lanes: torch.Tensor, mask: torch.Tensor
                   ) -> Tuple[MVState, torch.Tensor]:
    """Pin the current timestamp for the given reader lanes."""
    board = ann.announce(state.board, lanes, state.now, mask)
    return state._replace(board=board), state.now.expand(lanes.shape)


def end_snapshot(state: MVState, lanes: torch.Tensor, mask: torch.Tensor
                 ) -> MVState:
    return state._replace(board=ann.unannounce(state.board, lanes, mask))


def _ids(slot_ids: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if slot_ids is None else slot_ids.to(I32).contiguous()


def snapshot_read(state: MVState, slot_ids: Optional[torch.Tensor], t
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """rtx read (``search(t)``): latest payload at-or-before t per slot,
    through the version-search kernel.  ``slot_ids=None`` reads every
    slot.  ``t`` is a Python int (passed to the kernel by value) or an
    int32 tensor, 0-d or one per slot."""
    return search_ops.search(state.store.ts, state.store.payload,
                             _ids(slot_ids),
                             i32_or_int(t, state.store.ts.device))


def snapshot_value(state: MVState, slot_ids: Optional[torch.Tensor], t
                   ) -> torch.Tensor:
    """:func:`snapshot_read`'s payloads with 0 where a slot had no version
    at ``t``, in one launch (``search_ops.value_at``); ``slot_ids=None``
    reads every slot."""
    return search_ops.value_at(state.store.ts, state.store.payload,
                               _ids(slot_ids),
                               i32_or_int(t, state.store.ts.device))


def snapshot_gather(state: MVState, slot_ids: torch.Tensor, t,
                    values: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused rtx read: search(t) per slot and the value rows the resolved
    payloads index, in one launch.  Returns ``(rows[B, M], payload[B],
    found[B])``; rows of not-found slots are EMPTY-filled."""
    return search_ops.search_gather(
        state.store.ts, state.store.payload, values.contiguous(),
        slot_ids.to(I32).contiguous(), i32_or_int(t, slot_ids.device))


def current_read(state: MVState, slot_ids: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    return pool.read_current(state.store, slot_ids)


# ---------------------------------------------------------------------------
# GC step
# ---------------------------------------------------------------------------
def _extra(extra_pins, like: torch.Tensor) -> torch.Tensor:
    return torch.atleast_1d(torch.as_tensor(extra_pins, dtype=I32,
                                            device=like.device))


def _ann_scan(state: MVState, extra_pins) -> torch.Tensor:
    """Sorted announcements for needed(), external pins appended."""
    if extra_pins is None:
        return ann.scan(state.board)
    return sort_announcements(torch.cat(
        [state.board.slots, _extra(extra_pins, state.now)]))


def _ebr_bound(state: MVState, extra_pins) -> torch.Tensor:
    """Oldest local pin (or ``now``), clamped by the oldest external pin."""
    bound = ann.oldest(state.board, state.now)
    if extra_pins is not None:
        bound = torch.minimum(bound, _extra(extra_pins, state.now).min())
    return bound


def ckpt_kill_mask(state: MVState, ckpt_max, extra_pins=None
                   ) -> torch.Tensor:
    """bool[S, V]: the sole-survivor rule — a slot's only, current version,
    begun at or before ``ckpt_max`` and before every pin.  ``ckpt_max`` =
    EMPTY disables it."""
    store = state.store
    ckpt = torch.as_tensor(ckpt_max, dtype=I32, device=store.ts.device)
    bound = _ebr_bound(state, extra_pins)
    valid = store.ts != EMPTY
    sole = (valid.sum(dim=1) == 1)[:, None]
    cur = (store.succ == TS_MAX) & valid
    return (cur & sole & (store.ts <= ckpt) & (store.ts < bound)
            & (ckpt >= 0))


def evict_checkpointed(state: MVState, ckpt_max, extra_pins=None
                       ) -> Tuple[MVState, torch.Tensor, torch.Tensor]:
    """Free every entry :func:`ckpt_kill_mask` marks.  Returns (state',
    freed_payloads[S*V] with EMPTY holes, n_evicted)."""
    kill = ckpt_kill_mask(state, ckpt_max, extra_pins)
    freed = torch.where(kill, state.store.payload, EMPTY).reshape(-1)
    n = kill.sum(dtype=I32)
    return state._replace(store=pool.free_entries(state.store, kill)), freed, n


def gc_step(state: MVState, policy: str = "slrt", force: bool = False,
            flush_fraction: float = 0.5, extra_pins=None, ckpt_max=None
            ) -> Tuple[MVState, torch.Tensor]:
    """Run the policy's collection pass, then the checkpoint post-pass when
    ``ckpt_max`` is given.  Returns (state', freed_payloads)."""
    state, freed = _policy_gc_step(state, policy=policy, force=force,
                                   flush_fraction=flush_fraction,
                                   extra_pins=extra_pins)
    if ckpt_max is not None:
        state, freed_ck, _ = evict_checkpointed(state, ckpt_max, extra_pins)
        freed = torch.cat([freed.reshape(-1), freed_ck])
    return state, freed


def _policy_gc_step(state: MVState, policy: str = "slrt", force: bool = False,
                    flush_fraction: float = 0.5, extra_pins=None
                    ) -> Tuple[MVState, torch.Tensor]:
    """The per-policy collection pass proper."""
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}")
    V = state.store.ts.shape[1]
    B = state.ring.capacity
    if policy == "ebr":
        kill = pool.epoch_kill_mask(state.store, _ebr_bound(state, extra_pins))
        freed = torch.where(kill, state.store.payload, EMPTY).reshape(-1)
        return state._replace(store=pool.free_entries(state.store, kill)), freed
    if policy == "sweep":
        return _sweep_all_needed(state, extra_pins=extra_pins)
    if policy == "steam":
        if force:
            return _sweep_all_needed(state, extra_pins=extra_pins)
        return state, _empty(B, state.now)

    # dlrt / slrt: flush once the ring crosses the threshold (a host sync;
    # a boolean read, which a dry run's op counter explores both ways)
    thresh = int(B * flush_fraction)
    if not (force or bool(rt.ring_size(state.ring) >= thresh)):
        return state, _empty(B + B * V, state.now)
    A = _ann_scan(state, extra_pins)
    occ = state.ring.idx != EMPTY
    touched = torch.where(occ, torch.div(state.ring.idx, V,
                                         rounding_mode="floor"), 0)
    ring, store, freed = rt.flush(state.ring, state.store, A, state.now)
    state = state._replace(ring=ring, store=store)
    if policy == "slrt":
        state, freed2 = _sweep_slots(state, touched, occ,
                                     extra_pins=extra_pins)
    else:
        freed2 = _empty(B * V, state.now)
    return state, torch.cat([freed, freed2])


def _sweep_all_needed(state: MVState, extra_pins=None
                      ) -> Tuple[MVState, torch.Tensor]:
    """Full-store needed-sweep: one sweep launch over every slab."""
    A = _ann_scan(state, extra_pins)
    new_ts, new_succ, new_pay, freed = compact_ops.sweep(
        state.store.ts, state.store.succ, state.store.payload, None, None,
        A, state.now)
    store = VersionStore(ts=new_ts, succ=new_succ, payload=new_pay)
    return state._replace(store=store), freed


def _sweep_slots(state: MVState, slot_ids: torch.Tensor, mask: torch.Tensor,
                 extra_pins=None) -> Tuple[MVState, torch.Tensor]:
    """needed-sweep of the given slots: one sweep launch.

    Only masked lanes are written back.  Inert lanes are clamped to slot 0
    by the callers (ring holes, ``-1`` hot keys); writing their unchanged
    rows back would race with a masked lane of slot 0 (trap C1).  The sweep
    computes every slot it writes from the slot's original row, so masked
    lanes that share a slot agree.  ``freed`` is per lane."""
    A = _ann_scan(state, extra_pins)
    new_ts, new_succ, new_pay, freed = compact_ops.sweep(
        state.store.ts, state.store.succ, state.store.payload,
        slot_ids.to(I32).contiguous(), mask.contiguous(), A, state.now)
    store = VersionStore(ts=new_ts, succ=new_succ, payload=new_pay)
    return state._replace(store=store), freed


# ---------------------------------------------------------------------------
# Pressure path: capacity gate -> hot slots -> reclaim
# ---------------------------------------------------------------------------
def capacity_gate(state: MVState, slab_watermark: float = 0.75,
                  ring_watermark: float = 0.5) -> PressureSignal:
    """Slab- and ring-occupancy watermarks; ``deficit`` is the number of
    versions to free to bring every slab and the ring under them."""
    S, V = state.store.ts.shape
    occ = (state.store.ts != EMPTY).sum(dim=1, dtype=I32)
    slab_hi = max(1, int(slab_watermark * V))
    ring_hi = max(1, int(ring_watermark * state.ring.capacity))
    size = rt.ring_size(state.ring)
    deficit = ((occ - slab_hi).clamp(min=0).sum(dtype=I32)
               + (size - ring_hi).clamp(min=0))
    slab_frac = occ.max().float() / V
    ring_frac = size.float() / state.ring.capacity
    return PressureSignal(
        level=torch.maximum(slab_frac, ring_frac),
        under_pressure=(occ.max() > slab_hi) | (size > ring_hi),
        deficit=deficit,
        live=occ.sum(dtype=I32),
        capacity=i32(S * V, occ.device),
    )


def hot_slots(state: MVState, k: int) -> torch.Tensor:
    """Top-k slots by live-version occupancy, ``-1`` for slots with <= 1
    live version.  Ties go to the lower slot id, as ``lax.top_k`` orders
    them: a stable descending sort, not ``torch.topk`` (trap C2)."""
    occ = (state.store.ts != EMPTY).sum(dim=1, dtype=I32)
    k = min(k, occ.shape[0])
    vals, idx = torch.sort(occ, descending=True, stable=True)
    return torch.where(vals[:k] > 1, idx[:k].to(I32), -1)


def reclaim_on_pressure(state: MVState, hot_keys: torch.Tensor, deficit,
                        policy: str = "slrt", extra_pins=None, ckpt_max=None
                        ) -> Tuple[MVState, torch.Tensor, torch.Tensor]:
    """The policy's pressure response, then the checkpoint post-pass when
    ``ckpt_max`` is given.  Returns (state', freed_payloads, n_freed)."""
    live0 = live_versions(state)
    state, freed, _ = _policy_reclaim(state, hot_keys, deficit, policy=policy,
                                      extra_pins=extra_pins)
    if ckpt_max is not None:
        state, freed_ck, _ = evict_checkpointed(state, ckpt_max, extra_pins)
        freed = torch.cat([freed.reshape(-1), freed_ck])
    return state, freed, live0 - live_versions(state)


def _policy_reclaim(state: MVState, hot_keys: torch.Tensor, deficit,
                    policy: str = "slrt", extra_pins=None
                    ) -> Tuple[MVState, torch.Tensor, torch.Tensor]:
    """Hot-first synchronous reclaim; the cold spill (a full sweep) runs
    only while the deficit is unmet (steam, slrt).  ebr forces an epoch
    turnover, dlrt a ring flush, sweep a full sweep."""
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}")
    S, V = state.store.ts.shape
    live0 = live_versions(state)
    deficit = torch.as_tensor(deficit, dtype=I32, device=state.now.device)

    if policy == "ebr":
        state, freed = gc_step(state, policy="ebr", extra_pins=extra_pins)
        return state, freed, live0 - live_versions(state)
    if policy == "sweep":
        state, freed = _sweep_all_needed(state, extra_pins=extra_pins)
        return state, freed, live0 - live_versions(state)
    if policy == "dlrt":
        state, freed = gc_step(state, policy="dlrt", force=True,
                               extra_pins=extra_pins)
        return state, freed, live0 - live_versions(state)

    if policy == "slrt":
        state, freed_rt = gc_step(state, policy="slrt", force=True,
                                  extra_pins=extra_pins)
    else:
        freed_rt = _empty(0, state.now)
    hot_keys = hot_keys.to(I32)
    state, freed_hot = _sweep_slots(state, hot_keys.clamp(min=0),
                                    hot_keys >= 0, extra_pins=extra_pins)
    if bool(live0 - live_versions(state) >= deficit):
        freed_cold = _empty(S * V, state.now)
    else:
        state, freed_cold = _sweep_all_needed(state, extra_pins=extra_pins)
    freed = torch.cat([freed_rt.reshape(-1), freed_hot.reshape(-1),
                       freed_cold.reshape(-1)])
    return state, freed, live0 - live_versions(state)


# ---------------------------------------------------------------------------
# Monitoring
# ---------------------------------------------------------------------------
def live_versions(state: MVState) -> torch.Tensor:
    return (state.store.ts != EMPTY).sum(dtype=I32)


def space_report(state: MVState) -> dict:
    occ = pool.occupancy(state.store)
    return {
        "live_versions": int(live_versions(state)),
        "max_slot_occupancy": int(occ.max()),
        "ring_size": int(rt.ring_size(state.ring)),
        "overflows": int(state.overflow_count),
        "dropped_retires": int(state.dropped_retires),
    }
