"""Batched RangeTracker: the retire ring (port of
``repro.core.mvgc.rangetracker``).

Retired versions (flat store index + closed interval) are pushed into ring
holes as they are overwritten; a flush intersects the whole ring with the
sorted announcements in one vectorised pass, frees the obsolete store
entries and compacts the still-needed ones to the front of the ring.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch._tensor import I32, DeviceLike, drop_set, resolve_device
from repro_torch.core.mvgc.needed import needed_intervals
from repro_torch.core.mvgc.pool import EMPTY, TS_MAX, VersionStore, free_entries


class RetireRing(NamedTuple):
    idx: torch.Tensor    # i32[B]: flat store index (slot * V + v); EMPTY = hole
    low: torch.Tensor    # i32[B]: interval start (version ts)
    high: torch.Tensor   # i32[B]: interval end (successor ts)

    @property
    def capacity(self) -> int:
        return self.idx.shape[0]


def make_ring(capacity: int, device: DeviceLike = None) -> RetireRing:
    dev = resolve_device(device)
    return RetireRing(
        idx=torch.full((capacity,), EMPTY, dtype=I32, device=dev),
        low=torch.full((capacity,), EMPTY, dtype=I32, device=dev),
        high=torch.full((capacity,), TS_MAX, dtype=I32, device=dev),
    )


def ring_size(ring: RetireRing) -> torch.Tensor:
    return (ring.idx != EMPTY).sum(dtype=I32)


def _rank(mask: torch.Tensor) -> torch.Tensor:
    """i32 0-based rank of each True lane among the True lanes."""
    return torch.cumsum(mask.to(I32), dim=0, dtype=I32) - 1


def push(
    ring: RetireRing,
    flat_idx: torch.Tensor,   # i32[K] flat store indices being retired
    low: torch.Tensor,        # i32[K]
    high: torch.Tensor,       # i32[K]
    mask: torch.Tensor,       # bool[K]
) -> Tuple[RetireRing, torch.Tensor]:
    """Append retired intervals into ring holes, in ascending hole order.
    Returns (ring, dropped[K]): dropped lanes found no hole."""
    B = ring.capacity
    holes = ring.idx == EMPTY
    push_rank = _rank(mask)
    ok = mask & (push_rank < holes.sum(dtype=I32))
    arange = torch.arange(B, dtype=I32, device=holes.device)
    hole_pos = torch.sort(torch.where(holes, arange, B)).values
    dest = hole_pos[push_rank.clamp(max=B - 1).long()]
    new_ring = RetireRing(
        idx=drop_set(ring.idx, dest, flat_idx, ok),
        low=drop_set(ring.low, dest, low, ok),
        high=drop_set(ring.high, dest, high, ok),
    )
    return new_ring, mask & ~ok


def flush(
    ring: RetireRing,
    store: VersionStore,
    ann_sorted: torch.Tensor,
    now: torch.Tensor,
) -> Tuple[RetireRing, VersionStore, torch.Tensor]:
    """Intersect the ring with the announcements; free obsolete entries.

    Returns (ring', store', freed_payloads[B]) with EMPTY holes."""
    S, V = store.ts.shape
    occupied = ring.idx != EMPTY
    needed = needed_intervals(
        torch.where(occupied, ring.low, EMPTY), ring.high, ann_sorted, now)
    reclaim = occupied & ~needed
    kill_flat = drop_set(
        torch.zeros((S * V,), dtype=torch.bool, device=ring.idx.device),
        ring.idx, True, reclaim)
    safe = ring.idx.clamp(min=0, max=S * V - 1).long()
    freed_payloads = torch.where(reclaim, store.payload.reshape(-1)[safe],
                                 EMPTY)
    store = free_entries(store, kill_flat.reshape(S, V))
    ring = _compact_ring(ring, occupied & needed)
    return ring, store, freed_payloads


def _compact_ring(ring: RetireRing, keep: torch.Tensor) -> RetireRing:
    """Keep the ``keep`` entries, compacted to the front in order."""
    dest = _rank(keep)

    def scatter(arr, fill):
        return drop_set(torch.full_like(arr, fill), dest, arr, keep)

    return RetireRing(
        idx=scatter(ring.idx, EMPTY),
        low=scatter(ring.low, EMPTY),
        high=scatter(ring.high, TS_MAX),
    )
