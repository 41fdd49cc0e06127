"""Announcement board: one lane per concurrent snapshot reader (port of
``repro.core.mvgc.announce``).  Announce/unannounce are masked writes
with JAX's drop rule: a lane in ``[-P, 0)`` means ``lane + P`` and a lane
still outside ``[0, P)`` writes nothing; the scan is a sort."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._tensor import I32, DeviceLike, drop_set, resolve_device
from repro_torch.core.mvgc.needed import sort_announcements
from repro_torch.core.mvgc.pool import EMPTY, TS_MAX


class AnnounceBoard(NamedTuple):
    slots: torch.Tensor  # i32[P]: announced timestamp per lane; EMPTY = idle

    @property
    def num_lanes(self) -> int:
        return self.slots.shape[0]


def make_board(num_lanes: int, device: DeviceLike = None) -> AnnounceBoard:
    return AnnounceBoard(slots=torch.full(
        (num_lanes,), EMPTY, dtype=I32, device=resolve_device(device)))


def announce(board: AnnounceBoard, lanes: torch.Tensor, ts,
             mask: torch.Tensor) -> AnnounceBoard:
    """Pin timestamps: lanes[i] announces ts[i] where mask[i]."""
    ts = torch.as_tensor(ts, dtype=I32, device=board.slots.device)
    return AnnounceBoard(slots=drop_set(board.slots, lanes,
                                        ts.expand(lanes.shape), mask))


def unannounce(board: AnnounceBoard, lanes: torch.Tensor,
               mask: torch.Tensor) -> AnnounceBoard:
    return AnnounceBoard(slots=drop_set(board.slots, lanes, EMPTY, mask))


def scan(board: AnnounceBoard) -> torch.Tensor:
    """Sorted announcement snapshot (TS_MAX padded) for needed()."""
    return sort_announcements(board.slots)


def oldest(board: AnnounceBoard, now: torch.Tensor) -> torch.Tensor:
    """Oldest pinned timestamp, or ``now`` if nothing is pinned (the EBR
    epoch boundary)."""
    active = board.slots != EMPTY
    m = torch.where(active, board.slots, TS_MAX).min()
    return torch.where(active.any(), m, now).to(I32)
