"""The ``needed(A, t)`` predicate in interval form (port of
``repro.core.mvgc.needed``).

A version ``[ts, succ)`` is needed iff ``succ > t`` (still current at the
scan threshold) or some announced ``a`` satisfies ``ts <= a < succ`` — one
``searchsorted`` over the sorted announcements per version.  The compact
kernel (``repro_torch.kernels.compact``) fuses the same predicate with the
splice.
"""
from __future__ import annotations

import torch

from repro_torch.core.mvgc.pool import EMPTY, TS_MAX


def needed_intervals(
    ts: torch.Tensor,          # i32[...]: version timestamps (EMPTY allowed)
    succ: torch.Tensor,        # i32[...]: successor timestamps
    ann_sorted: torch.Tensor,  # i32[P]: sorted announcements, TS_MAX padding
    now,                       # i32[]: scan threshold t
) -> torch.Tensor:
    """bool[...] — True where the version is needed(A, now)."""
    P = ann_sorted.shape[0]
    idx = torch.searchsorted(ann_sorted, ts.contiguous(), right=False,
                             out_int32=True)          # first a >= ts
    a = ann_sorted[idx.clamp(max=P - 1).long()]
    pinned = (idx < P) & (a < succ)
    return (ts != EMPTY) & (pinned | (succ > now))


def sort_announcements(ann: torch.Tensor) -> torch.Tensor:
    """Sort a board into searchsorted form: idle lanes (EMPTY) become
    TS_MAX so they sort last and pin nothing."""
    return torch.sort(torch.where(ann == EMPTY, TS_MAX, ann)).values
