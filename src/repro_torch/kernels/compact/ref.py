"""Plain PyTorch version of the compact kernel: fused ``needed(A, t)`` and
splice over a row batch (port of ``repro.kernels.compact.ref``).

The broadcast-compare form ``∃a: ts <= a < succ`` is kept on purpose: it is
independent of the ``searchsorted`` form in ``core.mvgc.needed`` and of the
kernel's binary search, so the three check each other."""
from __future__ import annotations

import torch

EMPTY = -1
TS_MAX = 2_147_483_647


def needed_ref(ts: torch.Tensor, succ: torch.Tensor, ann_sorted: torch.Tensor,
               now) -> torch.Tensor:
    """bool[R, V]: needed(A, now) per entry (EMPTY entries are not needed)."""
    A = ann_sorted[None, None, :]
    pinned = ((ts[..., None] <= A) & (A < succ[..., None])).any(dim=-1)
    return (ts != EMPTY) & (pinned | (succ > now))


def compact_ref(ts: torch.Tensor, succ: torch.Tensor, payload: torch.Tensor,
                mask: torch.Tensor, ann_sorted: torch.Tensor, now):
    """Returns ``(ts', succ', payload', freed, n_freed)``: killed entries
    reset to EMPTY/TS_MAX/EMPTY, their payloads in ``freed`` (EMPTY holes,
    same [R, V] layout) and the exact count as an i32 scalar.  Rows with
    ``mask`` False pass through untouched."""
    need = needed_ref(ts, succ, ann_sorted, now)
    kill = (ts != EMPTY) & ~need & mask[:, None]
    return (torch.where(kill, EMPTY, ts),
            torch.where(kill, TS_MAX, succ),
            torch.where(kill, EMPTY, payload),
            torch.where(kill, payload, EMPTY),
            kill.sum(dtype=torch.int32))
