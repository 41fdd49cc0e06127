"""Plain PyTorch version of the compact kernel: fused ``needed(A, t)`` and
splice over a row batch (port of ``repro.kernels.compact.ref``), and the
store's needed-sweep built on it (``sweep_ref``: the gather / compact /
scatter composite that ``vstore._sweep_slots`` and ``_sweep_all_needed``
ran before the sweep kernel).

The broadcast-compare form ``∃a: ts <= a < succ`` is kept on purpose: it is
independent of the ``searchsorted`` form in ``core.mvgc.needed`` and of the
kernel's binary search, so the three check each other."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._tensor import drop_rows, gather_index, put_rows

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


def sweep_ref(ts: torch.Tensor, succ: torch.Tensor, payload: torch.Tensor,
              slot_ids: Optional[torch.Tensor], mask: Optional[torch.Tensor],
              ann_sorted: torch.Tensor, now):
    """Returns ``(ts', succ', payload', freed)`` of the ``[S, V]`` slab.

    With lanes (``slot_ids[R]``, ``mask[R]``): the rows the lanes name are
    gathered and compacted, and only masked lanes write theirs back (trap
    C1); ``freed`` is ``[R * V]`` per lane, duplicates included.  Lane ids
    follow JAX's rules: ``[-S, 0)`` wraps; a masked lane still out of
    range reads its row clamped into ``[0, S)`` and reports that row's
    kills in ``freed``, as JAX's gather does, but writes nothing (the
    drop).  With ``slot_ids = mask = None`` every slot is swept and
    ``freed`` is ``[S * V]``."""
    if slot_ids is None:
        every = torch.ones(ts.shape[:1], dtype=torch.bool, device=ts.device)
        new_ts, new_succ, new_pay, freed, _ = compact_ref(
            ts, succ, payload, every, ann_sorted, now)
        return new_ts, new_succ, new_pay, freed.reshape(-1)
    sid = gather_index(slot_ids, ts.shape[0])
    new_ts, new_succ, new_pay, freed, _ = compact_ref(
        ts[sid], succ[sid], payload[sid], mask, ann_sorted, now)
    dest = drop_rows(slot_ids, mask, ts.shape[0])
    return (put_rows(ts, dest, new_ts), put_rows(succ, dest, new_succ),
            put_rows(payload, dest, new_pay), freed.reshape(-1))
