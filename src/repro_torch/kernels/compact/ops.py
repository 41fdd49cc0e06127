"""Compact (K1): the store's needed-sweep in one launch (:func:`sweep`, the
main path) and the fused ``needed(A, now)`` + splice over an ``[R, V]``
row batch (:func:`compact`, its parity op); and the ``needed(A, now)``
mask alone (:func:`needed`, K5).

Replaces the Pallas kernels ``compact_pallas`` (``_fused_compact_kernel``)
and ``needed_pallas`` (``_compact_kernel``) of
``repro/kernels/compact/kernel.py`` with ``csrc/compact.cu``; the kernels
share one device function for the predicate.  The wrappers dispatch on the
device of their inputs: CPU tensors take the plain versions
(:mod:`repro_torch.kernels.compact.ref`), CUDA tensors launch the kernel
or raise.  ``compact.launches`` counts K1's launches, those of
:func:`sweep` (also counted alone in ``sweep.launches``) and of
:func:`compact`; ``needed.launches`` counts K5's.  As in the JAX package,
no engine or store calls :func:`needed`; the store's sweeps go through
:func:`sweep`.  Fake tensors (a dry run, :mod:`repro_torch.launch.dryrun`)
get empty results of the kernel's shapes, and each call is charged its
kernel's analytic cost (:mod:`repro_torch.kernels.cost`) under an op
counter (:mod:`repro_torch.launch.op_cost`), at one check of
:data:`repro_torch.kernels.cost.ACTIVE` a call when none counts.

Bound on the H100: bytes.  The sweep reads and writes 12 bytes per slab
entry, reads 5 per lane and writes 4 per freed handle; :func:`compact`
reads 12 bytes per entry and writes 16, K5 reads 8 and writes 1; all do
``log2(P)`` compares against the announcements they keep in shared
memory, far under the card's operation rate.  K5 issues its loads
before the board barrier and, on a large slab, streams runs of 4 entries
per thread (16-byte loads, one 4-byte store of bools) over about one
block per SM, with the board in Eytzinger order; a smaller slab takes
one entry per thread and the board as it is sorted (see
``csrc/compact.cu``).  Every board size runs: a board that fits the
block's opt-in shared memory (227 KB on the H100) is staged there, a
larger one searched sorted where it lies in global memory, through the
read-only path.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build, cost
from repro_torch.kernels.compact.ref import compact_ref, needed_ref, sweep_ref


def _now(now, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(now, dtype=torch.int32,
                           device=like.device).reshape(1)


@cost.charged("needed", lambda ts, ann_sorted, **_: cost.needed_cost(
    *ts.shape, ann_sorted.shape[0]))
def needed(ts: torch.Tensor, succ: torch.Tensor, ann_sorted: torch.Tensor,
           now) -> torch.Tensor:
    """bool[S, V]: ``needed(A, now)`` per entry.  ``ann_sorted`` must be
    sorted with TS_MAX padding (``core.mvgc.needed.sort_announcements``),
    as the plain version's contract already asks; ``now`` is an int32
    device scalar or a Python int (passed to the kernel by value)."""
    if is_fake(ts):
        return ts.new_empty(ts.shape, dtype=torch.bool)
    if ts.device.type == "cpu":
        return needed_ref(ts, succ, ann_sorted, now)
    _build.require_cuda_i32("needed", ts, succ, ann_sorted)
    if succ.shape != ts.shape or ts.dim() != 2 or ann_sorted.dim() != 1:
        raise ValueError("needed: ts and succ must be i32[S, V] and the "
                         "board i32[P]")
    now_t, now_v, _ = _build.int_arg("needed", now, 1)
    S, V = ts.shape
    out = torch.empty((S, V), dtype=torch.bool, device=ts.device)
    vec = (ts.data_ptr() | succ.data_ptr() | out.data_ptr()) % 16 == 0
    err = _build.lib().mvgc_needed(
        ts.data_ptr(), succ.data_ptr(), ann_sorted.data_ptr(),
        None if now_t is None else now_t.data_ptr(), now_v, out.data_ptr(),
        S, V, ann_sorted.shape[0], int(vec), _build.stream())
    _build.check("mvgc_needed", err)
    needed.launches += 1
    return out


@cost.charged("compact", lambda ts, ann_sorted, **_: cost.compact_cost(
    *ts.shape, ann_sorted.shape[0]))
def compact(ts: torch.Tensor, succ: torch.Tensor, payload: torch.Tensor,
            mask: torch.Tensor, ann_sorted: torch.Tensor, now: torch.Tensor):
    """Fused needed + splice.  Returns ``(ts', succ', payload', freed,
    n_freed)`` (see :func:`compact_ref`); all outputs are new tensors."""
    if is_fake(ts):
        return (*(ts.new_empty(ts.shape) for _ in range(4)),
                ts.new_empty(()))
    if ts.device.type == "cpu":
        return compact_ref(ts, succ, payload, mask, ann_sorted, now)
    now = _now(now, ts)
    _build.require_cuda_i32("compact", ts, succ, payload, ann_sorted, now)
    R, V = ts.shape
    P = ann_sorted.shape[0]
    if succ.shape != ts.shape or payload.shape != ts.shape \
            or mask.shape != (R,) or mask.dtype != torch.bool \
            or not mask.is_contiguous() or mask.device != ts.device:
        raise ValueError("compact: shapes/dtypes do not match [R, V] rows "
                         "with a bool[R] mask")
    out_ts = torch.empty_like(ts)
    out_succ = torch.empty_like(ts)
    out_pay = torch.empty_like(ts)
    freed = torch.empty_like(ts)
    count = torch.zeros((1,), dtype=torch.int32, device=ts.device)
    err = _build.lib().mvgc_compact(
        ts.data_ptr(), succ.data_ptr(), payload.data_ptr(), mask.data_ptr(),
        ann_sorted.data_ptr(), now.data_ptr(), out_ts.data_ptr(),
        out_succ.data_ptr(), out_pay.data_ptr(), freed.data_ptr(),
        count.data_ptr(), R, V, P, _build.stream())
    _build.check("mvgc_compact", err)
    compact.launches += 1
    return out_ts, out_succ, out_pay, freed, count[0]


def _sweep_cost(ts, slot_ids, ann_sorted, **_) -> cost.Cost:
    S, V = ts.shape
    return cost.sweep_cost(S, V, S if slot_ids is None else
                           slot_ids.shape[0], ann_sorted.shape[0],
                           lanes=slot_ids is not None)


@cost.charged("sweep", _sweep_cost)
def sweep(ts: torch.Tensor, succ: torch.Tensor, payload: torch.Tensor,
          slot_ids, mask, ann_sorted: torch.Tensor, now):
    """The needed-sweep of the ``[S, V]`` slab in one launch.  Returns
    ``(ts', succ', payload', freed)``, all new tensors.

    With ``slot_ids`` (i32[R]) and ``mask`` (bool[R]),
    the slots that masked lanes name are swept and ``freed`` is
    ``[R * V]`` per lane, duplicates included; with both ``None`` every
    slot is swept and ``freed`` is ``[S * V]``.  Lane ids follow JAX's
    rules (an id in ``[-S, 0)`` wraps; see ``sweep_ref``).  ``now`` is an int32
    device scalar or a Python int (passed to the kernel by value); see
    :func:`repro_torch.kernels.compact.ref.sweep_ref`.  No host sync."""
    if (slot_ids is None) != (mask is None):
        raise ValueError("sweep: give slot_ids and mask together, or neither")
    if is_fake(ts):
        S, V = ts.shape
        R = S if slot_ids is None else slot_ids.shape[0]
        new_ts, new_succ, new_pay, freed = ts.new_empty(
            (3 * S + R, V)).split_with_sizes([S, S, S, R])
        return new_ts, new_succ, new_pay, freed.view(-1)
    if ts.device.type == "cpu":
        return sweep_ref(ts, succ, payload, slot_ids, mask, ann_sorted, now)
    _build.require_cuda_i32("sweep", ts, succ, payload, ann_sorted)
    S, V = ts.shape
    if succ.shape != ts.shape or payload.shape != ts.shape \
            or ann_sorted.dim() != 1:
        raise ValueError("sweep: ts, succ and payload must be i32[S, V] and "
                         "the board i32[P]")
    R = S
    if slot_ids is not None:
        _build.require_cuda_i32("sweep", slot_ids)
        R = slot_ids.shape[0]
        if slot_ids.dim() != 1 or mask.shape != (R,) \
                or mask.dtype != torch.bool or not mask.is_contiguous() \
                or mask.device != ts.device:
            raise ValueError("sweep: slot_ids must be i32[R] with a bool[R] "
                             "mask")
    now_t, now_v, _ = _build.int_arg("sweep", now, 1)
    # one allocation: rows [0, 3S) are the new slab, rows [3S, 3S + R) freed
    out = torch.empty((3 * S + R, V), dtype=torch.int32, device=ts.device)
    new_ts, new_succ, new_pay, freed = out.split_with_sizes([S, S, S, R])
    err = _build.lib().mvgc_sweep(
        ts.data_ptr(), succ.data_ptr(), payload.data_ptr(),
        None if slot_ids is None else slot_ids.data_ptr(),
        None if mask is None else mask.data_ptr(), ann_sorted.data_ptr(),
        None if now_t is None else now_t.data_ptr(), now_v,
        new_ts.data_ptr(), new_succ.data_ptr(), new_pay.data_ptr(),
        freed.data_ptr(), S, V, R, ann_sorted.shape[0], int(slot_ids is None),
        _build.stream())
    _build.check("mvgc_sweep", err)
    sweep.launches += 1
    compact.launches += 1
    return new_ts, new_succ, new_pay, freed.view(-1)


compact.launches = 0
sweep.launches = 0
needed.launches = 0
