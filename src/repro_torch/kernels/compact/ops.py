"""Compact: fused ``needed(A, now)`` + splice over an ``[R, V]`` row batch.

Replaces the Pallas kernel ``compact_pallas`` (``_fused_compact_kernel``) of
``repro/kernels/compact/kernel.py`` with ``csrc/compact.cu``.  The wrapper
dispatches on the device of its inputs: CPU tensors take the plain version
(:func:`repro_torch.kernels.compact.ref.compact_ref`), CUDA tensors launch
the kernel or raise.  ``compact.launches`` counts kernel launches.

Bound on the H100: bytes.  Per entry the kernel reads 12 bytes and writes
16, and does ``log2(P)`` compares against the announcements it keeps in
shared memory, far under the card's operation rate.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.compact.ref import compact_ref


def compact(ts: torch.Tensor, succ: torch.Tensor, payload: torch.Tensor,
            mask: torch.Tensor, ann_sorted: torch.Tensor, now: torch.Tensor):
    """Fused needed + splice.  Returns ``(ts', succ', payload', freed,
    n_freed)`` (see :func:`compact_ref`); all outputs are new tensors.
    On the card, a board larger than the kernel's shared-memory copy of it
    (``kMaxAnn`` in ``csrc/compact.cu``) raises."""
    if ts.device.type == "cpu":
        return compact_ref(ts, succ, payload, mask, ann_sorted, now)
    now = torch.as_tensor(now, dtype=torch.int32, device=ts.device).reshape(1)
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


compact.launches = 0
