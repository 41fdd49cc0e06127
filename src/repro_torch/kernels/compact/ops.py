"""Compact: fused ``needed(A, now)`` + splice over an ``[R, V]`` row batch
(K1), and the ``needed(A, now)`` mask alone (K5).

Replaces the Pallas kernels ``compact_pallas`` (``_fused_compact_kernel``)
and ``needed_pallas`` (``_compact_kernel``) of
``repro/kernels/compact/kernel.py`` with ``csrc/compact.cu``; both kernels
share one device function for the predicate.  The wrappers dispatch on the
device of their inputs: CPU tensors take the plain versions
(:func:`repro_torch.kernels.compact.ref.compact_ref` and ``needed_ref``),
CUDA tensors launch the kernel or raise.  ``compact.launches`` and
``needed.launches`` count kernel launches.  As in the JAX package, no
engine or store calls :func:`needed`; the sweeps go through
:func:`compact`.

Bound on the H100: bytes.  Per entry K1 reads 12 bytes and writes 16, K5
reads 8 and writes 1; both do ``log2(P)`` compares against the
announcements they keep in shared memory, far under the card's operation
rate.  A board larger than the kernels' shared-memory copy of it
(``kMaxAnn`` in ``csrc/compact.cu``, 12288 entries) raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.compact.ref import compact_ref, needed_ref


def _now(now, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(now, dtype=torch.int32,
                           device=like.device).reshape(1)


def needed(ts: torch.Tensor, succ: torch.Tensor, ann_sorted: torch.Tensor,
           now) -> torch.Tensor:
    """bool[S, V]: ``needed(A, now)`` per entry.  ``ann_sorted`` must be
    sorted with TS_MAX padding (``core.mvgc.needed.sort_announcements``),
    as the plain version's contract already asks."""
    if ts.device.type == "cpu":
        return needed_ref(ts, succ, ann_sorted, now)
    now = _now(now, ts)
    _build.require_cuda_i32("needed", ts, succ, ann_sorted, now)
    if succ.shape != ts.shape or ts.dim() != 2 or ann_sorted.dim() != 1:
        raise ValueError("needed: ts and succ must be i32[S, V] and the "
                         "board i32[P]")
    S, V = ts.shape
    out = torch.empty((S, V), dtype=torch.bool, device=ts.device)
    err = _build.lib().mvgc_needed(
        ts.data_ptr(), succ.data_ptr(), ann_sorted.data_ptr(),
        now.data_ptr(), out.data_ptr(), S, V, ann_sorted.shape[0],
        _build.stream())
    _build.check("mvgc_needed", err)
    needed.launches += 1
    return out


def compact(ts: torch.Tensor, succ: torch.Tensor, payload: torch.Tensor,
            mask: torch.Tensor, ann_sorted: torch.Tensor, now: torch.Tensor):
    """Fused needed + splice.  Returns ``(ts', succ', payload', freed,
    n_freed)`` (see :func:`compact_ref`); all outputs are new tensors."""
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


compact.launches = 0
needed.launches = 0
