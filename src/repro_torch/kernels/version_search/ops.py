"""Version search: batched ``search(t)`` (K3) and the fused search plus
value-row gather (K2).

Replaces the Pallas kernels ``search_pallas`` and ``search_gather_pallas``
of ``repro/kernels/version_search/kernel.py`` with ``csrc/version_search.cu``
(one warp per query: the lanes take the masked max over the slab's V
entries, then copy the value row with coalesced loads).  The wrappers
dispatch on the device of their inputs: CPU tensors take the plain versions
in ``ref.py``, CUDA tensors launch the kernel or raise.  ``search.launches``
and ``search_gather.launches`` count kernel launches.

Bound on the H100: bytes — each query reads one slab row (2 x V int32) and
its value row (M int32) and writes M + 2 values, with no arithmetic to
speak of; at serving batch sizes the launch itself dominates.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.version_search.ref import search_gather_ref, search_ref


def _launch(ts, payload, values, slot_ids, t, out_rows, M, T):
    _build.require_cuda_i32("version_search", ts, payload, slot_ids, t)
    S, V = ts.shape
    B = slot_ids.shape[0]
    if payload.shape != ts.shape or t.shape != (B,):
        raise ValueError("version_search: payload must match ts [S, V] and "
                         "t must be i32[B]")
    out_pay = torch.empty((B,), dtype=torch.int32, device=ts.device)
    found = torch.empty((B,), dtype=torch.bool, device=ts.device)
    err = _build.lib().mvgc_search_gather(
        ts.data_ptr(), payload.data_ptr(),
        None if values is None else values.data_ptr(),
        slot_ids.data_ptr(), t.data_ptr(),
        None if out_rows is None else out_rows.data_ptr(),
        out_pay.data_ptr(), found.data_ptr(), S, V, T, M, B,
        _build.stream())
    _build.check("mvgc_search_gather", err)
    return out_pay, found


def search(ts: torch.Tensor, payload: torch.Tensor, slot_ids: torch.Tensor,
           t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(payload[B], found[B])`` per query ``(slot_ids[b], t[b])``."""
    if ts.device.type == "cpu":
        return search_ref(ts, payload, slot_ids, t)
    out = _launch(ts, payload, None, slot_ids, t, None, 0, 0)
    search.launches += 1
    return out


def search_gather(ts: torch.Tensor, payload: torch.Tensor,
                  values: torch.Tensor, slot_ids: torch.Tensor,
                  t: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(rows[B, M], payload[B], found[B])``; rows of not-found queries are
    EMPTY-filled.  Found payloads must index rows of ``values``."""
    if ts.device.type == "cpu":
        return search_gather_ref(ts, payload, values, slot_ids, t)
    _build.require_cuda_i32("search_gather", values)
    T, M = values.shape
    rows = torch.empty((slot_ids.shape[0], M), dtype=torch.int32,
                       device=ts.device)
    pay, found = _launch(ts, payload, values, slot_ids, t, rows, M, T)
    search_gather.launches += 1
    return rows, pay, found


search.launches = 0
search_gather.launches = 0
