"""Version search: batched ``search(t)`` (K3: :func:`value_at` on the main
path, :func:`search` its parity op), the fused search plus value-row
gather (K2's parity op) and the snapshot view (K2's main path).

Replaces the Pallas kernels ``search_pallas`` and ``search_gather_pallas``
of ``repro/kernels/version_search/kernel.py`` with ``csrc/version_search.cu``.
K3 gives each query a group of ``min(32, next_pow2(V))`` lanes (four
queries per warp at V = 8) that load ts and payload of the slab row in one
round trip and take the masked max over its V entries.  :func:`value_at`
is the main path's read (``snapshot_lengths``, ``lengths_at``): the
resolved payload with 0 where nothing was found, in one launch and one
allocation, every slot when ``slot_ids`` is None (no id array to build).
:func:`search` returns ``(payload, found)`` out of one allocation, as
``search_pallas`` does.  K2 keeps one warp per query and copies the value
row with coalesced loads; :func:`view` is ``paged.snapshot_view`` in one
launch: it reads the resolved version's table row and length straight
from ``tables`` and ``lengths``.  The wrappers dispatch on the device of
their inputs: CPU tensors take the plain versions in ``ref.py``, CUDA
tensors launch the kernel or raise.  ``search.launches`` counts K3's
launches, those of :func:`value_at` (also counted alone in
``value_at.launches``) and of :func:`search`; ``search_gather.launches``
counts K2's, those of :func:`view` (also counted alone in
``view.launches``) and of :func:`search_gather`.

Fake tensors (a dry run, :mod:`repro_torch.launch.dryrun`) get empty
results of the kernels' shapes, and each call is charged its kernel's
analytic cost (:mod:`repro_torch.kernels.cost`; ``search_gather`` and
``view`` with every query found) under an op counter
(:mod:`repro_torch.launch.op_cost`).

Slot ids follow JAX's gather rule: an id in ``[-S, 0)`` means ``id + S``,
an id still out of range is clamped into ``[0, S)``.  ``t`` is a Python
int, passed to the kernel by value (no fill is launched for it), or an
int32 device tensor, 0-d or one per query ``[B]``, read in place (no
``expand().contiguous()``).

Bound on the H100: bytes — each query reads its id and one slab row (2 x V
int32), K2 also its value row (M int32), and writes its outputs, with no
arithmetic to speak of; at serving batch sizes the launch itself
dominates.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build, cost
from repro_torch.kernels.version_search.ref import (search_gather_ref,
                                                     search_ref, value_at_ref,
                                                     view_ref)


def _check_slab(ts, payload, slot_ids):
    _build.require_cuda_i32("version_search", ts, payload)
    if payload.shape != ts.shape or ts.dim() != 2:
        raise ValueError("version_search: ts and payload must be i32[S, V]")
    if slot_ids is not None:
        _build.require_cuda_i32("version_search", slot_ids)
        if slot_ids.dim() != 1:
            raise ValueError("version_search: slot_ids must be i32[B]")


def _search(ts, payload, slot_ids, t, with_found: bool):
    """One K3 launch: ``(payload or EMPTY, found)`` when ``with_found``,
    else ``(payload or 0, None)``."""
    _check_slab(ts, payload, slot_ids)
    S, V = ts.shape
    B = S if slot_ids is None else slot_ids.shape[0]
    t_ten, t_val, t_stride = _build.int_arg("search", t, B)
    if with_found:   # one allocation: [B] int32 payloads, then [B] flags
        buf = torch.empty((5 * B,), dtype=torch.uint8, device=ts.device)
        out, found = buf[:4 * B].view(torch.int32), buf[4 * B:].view(
            torch.bool)
    else:
        out = torch.empty((B,), dtype=torch.int32, device=ts.device)
        found = None
    err = _build.lib().mvgc_search(
        ts.data_ptr(), payload.data_ptr(),
        None if slot_ids is None else slot_ids.data_ptr(),
        None if t_ten is None else t_ten.data_ptr(), t_val, t_stride,
        out.data_ptr(), None if found is None else found.data_ptr(),
        -1 if with_found else 0, S, V, B, _build.stream())
    _build.check("mvgc_search", err)
    search.launches += 1
    return out, found


def _queries(ts, slot_ids) -> int:
    return ts.shape[0] if slot_ids is None else slot_ids.shape[0]


@cost.charged("value_at", lambda ts, slot_ids, **_: cost.value_at_cost(
    _queries(ts, slot_ids), ts.shape[1], ids=slot_ids is not None))
def value_at(ts: torch.Tensor, payload: torch.Tensor,
             slot_ids: Optional[torch.Tensor], t) -> torch.Tensor:
    """i32[B]: the payload of the latest version with ts <= t per queried
    slot, 0 where there is none (``slot_ids=None``: every slot).  The main
    path's snapshot read: one launch, one allocation, no host sync."""
    if is_fake(ts):
        return ts.new_empty((_queries(ts, slot_ids),))
    if ts.device.type == "cpu":
        return value_at_ref(ts, payload, slot_ids, t)
    out, _ = _search(ts, payload, slot_ids, t, with_found=False)
    value_at.launches += 1
    return out


@cost.charged("search", lambda ts, slot_ids, **_: cost.search_cost(
    _queries(ts, slot_ids), ts.shape[1]))
def search(ts: torch.Tensor, payload: torch.Tensor,
           slot_ids: Optional[torch.Tensor], t
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(payload[B], found[B])`` per query ``(slot_ids[b], t)``, EMPTY
    payloads where nothing was found (``slot_ids=None``: every slot)."""
    if is_fake(ts):
        B = _queries(ts, slot_ids)
        buf = ts.new_empty((5 * B,), dtype=torch.uint8)
        return buf[:4 * B].view(torch.int32), buf[4 * B:].view(torch.bool)
    if ts.device.type == "cpu":
        return search_ref(ts, payload, slot_ids, t)
    return _search(ts, payload, slot_ids, t, with_found=True)


@cost.charged("search_gather", lambda ts, values, slot_ids, **_:
              cost.search_gather_cost(slot_ids.shape[0], ts.shape[1],
                                      values.shape[1], slot_ids.shape[0]))
def search_gather(ts: torch.Tensor, payload: torch.Tensor,
                  values: torch.Tensor, slot_ids: torch.Tensor, t
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(rows[B, M], payload[B], found[B])``; rows of not-found queries are
    EMPTY-filled.  Found payloads are clamped into ``[0, T)`` to index
    ``values[T, M]``."""
    if is_fake(ts):
        B, M = slot_ids.shape[0], values.shape[1]
        return (ts.new_empty((B, M)), ts.new_empty((B,)),
                ts.new_empty((B,), dtype=torch.bool))
    if ts.device.type == "cpu":
        return search_gather_ref(ts, payload, values, slot_ids, t)
    _check_slab(ts, payload, slot_ids)
    _build.require_cuda_i32("search_gather", values)
    S, V = ts.shape
    T, M = values.shape
    B = slot_ids.shape[0]
    t_ten, t_val, t_stride = _build.int_arg("search_gather", t, B)
    rows = torch.empty((B, M), dtype=torch.int32, device=ts.device)
    out_pay = torch.empty((B,), dtype=torch.int32, device=ts.device)
    found = torch.empty((B,), dtype=torch.bool, device=ts.device)
    err = _build.lib().mvgc_search_gather(
        ts.data_ptr(), payload.data_ptr(), values.data_ptr(),
        slot_ids.data_ptr(), None if t_ten is None else t_ten.data_ptr(),
        t_val, t_stride, rows.data_ptr(), out_pay.data_ptr(),
        found.data_ptr(), S, V, T, M, B, _build.stream())
    _build.check("mvgc_search_gather", err)
    search_gather.launches += 1
    return rows, out_pay, found


@cost.charged("view", lambda ts, tables, slot_ids, **_: cost.view_cost(
    slot_ids.shape[0], ts.shape[1], tables.shape[1], slot_ids.shape[0]))
def view(ts: torch.Tensor, payload: torch.Tensor, tables: torch.Tensor,
         lengths: torch.Tensor, slot_ids: torch.Tensor, t
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(page_table[B, MP], lengths[B])`` of the snapshot at ``t``: the
    table row and length of the version ``search(t)`` resolves per slot;
    NO_PAGE (-1) rows and length 0 where nothing was found (see
    :func:`repro_torch.kernels.version_search.ref.view_ref`).  One launch,
    one allocation, no host sync."""
    if is_fake(ts):
        B, MP = slot_ids.shape[0], tables.shape[1]
        out = ts.new_empty((B * MP + B,))
        return out[:B * MP].view(B, MP), out[B * MP:]
    if ts.device.type == "cpu":
        return view_ref(ts, payload, tables, lengths, slot_ids, t)
    _check_slab(ts, payload, slot_ids)
    _build.require_cuda_i32("view", tables, lengths)
    S, V = ts.shape
    T, MP = tables.shape
    B = slot_ids.shape[0]
    if lengths.shape != (T,):
        raise ValueError("view: lengths must be i32[T] beside tables "
                         "i32[T, MP]")
    t_ten, t_val, t_stride = _build.int_arg("version_search", t, B)
    out = torch.empty((B * MP + B,), dtype=torch.int32, device=ts.device)
    vec = MP % 4 == 0 and tables.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    err = _build.lib().mvgc_view(
        ts.data_ptr(), payload.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), slot_ids.data_ptr(),
        None if t_ten is None else t_ten.data_ptr(), t_val, t_stride,
        out.data_ptr(), out.data_ptr() + 4 * B * MP, S, V, T, MP, B,
        int(vec), _build.stream())
    _build.check("mvgc_view", err)
    view.launches += 1
    search_gather.launches += 1
    return out[:B * MP].view(B, MP), out[B * MP:]


search.launches = 0
value_at.launches = 0
search_gather.launches = 0
view.launches = 0
