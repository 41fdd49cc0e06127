"""Plain PyTorch version of version_search: batched ``search(t)`` over the
version slabs, with and without the value-row gather (port of
``repro.kernels.version_search.ref``), and the snapshot view built on it
(``view_ref``: the composite ``paged.snapshot_view`` ran before the view
kernel).

``t`` is a Python int, a 0-d tensor or one timestamp per query (``[B]``).
Slot ids follow JAX's gather rule: ``[-S, 0)`` wraps to ``id + S`` and an
id still out of range is clamped into ``[0, S)``.  ``slot_ids=None``
queries every slot (query ``q`` is slot ``q``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch._tensor import gather_index

EMPTY = -1
NEG_INF_I32 = -2_147_483_648


def search_ref(ts: torch.Tensor, payload: torch.Tensor,
               slot_ids: Optional[torch.Tensor], t
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(payload[B], found[B]): latest version with ts <= t per queried slot
    (masked argmax over V; the first index wins a tie, as ``jnp.argmax``)."""
    if slot_ids is None:
        slot_ids = torch.arange(ts.shape[0], device=ts.device)
    sid = gather_index(slot_ids, ts.shape[0])
    rows_ts = ts[sid]
    t_col = t[:, None] if torch.is_tensor(t) and t.dim() == 1 else t
    ok = (rows_ts != EMPTY) & (rows_ts <= t_col)
    idx = torch.where(ok, rows_ts, NEG_INF_I32).argmax(dim=1)
    found = ok.any(dim=1)
    pay = torch.gather(payload[sid], 1, idx[:, None])[:, 0]
    return torch.where(found, pay, EMPTY), found


def value_at_ref(ts: torch.Tensor, payload: torch.Tensor,
                 slot_ids: Optional[torch.Tensor], t) -> torch.Tensor:
    """i32[B]: the payload :func:`search_ref` resolves, 0 where nothing was
    found."""
    pay, found = search_ref(ts, payload, slot_ids, t)
    return torch.where(found, pay, 0)


def search_gather_ref(ts: torch.Tensor, payload: torch.Tensor,
                      values: torch.Tensor, slot_ids: torch.Tensor,
                      t: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(rows[B, M], payload[B], found[B])``: search(t), then the value row
    the resolved payload indexes; not-found rows are EMPTY-filled."""
    pay, found = search_ref(ts, payload, slot_ids, t)
    safe = pay.clamp(0, values.shape[0] - 1).long()
    rows = torch.where(found[:, None], values[safe], EMPTY)
    return rows, pay, found


def view_ref(ts: torch.Tensor, payload: torch.Tensor, tables: torch.Tensor,
             lengths: torch.Tensor, slot_ids: torch.Tensor, t
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(page_table[B, MP], lengths[B])``: search(t) per slot, then the
    resolved version's table row and length; NO_PAGE (-1) rows and length
    0 where nothing was found.  The length rides along as an extra value
    column, as the JAX ``snapshot_view`` gathers it."""
    MP = tables.shape[1]
    values = torch.cat([tables, lengths[:, None]], dim=1)
    rows, _, found = search_gather_ref(ts, payload, values, slot_ids, t)
    return rows[:, :MP].contiguous(), torch.where(found, rows[:, MP], 0)
