"""Plain PyTorch version of version_search: batched ``search(t)`` over the
version slabs, with and without the value-row gather (port of
``repro.kernels.version_search.ref``)."""
from __future__ import annotations

from typing import Tuple

import torch

EMPTY = -1
NEG_INF_I32 = -2_147_483_648


def search_ref(ts: torch.Tensor, payload: torch.Tensor,
               slot_ids: torch.Tensor, t: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(payload[B], found[B]): latest version with ts <= t per queried slot
    (masked argmax over V; the first index wins a tie, as ``jnp.argmax``)."""
    sid = slot_ids.long()
    rows_ts = ts[sid]
    ok = (rows_ts != EMPTY) & (rows_ts <= t[:, None])
    idx = torch.where(ok, rows_ts, NEG_INF_I32).argmax(dim=1)
    found = ok.any(dim=1)
    pay = torch.gather(payload[sid], 1, idx[:, None])[:, 0]
    return torch.where(found, pay, EMPTY), found


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
