"""Version slabs: the structure-of-arrays version store (port of
``repro.core.mvgc.pool``).

Each versioned object (a *slot*, e.g. a sequence's page table) owns a row of
``V`` entries ``(ts, succ, payload)``; ``succ`` is the timestamp at which the
version was overwritten (``TS_MAX`` while current) and ``ts == EMPTY`` marks
a free entry.  All arrays are int32 ``[S, V]``, exactly the JAX layout, and
every function returns new tensors (the store is small next to the pages it
governs).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch._tensor import (I32, DeviceLike, drop_rows, gather_index,
                                 put_rows, resolve_device)

TS_MAX = 2_147_483_647  # "current version" successor / padding
EMPTY = -1


class VersionStore(NamedTuple):
    """[S, V] version slabs.  Entry invalid iff ts == EMPTY."""

    ts: torch.Tensor        # i32[S, V]  version timestamp (EMPTY = free entry)
    succ: torch.Tensor      # i32[S, V]  successor timestamp (TS_MAX = current)
    payload: torch.Tensor   # i32[S, V]  opaque handle (e.g. page index)


def make_store(num_slots: int, versions_per_slot: int,
               device: DeviceLike = None) -> VersionStore:
    dev = resolve_device(device)
    shape = (num_slots, versions_per_slot)
    return VersionStore(
        ts=torch.full(shape, EMPTY, dtype=I32, device=dev),
        succ=torch.full(shape, TS_MAX, dtype=I32, device=dev),
        payload=torch.full(shape, EMPTY, dtype=I32, device=dev),
    )


def valid_mask(store: VersionStore) -> torch.Tensor:
    return store.ts != EMPTY


def occupancy(store: VersionStore) -> torch.Tensor:
    """Versions currently held per slot: i32[S]."""
    return valid_mask(store).sum(dim=1, dtype=I32)


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` of a bool ``[..., V]`` mask along the last axis: the
    first True index, 0 where the row has none (torch's argmax takes no
    bool and returns int64)."""
    return mask.to(I32).argmax(dim=-1).to(I32)


def current_index(store: VersionStore) -> torch.Tensor:
    """Index (into V) of the current version per slot; -1 if slot empty."""
    cur = (store.succ == TS_MAX) & valid_mask(store)
    return torch.where(cur.any(dim=1), first_true(cur), EMPTY)


def write(
    store: VersionStore,
    slot_ids: torch.Tensor,   # i32[B] distinct slots to write this step
    new_ts,                   # i32[] or i32[B] timestamp of the new versions
    payloads: torch.Tensor,   # i32[B] payload handles for the new versions
    write_mask: torch.Tensor,  # bool[B] lanes actually writing
) -> Tuple[VersionStore, torch.Tensor]:
    """Append one new version to each masked slot; the overwritten current
    version's interval closes at ``new_ts``.  Returns (store', overflow[B]):
    a lane overflows when its slot's slab has no free entry.  Masked slot
    ids must be unique (one writer per object per step).  Ids follow JAX's
    rules: ``[-S, 0)`` wraps, the rows of ids still out of range are read
    clamped and their writes dropped."""
    S, V = store.ts.shape
    B = slot_ids.shape[0]
    new_ts = torch.as_tensor(new_ts, dtype=I32, device=store.ts.device)
    new_ts = new_ts.expand(B)
    sid = gather_index(slot_ids, S)
    rows_ts = store.ts[sid]               # [B, V]
    rows_succ = store.succ[sid]
    rows_valid = rows_ts != EMPTY

    free = ~rows_valid
    has_free = free.any(dim=1)
    ins = first_true(free)                # first free position
    overflow = write_mask & ~has_free
    do = write_mask & has_free            # lanes that actually append

    is_cur = (rows_succ == TS_MAX) & rows_valid
    rows_succ = torch.where(is_cur & do[:, None], new_ts[:, None], rows_succ)

    cols = torch.arange(V, dtype=I32, device=ins.device)
    onehot = (cols[None, :] == ins[:, None]) & do[:, None]
    rows_ts = torch.where(onehot, new_ts[:, None], rows_ts)
    rows_succ = torch.where(onehot, TS_MAX, rows_succ)
    rows_pay = torch.where(onehot, payloads.to(I32)[:, None],
                           store.payload[sid])

    dest = drop_rows(slot_ids, do, S)
    new_store = VersionStore(
        ts=put_rows(store.ts, dest, rows_ts),
        succ=put_rows(store.succ, dest, rows_succ),
        payload=put_rows(store.payload, dest, rows_pay),
    )
    return new_store, overflow


def _pick(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(rows, 1, idx.long()[:, None])[:, 0]


def read_at(
    store: VersionStore,
    slot_ids: torch.Tensor,  # i32[B]
    t,                       # i32[] or i32[B] snapshot timestamps
) -> Tuple[torch.Tensor, torch.Tensor]:
    """search(t): latest version with ts <= t.  Returns (payload[B],
    found[B]) by a masked argmax over the V-wide slab."""
    B = slot_ids.shape[0]
    t = torch.as_tensor(t, dtype=I32, device=store.ts.device).expand(B)
    sid = gather_index(slot_ids, store.ts.shape[0])
    rows_ts = store.ts[sid]
    ok = (rows_ts != EMPTY) & (rows_ts <= t[:, None])
    masked = torch.where(ok, rows_ts, -2_147_483_648)
    idx = masked.argmax(dim=1)
    found = ok.any(dim=1)
    payload = _pick(store.payload[sid], idx)
    return torch.where(found, payload, EMPTY), found


def read_current(store: VersionStore, slot_ids: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """peekHead: payload of the current version per queried slot."""
    sid = gather_index(slot_ids, store.ts.shape[0])
    cur = (store.succ[sid] == TS_MAX) & (store.ts[sid] != EMPTY)
    found = cur.any(dim=1)
    payload = _pick(store.payload[sid], first_true(cur))
    return torch.where(found, payload, EMPTY), found


def epoch_kill_mask(store: VersionStore, bound) -> torch.Tensor:
    """bool[S, V]: entries whose interval closed at or before ``bound`` —
    the EBR epoch-quiescence splice set."""
    return (store.succ <= bound) & (store.ts != EMPTY)


def free_entries(store: VersionStore, kill: torch.Tensor) -> VersionStore:
    """Free every entry where kill[S, V] is True (the splice)."""
    return VersionStore(
        ts=torch.where(kill, EMPTY, store.ts),
        succ=torch.where(kill, TS_MAX, store.succ),
        payload=torch.where(kill, EMPTY, store.payload),
    )
