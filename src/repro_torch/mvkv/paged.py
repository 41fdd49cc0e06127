"""Multiversioned paged KV cache: COW page tables over a shared page pool
(port of ``repro.mvkv.paged``).

KV lives in fixed-size pages of a pool; each sequence's page table is a
versioned object whose versions live in a dense ``tables[MAX_VER, MP]``
array indexed by the descriptor payloads.  Every append commits a new
table version; snapshot readers resolve a pinned timestamp to a table
version (``snapshot_view``, one launch of the version-search view); a
page is recycled only when no live table version references it.

The page pool (``k_pages``/``v_pages``, gigabytes at serving size) is
updated **in place** by ``append_tokens`` and ``fork_sequence``: the
returned state shares those tensors with the one passed in, so a caller
must not read pages through a pre-op state afterwards.  Every other field
is a new tensor per op, as in JAX.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch._tensor import (I32, DeviceLike, i32_or_int, masked_rows,
                                 masked_set, put_rows, resolve_device)
from repro_torch.core.mvgc import vstore
from repro_torch.core.mvgc.pool import EMPTY
from repro_torch.core.telemetry import GCConfig, PressureSignal
from repro_torch.kernels.version_search import ops as search_ops

NO_PAGE = -1


class PagedKV(NamedTuple):
    k_pages: torch.Tensor     # [N, PS, Hkv, D] page pool
    v_pages: torch.Tensor     # [N, PS, Hkv, D]
    free: torch.Tensor        # bool[N]  (True = free)
    tables: torch.Tensor      # i32[MAX_VER, MP] page-table versions
    table_free: torch.Tensor  # bool[MAX_VER] free page-table slots
    lengths: torch.Tensor     # i32[MAX_VER] tokens covered by each version
    mv: vstore.MVState        # descriptor store: slot=sequence, payload=table

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[1]

    @property
    def max_pages(self) -> int:
        return self.tables.shape[1]


def make_paged_kv(num_seqs: int, num_pages: int, page_size: int,
                  max_pages_per_seq: int, kv_heads: int, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16, *,
                  gc: Optional[GCConfig] = None,
                  device: DeviceLike = None) -> PagedKV:
    """An empty paged-KV state on ``device``; GC sizing comes from ``gc``.
    The retire ring defaults to twice the table versions, so pressure
    flushes never drop a retire record."""
    dev = resolve_device(device)
    cfg = gc if gc is not None else GCConfig()
    max_ver = num_seqs * cfg.versions_per_slot
    ring = cfg.ring_capacity if cfg.ring_capacity > 0 else max(16, 2 * max_ver)
    pool_shape = (num_pages, page_size, kv_heads, head_dim)
    return PagedKV(
        k_pages=torch.zeros(pool_shape, dtype=dtype, device=dev),
        v_pages=torch.zeros(pool_shape, dtype=dtype, device=dev),
        free=torch.ones((num_pages,), dtype=torch.bool, device=dev),
        tables=torch.full((max_ver, max_pages_per_seq), NO_PAGE, dtype=I32,
                          device=dev),
        table_free=torch.ones((max_ver,), dtype=torch.bool, device=dev),
        lengths=torch.zeros((max_ver,), dtype=I32, device=dev),
        mv=vstore.make_state(num_seqs, cfg.versions_per_slot,
                             cfg.reader_lanes, ring_capacity=ring,
                             device=dev),
    )


def _alloc(free: torch.Tensor, want: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-match allocation: the i-th wanting lane gets the i-th free slot.
    Returns (new_free, slot_ids[K] (-1 where failed), ok[K])."""
    n = free.shape[0]
    arange = torch.arange(n, dtype=I32, device=free.device)
    pos = torch.sort(torch.where(free, arange, n)).values
    rank = torch.cumsum(want.to(I32), dim=0, dtype=I32) - 1
    ok = want & (rank < free.sum(dtype=I32))
    slots = torch.where(ok, pos[rank.clamp(max=n - 1).long()], -1)
    return masked_set(free, slots, False, ok), slots, ok


def _lanes(mask: torch.Tensor) -> torch.Tensor:
    """Indices of the True lanes (one host sync): the in-place pool writes
    touch only these, since torch has no drop mode."""
    return mask.nonzero().squeeze(1)


def _recycle(table_free: torch.Tensor, slots: torch.Tensor,
             freed: torch.Tensor, give_back: torch.Tensor) -> torch.Tensor:
    """Hand back table slots of lanes whose descriptor append overflowed,
    then the table slots of every collected descriptor version."""
    table_free = masked_set(table_free, slots, True, give_back)
    freed = freed.reshape(-1)
    return masked_set(table_free, freed, True, freed != EMPTY)


def append_tokens(
    st: PagedKV,
    seq_ids: torch.Tensor,    # i32[B] sequences receiving one token each
    k_new: torch.Tensor,      # [B, Hkv, D]
    v_new: torch.Tensor,      # [B, Hkv, D]
    mask: torch.Tensor,       # bool[B]
    gc_policy: str = "slrt",
    extra_pins: Optional[torch.Tensor] = None,
) -> Tuple[PagedKV, torch.Tensor]:
    """One decode step: write each masked sequence's token into its current
    page (a fresh page at a page boundary) and commit a new page-table
    version.  Returns (state', failed[B]); a lane fails when the page pool,
    the table pool or its descriptor slab cannot take the append.  The
    token is written into the pool in place."""
    PS, MP = st.page_size, st.max_pages
    B = seq_ids.shape[0]

    cur_tbl, has = vstore.current_read(st.mv, seq_ids)
    cur_safe = torch.where(has, cur_tbl, 0).long()
    lengths = torch.where(has, st.lengths[cur_safe], 0)
    page_idx = torch.div(lengths, PS, rounding_mode="floor")
    off = lengths - page_idx * PS
    pcol = page_idx.clamp(max=MP - 1).long()
    needs_page = (off == 0) & mask

    new_free, pages, got_page = _alloc(st.free, needs_page)
    page_of = torch.where(needs_page, pages, st.tables[cur_safe, pcol])
    ok = mask & torch.where(needs_page, got_page, page_of >= 0) \
        & (page_idx < MP)

    # write the token into (page_of, off), in place
    sel = _lanes(ok)
    dst_page, dst_off = page_of[sel].long(), off[sel].long()
    st.k_pages[dst_page, dst_off] = k_new[sel].to(st.k_pages.dtype)
    st.v_pages[dst_page, dst_off] = v_new[sel].to(st.v_pages.dtype)

    # every ok lane commits a NEW table version (COW row copy; fresh
    # sequences start from an all-NO_PAGE row)
    tf, tslots, got_tbl = _alloc(st.table_free, ok)
    commit = ok & got_tbl
    old_rows = torch.where(has[:, None], st.tables[cur_safe], NO_PAGE)
    lane = torch.arange(B, device=old_rows.device)
    new_rows = old_rows.clone()
    new_rows[lane, pcol] = torch.where(needs_page & commit, page_of,
                                       old_rows[lane, pcol])
    dest = masked_rows(tslots, commit, st.tables.shape[0])
    tables = put_rows(st.tables, dest, new_rows)
    lengths_arr = put_rows(st.lengths, dest, lengths + 1)

    mv, freed, ovf = vstore.write_step(st.mv, seq_ids, tslots, commit,
                                       policy=gc_policy,
                                       extra_pins=extra_pins)
    table_free = _recycle(tf, tslots, freed, commit & ovf)
    free_pages = _sweep_unreferenced(tables, table_free, new_free)
    st2 = PagedKV(st.k_pages, st.v_pages, free_pages, tables, table_free,
                  lengths_arr, mv)
    return st2, mask & ~(commit & ~ovf)


def reset_sequence(
    st: PagedKV,
    seq_ids: torch.Tensor,    # i32[B] sequence slots being recycled
    mask: torch.Tensor,       # bool[B]
    gc_policy: str = "slrt",
    extra_pins: Optional[torch.Tensor] = None,
) -> Tuple[PagedKV, torch.Tensor]:
    """Sequence completion: commit an empty table version (no pages, zero
    length).  The old pages stay pinned by the stale versions until the GC
    policy collects them.  Returns (state', failed[B])."""
    B = seq_ids.shape[0]
    tf, tslots, got = _alloc(st.table_free, mask)
    ok = mask & got
    empty_rows = torch.full((B, st.max_pages), NO_PAGE, dtype=I32,
                            device=st.tables.device)
    dest = masked_rows(tslots, ok, st.tables.shape[0])
    tables = put_rows(st.tables, dest, empty_rows)
    lengths_arr = put_rows(st.lengths, dest, 0)
    mv, freed, ovf = vstore.write_step(st.mv, seq_ids, tslots, ok,
                                       policy=gc_policy,
                                       extra_pins=extra_pins)
    table_free = _recycle(tf, tslots, freed, ok & ovf)
    free_pages = _sweep_unreferenced(tables, table_free, st.free)
    st2 = PagedKV(st.k_pages, st.v_pages, free_pages, tables, table_free,
                  lengths_arr, mv)
    return st2, mask & ~(ok & ~ovf)


def fork_sequence(
    st: PagedKV,
    src_ids: torch.Tensor,    # i32[B] parent sequences
    dst_ids: torch.Tensor,    # i32[B] child sequence slots
    mask: torch.Tensor,       # bool[B]
    gc_policy: str = "slrt",
    extra_pins: Optional[torch.Tensor] = None,
    copy_pages: bool = False,
) -> Tuple[PagedKV, torch.Tensor]:
    """COW fork: the child's first table version shares every full page of
    the parent's current version and gets a copy of a partial last page.
    ``copy_pages=True`` is the eager-copy control: every page the parent
    covers is copied.  Copies are written into the pool in place.  Returns
    (state', failed[B])."""
    PS, MP = st.page_size, st.max_pages
    B = src_ids.shape[0]
    src_tbl, has = vstore.current_read(st.mv, src_ids)
    src_safe = torch.where(has, src_tbl, 0).long()
    src_len = torch.where(has, st.lengths[src_safe], 0)
    page_idx = torch.div(src_len, PS, rounding_mode="floor")
    off = src_len - page_idx * PS
    pcol = page_idx.clamp(max=MP - 1).long()

    if copy_pages:
        n_used = torch.div(src_len + PS - 1, PS, rounding_mode="floor")
        cols = torch.arange(MP, dtype=I32, device=src_len.device)
        want2d = (cols[None, :] < n_used[:, None]) & (mask & has)[:, None]
        free2, cflat, got = _alloc(st.free, want2d.reshape(-1))
        got2d = got.reshape(B, MP)
        lane_ok = mask & has & (got2d | ~want2d).all(dim=1)
        tf, tslots, got_t = _alloc(st.table_free, lane_ok)
        ok = lane_ok & got_t
        # hand back pages allocated for lanes that did not fully make it
        giveback = got & ~ok.repeat_interleave(MP)
        free2 = masked_set(free2, cflat, True, giveback)
        do_copy2d = want2d & ok[:, None]
        rows = torch.where(do_copy2d, cflat.reshape(B, MP), NO_PAGE)
        src_flat = st.tables[src_safe].clamp(min=0).reshape(-1)
        sel = _lanes(do_copy2d.reshape(-1))
        dst, src = cflat[sel].long(), src_flat[sel].long()
    else:
        needs_copy = mask & has & (off > 0)
        free2, cpages, got_page = _alloc(st.free, needs_copy)
        ok0 = mask & has & (~needs_copy | got_page)
        tf, tslots, got = _alloc(st.table_free, ok0)
        ok = ok0 & got
        rows = torch.where(ok[:, None], st.tables[src_safe], NO_PAGE)
        do_copy = needs_copy & ok
        lane = torch.arange(B, device=rows.device)
        rows[lane, pcol] = torch.where(do_copy, cpages, rows[lane, pcol])
        src_page = st.tables[src_safe, pcol].clamp(min=0)
        sel = _lanes(do_copy)
        dst, src = cpages[sel].long(), src_page[sel].long()
    # sources are live pages and destinations freshly allocated ones, so
    # the gather on the right reads the pre-fork content
    st.k_pages[dst] = st.k_pages[src]
    st.v_pages[dst] = st.v_pages[src]

    dest = masked_rows(tslots, ok, st.tables.shape[0])
    tables = put_rows(st.tables, dest, rows)
    lengths_arr = put_rows(st.lengths, dest, src_len)
    mv, freed, ovf = vstore.write_step(st.mv, dst_ids, tslots, ok,
                                       policy=gc_policy,
                                       extra_pins=extra_pins)
    table_free = _recycle(tf, tslots, freed, ok & ovf)
    free_pages = _sweep_unreferenced(tables, table_free, free2)
    st2 = PagedKV(st.k_pages, st.v_pages, free_pages, tables, table_free,
                  lengths_arr, mv)
    return st2, mask & ~(ok & ~ovf)


# ---------------------------------------------------------------------------
# Pressure path: pool watermark -> hot sequences -> reclaim
# ---------------------------------------------------------------------------
def page_pressure(st: PagedKV, watermark: float = 0.25) -> PressureSignal:
    """Free pages under ``watermark`` of the pool = pressure; the deficit
    is in pages."""
    n = st.free.shape[0]
    lo = max(1, int(watermark * n))
    free = st.free.sum(dtype=I32)
    return PressureSignal(
        level=1.0 - free.float() / n,
        under_pressure=free < lo,
        deficit=(lo - free).clamp(min=0),
        live=n - free,
        capacity=torch.tensor(n, dtype=I32, device=free.device),
    )


def hot_sequences(st: PagedKV, k: int) -> torch.Tensor:
    """Sequences holding the most live descriptor versions."""
    return vstore.hot_slots(st.mv, k)


def _after_collect(st: PagedKV, mv: vstore.MVState, freed: torch.Tensor
                   ) -> Tuple[PagedKV, torch.Tensor]:
    """Recycle the table slots of collected versions, sweep the pages no
    live table references; returns (state', pages_freed)."""
    freed = freed.reshape(-1)
    table_free = masked_set(st.table_free, freed, True, freed != EMPTY)
    free_pages = _sweep_unreferenced(st.tables, table_free, st.free)
    pages_freed = free_pages.sum(dtype=I32) - st.free.sum(dtype=I32)
    return st._replace(mv=mv, table_free=table_free, free=free_pages), \
        pages_freed


def reclaim_on_pressure(st: PagedKV, hot_keys: torch.Tensor, deficit,
                        gc_policy: str = "slrt", extra_pins=None,
                        ckpt_max=None) -> Tuple[PagedKV, torch.Tensor]:
    """Synchronous page reclamation: hot-sequence-first descriptor
    compaction, table-slot recycling, then the reachability sweep.
    Returns (state', pages_freed)."""
    mv, freed, _ = vstore.reclaim_on_pressure(
        st.mv, hot_keys, deficit, policy=gc_policy, extra_pins=extra_pins,
        ckpt_max=ckpt_max)
    return _after_collect(st, mv, freed)


def evict_checkpointed(st: PagedKV, ckpt_max, extra_pins=None
                       ) -> Tuple[PagedKV, torch.Tensor, torch.Tensor]:
    """The sole-survivor rule at page granularity.  Returns (state',
    pages_freed, versions_evicted)."""
    mv, freed, n_ev = vstore.evict_checkpointed(st.mv, ckpt_max, extra_pins)
    st, pages_freed = _after_collect(st, mv, freed)
    return st, pages_freed, n_ev


def _sweep_unreferenced(tables: torch.Tensor, table_free: torch.Tensor,
                        page_free: torch.Tensor) -> torch.Tensor:
    """A page is live iff a live table version references it: bool[N]
    free map (True = free)."""
    n_pages = page_free.shape[0]
    refs = torch.where(table_free[:, None], NO_PAGE, tables).reshape(-1)
    referenced = masked_set(
        torch.zeros((n_pages,), dtype=torch.bool, device=refs.device),
        refs, True, refs >= 0)
    return ~referenced


def snapshot_view(st: PagedKV, seq_ids: torch.Tensor, t
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve a pinned timestamp to (page_table[B, MP], lengths[B]) with
    one launch of the view kernel, which reads the resolved version's table
    row and length straight from ``tables`` and ``lengths``.  Not-found
    rows are NO_PAGE with length 0 — ready for
    :func:`repro_torch.kernels.decode_attention.ops.paged_decode`.  ``t``
    is a Python int (passed to the kernel by value) or an int32 tensor,
    0-d or one per sequence."""
    return search_ops.view(st.mv.store.ts, st.mv.store.payload, st.tables,
                           st.lengths, seq_ids.to(I32).contiguous(),
                           i32_or_int(t, st.tables.device))


def _one_lane(lane, like: torch.Tensor) -> torch.Tensor:
    return torch.atleast_1d(torch.as_tensor(lane, dtype=I32,
                                            device=like.device))


def begin_snapshot(st: PagedKV, lane) -> Tuple[PagedKV, torch.Tensor]:
    lanes = _one_lane(lane, st.free)
    mv, ts = vstore.begin_snapshot(st.mv, lanes,
                                   torch.ones_like(lanes, dtype=torch.bool))
    return st._replace(mv=mv), ts[0]


def end_snapshot(st: PagedKV, lane) -> PagedKV:
    lanes = _one_lane(lane, st.free)
    mv = vstore.end_snapshot(st.mv, lanes,
                             torch.ones_like(lanes, dtype=torch.bool))
    return st._replace(mv=mv)


def live_pages(st: PagedKV) -> torch.Tensor:
    return (~st.free).sum(dtype=I32)
