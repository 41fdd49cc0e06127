"""The port's CUDA kernels and engine on the card (marker ``gpu``).

Each kernel against its plain PyTorch version on the same CUDA tensors, at
ragged and edge shapes the serving run does not reach, the serve_bench
storm trace on the card against the same trace on the CPU, the model
engine (``MVServeEngine``) at reduced size on the card against the CPU, and
the sharded engine's global-LWM pin through K1 and a 4-host trace on the
card against the CPU, and the rank programs of ``tests/_torch_ranks.py``
on 4 gloo ranks on the card (the engine over meshes of 2 and 4 ranks,
the pipeline, the 2 x 2 sharded step and data parallelism) against the
one-process port on the card, and the placed serve step's combines over
``model`` (the sequence-split decode's softmax, the vocab-shard argmax)
on thread ranks against the one-rank code.  These tests
need a GPU and ``nvcc``; without a card they skip.  Run them on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.ckpt.manager import tree_flatten
from repro_torch.configs import SHAPES, reduced_config
from repro_torch.configs.base import RunConfig
from repro_torch.convert import to_numpy
from repro_torch.core.mvgc.needed import sort_announcements
from repro_torch.core.telemetry import GCConfig
from repro_torch.dist import ShardedPagedKVEngine
from repro_torch.kernels.compact import ops as compact_ops
from repro_torch.kernels.compact.ref import compact_ref, needed_ref, sweep_ref
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import paged_decode_ref
from repro_torch.kernels.flash_prefill import ops as flash_ops
from repro_torch.kernels.flash_prefill.ref import (_p_dx, _products,
                                                   attention_bwd_ref,
                                                   attention_lse_ref,
                                                   attention_ref,
                                                   bwd_bf16_margin,
                                                   fwd_f32_rounding)
from repro_torch.kernels.version_search import ops as search_ops
from repro_torch.kernels.version_search.ref import (search_gather_ref,
                                                     search_ref, value_at_ref,
                                                     view_ref)
from repro_torch.models import transformer as tf
from repro_torch.mvkv import paged
from repro_torch.serve.engine import MVServeEngine, PagedKVEngine

pytestmark = pytest.mark.gpu
EMPTY, TS_MAX = -1, 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    return torch.device("cuda")


def slabs(rng, R, V):
    ts = rng.integers(0, 60, (R, V)).astype(np.int32)
    succ = (ts + rng.integers(1, 12, (R, V))).astype(np.int32)
    succ[rng.random((R, V)) < 0.3] = TS_MAX
    free = rng.random((R, V)) < 0.3
    ts[free], succ[free] = EMPTY, TS_MAX
    pay = np.where(free, EMPTY, rng.integers(0, 500, (R, V))).astype(np.int32)
    return ts, succ, pay


@pytest.mark.parametrize("R,V,P", [(1, 1, 1), (257, 5, 3), (1000, 16, 64),
                                   (4096, 8, 3000)])
def test_compact_kernel(cuda, R, V, P):
    rng = np.random.default_rng(R + V + P)
    ts, succ, pay = slabs(rng, R, V)
    ann = np.sort(np.where(rng.random(P) < 0.3, TS_MAX,
                           rng.integers(0, 70, P))).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda) for x in
            (ts, succ, pay, rng.random(R) < 0.7, ann)]
    args.append(torch.tensor(40, dtype=torch.int32, device=cuda))
    got = compact_ops.compact(*args)
    want = compact_ref(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("P", [1, 16, 1024])
@pytest.mark.parametrize("V", [1, 8, 16])
@pytest.mark.parametrize("S", [1, 333, 4097])
def test_needed_kernel(cuda, S, V, P):
    """K5 against needed_ref at ragged S: EMPTY entries, TS_MAX padding,
    duplicate announcements."""
    rng = np.random.default_rng(S * V + P)
    ts, succ, _ = slabs(rng, S, V)
    ann = np.where(rng.random(P) < 0.3, TS_MAX, rng.integers(0, 70, P))
    ann[: P // 3] = ann[P - 1]
    ann = np.sort(ann).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda) for x in (ts, succ, ann)]
    args.append(torch.tensor(40, dtype=torch.int32, device=cuda))
    before = compact_ops.needed.launches
    got = compact_ops.needed(*args)
    assert compact_ops.needed.launches == before + 1
    assert got.dtype == torch.bool and got.shape == (S, V)
    assert torch.equal(got, needed_ref(*args))


def test_needed_kernel_on_an_empty_slab(cuda):
    ts = torch.full((300, 8), EMPTY, dtype=torch.int32, device=cuda)
    succ = torch.full((300, 8), TS_MAX, dtype=torch.int32, device=cuda)
    ann = torch.tensor([3, 9, TS_MAX], dtype=torch.int32, device=cuda)
    got = compact_ops.needed(ts, succ, ann, 5)
    assert not bool(got.any())
    assert torch.equal(got, needed_ref(ts, succ, ann, 5))


def test_board_above_the_shared_memory_copy_raises(cuda):
    """A board of 12289 announcements, one past the 12288 that the kernels
    once staged in 48 KB of shared memory and refused above (no board is
    refused now): K5 and K1's parity op run on it, equal to their plain
    versions, as does the board of 12288."""
    ts = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    ann = torch.full((12 * 1024 + 1,), TS_MAX, dtype=torch.int32,
                     device=cuda)
    now = torch.tensor(1, dtype=torch.int32, device=cuda)
    mask = torch.ones(4, dtype=torch.bool, device=cuda)
    for board in (ann, ann[:12 * 1024]):
        assert torch.equal(compact_ops.needed(ts, ts, board, now),
                           needed_ref(ts, ts, board, now))
        for a, b in zip(compact_ops.compact(ts, ts, ts, mask, board, now),
                        compact_ref(ts, ts, ts, mask, board, now)):
            assert torch.equal(a, b)


#: boards past the old 12288-entry limit: one past it (staged in opt-in
#: shared memory), 60000 (past the H100's 227 KB opt-in: searched in
#: global memory) and 2^20
LARGE_BOARDS = [12 * 1024 + 1, 60000, 1 << 20]


def _large_board(rng, P):
    """A sorted board of P entries with duplicates and TS_MAX padding;
    its live entries at or after now (40) and below the slabs' largest
    ts, so that it pins some closed versions and leaves others free."""
    ann = np.where(rng.random(P) < 0.3, TS_MAX, rng.integers(40, 70, P))
    ann[: P // 3] = ann[P - 1]
    return np.sort(ann).astype(np.int32)


def _needed_chunked(ts, succ, ann, now):
    """``needed_ref`` over row chunks (it broadcasts over the board)."""
    rows = max(1, 2**26 // (ts.shape[1] * ann.shape[0]))
    return torch.cat([needed_ref(ts[i:i + rows], succ[i:i + rows], ann, now)
                      for i in range(0, ts.shape[0], rows)])


@pytest.mark.parametrize("P", LARGE_BOARDS)
def test_k1_k5_on_boards_past_the_old_limit(cuda, P):
    """K1's sweep (lanes and every slot) and parity op, and K5 on both of
    its layouts (one entry per thread, and runs of 4 at 135168 entries),
    on boards of 12289, 60000 and 2^20 announcements: exactly their
    plain versions, ``now`` on the card and by value."""
    rng = np.random.default_rng(P)
    ann = torch.from_numpy(_large_board(rng, P)).to(cuda)
    now = torch.tensor(40, dtype=torch.int32, device=cuda)
    # K5, both layouts (the wide one from kRun * SMs * 256 entries)
    for S, V in ((333, 5), (16896, 8)):
        ts, succ, _ = (torch.from_numpy(x).to(cuda) for x in slabs(rng, S,
                                                                    V))
        want = _needed_chunked(ts, succ, ann, 40)
        for t in (40, now):
            assert torch.equal(compact_ops.needed(ts, succ, ann, t), want)
    # K1: the sweep over lanes and over every slot, and the parity op
    S, V, R = 64, 8, 300
    ts, succ, pay = (torch.from_numpy(x).to(cuda) for x in slabs(rng, S, V))
    ids = torch.from_numpy(rng.integers(0, S, R).astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random(R) < 0.8).to(cuda)
    for lanes in ((ids, mask), (None, None)):
        want = sweep_ref(ts, succ, pay, *lanes, ann, now)
        for t in (now, 40):
            got = compact_ops.sweep(ts, succ, pay, *lanes, ann, t)
            for a, b in zip(got, want, strict=True):
                assert torch.equal(a, b)
        assert bool((want[3] != EMPTY).any()), "the sweep freed nothing"
    rows = torch.from_numpy(rng.random(S) < 0.7).to(cuda)
    for a, b in zip(compact_ops.compact(ts, succ, pay, rows, ann, now),
                    compact_ref(ts, succ, pay, rows, ann, now)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S,V,B,M", [(3, 1, 1, 1), (40, 8, 77, 33),
                                     (9, 40, 300, 257)])
def test_search_kernels(cuda, S, V, B, M):
    rng = np.random.default_rng(S * V + B)
    ts = np.full((S, V), EMPTY, np.int32)
    for s in range(S):
        n = int(rng.integers(0, V + 1))
        ts[s, rng.permutation(V)[:n]] = rng.permutation(100)[:n]
    pay = np.where(ts == EMPTY, EMPTY, rng.integers(0, 50, (S, V))
                   ).astype(np.int32)
    values = rng.integers(-1, 99, (50, M)).astype(np.int32)
    ids = rng.integers(0, S, B).astype(np.int32)
    t = rng.integers(-1, 110, B).astype(np.int32)
    ts, pay, values, ids, t = (torch.from_numpy(x).to(cuda)
                               for x in (ts, pay, values, ids, t))
    for a, b in zip(search_ops.search(ts, pay, ids, t),
                    search_ref(ts, pay, ids, t)):
        assert torch.equal(a, b)
    for a, b in zip(search_ops.search_gather(ts, pay, values, ids, t),
                    search_gather_ref(ts, pay, values, ids, t)):
        assert torch.equal(a, b)


SWEEP_CASES = {
    # name: (S, V, R, P); R = 0: every slot swept (no lanes, no mask)
    "phase5_flush": (256, 8, 4096, 16),   # the slrt flush at phase 5
    "phase5_every_slot": (256, 8, 0, 16),
    "ragged": (333, 5, 77, 3),            # S*V, R*V not multiples of 256
    "ragged_every_slot": (333, 5, 0, 3),
    "fewer_lanes": (1000, 16, 100, 64),   # R < S
    "duplicates": (7, 3, 1000, 2),        # each slot named by ~140 lanes
    "all_false": (300, 8, 500, 5),
    "one_version": (1000, 1, 3000, 7),    # a slab block spans 256 slots
    "largest_board": (64, 8, 300, 12 * 1024),  # board above 48 KB of smem
}


def sweep_inputs(cuda, case):
    """Slabs with EMPTY entries and EMPTY rows, a sorted board with TS_MAX
    padding, lane ids with duplicates and about 20 % unmasked lanes
    clamped onto slot 0 (ring holes)."""
    S, V, R, P = SWEEP_CASES[case]
    rng = np.random.default_rng(S + V + R + P)
    ts, succ, pay = slabs(rng, S, V)
    gone = rng.random(S) < 0.1
    ts[gone], succ[gone], pay[gone] = EMPTY, TS_MAX, EMPTY
    # the largest board pins only at or after now (40), or it would pin
    # every closed version and the case would free nothing
    low = 40 if case == "largest_board" else 0
    ann = np.sort(np.where(rng.random(P) < 0.3, TS_MAX,
                           rng.integers(low, 70, P))).astype(np.int32)
    ids = mask = None
    if R:
        ids = rng.integers(0, S, R).astype(np.int32)
        mask = rng.random(R) < 0.8
        if case == "all_false":
            mask[:] = False
        ids[~mask] = 0
        ids, mask = (torch.from_numpy(x).to(cuda) for x in (ids, mask))
    slab = [torch.from_numpy(x).to(cuda) for x in (ts, succ, pay)]
    return (*slab, ids, mask, torch.from_numpy(ann).to(cuda),
            torch.tensor(40, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("case", sorted(SWEEP_CASES))
def test_sweep_kernel(cuda, case):
    """K1's one-launch sweep against ``sweep_ref`` (gathers + compact +
    masked scatters), exactly, with ``now`` on the device and by value."""
    args = sweep_inputs(cuda, case)
    want = sweep_ref(*args)
    before = (compact_ops.compact.launches, compact_ops.sweep.launches)
    for now in (args[-1], 40):
        got = compact_ops.sweep(*args[:-1], now)
        assert [x.shape for x in got] == [x.shape for x in want]
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b)
    assert (compact_ops.compact.launches, compact_ops.sweep.launches) == \
        (before[0] + 2, before[1] + 2)
    if case != "all_false":
        assert bool((want[3] != EMPTY).any()), "the sweep freed nothing"


def test_sweep_with_no_lanes_changes_nothing(cuda):
    """R = 0 lanes: the slab comes back unchanged and nothing is freed (an
    empty lane batch is not the every-slot sweep)."""
    ts, succ, pay, _, _, ann, now = sweep_inputs(cuda, "ragged")
    ids = torch.zeros((0,), dtype=torch.int32, device=cuda)
    mask = torch.zeros((0,), dtype=torch.bool, device=cuda)
    got = compact_ops.sweep(ts, succ, pay, ids, mask, ann, now)
    for a, b in zip(got, sweep_ref(ts, succ, pay, ids, mask, ann, now),
                    strict=True):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(got, (ts, succ, pay)))
    assert got[3].shape == (0,)


VIEW_CASES = [
    # S, V, B, T, MP, t's form
    (256, 8, 256, 2048, 256, "int"),      # phase 5's view
    (256, 8, 256, 2048, 256, "[B]"),
    (9, 40, 300, 50, 257, "0-d"),         # V > 32, MP % 4 != 0
    (40, 8, 77, 120, 5, "[B]"),
    (3, 1, 1, 4, 4, "int"),
    (40, 8, 77, 120, 8, "unaligned"),     # tables not 16-byte aligned
]


@pytest.mark.parametrize("S,V,B,T,MP,form", VIEW_CASES)
def test_view_kernel(cuda, S, V, B, T, MP, form):
    """K2's one-launch view against ``view_ref`` (cat + search_gather +
    slice + where), exactly: NO_PAGE padding, not-found rows of length 0,
    found payloads clamped into [0, T)."""
    rng = np.random.default_rng(S * V + B + MP)
    ts = np.full((S, V), EMPTY, np.int32)
    for s in range(S):
        n = int(rng.integers(0, V + 1))
        ts[s, rng.permutation(V)[:n]] = rng.permutation(100)[:n]
    pay = np.where(ts == EMPTY, EMPTY, rng.integers(0, T + 3, (S, V))
                   ).astype(np.int32)
    tables = np.where(rng.random((T, MP)) < 0.3, -1,
                      rng.integers(0, 9999, (T, MP))).astype(np.int32)
    lengths = rng.integers(0, 999, T).astype(np.int32)
    ids = rng.integers(0, S, B).astype(np.int32)
    tq = rng.integers(-1, 110, B).astype(np.int32)
    ts, pay, lengths, ids, tq = (torch.from_numpy(x).to(cuda)
                                 for x in (ts, pay, lengths, ids, tq))
    flat = torch.from_numpy(tables.reshape(-1)).to(cuda)
    if form == "unaligned":
        flat = torch.cat([flat[:1], flat])[1:]
        assert flat.data_ptr() % 16 != 0
    tables = flat.view(T, MP)
    t = {"int": 50, "0-d": torch.tensor(50, dtype=torch.int32, device=cuda),
         "[B]": tq, "unaligned": tq}[form]
    before = (search_ops.search_gather.launches, search_ops.view.launches)
    got = search_ops.view(ts, pay, tables, lengths, ids, t)
    want = view_ref(ts, pay, tables, lengths, ids, t)
    assert (search_ops.search_gather.launches, search_ops.view.launches) == \
        (before[0] + 1, before[1] + 1)
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape and a.is_contiguous()
        assert torch.equal(a, b)
    if B > 1:                       # not-found rows and padding present
        assert bool((got[1] == 0).any()) and bool((got[0] == -1).any())


def device_kernels(fn):
    """Names of the device kernels one call of ``fn`` runs (profiler).
    Under pytest a capture now and then holds no device record at all,
    for any op (about one in 60 on an H100); such a capture says nothing
    of the call, so it is taken again, up to 5 times.  A call that
    launches nothing still returns no name."""
    from torch.profiler import ProfilerActivity, profile
    fn()                                   # builds the library, warms up
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if str(e.device_type).endswith("CUDA")]
        if names:
            break
    return names


def test_sweep_runs_one_device_kernel(cuda):
    args = sweep_inputs(cuda, "phase5_flush")
    names = device_kernels(lambda: compact_ops.sweep(*args))
    assert len(names) == 1 and "sweep_kernel" in names[0]


def test_view_runs_one_device_kernel(cuda):
    ts, succ, pay = (torch.from_numpy(x).to(cuda) for x in
                     slabs(np.random.default_rng(0), 256, 8))
    tables = torch.full((2048, 256), -1, dtype=torch.int32, device=cuda)
    lengths = torch.zeros(2048, dtype=torch.int32, device=cuda)
    ids = torch.arange(256, dtype=torch.int32, device=cuda)
    names = device_kernels(lambda: search_ops.view(ts, pay, tables, lengths,
                                                   ids, 30))
    assert len(names) == 1 and "view_kernel" in names[0]


def test_snapshot_view_runs_one_device_kernel(cuda):
    """``paged.snapshot_view`` with int32 ids and a Python-int t: one
    launch, no fill for t, no copy of the tables."""
    st = paged.make_paged_kv(4, 16, 2, 4, 1, 4, dtype=torch.float32,
                             gc=GCConfig(versions_per_slot=4,
                                         reader_lanes=2), device=cuda)
    ids = torch.arange(4, dtype=torch.int32, device=cuda)
    kv = torch.ones((4, 1, 4), device=cuda)
    for _ in range(3):
        st, _ = paged.append_tokens(st, ids, kv, kv, ids < 3)
    t = int(st.mv.now)
    names = device_kernels(lambda: paged.snapshot_view(st, ids, t))
    assert len(names) == 1 and "view_kernel" in names[0]
    tbl, lens = paged.snapshot_view(st, ids, t)
    assert lens.tolist() == [3, 3, 3, 0]


# ---------------------------------------------------------------------------
# trap C6: JAX's index rules on the card (wrap [-n, 0), then clamp or drop)
# ---------------------------------------------------------------------------
NEG_IDS = [-1, 0, -7, 3, 7, -8, 1000, -1000, 2, -2]   # over S = 7 slots


def test_sweep_kernel_negative_and_out_of_range_lanes(cuda):
    """K1's sweep against ``sweep_ref`` on lane ids -1, -S (slot 0), ids
    still out of range (read clamped, written nowhere) and in-range ids,
    with and without a mask."""
    rng = np.random.default_rng(6)
    S, V = 7, 4
    ts, succ, pay = (torch.from_numpy(x).to(cuda) for x in slabs(rng, S, V))
    ids = torch.tensor(NEG_IDS, dtype=torch.int32, device=cuda)
    ann = torch.tensor([5, 33, TS_MAX], dtype=torch.int32, device=cuda)
    for mask in (torch.ones(len(NEG_IDS), dtype=torch.bool, device=cuda),
                 torch.from_numpy(rng.random(len(NEG_IDS)) < 0.6).to(cuda)):
        got = compact_ops.sweep(ts, succ, pay, ids, mask, ann, 40)
        want = sweep_ref(ts, succ, pay, ids, mask, ann, 40)
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b)
    assert bool((got[3] != EMPTY).any())


@pytest.mark.parametrize("op", ["search", "value_at", "search_gather", "view"])
def test_search_kernels_negative_and_out_of_range_ids(cuda, op):
    """K3's ops and K2's against their plain versions on ids that wrap
    (-1, -S) and ids still out of range (clamped into [0, S)): no kernel
    reads outside the slab."""
    rng = np.random.default_rng(7)
    S, V, T, MP = 7, 8, 30, 12
    ts = np.full((S, V), EMPTY, np.int32)
    for s in range(S):
        n = int(rng.integers(1, V + 1))
        ts[s, rng.permutation(V)[:n]] = rng.permutation(60)[:n]
    pay = np.where(ts == EMPTY, EMPTY, rng.integers(0, T, (S, V))
                   ).astype(np.int32)
    tables = rng.integers(-1, 999, (T, MP)).astype(np.int32)
    lengths = rng.integers(0, 99, T).astype(np.int32)
    ts, pay, tables, lengths = (torch.from_numpy(x).to(cuda)
                                for x in (ts, pay, tables, lengths))
    ids = torch.tensor(NEG_IDS, dtype=torch.int32, device=cuda)
    for t in (40, torch.from_numpy(rng.integers(-1, 70, len(NEG_IDS)).astype(
            np.int32)).to(cuda)):
        fn, ref, extra = {
            "search": (search_ops.search, search_ref, ()),
            "value_at": (search_ops.value_at, value_at_ref, ()),
            "search_gather": (search_ops.search_gather, search_gather_ref,
                              (torch.cat([tables, lengths[:, None]], 1),)),
            "view": (search_ops.view, view_ref, (tables, lengths)),
        }[op]
        got = fn(ts, pay, *extra, ids, t)
        torch.cuda.synchronize()
        want = ref(ts, pay, *extra, ids, t)
        for a, b in zip(as_tuple(got), as_tuple(want), strict=True):
            assert torch.equal(a, b)


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


# ---------------------------------------------------------------------------
# K3: value_at / search at the group sizes' edges
# ---------------------------------------------------------------------------
def k3_slab(rng, S, V, ties=True, empty_rows=True):
    """Slabs with EMPTY entries, EMPTY rows and (``ties``) equal
    timestamps in one row, which the first index must win."""
    ts = np.full((S, V), EMPTY, np.int32)
    for s in range(S):
        n = int(rng.integers(0, V + 1))
        ts[s, rng.permutation(V)[:n]] = rng.integers(0, 50, n)
    if ties and V > 1:
        ts[::3, :] = rng.integers(0, 50)        # a whole row of one value
    if empty_rows:
        ts[1::5] = EMPTY
    pay = np.where(ts == EMPTY, EMPTY, rng.integers(0, 9999, (S, V))
                   ).astype(np.int32)
    return torch.from_numpy(ts), torch.from_numpy(pay)


@pytest.mark.parametrize("B", [1, 5, 31, 257])
@pytest.mark.parametrize("V", [1, 3, 8, 16, 32, 40])
def test_k3_group_edges(cuda, V, B):
    """K3 at V in {1, 3, 8, 16, 32} (a group of 1, 4, 8, 16 or 32 lanes;
    40: a group of 32 that loops) and B not a multiple of the queries per
    warp, with ties, EMPTY rows and not-found queries: ``search`` and
    ``value_at`` equal their plain versions, with ``t`` by value, 0-d and
    per query, one launch counted per call."""
    rng = np.random.default_rng(V * 1000 + B)
    S = 37
    ts, pay = (x.to(cuda) for x in k3_slab(rng, S, V))
    ids = torch.from_numpy(rng.integers(-S, S, B).astype(np.int32)).to(cuda)
    tq = torch.from_numpy(rng.integers(-1, 60, B).astype(np.int32)).to(cuda)
    before = (search_ops.search.launches, search_ops.value_at.launches)
    for t in (25, torch.tensor(25, dtype=torch.int32, device=cuda), tq):
        got = search_ops.search(ts, pay, ids, t)
        want = search_ref(ts, pay, ids, t)
        for a, b in zip(got, want, strict=True):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a, b)
        assert torch.equal(search_ops.value_at(ts, pay, ids, t),
                           torch.where(want[1], want[0], 0))
    assert (search_ops.search.launches, search_ops.value_at.launches) == \
        (before[0] + 6, before[1] + 3)


@pytest.mark.parametrize("S,V,B", [(37, 3, 31), (256, 8, 256),
                                   (65536, 8, 8192), (40, 40, 5)])
def test_k3_runs_one_device_kernel(cuda, S, V, B):
    """``search`` (ids, per-query t) and ``value_at`` (every slot, t by
    value): one device kernel per call, by the profiler."""
    ts, pay = (x.to(cuda) for x in k3_slab(np.random.default_rng(S), S, V))
    ids = torch.arange(B, dtype=torch.int32, device=cuda) % S
    tq = torch.full((B,), 30, dtype=torch.int32, device=cuda)
    for fn in (lambda: search_ops.search(ts, pay, ids, tq),
               lambda: search_ops.value_at(ts, pay, None, 30)):
        names = device_kernels(fn)
        assert len(names) == 1 and "search_kernel" in names[0]


@pytest.mark.parametrize("S,V", [(1, 1), (37, 3), (256, 8), (1000, 16),
                                 (65536, 8)])
def test_k3_every_slot_mode_equals_explicit_ids(cuda, S, V):
    """``slot_ids=None`` queries every slot: the same bits as explicit
    ids ``arange(S)``, on the card and against the plain version."""
    rng = np.random.default_rng(S + V)
    ts, pay = (x.to(cuda) for x in k3_slab(rng, S, V))
    ids = torch.arange(S, dtype=torch.int32, device=cuda)
    for t in (30, torch.from_numpy(rng.integers(-1, 60, S).astype(
            np.int32)).to(cuda)):
        every = search_ops.value_at(ts, pay, None, t)
        assert torch.equal(every, search_ops.value_at(ts, pay, ids, t))
        assert torch.equal(every, value_at_ref(ts, pay, None, t))
        for a, b in zip(search_ops.search(ts, pay, None, t),
                        search_ops.search(ts, pay, ids, t), strict=True):
            assert torch.equal(a, b)


def test_k3_callers_equal_the_composite_they_replaced(cuda):
    """``snapshot_lengths`` / ``lengths_at`` (one ``value_at`` launch)
    against the composite they ran before: ``search`` over ``arange`` ids,
    then ``where(found, lens, 0)``; and phase 5's every-slot
    ``snapshot_read`` against explicit ids."""
    from repro_torch.core.mvgc import vstore
    from repro_torch.serve import engine as serve_engine
    cfg = reduced_config("minitron-4b")
    run = RunConfig(model=cfg, shape=SHAPES["decode_32k"],
                    versions_per_slot=4, reader_lanes=4)
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(1))
    eng = MVServeEngine(cfg, run, params, batch=4, max_len=32, device=cuda)
    eng.prefill(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 8)))
    pins = [eng.pin(0)]
    for _ in range(5):
        eng.step()
        pins.append(int(eng.state.mv.now))
    ids = torch.arange(4, dtype=torch.int32, device=cuda)
    for t in [0, *pins]:
        pay, found = vstore.snapshot_read(eng.state.mv, ids, t)
        old = torch.where(found, pay, 0)
        before = search_ops.value_at.launches
        assert torch.equal(serve_engine.snapshot_lengths(eng.state, t), old)
        assert torch.equal(eng.lengths_at(t), old)
        assert search_ops.value_at.launches == before + 2
        for a, b in zip(vstore.snapshot_read(eng.state.mv, None, t),
                        (pay, found), strict=True):
            assert torch.equal(a, b)
    names = device_kernels(lambda: eng.lengths_at(pins[-1]))
    assert len(names) == 1 and "search_kernel" in names[0]


# ---------------------------------------------------------------------------
# K5: runs of 4 entries, the Eytzinger board, packed stores
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P", [1, 16, 33, 1024, 12 * 1024])
@pytest.mark.parametrize("S,V", [(1, 1), (3, 5), (4097, 16), (45057, 3),
                                 (65536, 8), (200003, 8)])
def test_k5_run_and_board_edges(cuda, S, V, P):
    """K5's two layouts at every board size: one entry per thread and a
    sorted board (1, 15 and 65552 entries), runs of 4 and an Eytzinger
    board (135171 entries: a ragged last run; 524288; 1600024: more runs
    than the grid holds at once, so blocks stride); boards of 1 to 12288
    entries (the largest Eytzinger board above 48 KB of shared memory)
    with duplicates and TS_MAX padding: equal to ``needed_ref``, ``now``
    by value and on the card."""
    rng = np.random.default_rng(S * V + P)
    ts, succ, _ = slabs(rng, S, V)
    ann = np.where(rng.random(P) < 0.3, TS_MAX, rng.integers(0, 70, P))
    ann[: P // 3] = ann[P - 1]                       # duplicates
    ann = torch.from_numpy(np.sort(ann).astype(np.int32)).to(cuda)
    ts, succ = (torch.from_numpy(x).to(cuda) for x in (ts, succ))
    rows = max(1, 2**26 // (V * P))        # needed_ref broadcasts over P
    want = torch.cat([needed_ref(ts[i:i + rows], succ[i:i + rows], ann, 40)
                      for i in range(0, S, rows)])
    for now in (40, torch.tensor(40, dtype=torch.int32, device=cuda)):
        got = compact_ops.needed(ts, succ, ann, now)
        assert got.dtype == torch.bool and got.shape == (S, V)
        assert torch.equal(got, want)


@pytest.mark.parametrize("S,V,P", [(3, 5, 1), (4096, 8, 16),
                                   (65536, 8, 256), (32768, 16, 1024),
                                   (64, 8, 12 * 1024)])
def test_k5_runs_one_device_kernel(cuda, S, V, P):
    """One device kernel per ``needed`` call, by the profiler, at an edge
    shape, phase 3's three shapes and the largest board."""
    ts, succ, _ = (torch.from_numpy(x).to(cuda)
                   for x in slabs(np.random.default_rng(P), S, V))
    ann = torch.sort(torch.randint(0, 70, (P,), dtype=torch.int32,
                                   device=cuda)).values
    names = device_kernels(lambda: compact_ops.needed(ts, succ, ann, 40))
    assert len(names) == 1 and "needed_kernel" in names[0]


def test_k5_unaligned_inputs_take_the_scalar_path(cuda):
    """Views that start off a 16-byte boundary, large enough for runs of
    4: the kernel reads and writes them one entry at a time, with the same
    result."""
    rng = np.random.default_rng(9)
    ts, succ, _ = slabs(rng, 40001, 8)
    ts, succ = (torch.from_numpy(x).to(cuda).reshape(-1) for x in (ts, succ))
    ts_u = ts[1:320001].view(40000, 8)
    succ_u = succ[3:320003].view(40000, 8)
    assert ts_u.data_ptr() % 16 and succ_u.data_ptr() % 16
    ann = torch.tensor([4, 4, 30, 52, TS_MAX], dtype=torch.int32,
                       device=cuda)
    assert torch.equal(compact_ops.needed(ts_u, succ_u, ann, 40),
                       needed_ref(ts_u, succ_u, ann, 40))


# both versions sum in float32 in another order; a bf16 output may round to
# the neighbouring bf16 value, one step of 2**-7 relative
DECODE_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
              torch.bfloat16: dict(atol=4e-3, rtol=2**-7)}


def decode_inputs(cuda, dtype, Hq, Hkv, D, PS, MP, B=7, N=64, lengths=None):
    """A snapshot-view-shaped table: distinct pages, -1 past each length,
    row 0 of length 0 (random lengths unless ``lengths`` is given)."""
    rng = np.random.default_rng(Hq + D + PS)
    if lengths is None:
        lengths = rng.integers(0, MP * PS + 1, B).astype(np.int32)
        lengths[0] = 0
    lengths = np.asarray(lengths, np.int32)
    B = len(lengths)
    table = np.full((B, MP), -1, np.int32)
    pages = rng.permutation(N)
    cursor = 0
    for b in range(B):
        n = -(-int(lengths[b]) // PS)
        table[b, :n] = pages[cursor:cursor + n]
        cursor += n
    gen = torch.Generator(device=cuda).manual_seed(0)
    kp = torch.randn((N, PS, Hkv, D), generator=gen, device=cuda, dtype=dtype)
    vp = torch.randn((N, PS, Hkv, D), generator=gen, device=cuda, dtype=dtype)
    q = torch.randn((B, Hq, D), generator=gen, device=cuda, dtype=dtype)
    table, lengths = (torch.from_numpy(x).to(cuda) for x in (table, lengths))
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D,PS,MP", [(1, 1, 16, 4, 3),
                                            (6, 2, 64, 8, 5),
                                            (24, 8, 128, 16, 9)])
def test_paged_decode_kernel(cuda, dtype, Hq, Hkv, D, PS, MP):
    q, kp, vp, table, lengths = decode_inputs(cuda, dtype, Hq, Hkv, D, PS, MP)
    got = decode_ops.paged_decode(q, kp, vp, table, lengths)
    want = paged_decode_ref(q, kp, vp, table, lengths)
    assert torch.allclose(got.float(), want.float(), **DECODE_TOL[dtype])
    assert bool((got[0] == 0).all())
    assert torch.equal(got, decode_ops.paged_decode(q, kp, vp, table,
                                                    lengths))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_marks_a_corrupt_view_nan(cuda, dtype):
    """A table entry inside the length that names no page (-1 or >= N)
    turns that sequence's output to NaN; the other rows are untouched."""
    q, kp, vp, table, lengths = decode_inputs(cuda, dtype, 6, 2, 64, 8, 5)
    good = decode_ops.paged_decode(q, kp, vp, table, lengths)
    rows = torch.nonzero(lengths > 0).squeeze(1)[:2].tolist()
    assert len(rows) == 2
    bad = table.clone()
    bad[rows[0], 0] = -1
    bad[rows[1], (int(lengths[rows[1]]) - 1) // 8] = kp.shape[0]
    got = decode_ops.paged_decode(q, kp, vp, bad, lengths)
    assert bool(got[rows].isnan().all())
    keep = torch.ones(len(lengths), dtype=torch.bool, device=cuda)
    keep[rows] = False
    assert torch.equal(got[keep], good[keep])


def split_edges(cuda, B, Hq, Hkv, PS, MP):
    """K4's split of a page table of MP pages for a batch of B, and the
    lengths at its edges: 0, 1, PS - 1, exactly one chunk, one past it,
    the start of the last split and the full MP * PS."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n_split = decode_ops.split_plan(B, Hq, Hkv, PS, MP, sms)
    chunk = -(-MP // n_split)
    edges = [0, 1, PS - 1, chunk * PS, chunk * PS + 1,
             (n_split - 1) * chunk * PS + 1, MP * PS]
    return n_split, chunk, edges


def check_decode(q, kp, vp, table, lengths, dtype):
    got = decode_ops.paged_decode(q, kp, vp, table, lengths)
    want = paged_decode_ref(q, kp, vp, table, lengths)
    assert torch.allclose(got.float(), want.float(), **DECODE_TOL[dtype])
    assert bool((got[lengths == 0] == 0).all())
    assert torch.equal(got, decode_ops.paged_decode(q, kp, vp, table,
                                                    lengths)), \
        "two calls gave different bits"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("MP", [16, 64])
def test_paged_decode_split_edges_batch_of_one(cuda, dtype, MP):
    """A batch of one sequence takes many splits: of one page each at
    MP = 16, of several at MP = 64 (two on a 132-SM H100); each length at
    a split edge, one call at a time."""
    Hq, Hkv, D, PS = 24, 8, 128, 16
    n_split, chunk, edges = split_edges(cuda, 1, Hq, Hkv, PS, MP)
    assert n_split > 8
    assert (chunk == 1) == (MP == 16)
    for n in edges:
        check_decode(*decode_inputs(cuda, dtype, Hq, Hkv, D, PS, MP, N=80,
                                    lengths=[n]), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D,PS", [(24, 8, 128, 16), (6, 2, 64, 8),
                                         (4, 4, 20, 4)])
def test_paged_decode_split_edges_in_one_batch(cuda, dtype, Hq, Hkv, D, PS):
    MP = 64
    n_split, chunk, edges = split_edges(cuda, 7, Hq, Hkv, PS, MP)
    assert n_split > 1 and chunk > 1
    check_decode(*decode_inputs(cuda, dtype, Hq, Hkv, D, PS, MP, N=512,
                                lengths=edges), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bad_page", [-1, 512])
def test_paged_decode_corrupt_entry_in_the_last_split(cuda, dtype, bad_page):
    """A corrupt entry that only the last split reads still turns all
    heads of its sequence to NaN, and leaves the other rows as they were."""
    Hq, Hkv, D, PS, MP = 6, 2, 64, 8, 64
    n_split, chunk, _ = split_edges(cuda, 3, Hq, Hkv, PS, MP)
    assert n_split > 1
    q, kp, vp, table, lengths = decode_inputs(
        cuda, dtype, Hq, Hkv, D, PS, MP, N=512, lengths=[MP * PS, 100, 0])
    good = decode_ops.paged_decode(q, kp, vp, table, lengths)
    bad = table.clone()
    bad[0, MP - 1] = bad_page
    got = decode_ops.paged_decode(q, kp, vp, bad, lengths)
    assert bool(got[0].isnan().all())
    assert torch.equal(got[1:], good[1:])
    assert torch.equal(got.isnan(), decode_ops.paged_decode(
        q, kp, vp, bad, lengths).isnan())


def storm(device, policy):
    B, steps = 8, 60
    eng = PagedKVEngine(B, 24, 4, 3, 1, 4,
                        gc=GCConfig(policy=policy, versions_per_slot=6,
                                    reader_lanes=4),
                        device=device)
    rng = np.random.default_rng(0)
    targets = rng.integers(4, 13, B)
    cur = np.zeros(B, np.int64)
    ids = torch.arange(B, dtype=torch.int32)
    log = []
    for step in range(steps):
        kv = torch.full((B, 1, 4), float(step))
        failed = eng.step(ids, kv, kv, torch.ones(B, dtype=torch.bool))
        cur += ~failed.cpu().numpy()
        done = cur >= targets
        if done.any():
            eng.reset(ids, done)
            cur[done] = 0
        if step % 5 == 0:
            ts = eng.pin(step % 4)
            log.append(to_numpy(eng.view_at(ts)[0]).tolist())
            eng.unpin(step % 4)
        log.append(eng.freed_pages())
    return eng, log


def leaves(x):
    if isinstance(x, tuple):
        return [leaf for v in x for leaf in leaves(v)]
    return [x]


@pytest.mark.parametrize("policy", ["ebr", "steam", "dlrt", "slrt", "sweep"])
def test_engine_on_the_card_matches_the_cpu(cuda, policy):
    g, g_log = storm(cuda, policy)
    c, c_log = storm("cpu", policy)
    assert g_log == c_log
    assert g.space() == c.space()
    for a, b in zip(leaves(to_numpy(g.st)), leaves(to_numpy(c.st)),
                    strict=True):
        np.testing.assert_array_equal(a, b)


def test_bf16_engine_checkpoint_restores_bit_equal(cuda, tmp_path):
    """A bf16 PagedKVEngine on the card, with forks and pressure, saved and
    restored into a fresh engine on the card (and one on the CPU): every
    leaf bit-equal, the host-side state equal, and the same next steps."""
    def engine(device):
        return PagedKVEngine(6, 24, 4, 4, 2, 8,
                             gc=GCConfig(policy="slrt", versions_per_slot=4,
                                         reader_lanes=2),
                             dtype=torch.bfloat16, device=device)

    eng = engine(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    ids = torch.arange(6, dtype=torch.int32, device=cuda)
    one = torch.ones(1, dtype=torch.bool, device=cuda)
    for step in range(30):
        kv = torch.randn((6, 2, 8), generator=gen, device=cuda,
                         dtype=torch.bfloat16)
        eng.step(ids, kv, kv, (ids < 2) | (ids == step % 6))
        if step % 7 == 3:
            eng.fork(ids[:1], ids[2 + step % 4:3 + step % 4], one)
    eng.pin(1)
    assert eng.forks > 0 and eng.pages_reclaimed > 0
    eng.checkpoint(str(tmp_path))
    fresh, host = engine(cuda), engine("cpu")
    fresh.restore(str(tmp_path))
    host.restore(str(tmp_path))
    for e in (fresh, host):
        for a, b in zip(leaves(eng.st), leaves(e.st), strict=True):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
        assert (e.stats, e.dag, e._freed_pages, e.ckpt_max) == \
            (eng.stats, eng.dag, eng._freed_pages, eng.ckpt_max)
    for _ in range(5):
        kv = torch.randn((6, 2, 8), generator=gen, device=cuda,
                         dtype=torch.bfloat16)
        ones = torch.ones(6, dtype=torch.bool, device=cuda)
        assert torch.equal(eng.step(ids, kv, kv, ones),
                           fresh.step(ids, kv, kv, ones))
        assert eng.freed_pages() == fresh.freed_pages()
    for a, b in zip(leaves(eng.st), leaves(fresh.st), strict=True):
        assert torch.equal(a, b)


# K6 against its plain version within DECODE_TOL: both compute in float32
# and sum in other orders.  A bf16 output may round to the neighbouring
# bf16 value, which rtol = 2**-7 allows (K6's largest bf16 differences on
# an H100 are one such step, above the atol).  The float32 cases, at 1e-5,
# run the split-TF32 route; both routes' masks are pinned exactly by the
# marker tests below them
FLASH_CASES = [
    # B, Hq, Hkv, T, S, D, causal, window, softcap
    (2, 24, 8, 256, 256, 128, True, 0, 0.0),     # minitron-4b heads
    (1, 8, 4, 300, 300, 256, True, 64, 50.0),    # gemma2-2b local layer
    (2, 3, 1, 200, 200, 64, True, 0, 0.0),       # ragged T, G = 3
    (2, 2, 2, 77, 77, 16, True, 5, 0.0),         # reduced widths
    (1, 4, 1, 65, 65, 96, False, 0, 30.0),       # non-causal, odd D
    (1, 2, 1, 100, 70, 32, True, 0, 0.0),        # S < T
    (1, 2, 1, 90, 40, 32, True, 8, 0.0),         # rows that see nothing
    (1, 2, 2, 1, 1, 8, True, 0, 0.0),
    # edges of the bf16 kernel's 128-row query and 128/64-column KV tiles
    (1, 2, 1, 129, 129, 128, True, 0, 0.0),
    (1, 2, 1, 255, 255, 128, True, 0, 0.0),
    (1, 2, 1, 1000, 1000, 128, True, 0, 0.0),
    (1, 4, 2, 300, 300, 256, True, 200, 50.0),   # window across 64 columns
    (1, 2, 1, 100, 300, 64, False, 0, 0.0),      # S > T, every column
    (1, 2, 1, 100, 300, 64, True, 0, 0.0),       # S > T, causal
    (1, 4, 2, 150, 150, 20, True, 0, 0.0),       # bf16 D padded to 24
    (4, 8, 2, 640, 640, 128, True, 0, 0.0),      # 160 blocks > 132 SMs
    # edges of the float32 kernel's 64-row query tiles, its 32-column KV
    # steps (taken in turn by two warpgroups) and its head dim padded to
    # 64, 128 or 256 (D not a multiple of 32)
    (1, 2, 1, 64, 64, 128, True, 0, 0.0),        # one query tile
    (1, 2, 1, 65, 65, 256, True, 0, 50.0),       # a tile and one row
    (1, 2, 1, 64, 33, 64, False, 0, 0.0),        # S a column past a step
    (1, 2, 1, 64, 32, 64, False, 0, 0.0),        # one step: warpgroup 1 idle
    (1, 4, 2, 96, 96, 96, True, 32, 0.0),        # D 96, a window of a step
    (2, 3, 3, 200, 200, 20, True, 33, 30.0),     # D 20, window past a step
]


def flash_inputs(cuda, dtype, B, Hq, Hkv, T, S, D, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=cuda, dtype=dtype)
            for shape in ((B, Hq, T, D), (B, Hkv, S, D), (B, Hkv, S, D))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,T,S,D,causal,window,cap", FLASH_CASES)
def test_flash_prefill_kernel(cuda, dtype, B, Hq, Hkv, T, S, D, causal,
                              window, cap):
    q, k, v = flash_inputs(cuda, dtype, B, Hq, Hkv, T, S, D)
    kw = dict(causal=causal, window=window, softcap=cap)
    before = flash_ops.flash_attention.launches
    got = flash_ops.flash_attention(q, k, v, **kw)
    assert flash_ops.flash_attention.launches == before + 1
    want = attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.allclose(got.float(), want.float(), **DECODE_TOL[dtype])
    assert torch.equal(got, flash_ops.flash_attention(q, k, v, **kw)), \
        "two calls gave different bits"


# K6 on whisper-tiny's heads as a rank of a 2 x 2 mesh runs them: 3 of its
# 6 heads of 64, bidirectional, its encoder layer over the 1500 frames and
# its cross-attention over them (the training step's 448 rows, the
# prefill's 64 and a decode step's one); one sequence a data rank in
# training, 8 at serve time
WHISPER_LOCAL_FLASH = [
    # B, Hq, Hkv, T, S
    (1, 3, 3, 1500, 1500),
    (8, 3, 3, 1500, 1500),
    (1, 3, 3, 448, 1500),
    (8, 3, 3, 64, 1500),
    (8, 3, 3, 1, 1500),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,T,S", WHISPER_LOCAL_FLASH)
def test_flash_prefill_whisper_local_heads(cuda, dtype, B, Hq, Hkv, T, S):
    """K6 non-causal on 3 of whisper-tiny's 6 heads (D 64), as an encoder
    layer (T = S = 1500) and as cross-attention, against its plain
    version within DECODE_TOL, in both routes."""
    q, k, v = flash_inputs(cuda, dtype, B, Hq, Hkv, T, S, 64)
    kw = dict(causal=False, window=0, softcap=0.0)
    before = flash_ops.flash_attention.launches
    got = flash_ops.flash_attention(q, k, v, **kw)
    assert flash_ops.flash_attention.launches == before + 1
    want = attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.allclose(got.float(), want.float(), **DECODE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 200])
def test_flash_prefill_softcap_bends_the_logits(cuda, dtype, window):
    """gemma2-2b's layer shape with q scaled by 12: the logits q.k/sqrt(D)
    are about N(0, 12^2), so the cap of 50 bends them (randn's N(0, 1)
    logits move by under 0.006 under it, which no tolerance here sees).
    The kernel must agree with the capped answer and the uncapped plain
    version must not, which shows the check sees the cap.  The bf16 route
    is held to the capped plain version: DECODE_TOL plus what rounding P
    to bf16 can move an output by, 2**-8 of sum_j p_j |v_j| (the plain
    version on |V|).  The float32 route is held to the exact answer (the
    plain version on float64 copies) within ref.fwd_f32_rounding, the
    limit derived from float32's rounding at these logits: at them the
    float32 plain version is itself about twice DECODE_TOL[float32] from
    the exact answer, so no evaluation that does not repeat its sums
    meets DECODE_TOL against it
    (tests/test_torch_f32_limit.py shows the limit passing float32
    evaluations and failing one missing a correction product)."""
    q, k, v = flash_inputs(cuda, dtype, 1, 8, 4, 512, 512, 256, seed=3)
    q = q * 12.0
    kw = dict(causal=True, window=window, softcap=50.0)
    got = flash_ops.flash_attention(q, k, v, **kw).float()
    if dtype == torch.float32:
        want = attention_ref(q.double(), k.double(), v.double(), **kw)
        limit = fwd_f32_rounding(q, k, v, **kw)
    else:
        want = attention_ref(q, k, v, **kw).float()
        tol = DECODE_TOL[dtype]
        limit = (tol["atol"] + tol["rtol"] * want.abs()
                 + 2**-8 * attention_ref(q, k, v.abs(), **kw).float())
    assert bool(((got - want).abs() <= limit).all())
    uncapped = attention_ref(q, k, v, **dict(kw, softcap=0.0)).float()
    assert not bool(((uncapped - want).abs() <= limit).all())


def masked_attention(q, k, v, mask, softcap=0.0):
    """Attention in float32 under an explicit [T, S] mask (True: seen)."""
    G = q.shape[1] // k.shape[1]
    logits = torch.einsum("bhtd,bhsd->bhts", q.float(),
                          k.float().repeat_interleave(G, 1)) \
        / math.sqrt(q.shape[-1])
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    p = torch.softmax(logits.masked_fill(~mask, -math.inf), -1)
    return torch.einsum("bhts,bhsd->bhtd", p.nan_to_num(nan=0.0),
                        v.float().repeat_interleave(G, 1))


def marked_values(cuda, Hkv, S, D):
    """V with one marker per key: 64 at dim ``j % D`` of key ``j``, else 0,
    so each seen key carries its weight into a dim of its own."""
    v = torch.zeros((1, Hkv, S, D), device=cuda)
    j = torch.arange(S, device=cuda)
    v[:, :, j, j % D] = 64.0
    return v.bfloat16()


def routed_call(q, k, v, **kw):
    """K6 on q's dtype's route, which must launch once."""
    route = flash_ops.ROUTES[q.dtype]
    before = flash_ops.flash_attention.route_launches[route]
    got = flash_ops.flash_attention(q, k, v, **kw)
    assert flash_ops.flash_attention.route_launches[route] == before + 1
    return got.float()


def mask_edges_exactly(cuda, dtype, Hq, Hkv, T, D, window, cap):
    """A route's causal and window edges, column for column.  The logits
    are small (|q| = 0.25), so each seen key carries about 1/n of its
    marker: a column too many or too few at an edge moves its dim by about
    30/n, far past the tolerance.  Each mask moved by one column must be
    rejected, which shows the check has that power."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = (0.25 * torch.randn((1, Hq, T, D), generator=gen,
                            device=cuda)).to(dtype)
    k = torch.randn((1, Hkv, T, D), generator=gen, device=cuda).to(dtype)
    v = marked_values(cuda, Hkv, T, D).to(dtype)
    got = routed_call(q, k, v, causal=True, window=window, softcap=cap)
    i = torch.arange(T, device=cuda)[:, None]
    j = torch.arange(T, device=cuda)[None, :]

    def mask(hi, w):
        return (j <= i + hi) & ((j > i - w) if w > 0 else True)

    tol = DECODE_TOL[dtype]
    want = masked_attention(q, k, v, mask(0, window), cap)
    assert torch.allclose(want, attention_ref(
        q, k, v, causal=True, window=window, softcap=cap).float(), **tol)
    assert torch.allclose(got, want, **tol)
    moved = [mask(1, window), mask(-1, window)]
    if window:
        moved += [mask(0, window + 1), mask(0, window - 1)]
    for m in moved:
        assert not torch.allclose(got, masked_attention(q, k, v, m, cap),
                                  **tol)


@pytest.mark.parametrize("Hq,Hkv,T,D,window,cap", [
    (4, 2, 300, 128, 0, 0.0),      # causal edge across 96-column tiles
    (4, 2, 300, 64, 100, 0.0),     # window edge across 128-column tiles
    (4, 2, 300, 256, 70, 50.0),    # window edge across 32-column tiles
])
def test_flash_prefill_wgmma_mask_edges_exactly(cuda, Hq, Hkv, T, D, window,
                                                cap):
    """The bf16 (wgmma) route's causal and window edges, column for column
    (:func:`mask_edges_exactly`)."""
    mask_edges_exactly(cuda, torch.bfloat16, Hq, Hkv, T, D, window, cap)


@pytest.mark.parametrize("Hq,Hkv,T,D,window,cap", [
    (4, 2, 300, 128, 0, 0.0),      # causal edge across 32-column steps
    (4, 2, 300, 64, 100, 0.0),     # window edge, 64-row query tiles
    (4, 2, 300, 256, 70, 50.0),    # D 256 with a softcap
    (2, 1, 200, 96, 33, 0.0),      # D 96 padded to 128, window past a step
])
def test_flash_prefill_tf32_mask_edges_exactly(cuda, Hq, Hkv, T, D, window,
                                               cap):
    """The float32 (split-TF32) route's causal and window edges, column
    for column (:func:`mask_edges_exactly`), at float32's limit."""
    mask_edges_exactly(cuda, torch.float32, Hq, Hkv, T, D, window, cap)


@pytest.mark.parametrize("T,S,D", [(64, 130, 64), (50, 97, 128),
                                   (40, 33, 256)])
def test_flash_prefill_wgmma_ignores_columns_past_s(cuda, T, S, D):
    """S ends one or two columns into the last KV tile (of 128, 96 and 32
    columns).  Every real logit is about -4 sqrt(D), so a zero-filled
    column past S, with logit 0, would take nearly all the weight and pull
    its row towards 0; the reference with one such column must be
    rejected."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = torch.full((1, 2, T, D), 2.0, device=cuda).bfloat16()
    k = (-2.0 + 0.25 * torch.randn((1, 1, S, D), generator=gen,
                                   device=cuda)).bfloat16()
    v = marked_values(cuda, 1, S, D)
    got = routed_call(q, k, v, causal=False)
    tol = DECODE_TOL[torch.bfloat16]
    assert torch.allclose(got, attention_ref(q, k, v, causal=False).float(),
                          **tol)
    pad = (0, 0, 0, 1)
    seen = torch.ones((T, S + 1), dtype=torch.bool, device=cuda)
    assert not torch.allclose(got, masked_attention(
        q, torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad),
        seen), **tol)


def test_flash_prefill_routes_by_dtype(cuda):
    """bf16 launches the wgmma+TMA kernel, float32 the split-TF32 one."""
    for dtype, route in ((torch.bfloat16, "wgmma+tma"),
                         (torch.float32, "wgmma-tf32x3")):
        q, k, v = flash_inputs(cuda, dtype, 1, 2, 1, 130, 130, 64)
        before = dict(flash_ops.flash_attention.route_launches)
        flash_ops.flash_attention(q, k, v)
        after = flash_ops.flash_attention.route_launches
        assert {r: after[r] - before[r] for r in after} == \
            {r: int(r == route) for r in after}


def test_flash_prefill_rejects_what_it_cannot_run(cuda):
    q, k, v = flash_inputs(cuda, torch.float32, 1, 2, 1, 8, 8, 16)
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError):
        flash_ops.flash_attention(*flash_inputs(cuda, torch.float32, 1, 2, 1,
                                                8, 8, 320))


# K6b, the gradient kernels: the CPU gradient tests' cases
# (tests/test_torch_flash_grad.py) and two wider ones
FLASH_GRAD_CASES = [
    (2, 4, 4, 64, 64, 16, True, 0, 0.0),
    (1, 4, 2, 100, 100, 64, True, 9, 0.0),
    (1, 4, 2, 50, 50, 16, True, 64, 0.0),
    (1, 8, 2, 70, 70, 64, True, 0, 50.0),
    (2, 8, 2, 40, 40, 16, True, 0, 0.0),
    (1, 16, 1, 33, 33, 16, True, 5, 50.0),
    (1, 2, 1, 40, 40, 256, True, 16, 50.0),
    (2, 4, 2, 10, 75, 16, False, 0, 0.0),
    (1, 4, 4, 67, 67, 64, True, 0, 50.0),
    (1, 8, 4, 300, 300, 256, True, 100, 50.0),   # 10 KV tiles of 32
    (2, 6, 2, 200, 131, 128, False, 0, 0.0),     # S ends inside a tile
]
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,Hq,Hkv,T,S,D,causal,window,cap",
                         [FLASH_GRAD_CASES[3], FLASH_GRAD_CASES[9],
                          FLASH_GRAD_CASES[10]])
def test_flash_attention_gradient_matches_autograd_through_ref(
        cuda, B, Hq, Hkv, T, S, D, causal, window, cap):
    """The autograd function on the card (K6 with LSE, then K6b) against
    autograd through the plain ``attention_ref``."""
    q, k, v = flash_inputs(cuda, torch.float32, B, Hq, Hkv, T, S, D, seed=1)
    do = torch.randn_like(q)
    kw = dict(causal=causal, window=window, softcap=cap)
    a = [x.clone().requires_grad_(True) for x in (q, k, v)]
    b = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fwd = flash_ops.flash_attention.launches
    bwd = flash_ops.flash_attention_backward.launches
    got = torch.autograd.grad(flash_ops.flash_attention(*a, **kw), a, do)
    assert flash_ops.flash_attention.launches == fwd + 1
    assert flash_ops.flash_attention_backward.launches == bwd + 1
    want = torch.autograd.grad(attention_ref(*b, **kw), b, do)
    for g, w in zip(got, want):
        assert torch.allclose(g, w, **GRAD_TOL)


# more K6b edges: one query tile's dQ summed over 64 KV tiles (S 4096,
# bidirectional), and a window of 1 (each query tile sees only the KV tile
# on its diagonal, each row only itself: P = 1 there, so dv = do summed
# over the group and dq = dk = 0); the bf16 route's tiles of 128 rows, 64
# a consumer warpgroup (64 KV rows shared by both at D 256): S and T that
# end 64 rows into a tile (192), a tile whose second consumer holds one
# row (S 65), T 1, a window of 100 across the 128-row boundary, and
# recurrentgemma-9b's local layer (16 query heads over one KV head, D 256,
# window 2048) at T 300
FLASH_GRAD_EDGES = [
    (1, 4, 2, 64, 4096, 128, False, 0, 0.0),
    (1, 4, 2, 256, 256, 64, True, 1, 0.0),
    (1, 4, 2, 192, 192, 128, True, 0, 0.0),
    (2, 4, 2, 100, 65, 256, False, 0, 0.0),
    (1, 4, 2, 65, 65, 128, True, 0, 50.0),
    (2, 4, 2, 1, 1, 64, True, 0, 0.0),
    (1, 6, 3, 1, 200, 128, False, 0, 0.0),
    (1, 4, 2, 300, 300, 128, True, 100, 0.0),
    (1, 16, 1, 300, 300, 256, True, 2048, 0.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,T,S,D,causal,window,cap",
                         FLASH_GRAD_CASES + FLASH_GRAD_EDGES)
def test_flash_backward_kernel(cuda, dtype, B, Hq, Hkv, T, S, D, causal,
                               window, cap):
    """K6's row LSE (its float32 route, or its wgmma route in bf16) and
    K6b's dq, dk, dv on the dtype's route against the plain versions on
    the same CUDA tensors: float32 (split-TF32) within GRAD_TOL (both sum
    in float32 in other orders), bf16 within bwd_bf16_margin; one K6b call
    of that route per backward, and two calls give the same bits."""
    q, k, v = flash_inputs(cuda, dtype, B, Hq, Hkv, T, S, D, seed=T)
    do = torch.randn_like(q)
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = flash_ops._launch(q, k, v, causal, window, cap, lse=True)
    out_r, lse_r = attention_lse_ref(q, k, v, **kw)
    if dtype == torch.float32:
        assert torch.allclose(out, out_r, atol=1e-5, rtol=1e-5)
    assert torch.allclose(lse, lse_r, atol=1e-5, rtol=1e-5)
    before = flash_ops.flash_attention_backward.launches
    routes = dict(flash_ops.flash_attention_backward.route_launches)
    got = flash_ops.flash_attention_backward(q, k, v, out, do, lse, **kw)
    assert flash_ops.flash_attention_backward.launches == before + 1
    after = flash_ops.flash_attention_backward.route_launches
    assert {r: after[r] - routes[r] for r in after} == \
        {r: int(r == flash_ops.BWD_ROUTES[dtype]) for r in after}
    want = attention_bwd_ref(q, k, v, out, do, lse, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
    if dtype == torch.float32:
        assert all(torch.allclose(g, w, **GRAD_TOL) for g, w in zip(got, want))
    else:
        assert bwd_bf16_margin(got, want, q, k, v, out, do, lse, **kw) <= 1.0
    again = flash_ops.flash_attention_backward(q, k, v, out, do, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "two calls gave different bits"
    if window == 1:
        G = Hq // Hkv
        tol = GRAD_TOL if dtype == torch.float32 else DECODE_TOL[dtype]
        dv = do.float().view(B, Hkv, G, T, D).sum(2)
        assert torch.allclose(got[2].float(), dv, **tol)
        for g in got[:2]:
            assert torch.allclose(g.float(), torch.zeros_like(g.float()),
                                  **tol)


def test_bf16_limit_catches_a_dropped_kv_tile(cuda):
    """bwd_bf16_margin is tight enough to see a wrong sum on the card:
    K6b's bf16 dq at T 4096 passes, and the same dq with one KV tile's
    share (64 columns, from the plain version's dX) taken out of the last
    query tile's rows does not."""
    B, Hq, Hkv, T, D = 1, 4, 2, 4096, 128
    q, k, v = flash_inputs(cuda, torch.bfloat16, B, Hq, Hkv, T, T, D, seed=3)
    do = torch.randn_like(q)
    out, lse = flash_ops._launch(q, k, v, True, 0, 0.0, lse=True)
    got = flash_ops.flash_attention_backward(q, k, v, out, do, lse)
    want = attention_bwd_ref(q, k, v, out, do, lse)
    inputs = (q, k, v, out, do, lse)
    assert bwd_bf16_margin(got, want, *inputs) <= 1.0
    # the share of KV columns 320..383 (all visible) in the last 64 query
    # rows' dq, as attention_bwd_ref computes it
    rows, cols = slice(T - 64, T), slice(320, 384)
    qr, dor = q[:, :, rows], do[:, :, rows]
    p, dx = _p_dx(qr, k[:, :, cols], v[:, :, cols], out[:, :, rows], dor,
                  lse[:, :, rows], False, 0, 0.0)
    dq = got[0].float()
    dq[:, :, rows] -= _products(p, dx, qr.float(), k[:, :, cols].float(),
                                dor.float(), 1.0 / math.sqrt(D))[0]
    assert bwd_bf16_margin((dq.bfloat16(),) + tuple(got[1:]), want,
                           *inputs) > 1.0


@pytest.mark.parametrize("Hq,Hkv,T,D,window,cap", [
    (4, 2, 300, 128, 0, 0.0),
    (4, 2, 300, 64, 100, 0.0),
    (8, 4, 300, 256, 70, 50.0),
    (2, 1, 1000, 20, 0, 0.0),      # D padded to 24
])
def test_flash_prefill_wgmma_lse(cuda, Hq, Hkv, T, D, window, cap):
    """K6's wgmma route writes each row's log-sum-exp of the float32
    logits (before P is rounded to bf16): against attention_lse_ref on the
    same bf16 inputs, and the output is the one the call without an LSE
    gives, bit for bit."""
    q, k, v = flash_inputs(cuda, torch.bfloat16, 1, Hq, Hkv, T, T, D, seed=5)
    kw = dict(causal=True, window=window, softcap=cap)
    before = flash_ops.flash_attention.route_launches["wgmma+tma"]
    out, lse = flash_ops._launch(q, k, v, True, window, cap, lse=True)
    assert flash_ops.flash_attention.route_launches["wgmma+tma"] == \
        before + 1
    _, want = attention_lse_ref(q, k, v, **kw)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    assert torch.allclose(lse, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(out, flash_ops.flash_attention(q, k, v, **kw))


@pytest.mark.parametrize("Hq,Hkv,T,D,window,cap", [
    (4, 2, 300, 128, 0, 0.0),
    (4, 2, 300, 64, 100, 0.0),
    (8, 4, 300, 256, 70, 50.0),
    (2, 1, 1000, 20, 0, 0.0),      # D padded to 64
    (2, 1, 130, 96, 40, 0.0),      # D padded to 128
])
def test_flash_prefill_tf32_lse(cuda, Hq, Hkv, T, D, window, cap):
    """K6's float32 (split-TF32) route writes each row's log-sum-exp of
    the logits: against attention_lse_ref on the same inputs within 1e-5,
    and the output is the one the call without an LSE gives, bit for
    bit."""
    q, k, v = flash_inputs(cuda, torch.float32, 1, Hq, Hkv, T, T, D, seed=5)
    kw = dict(causal=True, window=window, softcap=cap)
    before = flash_ops.flash_attention.route_launches["wgmma-tf32x3"]
    out, lse = flash_ops._launch(q, k, v, True, window, cap, lse=True)
    assert flash_ops.flash_attention.route_launches["wgmma-tf32x3"] == \
        before + 1
    want_out, want = attention_lse_ref(q, k, v, **kw)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    assert torch.allclose(lse, want, atol=1e-5, rtol=1e-5)
    assert torch.allclose(out, want_out, **DECODE_TOL[torch.float32])
    assert torch.equal(out, flash_ops.flash_attention(q, k, v, **kw))


def test_flash_attention_runs_a_bf16_gradient(cuda):
    """C14 closed: bf16 inputs under autograd run K6's wgmma route (with
    its LSE) forward and K6b's bf16 route backward, and raise nothing."""
    q, k, v = (x.requires_grad_(True) for x in flash_inputs(
        cuda, torch.bfloat16, 1, 4, 2, 130, 130, 128))
    fwd = dict(flash_ops.flash_attention.route_launches)
    bwd = dict(flash_ops.flash_attention_backward.route_launches)
    out = flash_ops.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), torch.randn_like(out))
    assert flash_ops.flash_attention.route_launches["wgmma+tma"] == \
        fwd["wgmma+tma"] + 1
    assert flash_ops.flash_attention_backward.route_launches[
        "wgmma-bf16"] == bwd["wgmma-bf16"] + 1
    assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
               for g in grads)


def test_model_bf16_gradient_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """Reduced gemma2-2b in bf16 (C14): every attention layer's backward a
    K6b bf16 call, and every parameter's gradient on the card within 2**-4
    of its leaf's largest magnitude of the CPU's on the same weights (the
    card rounds P and dX to bf16 in K6 and K6b and sums the bf16 matmuls
    in other orders than the CPU; a few bf16 roundings of the largest
    terms), nonzero wherever the CPU's is; the loss within 1e-2.  The
    limit sees a wrong gradient: the CPU's with the first 8 KV columns'
    share removed from every layer's dq is outside it."""
    cfg = reduced_config("gemma2-2b")
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)

    def grads(p, dev):
        leaves = tree_flatten(p)
        for x in leaves:
            x.requires_grad_(True)
        loss, _ = tf.loss_fn(p, cfg, {"tokens": torch.from_numpy(tokens).to(
            dev)})
        return loss, torch.autograd.grad(loss, leaves)

    before = flash_ops.flash_attention_backward.route_launches["wgmma-bf16"]
    loss_g, g_g = grads(params, cuda)
    n_attn = sum(k in ("attn", "local") for k in tf._kinds(cfg))
    assert flash_ops.flash_attention_backward.route_launches[
        "wgmma-bf16"] - before == n_attn

    def to_cpu(x):
        if isinstance(x, dict):
            return {k: to_cpu(v) for k, v in x.items()}
        if isinstance(x, list):
            return [to_cpu(v) for v in x]
        return x.detach().cpu()

    def within(g_c):
        return all(float((a.float().cpu() - b.float()).abs().max())
                   <= 2.0**-4 * float(b.float().abs().max())
                   for a, b in zip(g_g, g_c))

    loss_c, g_c = grads(to_cpu(params), "cpu")
    torch.testing.assert_close(loss_g.float().cpu(), loss_c.float(),
                               atol=1e-2, rtol=0)
    assert within(g_c)
    for a, b in zip(g_g, g_c):
        if b.any():
            assert a.any()

    plain = flash_ops.attention_bwd_ref

    def without_first_columns(q, k, v, o, do, lse, **kw):
        dq, dk, dv = plain(q, k, v, o, do, lse, **kw)
        share = plain(q, k[:, :, :8], v[:, :, :8], o, do, lse, **kw)[0]
        return (dq.float() - share.float()).to(dq.dtype), dk, dv

    monkeypatch.setattr(flash_ops, "attention_bwd_ref", without_first_columns)
    assert not within(grads(to_cpu(params), "cpu")[1])


@pytest.mark.parametrize("arch", ["gemma2-2b", "whisper-tiny"])
def test_model_gradient_on_the_card_matches_the_cpu(cuda, arch):
    """Reduced models in float32: every attention layer's backward is a
    K6b call, and every parameter's gradient on the card (``wq``, ``wk``,
    ``wv`` and ``ln1`` included, which a K6 launch without the autograd
    function would leave at zero) is within 1e-4 of the CPU's on the same
    weights, nonzero wherever the CPU's is."""
    cfg = reduced_config(arch)
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(
        np.int32)}
    if cfg.encoder_layers:
        batch["frontend"] = (rng.standard_normal(
            (2, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)

    def grads(p, dev):
        leaves = tree_flatten(p)
        for x in leaves:
            x.requires_grad_(True)
        loss, _ = tf.loss_fn(p, cfg, {k: torch.from_numpy(v).to(dev)
                                      for k, v in batch.items()})
        return loss, torch.autograd.grad(loss, leaves)

    before = flash_ops.flash_attention_backward.launches
    loss_g, g_g = grads(params, cuda)
    n_attn = sum(k in ("attn", "local") for k in tf._kinds(cfg))
    if cfg.encoder_layers:    # the encoder's layers and the cross-attention
        n_attn += cfg.encoder_layers + cfg.num_layers
    assert flash_ops.flash_attention_backward.launches - before == n_attn

    def to_cpu(x):
        if isinstance(x, dict):
            return {k: to_cpu(v) for k, v in x.items()}
        if isinstance(x, list):
            return [to_cpu(v) for v in x]
        return x.detach().cpu()

    loss_c, g_c = grads(to_cpu(params), "cpu")
    torch.testing.assert_close(loss_g.cpu(), loss_c, atol=1e-5, rtol=1e-5)
    for a, b in zip(g_g, g_c):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)
        if b.any():
            assert a.any()
    wq = params["layers"][0]["mixer"]["wq"]
    assert g_g[[i for i, x in enumerate(tree_flatten(params))
                if x is wq][0]].abs().sum() > 0


def test_mv_serve_engine_on_the_card(cuda):
    """Reduced minitron-4b in float32: one K6 launch per layer per prefill,
    logits within 1e-4 of the CPU engine on the same weights, and the
    same GC trace (stats and space) step by step."""
    cfg = reduced_config("minitron-4b")
    run = RunConfig(model=cfg, shape=SHAPES["decode_32k"],
                    versions_per_slot=4, reader_lanes=4)
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    def to_cpu(x):
        if isinstance(x, dict):
            return {k: to_cpu(v) for k, v in x.items()}
        if isinstance(x, list):
            return [to_cpu(v) for v in x]
        return x.cpu()

    g = MVServeEngine(cfg, run, params, batch=4, max_len=32, device=cuda)
    c = MVServeEngine(cfg, run, to_cpu(params), batch=4, max_len=32,
                      device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16))
    before = flash_ops.flash_attention.launches
    g.prefill(prompt)
    assert flash_ops.flash_attention.launches - before == cfg.num_layers
    c.prefill(prompt)
    cand = c.state.last_tokens
    for i in range(10):
        g.step()
        c.step()
        assert g.last_stats == c.last_stats
        if i == 2:
            ts = g.pin(0)
            assert c.pin(0) == ts
    torch.testing.assert_close(g.score(cand, ts).cpu(), c.score(cand, ts),
                               atol=1e-4, rtol=1e-4)
    assert g.space() == c.space()
    assert flash_ops.flash_attention.launches - before == cfg.num_layers


@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-moe-1b-a400m",
                                  "deepseek-moe-16b", "recurrentgemma-9b",
                                  "xlstm-125m", "internvl2-2b"])
def test_new_families_on_the_card_match_the_cpu(cuda, arch):
    """Reduced gemma2-2b (its 16-slot rings wrap in this trace), the two
    MoE models, the recurrent families and internvl2-2b (no patches) in
    float32: the card's engine against the CPU's on the same weights:
    tokens and GC stats equal at every step, a pinned reader's score
    within 1e-4 (a recurrent one scores the newest state on both: C12),
    and the rings' positions equal."""
    cfg = reduced_config(arch)
    run = RunConfig(model=cfg, shape=SHAPES["decode_32k"],
                    versions_per_slot=4, reader_lanes=4)
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(1))

    def to_cpu(x):
        if isinstance(x, dict):
            return {k: to_cpu(v) for k, v in x.items()}
        if isinstance(x, list):
            return [to_cpu(v) for v in x]
        return x.cpu()

    g = MVServeEngine(cfg, run, params, batch=4, max_len=32, device=cuda)
    c = MVServeEngine(cfg, run, to_cpu(params), batch=4, max_len=32,
                      device="cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16))
    g.prefill(prompt)
    c.prefill(prompt)
    cand = c.state.last_tokens
    for i in range(10):
        assert torch.equal(g.step().cpu(), c.step()), f"step {i}"
        assert g.last_stats == c.last_stats
        if i == 2:
            ts = g.pin(0)
            assert c.pin(0) == ts
    torch.testing.assert_close(g.score(cand, ts).cpu(), c.score(cand, ts),
                               atol=1e-4, rtol=1e-4)
    for a, b in zip(g.state.cache, c.state.cache):
        if hasattr(a, "pos"):
            assert torch.equal(a.pos.cpu(), b.pos)


# K6 at the shapes the last four families serve it (chip_smoke.py's FLASH
# cases of phases 6d and 6g, at a batch of 2): whisper-tiny's encoder
# (1500 frames, 6 heads of 64, bidirectional), its cross-attention at a
# prefill of 64 tokens and at one decode row (127 idle rows of the bf16
# route's 128-row tile; S = 1500 ends inside a KV tile), and a
# recurrentgemma-9b local layer (16 query heads over one KV head, D 256,
# window 2048 over 1984 tokens)
FAMILY_FLASH = {
    # B, Hq, Hkv, T, S, D, causal, window
    "whisper_encoder": (2, 6, 6, 1500, 1500, 64, False, 0),
    "whisper_cross_prefill": (2, 6, 6, 64, 1500, 64, False, 0),
    "whisper_cross_decode": (2, 6, 6, 1, 1500, 64, False, 0),
    "recurrentgemma_local": (1, 16, 1, 1984, 1984, 256, True, 2048),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FAMILY_FLASH))
def test_flash_prefill_at_the_last_families_shapes(cuda, case, dtype):
    """K6 against ``attention_ref`` on the card within DECODE_TOL; in bf16
    plus what rounding P to bf16 can move an output by (2**-8 of
    sum_j p_j |v_j|, the plain version on |V|), as phase 3's rows hold
    it; two calls give the same bits."""
    B, Hq, Hkv, T, S, D, causal, window = FAMILY_FLASH[case]
    q, k, v = flash_inputs(cuda, dtype, B, Hq, Hkv, T, S, D, seed=4)
    kw = dict(causal=causal, window=window)
    got = flash_ops.flash_attention(q, k, v, **kw)
    want = attention_ref(q, k, v, **kw).float()
    assert got.shape == q.shape and bool(torch.isfinite(got.float()).all())
    tol = DECODE_TOL[dtype]
    limit = tol["atol"] + tol["rtol"] * want.abs()
    if dtype == torch.bfloat16:
        limit = limit + 2**-8 * attention_ref(q, k, v.abs(), **kw).float()
    assert bool(((got.float() - want).abs() <= limit).all()), \
        float((got.float() - want).abs().max())
    assert torch.equal(got, flash_ops.flash_attention(q, k, v, **kw))


def _layer_on(device, arch, seed):
    """One full-width layer of ``arch`` (its first kind) in float32 from a
    seeded generator on the CPU, and the inputs, on ``device``."""
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import init_block, init_block_cache
    cfg = get_config(arch)
    kind = cfg.layer_pattern[0]
    p = init_block(torch.Generator().manual_seed(seed), cfg, kind)
    x = torch.randn((2, 100, cfg.d_model),
                    generator=torch.Generator().manual_seed(seed + 1)) * 0.5
    steps = torch.randn((3, 2, 1, cfg.d_model),
                        generator=torch.Generator().manual_seed(seed + 2)) \
        * 0.5
    state = init_block_cache(cfg, kind, 2, 0, device=device)

    def to(t):
        if isinstance(t, dict):
            return {k: to(v) for k, v in t.items()}
        return t.to(device)

    return cfg, kind, to(p), x.to(device), steps.to(device), state


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-125m"])
def test_full_width_recurrent_layer_on_the_card_matches_the_cpu(cuda, arch):
    """One layer at full published width in float32: recurrentgemma-9b's
    RG-LRU block (d_model and rnn_width 4096, its MLP of 12288) and
    xlstm-125m's mLSTM block (768 wide, 4 heads of 384): a prefill of 100
    tokens (the log-depth scan; chunks of 64, a ragged tail) and 3 decode
    steps on the card against the same on the CPU: outputs within 1e-4 and
    states within 1e-5 relative (the GEMMs sum in other orders; TF32
    off)."""
    from repro_torch.models.blocks import block_apply
    outs = []
    for dev in (cuda, torch.device("cpu")):
        cfg, kind, p, x, steps, state = _layer_on(dev, arch, 5)
        pos = torch.zeros((2, 100), dtype=torch.int32, device=dev)
        y, state = block_apply(p, cfg, kind, x, pos, cache=state,
                               mode="prefill")
        ys = [y]
        for s in steps:
            y, state = block_apply(p, cfg, kind, s, pos[:, :1], cache=state,
                                   mode="decode")
            ys.append(y)
        outs.append(([t.cpu() for t in ys], [t.cpu() for t in state]))
    (card_y, card_state), (cpu_y, cpu_state) = outs
    for a, b in zip(card_y, cpu_y, strict=True):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    for a, b in zip(card_state, cpu_state, strict=True):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("arch", ["internvl2-2b", "whisper-tiny"])
def test_frontend_steps_on_the_card_match_the_cpu(cuda, arch):
    """Reduced internvl2-2b with 8 patch embeddings and whisper-tiny over
    16 frames in float32 through ``prefill_step`` and ``decode_one`` (with
    ``enc_out``), on the card against the CPU: tokens and stats equal at
    every step, the last logits of a decode within 1e-4; K6 runs in every
    attention layer, the encoder's and the cross-attention included."""
    from repro_torch.serve import engine as tengine
    cfg = reduced_config(arch)
    run = RunConfig(model=cfg, shape=SHAPES["decode_32k"],
                    versions_per_slot=4, reader_lanes=4)
    params = tf.init_params(cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 9))
                              .astype(np.int32))
    fe = torch.from_numpy((rng.standard_normal(
        (4, cfg.encoder_tokens or cfg.frontend_tokens, cfg.d_model)) * 0.02)
        .astype(np.float32))
    runs = []
    for dev in (cuda, torch.device("cpu")):
        p = _to_device(params, dev)
        st = tengine.make_serve_state(cfg, run, p, 4, 32, torch.float32, dev)
        before = flash_ops.flash_attention.launches
        st = tengine.prefill_step(st, cfg, run, tokens.to(dev), fe.to(dev))
        enc = (tf._run_encoder(p, cfg, fe.to(dev)) if cfg.encoder_layers
               else None)
        log = []
        for _ in range(6):
            st, toks, _, stats = tengine.decode_one(st, cfg, run,
                                                    enc_out=enc)
            log.append((toks.cpu().tolist(),
                        {k: int(v) for k, v in stats.items()}))
        launched = flash_ops.flash_attention.launches - before
        logits, _ = tf.decode_step(p, cfg, st.last_tokens, st.cache,
                                   st.cache_len, enc_out=enc)
        runs.append((log, logits.cpu(), launched))
    card, host = runs
    assert card[0] == host[0]
    torch.testing.assert_close(card[1], host[1], atol=1e-4, rtol=1e-4)
    # prefill: every layer's self-attention (whisper: its encoder, and
    # cross-attention in every layer); whisper: the caller's encoder pass,
    # then cross-attention in every layer of the 6 decode steps
    attn, enc = cfg.num_layers, cfg.encoder_layers
    want = attn if not enc else (enc + 2 * attn) + enc + 6 * attn
    assert card[2] == want and host[2] == 0


def _to_device(x, dev):
    if isinstance(x, dict):
        return {k: _to_device(v, dev) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_device(v, dev) for v in x]
    return x.to(dev)


@pytest.mark.parametrize("dispatch", ["global", "grouped"])
def test_moe_gives_the_same_bits_twice_on_the_card(cuda, dispatch):
    """The combine adds each token's choices in a fixed order (no
    atomics), so two calls in bf16 on the card give the same bits."""
    from repro_torch.models import moe
    cfg = reduced_config("deepseek-moe-16b", d_model=256, d_ff=512,
                         num_experts=16, top_k=6, moe_dispatch=dispatch)
    p = moe.init_moe(torch.Generator(device=cuda).manual_seed(2), cfg,
                     dtype=torch.bfloat16)
    x = torch.randn((4, 512, cfg.d_model), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3)
                    ).to(torch.bfloat16)
    a = moe.moe(p, cfg, x)[0]
    assert torch.equal(a, moe.moe(p, cfg, x)[0])


# ---------------------------------------------------------------------------
# the multi-host layer: K1 with the global-LWM pin, a 4-host trace
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lanes", ["slots", "every_slot"])
@pytest.mark.parametrize("pin", ["sentinel", "below_now"])
def test_sweep_with_the_lwm_pin(cuda, pin, lanes):
    """K1 over the board every shard op sorts: 16 lanes plus the global
    LWM (17 entries, not a power of two), against ``sweep_ref``; with the
    TS_MAX sentinel the result equals the sweep with no extra pin."""
    S, V = 256, 8
    rng = np.random.default_rng(17)
    ts, succ, pay = (torch.from_numpy(x).to(cuda) for x in slabs(rng, S, V))
    board = np.where(rng.random(16) < 0.5, EMPTY,
                     rng.integers(0, 60, 16)).astype(np.int32)
    lwm = TS_MAX if pin == "sentinel" else 23          # now is 40
    slots = torch.from_numpy(board).to(cuda)
    ann = sort_announcements(torch.cat(
        [slots, torch.tensor([lwm], dtype=torch.int32, device=cuda)]))
    assert ann.shape == (17,)
    ids = mask = None
    if lanes == "slots":
        ids = torch.from_numpy(rng.integers(0, S, 64).astype(np.int32)).to(
            cuda)
        mask = torch.from_numpy(rng.random(64) < 0.8).to(cuda)
    got = compact_ops.sweep(ts, succ, pay, ids, mask, ann, 40)
    for a, b in zip(got, sweep_ref(ts, succ, pay, ids, mask, ann, 40),
                    strict=True):
        assert torch.equal(a, b)
    if pin == "sentinel":
        no_pin = compact_ops.sweep(ts, succ, pay, ids, mask,
                                   sort_announcements(slots), 40)
        for a, b in zip(got, no_pin, strict=True):
            assert torch.equal(a, b)
    else:      # every version the LWM sees stays
        seen = (ts != EMPTY) & (ts <= lwm) & (succ > lwm)
        assert bool(seen.any()) and torch.equal(got[0][seen], ts[seen])


def dist_trace(device):
    """dist_bench's standard tier geometry (4 hosts of 4 sequences, 10
    pages of 4 tokens, 6 versions), slrt: 48 steps with resets and a
    reader pinned on a rotating host every 6 steps for 3 steps."""
    H, B = 4, 4
    eng = ShardedPagedKVEngine(
        H, B, 10, 4, 3, 1, 4,
        gc=GCConfig(policy="slrt", versions_per_slot=6, reader_lanes=4,
                    stale_after_s=5.0), device=device)
    rng = np.random.default_rng(0)
    targets = rng.integers(4, 11, (H, B))
    cur = np.zeros((H, B), np.int64)
    ids = torch.arange(B, dtype=torch.int32).expand(H, B)
    views, held = [], None
    for step in range(48):
        kv = torch.full((H, B, 1, 4), float(step))
        failed = eng.step(ids, kv, kv, torch.ones((H, B), dtype=torch.bool))
        cur += ~failed.cpu().numpy()
        done = cur >= targets
        if done.any():
            eng.reset(ids, done)
            cur[done] = 0
        if step % 6 == 0:
            held = ((step // 6) % H, step % 4)
            ts = eng.pin(*held)
        if held is not None:
            views.append([to_numpy(x).tolist()
                          for x in eng.view_at(held[0], ts)])
        if step % 6 == 2:
            eng.unpin(*held)
            held = None
    return eng, views


def test_sharded_engine_on_the_card_matches_the_cpu(cuda):
    g, g_views = dist_trace(cuda)
    c, c_views = dist_trace("cpu")
    assert g_views == c_views
    assert g.space() == c.space()
    assert g.space()["pages_reclaimed"] > 0 and g.space()["lwm_advances"] > 0
    for a, b in zip(leaves(to_numpy(g.stacked())),
                    leaves(to_numpy(c.stacked())), strict=True):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# placement over ranks on the card: 4 gloo ranks on one GPU
# (tests/_torch_ranks.py; tests/test_torch_ranks.py runs the same programs
# on the CPU against JAX)
# ---------------------------------------------------------------------------
RANKS = 4


@pytest.fixture(scope="module")
def card_ranks(tmp_path_factory):
    """The engine, pipeline and train programs on 4 rank processes, each
    on ``cuda:0``; inputs written from seeds, the checkpoint they restore
    written by the one-process port on the card.  Returns (io, that
    engine)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import _torch_ranks as R
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.kernels import _build
    from repro_torch.train.step import init_state
    _build.lib()                       # built once, before the ranks load it
    io = tmp_path_factory.mktemp("card_ranks")
    R.pipeline_inputs(str(io))
    for case, (arch, over, _) in R.TRAIN_CASES.items():
        CheckpointManager(str(io / f"train_state_{case}")).save(
            0, init_state(reduced_config(arch, **over),
                          torch.Generator().manual_seed(0), device="cpu"))
    ceng = R.engine(R.CKPT_HOSTS, "cuda", hot_k=4)
    R.drive_ckpt(ceng, 5, 0, np.random.default_rng(0))
    ceng.pin(1, 0)
    ceng.checkpoint(str(io / "ckpt_jax"))
    R.spawn(RANKS, str(io), "cuda", ["engine", "pipeline", "train"],
            timeout=900)
    return str(io), ceng


def _records(io, rank):
    import json
    import _torch_ranks as R
    return json.loads(str(R.load(io, "engine", rank)["records"]))


def test_rank_engine_matches_one_process_on_the_card(card_ranks):
    """Every protocol record of every rank (meshes of 2 and 4) equals the
    one-process engine's on the card (a pressure level is a float32
    quotient, which the card and the CPU may round apart); the tiers give
    the committed rows; the checkpoint interchange equals the one-process
    engine's."""
    import importlib.util
    import json
    import os
    import _torch_ranks as R
    io, ceng = card_ranks
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    expected = smoke.expected_dist_rows()
    want = {name: json.loads(json.dumps(proto(
        lambda hosts, **kw: R.engine(hosts, "cuda", None, **kw)),
        sort_keys=True)) for name, proto in R.PROTOCOLS.items()}
    saved = R.engine(R.CKPT_HOSTS, "cuda", hot_k=4)
    R.drive_ckpt(saved, 5, 0, np.random.default_rng(0))
    saved.pin(1, 0)
    saved_end = json.loads(json.dumps(R.finish(saved), sort_keys=True))
    failed = R.drive_ckpt(ceng, 4, 5, np.random.default_rng(1))
    ceng_end = json.loads(json.dumps(R.finish(ceng), sort_keys=True))
    for rank in range(RANKS):
        recs = _records(io, rank)
        for name in R.PROTOCOLS:
            for n in (2, RANKS):
                assert recs[f"{name}@{n}"] == want[name], (rank, name, n)
        for key in R.TIERS:
            got = recs["tier:" + "/".join(key)]
            assert {f: expected[key][f] for f in got} == got, (rank, key)
        assert {k: v for k, v in recs["ckpt_port"].items()
                if k != "step"} == saved_end
        assert recs["ckpt_jax"]["failed"] == failed
        assert {k: v for k, v in recs["ckpt_jax"].items()
                if k not in ("step", "restored", "failed")} == ceng_end


def test_rank_pipeline_on_the_card_matches_sequential(card_ranks):
    """``tanh(h @ w)`` over 4 stage ranks on the card: the output, and the
    gradient of ``sum(y * c)`` at each of PIPE_CASES (each rank's stage
    weight, every rank's ``x.grad``), within atol 1e-5 of the stages in
    sequence on the CPU."""
    import _torch_ranks as R
    io, _ = card_ranks
    for case in R.PIPE_CASES:
        want = R.tanh_reference(io, case)
        for rank in range(RANKS):
            y = R.load(io, "pipeline", rank)[f"{case}_y"]
            np.testing.assert_allclose(y, want["y"], atol=R.PIPE_ATOL,
                                       rtol=0)
        R.check_pipe_grads(io, case, [want], RANKS)


@pytest.mark.parametrize("case", ["dense", "moe"])
def test_rank_train_on_the_card_matches_one_rank(card_ranks, cuda, case):
    """The 2 x 2 sharded step (K6 and K6b on every rank) on distinct rows,
    dense and MoE (``_torch_ranks.TRAIN_CASES``), and, for the dense case,
    data parallelism over the data groups, against the one-rank step on
    the card from the same state, 3 steps: ``_torch_ranks.check_run``'s
    limits, the losses and gradient norms within JAX's rtol 1e-4; the
    planted faults (the update skipped, a wrong half, and the three of
    the compute over ``model``: ``_torch_ranks.TP_FAULTS``; for the MoE
    case the four of its experts over ``model``:
    ``_torch_ranks.MOE_FAULTS``) fail them."""
    import _torch_ranks as R
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.train.step import init_state
    io, _ = card_ranks
    arch, over, _ = R.TRAIN_CASES[case]
    state, _ = CheckpointManager(f"{io}/train_state_{case}").restore(
        0, like=init_state(reduced_config(arch, **over), device=cuda),
        device=cuda)
    ref = R.one_rank(state, case, cuda)
    R.check_run(R.placed(io, case, case), ref, ref["p0"], rtol=R.JAX_RTOL)
    if case != "dense":
        for fault in R.MOE_FAULTS:
            with pytest.raises(AssertionError):
                R.check_run(R.placed(io, fault, case), ref, ref["p0"],
                            rtol=R.JAX_RTOL)
        return
    for rec in R.data_parallel(io, "dp"):
        R.check_run(rec, ref, ref["p0"], rtol=R.JAX_RTOL)
    for fault in ("fault_skip", "fault_half", *R.TP_FAULTS):
        with pytest.raises(AssertionError):
            R.check_run(R.placed(io, fault), ref, ref["p0"],
                        rtol=R.JAX_RTOL)


def test_dry_run_census_equals_the_card_launches(cuda):
    """``launch/dryrun.py``'s trace of a two-layer gemma2-2b training step
    in bf16 (B 1 x T 512, fake CUDA tensors: nothing built, nothing
    launched) against the same step run for real on the card: the dry
    run's kernel census equals the launches the wrappers count, K6 twice
    per layer (forward and the checkpoint's recompute) on its wgmma route
    and K6b once on its bf16 route."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, specs
    from repro_torch.train.step import init_state, train_step
    cfg = dataclasses.replace(get_config("gemma2-2b"), num_layers=2)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"])
    B, T = 1, 512

    def step(state, batch):
        return train_step(state, batch, cfg, run)

    def counts():
        return {"flash_prefill": flash_ops.flash_attention.launches,
                "flash_backward_bf16":
                    flash_ops.flash_attention_backward.route_launches[
                        flash_ops.BWD_ROUTES[torch.bfloat16]]}

    shapes = (specs.shapes_of(lambda dev: init_state(
        cfg, torch.Generator(device=dev), dtype=torch.bfloat16)),
        {"tokens": specs.Shaped((B, T), torch.int32)})
    before = counts()
    dry, _ = dryrun.trace(step, shapes, cuda)
    assert counts() == before              # the dry run launched nothing
    census = {k: v["launches"] for k, v in dry.result()["kernels"].items()}
    state = init_state(cfg, torch.Generator(device=cuda).manual_seed(0),
                       dtype=torch.bfloat16)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, T),
                                     dtype=torch.int32, device=cuda)}
    step(state, batch)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in counts().items()}
    assert census == launched == {"flash_prefill": 4,
                                  "flash_backward_bf16": 2}


class _ThreadAxis:
    """``n`` model ranks as threads of this process, for the serve step's
    combines over ``model`` without a process group: ``reduce`` and
    ``gather`` meet the other threads' tensors at a barrier and combine
    them in rank order, as gloo's collectives do across ranks."""

    def __init__(self, n: int):
        import threading
        self.n, self.slots = n, [None] * n
        self.barrier = threading.Barrier(n)

    def rank(self, index: int):
        import copy
        axis = copy.copy(self)
        axis.index = index
        return axis

    def _meet(self, x):
        self.slots[self.index] = x
        self.barrier.wait()
        parts = list(self.slots)
        self.barrier.wait()
        return parts

    def reduce(self, x, op=None):
        import torch.distributed as dist
        parts = self._meet(x.detach())
        if op == dist.ReduceOp.MAX:
            return torch.stack(parts).amax(0)
        if op == dist.ReduceOp.MIN:
            return torch.stack(parts).amin(0)
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out

    def gather(self, x, dim):
        return torch.cat(self._meet(x.detach()), dim=dim)


def _on_threads(fn, n: int) -> list:
    """``fn(axis)`` for each of ``n`` thread ranks; their results in rank
    order."""
    import threading
    axis, out = _ThreadAxis(n), [None] * n

    def run(r):
        out[r] = fn(axis.rank(r))
    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


#: gemma2-2b's and recurrentgemma-9b's decode heads (Hq, Hkv, D, softcap)
#: at B 8 (a data rank's rows) over a 1024-position cache
SERVE_HEADS = {"gemma2-2b": (8, 4, 256, 50.0),
               "recurrentgemma-9b": (16, 1, 256, 0.0)}


@pytest.mark.parametrize("arch", list(SERVE_HEADS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sequence_split_decode_combine_on_the_card(cuda, arch, dtype):
    """``attention._decode_attend`` over a cache split on its positions
    into 2 blocks (each thread rank's query heads gathered; the row max,
    then the row sum, then ``P V`` reduced over the thread ranks; each
    rank's heads of the output returned) against the one-rank plain code
    over the whole cache, on CUDA tensors: only the order of the two sums
    differs, so
    float32 agrees within 1e-5 relative (atol 1e-6); in bf16 the cache's
    rounding of ``p`` may fall on the other side of a bf16 step, within
    one bf16 step of the output (2^-7 relative) and 2^-6 of the largest
    |v| (one step of one ``p`` times its ``v``)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import attention as att
    Hq, Hkv, D, cap = SERVE_HEADS[arch]
    cfg = dataclasses.replace(get_config(arch), attn_softcap=cap)
    B, L, n = 8, 1024, 2
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, 1, Hq, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, L, Hkv, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, L, Hkv, D), generator=g, device=cuda).to(dtype)
    lens = torch.randint(1, L, (B,), generator=g, device=cuda)
    mask = torch.arange(L, device=cuda)[None, None, :] < lens[:, None, None]
    want = att._decode_attend(cfg, q, k, v, mask, dtype)
    blk = L // n
    got = _on_threads(lambda ax: att._decode_attend(
        cfg, q.chunk(n, dim=2)[ax.index],
        k[:, ax.index * blk:(ax.index + 1) * blk],
        v[:, ax.index * blk:(ax.index + 1) * blk],
        mask[..., ax.index * blk:(ax.index + 1) * blk], dtype, ax), n)
    tol = (dict(atol=1e-6, rtol=1e-5) if dtype == torch.float32 else
           dict(atol=2**-6 * float(v.float().abs().max()), rtol=2**-7))
    for out in got:
        assert out.is_cuda and out.dtype == dtype
        assert out.shape == (B, 1, Hq // n, D)
    torch.testing.assert_close(torch.cat(got, dim=2).float(), want.float(),
                               **tol)


@pytest.mark.parametrize("V", [256000, 256])
def test_vocab_shard_argmax_on_the_card(cuda, V):
    """``engine._greedy`` over the vocabulary's blocks of 2 thread ranks
    (each block's largest value and first index, offset by the block's
    first row; the largest value, then the smallest global index) equals
    ``torch.argmax`` of the whole rows on CUDA bit for bit: random bf16
    and float32 logits at gemma2-2b's and recurrentgemma-9b's vocabulary
    and at the reduced one, and rows with exact ties inside a block,
    across the blocks, at both blocks' first columns, at their seam, and
    over a whole row."""
    from repro_torch.serve import engine as eng
    n, blk = 2, V // 2
    g = torch.Generator(device=cuda).manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((8, 1, V), generator=g, device=cuda).to(dtype)
        x[1, 0, [3, blk + 3]] = 9.0                 # tie across the blocks
        x[2, 0, [blk + 5, blk + 1]] = 9.0           # tie inside block 1
        x[3, 0, [blk, 0]] = 9.0                     # both first columns
        x[4, 0, [blk - 1, blk]] = 9.0               # the blocks' seam
        x[5] = 0.0                                  # a whole row tied
        want = eng._greedy(x)
        got = _on_threads(lambda ax: eng._greedy(
            x[..., ax.index * blk:(ax.index + 1) * blk], ax), n)
        for out in got:
            assert out.dtype == want.dtype and out.is_cuda
            assert torch.equal(out, want), (dtype, out.ravel(), want.ravel())
        assert want[1, 0] == 3 and want[2, 0] == blk + 1 \
            and want[3, 0] == 0 and want[4, 0] == blk - 1 and want[5, 0] == 0
