"""Parity of the port's slab primitives and kernel plain versions with the
JAX package, on random slabs with EMPTY / TS_MAX edges.

Inputs are made with numpy from a seed and fed to both packages; every
integer output must be exactly equal.  The Pallas kernels compact (K1) and
search (K3) are run in interpret mode, as the JAX package's own tests run
them; search+gather (K2) is held against ``search_gather_ref`` only,
because its Pallas version cannot run on this jax (trap C3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.core.mvgc import announce as j_ann
from repro.core.mvgc import needed as j_needed
from repro.core.mvgc import pool as j_pool
from repro.core.mvgc import rangetracker as j_rt
from repro.core.mvgc import vstore as j_vs
from repro.kernels.compact import kernel as j_ck
from repro.kernels.compact import ref as j_cref
from repro.kernels.version_search import kernel as j_sk
from repro.kernels.version_search import ref as j_sref

from repro_torch.convert import mvstate_from_numpy, to_numpy
from repro_torch.core.mvgc import announce as t_ann
from repro_torch.core.mvgc import needed as t_needed
from repro_torch.core.mvgc import pool as t_pool
from repro_torch.core.mvgc import rangetracker as t_rt
from repro_torch.core.mvgc import vstore as t_vs
from repro_torch.kernels.compact import ops as t_cops
from repro_torch.kernels.compact import ref as t_cref
from repro_torch.kernels.version_search import ops as t_sops
from repro_torch.kernels.version_search import ref as t_sref

EMPTY, TS_MAX = -1, 2**31 - 1
SEEDS = [0, 1, 2]


def T(x):
    return torch.from_numpy(np.array(x))


def J(x):
    return jnp.asarray(np.array(x))


def same(j, t):
    np.testing.assert_array_equal(np.asarray(j), to_numpy(t))


def rand_slab(rng, S, V):
    """Slabs with free entries, closed and current intervals: ts EMPTY or a
    timestamp, succ TS_MAX (current / free) or a later timestamp."""
    ts = rng.integers(0, 40, (S, V)).astype(np.int32)
    succ = (ts + rng.integers(1, 10, (S, V))).astype(np.int32)
    succ[rng.random((S, V)) < 0.3] = TS_MAX
    free = rng.random((S, V)) < 0.3
    ts[free] = EMPTY
    succ[free] = TS_MAX
    pay = np.where(free, EMPTY, rng.integers(0, 1000, (S, V))).astype(np.int32)
    return ts, succ, pay


def rand_ann(rng, P):
    ann = rng.integers(0, 45, P).astype(np.int32)
    ann[rng.random(P) < 0.4] = EMPTY
    return ann


# ---------------------------------------------------------------------------
# pool
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_pool_reads_and_masks(seed):
    rng = np.random.default_rng(seed)
    S, V, B = 7, 5, 11
    ts, succ, pay = rand_slab(rng, S, V)
    js = j_pool.VersionStore(J(ts), J(succ), J(pay))
    tstore = t_pool.VersionStore(T(ts), T(succ), T(pay))
    ids = rng.integers(0, S, B).astype(np.int32)
    t = rng.integers(-2, 50, B).astype(np.int32)
    for a, b in zip(j_pool.read_at(js, J(ids), J(t)),
                    t_pool.read_at(tstore, T(ids), T(t))):
        same(a, b)
    for a, b in zip(j_pool.read_at(js, J(ids), jnp.int32(20)),
                    t_pool.read_at(tstore, T(ids), 20)):
        same(a, b)
    for a, b in zip(j_pool.read_current(js, J(ids)),
                    t_pool.read_current(tstore, T(ids))):
        same(a, b)
    same(j_pool.current_index(js), t_pool.current_index(tstore))
    same(j_pool.occupancy(js), t_pool.occupancy(tstore))
    same(j_pool.epoch_kill_mask(js, jnp.int32(25)),
         t_pool.epoch_kill_mask(tstore, 25))
    kill = rng.random((S, V)) < 0.5
    same(j_pool.free_entries(js, J(kill)).ts,
         t_pool.free_entries(tstore, T(kill)).ts)


@pytest.mark.parametrize("seed", SEEDS)
def test_pool_write_with_overflow(seed):
    rng = np.random.default_rng(seed)
    S, V = 6, 3
    js = j_pool.make_store(S, V)
    tstore = t_pool.make_store(S, V, device="cpu")
    for step in range(1, 12):
        B = int(rng.integers(1, S + 1))
        ids = rng.permutation(S)[:B].astype(np.int32)
        pl = rng.integers(0, 100, B).astype(np.int32)
        m = rng.random(B) < 0.8
        js, jo = j_pool.write(js, J(ids), jnp.int32(step), J(pl), J(m))
        tstore, to = t_pool.write(tstore, T(ids), step, T(pl), T(m))
        same(jo, to)
        for f in ("ts", "succ", "payload"):
            same(getattr(js, f), getattr(tstore, f))
        # free a random subset so appends keep landing in holes
        kill = rng.random((S, V)) < 0.2
        js = j_pool.free_entries(js, J(kill))
        tstore = t_pool.free_entries(tstore, T(kill))


# ---------------------------------------------------------------------------
# needed, announce
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_needed_intervals_and_sort(seed):
    rng = np.random.default_rng(seed)
    ts, succ, _ = rand_slab(rng, 9, 6)
    ann = rand_ann(rng, 7)
    ja = j_needed.sort_announcements(J(ann))
    ta = t_needed.sort_announcements(T(ann))
    same(ja, ta)
    for now in (0, 17, 45, TS_MAX):
        same(j_needed.needed_intervals(J(ts), J(succ), ja, jnp.int32(now)),
             t_needed.needed_intervals(T(ts), T(succ), ta, now))


@pytest.mark.parametrize("seed", SEEDS)
def test_announce_board(seed):
    rng = np.random.default_rng(seed)
    P = 6
    jb = j_ann.make_board(P)
    tb = t_ann.make_board(P, device="cpu")
    for step in range(10):
        lanes = rng.permutation(P)[:3].astype(np.int32)
        m = rng.random(3) < 0.6
        if step % 3 == 2:
            jb = j_ann.unannounce(jb, J(lanes), J(m))
            tb = t_ann.unannounce(tb, T(lanes), T(m))
        else:
            jb = j_ann.announce(jb, J(lanes), jnp.int32(step), J(m))
            tb = t_ann.announce(tb, T(lanes), torch.tensor(step), T(m))
        same(jb.slots, tb.slots)
        same(j_ann.scan(jb), t_ann.scan(tb))
        same(j_ann.oldest(jb, jnp.int32(99)),
             t_ann.oldest(tb, torch.tensor(99, dtype=torch.int32)))


# ---------------------------------------------------------------------------
# retire ring
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_ring_push_flush_compact(seed):
    rng = np.random.default_rng(seed)
    S, V, cap = 5, 4, 9
    ts, succ, pay = rand_slab(rng, S, V)
    js = j_pool.VersionStore(J(ts), J(succ), J(pay))
    tstore = t_pool.VersionStore(T(ts), T(succ), T(pay))
    jr, tr = j_rt.make_ring(cap), t_rt.make_ring(cap, device="cpu")
    for step in range(6):
        K = 4
        flat = rng.integers(0, S * V, K).astype(np.int32)
        low = rng.integers(0, 30, K).astype(np.int32)
        high = (low + rng.integers(1, 8, K)).astype(np.int32)
        m = rng.random(K) < 0.7
        jr, jd = j_rt.push(jr, J(flat), J(low), J(high), J(m))
        tr, td = t_rt.push(tr, T(flat), T(low), T(high), T(m))
        same(jd, td)
        same(j_rt.ring_size(jr), t_rt.ring_size(tr))
        if step % 2:
            ann = rand_ann(rng, 3)
            now = int(rng.integers(10, 40))
            jr, js, jf = j_rt.flush(jr, js, j_needed.sort_announcements(
                J(ann)), jnp.int32(now))
            tr, tstore, tf = t_rt.flush(tr, tstore, t_needed.sort_announcements(
                T(ann)), torch.tensor(now, dtype=torch.int32))
            same(jf, tf)
            for f in ("ts", "succ", "payload"):
                same(getattr(js, f), getattr(tstore, f))
        for f in ("idx", "low", "high"):
            same(getattr(jr, f), getattr(tr, f))
    keep = rng.random(cap) < 0.5
    jc, tc = j_rt._compact_ring(jr, J(keep)), t_rt._compact_ring(tr, T(keep))
    for f in ("idx", "low", "high"):
        same(getattr(jc, f), getattr(tc, f))


# ---------------------------------------------------------------------------
# kernel plain versions (and the CPU dispatch of their wrappers)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_compact_plain_version_matches_jax(seed):
    rng = np.random.default_rng(seed)
    R, V, P = 13, 6, 5
    ts, succ, pay = rand_slab(rng, R, V)
    mask = rng.random(R) < 0.7
    ann = rand_ann(rng, P)
    ann = np.sort(np.where(ann == EMPTY, TS_MAX, ann)).astype(np.int32)
    now = 30
    args_j = (J(ts), J(succ), J(pay), J(mask), J(ann), jnp.int32(now))
    args_t = (T(ts), T(succ), T(pay), T(mask), T(ann),
              torch.tensor(now, dtype=torch.int32))
    want = j_cref.compact_ref(*args_j)
    pallas = j_ck.compact_pallas(*args_j, block_r=8, interpret=True)
    for got in (t_cref.compact_ref(*args_t), t_cops.compact(*args_t)):
        for a, p, b in zip(want, pallas, got):
            same(a, b)
            same(p, b)
    same(j_cref.needed_ref(*args_j[:2], args_j[4], args_j[5]),
         t_cref.needed_ref(*args_t[:2], args_t[4], args_t[5]))
    assert t_cops.compact.launches == 0     # CPU tensors never launch


NEEDED_BOARDS = {
    # name: (S, V, P) and how the board is drawn
    "padded": (13, 6, 5),        # idle lanes as TS_MAX padding
    "duplicates": (17, 4, 8),    # several lanes pinning one timestamp
    "single_lane": (9, 3, 1),    # P = 1
    "all_idle": (8, 5, 4),       # every lane TS_MAX
    "all_empty": (6, 4, 3),      # no version written at all
}


@pytest.mark.parametrize("board", sorted(NEEDED_BOARDS))
@pytest.mark.parametrize("seed", SEEDS)
def test_needed_plain_version_matches_pallas(board, seed):
    """K5's CPU dispatch (``needed_ref``) against the Pallas kernel in
    interpret mode and the JAX ``needed_ref``, on slabs with EMPTY
    entries and sorted boards."""
    rng = np.random.default_rng(seed)
    S, V, P = NEEDED_BOARDS[board]
    ts, succ, _ = rand_slab(rng, S, V)
    ann = rand_ann(rng, P)
    if board == "duplicates":
        ann[: P // 2] = ann[P - 1] if ann[P - 1] != EMPTY else 7
    if board == "all_idle":
        ann[:] = EMPTY
    if board == "all_empty":
        ts[:], succ[:] = EMPTY, TS_MAX
    ann = np.sort(np.where(ann == EMPTY, TS_MAX, ann)).astype(np.int32)
    now = 30
    args_j = (J(ts), J(succ), J(ann), jnp.int32(now))
    args_t = (T(ts), T(succ), T(ann), torch.tensor(now, dtype=torch.int32))
    pallas = j_ck.needed_pallas(*args_j, block_s=4,
                                interpret=True).astype(bool)
    got = t_cops.needed(*args_t)
    assert got.dtype == torch.bool and got.shape == (S, V)
    same(pallas, got)
    same(j_cref.needed_ref(*args_j), got)
    same(j_needed.needed_intervals(*args_j), got)
    if board == "all_empty":
        assert not bool(got.any())
    assert t_cops.needed.launches == 0      # CPU tensors never launch


@pytest.mark.parametrize("seed", SEEDS)
def test_search_plain_versions_match_jax(seed):
    rng = np.random.default_rng(seed)
    S, V, B, Tn, M = 9, 8, 12, 20, 5
    ts, _, _ = rand_slab(rng, S, V)
    # distinct timestamps per slot, as the store guarantees
    for s in range(S):
        live = ts[s] != EMPTY
        ts[s, live] = rng.permutation(40)[:live.sum()]
    pay = np.where(ts == EMPTY, EMPTY, rng.integers(0, Tn, (S, V))
                   ).astype(np.int32)
    values = rng.integers(-1, 50, (Tn, M)).astype(np.int32)
    ids = rng.integers(0, S, B).astype(np.int32)
    t = rng.integers(-1, 45, B).astype(np.int32)
    t[0] = -1                                    # before every version
    want = j_sref.search_ref(J(ts), J(pay), J(ids), J(t))
    pallas = j_sk.search_pallas(J(ts), J(pay), J(ids), J(t), block_b=8,
                                interpret=True)
    for got in (t_sref.search_ref(T(ts), T(pay), T(ids), T(t)),
                t_sops.search(T(ts), T(pay), T(ids), T(t))):
        for a, p, b in zip(want, pallas, got):
            same(a, b)
            same(p, b)
    want = j_sref.search_gather_ref(J(ts), J(pay), J(values), J(ids), J(t))
    for got in (t_sref.search_gather_ref(T(ts), T(pay), T(values), T(ids),
                                         T(t)),
                t_sops.search_gather(T(ts), T(pay), T(values), T(ids), T(t))):
        for a, b in zip(want, got):
            same(a, b)
    assert not bool(np.asarray(want[2]).all())   # not-found rows present
    assert t_sops.search.launches == t_sops.search_gather.launches == 0


# ---------------------------------------------------------------------------
# the store's needed-sweep (K1's main path): sweep_ref against JAX
# ---------------------------------------------------------------------------
SWEEP_CASES = {
    # name: (S, V, R, P); the lanes' draw is set in _sweep_lanes
    "duplicates": (6, 4, 20, 3),     # R > S: masked lanes share slots
    "fewer_lanes": (12, 5, 5, 4),    # R < S
    "all_false": (7, 3, 9, 2),       # no lane masked: nothing changes
    "empty_rows": (8, 4, 10, 3),     # slots with no version at all
    "inert_slot0": (5, 4, 8, 2),     # unmasked lanes clamped onto slot 0
}


def _sweep_state(rng, S, V, P, name):
    """A JAX MVState with random slabs and board, slot 0 holding nothing
    to kill (current versions only), and the port's copy of it."""
    ts, succ, pay = rand_slab(rng, S, V)
    succ[0] = TS_MAX                      # slot 0: current or free entries
    if name == "empty_rows":
        gone = rng.permutation(np.arange(1, S))[:3]
        ts[gone], succ[gone], pay[gone] = EMPTY, TS_MAX, EMPTY
    board = rand_ann(rng, P)
    j = j_vs.make_state(S, V, P)._replace(
        store=j_pool.VersionStore(J(ts), J(succ), J(pay)),
        board=j_ann.AnnounceBoard(J(board)), now=jnp.int32(30))
    return j, mvstate_from_numpy(jax.tree_util.tree_map(np.asarray, j),
                                 "cpu")


def _sweep_lanes(rng, S, R, name):
    """Lane ids and mask as the store's callers give them: masked lanes
    anywhere in [0, S) (duplicates allowed), inert lanes clamped onto
    slot 0, which has nothing to kill, so JAX's write-back of their
    unchanged rows cannot meet trap C5."""
    ids = rng.integers(0, S, R).astype(np.int32)
    mask = rng.random(R) < 0.75
    if name == "all_false":
        mask[:] = False
    if name == "inert_slot0":
        mask[: R // 2] = False
    ids[~mask] = 0
    return ids, mask


@pytest.mark.parametrize("case", sorted(SWEEP_CASES))
@pytest.mark.parametrize("seed", SEEDS)
def test_sweep_slots_matches_jax(case, seed):
    """``sweep_ref`` and the port's ``_sweep_slots`` (which runs it on the
    CPU) against ``repro.core.mvgc.vstore._sweep_slots`` (lax path): the
    whole slab and the freed handles per lane, exactly."""
    rng = np.random.default_rng(seed)
    S, V, R, P = SWEEP_CASES[case]
    j, t = _sweep_state(rng, S, V, P, case)
    ids, mask = _sweep_lanes(rng, S, R, case)
    j2, jfreed = j_vs._sweep_slots(j, J(ids), J(mask), use_kernel=False)
    t2, tfreed = t_vs._sweep_slots(t, T(ids), T(mask))
    A = t_needed.sort_announcements(t.board.slots)
    direct = t_cref.sweep_ref(t.store.ts, t.store.succ, t.store.payload,
                              T(ids), T(mask), A, t.now)
    want = (j2.store.ts, j2.store.succ, j2.store.payload, jfreed)
    for got in ((t2.store.ts, t2.store.succ, t2.store.payload, tfreed),
                direct):
        for a, b in zip(want, got, strict=True):
            same(a, b)
    freed = to_numpy(tfreed)
    assert freed.shape == (R * V,)
    if case == "all_false":
        assert (freed == EMPTY).all()
        same(j.store.ts, t2.store.ts)
    if case == "duplicates":
        lanes = freed.reshape(R, V)
        hits = [tuple(lanes[r]) for r in range(R)
                if mask[r] and (lanes[r] != EMPTY).any()]
        assert len(hits) > len(set(hits)), "no slot killed through two lanes"
    assert t_cops.compact.launches == t_cops.sweep.launches == 0


@pytest.mark.parametrize("case", ["random", "empty_rows"])
@pytest.mark.parametrize("seed", SEEDS)
def test_sweep_all_needed_matches_jax(case, seed):
    """The every-slot sweep (no lanes, no mask) against
    ``repro.core.mvgc.vstore._sweep_all_needed``: freed is [S * V]."""
    rng = np.random.default_rng(seed)
    S, V, P = 9, 4, 3
    j, t = _sweep_state(rng, S, V, P, case)
    j2, jfreed = j_vs._sweep_all_needed(j, use_kernel=False)
    t2, tfreed = t_vs._sweep_all_needed(t)
    A = t_needed.sort_announcements(t.board.slots)
    direct = t_cops.sweep(t.store.ts, t.store.succ, t.store.payload, None,
                          None, A, t.now)
    want = (j2.store.ts, j2.store.succ, j2.store.payload, jfreed)
    for got in ((t2.store.ts, t2.store.succ, t2.store.payload, tfreed),
                direct):
        for a, b in zip(want, got, strict=True):
            same(a, b)
    assert to_numpy(tfreed).shape == (S * V,)
    assert (to_numpy(tfreed) != EMPTY).any(), "the sweep freed nothing"
    with pytest.raises(ValueError):
        t_cops.sweep(t.store.ts, t.store.succ, t.store.payload, None,
                     T(np.ones(S, bool)), A, t.now)


# ---------------------------------------------------------------------------
# traps C1 and C2
# ---------------------------------------------------------------------------
def _hot_state():
    """Slots 0 and 1 hold three versions each, none pinned."""
    st = j_vs.make_state(4, 4, 2, ring_capacity=16)
    for i in range(3):
        st, _, _ = j_vs.write_step(
            st, jnp.array([0, 1], jnp.int32),
            jnp.array([10 + i, 20 + i], jnp.int32), jnp.ones((2,), bool),
            policy="steam")
    return st


def test_c1_duplicate_slot_sweep_keeps_masked_lane():
    """hot = [0, -1, -1]: the inert lanes are clamped onto slot 0.  The
    port writes back only the masked lane, so slot 0 is compacted and
    every handle it reports freed really left the store.  The JAX function
    applied without the inert duplicates gives the same state."""
    j = _hot_state()
    t = mvstate_from_numpy(jax.tree_util.tree_map(np.asarray, j), "cpu")
    hot = np.array([0, -1, -1], np.int32)
    t2, freed = t_vs._sweep_slots(t, T(np.maximum(hot, 0)), T(hot >= 0))
    j2, jfreed = j_vs._sweep_slots(j, jnp.array([0], jnp.int32),
                                   jnp.array([True]))
    for f in ("ts", "succ", "payload"):
        same(getattr(j2.store, f), getattr(t2.store, f))
    freed = to_numpy(freed)
    assert sorted(freed[freed != EMPTY]) == [11]
    assert 11 not in to_numpy(t2.store.payload)
    np.testing.assert_array_equal(np.asarray(jfreed)[:4], freed[:4])


def test_c2_hot_slot_ties_follow_lax_top_k():
    occ = [2, 3, 3, 1, 3, 2, 3, 3]
    ts = np.full((8, 4), EMPTY, np.int32)
    for s, n in enumerate(occ):
        ts[s, :n] = np.arange(n)
    j = j_vs.make_state(8, 4, 2)._replace(
        store=j_pool.VersionStore(J(ts), J(np.full_like(ts, TS_MAX)), J(ts)))
    t = mvstate_from_numpy(jax.tree_util.tree_map(np.asarray, j), "cpu")
    same(j_vs.hot_slots(j, 4), t_vs.hot_slots(t, 4))
    assert to_numpy(t_vs.hot_slots(t, 4)).tolist() == [1, 2, 4, 6]
