"""JAX's index rules in the port (trap C6), against the JAX package.

JAX reads an index in ``[-n, 0)`` as ``index + n`` in every gather and in
``.at[].set(mode="drop")``; a gather clamps an index still out of range,
a drop-mode scatter drops it.  The same numpy inputs, with index -1 and
with indices still out of range after wrapping, go through the JAX
function and its counterpart in the port; every integer output must be
exactly equal.  Masked lanes name distinct rows after wrapping: a
duplicate meets XLA's last-write-wins (trap C5), which stays out of scope.
The CUDA kernels are held against the same plain versions on the card in
``tests/test_torch_gpu.py`` (``-k negative``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.configs import reduced_config as jax_reduced
from repro.configs.base import RunConfig as JRun
from repro.configs.base import SHAPES as JSHAPES
from repro.core.mvgc import announce as j_ann
from repro.core.mvgc import pool as j_pool
from repro.core.mvgc import vstore as j_vs
from repro.core.telemetry import GCConfig as JGC
from repro.kernels.version_search import kernel as j_sk
from repro.kernels.version_search import ref as j_sref
from repro.models import transformer as jtf
from repro.mvkv import paged as jp
from repro.serve import engine as jengine

from repro_torch._tensor import drop_set, gather_index
from repro_torch.configs import SHAPES, reduced_config
from repro_torch.configs.base import RunConfig
from repro_torch.convert import mvstate_from_numpy, params_from_numpy, to_numpy
from repro_torch.core.mvgc import announce as t_ann
from repro_torch.core.mvgc import vstore as t_vs
from repro_torch.core.mvgc.needed import sort_announcements
from repro_torch.core.telemetry import GCConfig as TGC
from repro_torch.kernels.compact.ref import sweep_ref
from repro_torch.kernels.version_search import ops as t_sops
from repro_torch.kernels.version_search import ref as t_sref
from repro_torch.serve.engine import MVServeEngine, PagedKVEngine

EMPTY, TS_MAX = -1, 2**31 - 1
S, V = 6, 4


def same(j, t):
    np.testing.assert_array_equal(np.asarray(j), to_numpy(t))


def assert_states_equal(j, t):
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, j))
    got = jax.tree_util.tree_leaves(to_numpy(t))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


# index sets over n = 6 rows: -1 alone, -1 beside in-range ids, ids still
# out of range after wrapping (6, -7, big), and -n (wraps to row 0)
IDS = {
    "minus_one": [-1],
    "mixed": [-1, 2, -6, 3],
    "out_of_range": [6, -7, 1, 1000, -1000],
    "all": [-1, 6, -7, 2, -5, 40],
}


def _rows(ids, n):
    """Where JAX's gather reads each id (wrap, then clamp)."""
    return [min(max(i + n if i < 0 else i, 0), n - 1) for i in ids]


@pytest.mark.parametrize("case", sorted(IDS))
def test_gather_and_drop_rules_match_jax(case):
    """The helpers themselves: ``x[ids]`` and ``x.at[ids].set(v,
    mode="drop")`` of JAX against :func:`gather_index` and
    :func:`drop_set` (lanes that wrap onto one row carry one value)."""
    ids = np.array(IDS[case], np.int32)
    x = np.arange(S * 2, dtype=np.int32).reshape(S, 2)
    same(jnp.asarray(x)[jnp.asarray(ids)],
         torch.from_numpy(x)[gather_index(torch.from_numpy(ids), S)])
    assert _rows(ids.tolist(), S) == \
        gather_index(torch.from_numpy(ids), S).remainder(S).tolist()
    vals = np.array([100 + r for r in _rows(ids.tolist(), S)], np.int32)
    mask = np.ones(len(ids), bool)
    mask[-1] = len(ids) == 1
    want = jnp.asarray(x[:, 0]).at[jnp.where(jnp.asarray(mask),
                                             jnp.asarray(ids), S)].set(
        jnp.asarray(vals), mode="drop")
    same(want, drop_set(torch.from_numpy(x[:, 0]), torch.from_numpy(ids),
                        torch.from_numpy(vals), torch.from_numpy(mask)))


@pytest.mark.parametrize("lanes,mask", [
    ([-1], [True]),
    ([-1, 9, -5, 1], [True, True, True, True]),   # 9, -5: out of range
    ([-4, 2, -2], [True, False, True]),
])
def test_announce_and_unannounce_match_jax(lanes, mask):
    P = 4
    jb, tb = j_ann.make_board(P), t_ann.make_board(P, device="cpu")
    lanes_np, mask_np = np.array(lanes, np.int32), np.array(mask)
    jb = j_ann.announce(jb, jnp.asarray(lanes_np), jnp.int32(7),
                        jnp.asarray(mask_np))
    tb = t_ann.announce(tb, torch.from_numpy(lanes_np), 7,
                        torch.from_numpy(mask_np))
    same(jb.slots, tb.slots)
    assert (to_numpy(tb.slots) != EMPTY).any()
    jb = j_ann.unannounce(jb, jnp.asarray(lanes_np), jnp.asarray(mask_np))
    tb = t_ann.unannounce(tb, torch.from_numpy(lanes_np),
                          torch.from_numpy(mask_np))
    same(jb.slots, tb.slots)


# write_step lanes: -1 (slot S-1), an in-range slot, and ids still out of
# range (S, -S-1), whose gathers clamp onto slots S-1 and 0 and whose
# writes drop; the ring records slot_id * V + v from the id as given
WRITE_IDS = np.array([-1, 2, S, -S - 1], np.int32)


@pytest.mark.parametrize("policy", ["ebr", "steam", "dlrt", "slrt", "sweep"])
def test_write_step_and_gc_match_jax(policy):
    """Eight write steps on the ids above, a pin on lane -1 and forced
    collections: the whole ``MVState``, the freed handles and the
    overflow lanes equal JAX's after every op."""
    P = 3
    j = j_vs.make_state(S, V, P, ring_capacity=32)
    t = t_vs.make_state(S, V, P, ring_capacity=32, device="cpu")
    ids = jnp.asarray(WRITE_IDS)
    mask = np.ones(len(WRITE_IDS), bool)
    for step in range(8):
        pl = np.arange(len(WRITE_IDS), dtype=np.int32) + 10 * step
        j, fj, oj = j_vs.write_step(j, ids, jnp.asarray(pl),
                                    jnp.asarray(mask), policy=policy)
        t, ft, ot = t_vs.write_step(t, torch.from_numpy(WRITE_IDS),
                                    torch.from_numpy(pl),
                                    torch.from_numpy(mask), policy=policy)
        same(fj, ft)
        same(oj, ot)
        assert_states_equal(j, t)
        if step == 2:
            lane, on = np.array([-1], np.int32), np.array([True])
            j, _ = j_vs.begin_snapshot(j, jnp.asarray(lane), jnp.asarray(on))
            t, _ = t_vs.begin_snapshot(t, torch.from_numpy(lane),
                                       torch.from_numpy(on))
            assert int(to_numpy(t.board.slots)[P - 1]) == 3
        if step % 3 == 2:
            j, fj = j_vs.gc_step(j, policy=policy, force=True)
            t, ft = t_vs.gc_step(t, policy=policy, force=True)
            same(fj, ft)
            assert_states_equal(j, t)
    # slot S-1 took the writes of id -1: versions, not one lone write
    assert (to_numpy(t.store.ts)[S - 1] != EMPTY).sum() > 1
    for q in (WRITE_IDS, np.arange(S, dtype=np.int32)):
        for a, b in zip(j_vs.snapshot_read(j, jnp.asarray(q), jnp.int32(5)),
                        t_vs.snapshot_read(t, torch.from_numpy(q), 5)):
            same(a, b)


@pytest.mark.parametrize("policy", ["dlrt", "slrt"])
@pytest.mark.parametrize("sid", [-1, S - 1])
def test_retiring_slot_minus_one_at_the_last_version_leaks_as_in_jax(
        policy, sid):
    """Trap C9, a JAX fault reproduced for parity: the retire ring records
    ``slot_id * V + v`` from the id as given, so id -1 retiring its
    version at ``v = V-1`` pushes flat index -1, the ring's hole marker,
    and the flush never reclaims that entry.  Four writes fill slot S-1
    (current at ``v = V-1``), a collection frees the three closed ones, a
    fifth write retires ``v = V-1``, a last collection runs with no reader
    pinned: through id S-1 the entry is reclaimed, through id -1 it stays,
    in both packages alike."""
    j = j_vs.make_state(S, V, 3, ring_capacity=32)
    t = t_vs.make_state(S, V, 3, ring_capacity=32, device="cpu")
    ids, mask = np.array([sid], np.int32), np.array([True])
    for step in range(V + 1):
        pl = np.array([10 + step], np.int32)
        j, _, _ = j_vs.write_step(j, jnp.asarray(ids), jnp.asarray(pl),
                                  jnp.asarray(mask), policy=policy)
        t, _, _ = t_vs.write_step(t, torch.from_numpy(ids),
                                  torch.from_numpy(pl),
                                  torch.from_numpy(mask), policy=policy)
        if step == V - 1:
            assert int(to_numpy(t.store.succ)[S - 1, V - 1]) == TS_MAX
        if step in (V - 1, V):
            j, fj = j_vs.gc_step(j, policy=policy, force=True)
            t, ft = t_vs.gc_step(t, policy=policy, force=True)
            same(fj, ft)
        assert_states_equal(j, t)
    last = to_numpy(t.store.ts)[S - 1, V - 1]
    assert (last != EMPTY) == (sid == -1)
    assert (np.asarray(j.store.ts)[S - 1, V - 1] != EMPTY) == (sid == -1)


def _sweep_pair(seed):
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 40, (S, V)).astype(np.int32)
    succ = (ts + rng.integers(1, 10, (S, V))).astype(np.int32)
    succ[rng.random((S, V)) < 0.2] = TS_MAX
    free = rng.random((S, V)) < 0.2
    ts[free], succ[free] = EMPTY, TS_MAX
    pay = np.where(free, EMPTY, rng.integers(0, 999, (S, V))).astype(np.int32)
    board = np.array([12, EMPTY, 30], np.int32)
    j = j_vs.make_state(S, V, 3)._replace(
        store=j_pool.VersionStore(jnp.asarray(ts), jnp.asarray(succ),
                                  jnp.asarray(pay)),
        board=j_ann.AnnounceBoard(jnp.asarray(board)), now=jnp.int32(30))
    return j, mvstate_from_numpy(jax.tree_util.tree_map(np.asarray, j), "cpu")


# every lane masked, rows distinct after wrapping except the out-of-range
# lanes, which JAX reads clamped (onto rows S-1 and 0) but never writes
SWEEP_IDS = {
    "minus_one": [-1, 1],
    "wrapped": [-1, -6, 2, -3],
    "out_of_range": [-1, S, -S - 1, 2, 100],
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(SWEEP_IDS))
def test_sweep_ref_matches_jax(case, seed):
    """``sweep_ref`` and the store's ``_sweep_slots`` against
    ``repro.core.mvgc.vstore._sweep_slots`` on the same ids: the slab and
    the freed handles per lane, exactly (an out-of-range lane reports the
    kills of the row its clamped gather read, as JAX's does)."""
    j, t = _sweep_pair(seed)
    ids = np.array(SWEEP_IDS[case], np.int32)
    mask = np.ones(len(ids), bool)
    j2, jfreed = j_vs._sweep_slots(j, jnp.asarray(ids), jnp.asarray(mask))
    t2, tfreed = t_vs._sweep_slots(t, torch.from_numpy(ids),
                                   torch.from_numpy(mask))
    direct = sweep_ref(t.store.ts, t.store.succ, t.store.payload,
                       torch.from_numpy(ids), torch.from_numpy(mask),
                       sort_announcements(t.board.slots), t.now)
    want = (j2.store.ts, j2.store.succ, j2.store.payload, jfreed)
    for got in ((t2.store.ts, t2.store.succ, t2.store.payload, tfreed),
                direct):
        for a, b in zip(want, got, strict=True):
            same(a, b)
    freed = to_numpy(tfreed).reshape(len(ids), V)
    assert (freed[0] != EMPTY).any(), "lane -1 freed nothing: weak check"
    assert not np.array_equal(to_numpy(t2.store.ts)[S - 1],
                              to_numpy(t.store.ts)[S - 1])


SEARCH_IDS = {
    "minus_one": [-1, -1, 0],
    "wrapped": [-1, -S, -3, 5],
    "out_of_range": [S, -S - 1, 1000, -1000, 2],
}


@pytest.mark.parametrize("case", sorted(SEARCH_IDS))
def test_search_and_view_refs_match_jax(case):
    """``search_ref`` / ``value_at_ref`` / ``search_gather_ref`` /
    ``view_ref`` and their wrappers on the CPU against JAX's
    ``search_ref``, ``search_pallas`` (interpret mode) and
    ``search_gather_ref``, on wrapped and clamped ids."""
    rng = np.random.default_rng(len(case))
    ts = np.full((S, V), EMPTY, np.int32)
    for s in range(S):
        n = int(rng.integers(1, V + 1))
        ts[s, rng.permutation(V)[:n]] = rng.permutation(40)[:n]
    Tn, MP = 24, 5
    pay = np.where(ts == EMPTY, EMPTY, rng.integers(0, Tn, (S, V))
                   ).astype(np.int32)
    tables = rng.integers(-1, 99, (Tn, MP)).astype(np.int32)
    lengths = rng.integers(0, 80, Tn).astype(np.int32)
    ids = np.array(SEARCH_IDS[case], np.int32)
    t = rng.integers(-1, 45, len(ids)).astype(np.int32)
    J = jnp.asarray
    tt = torch.from_numpy
    want = j_sref.search_ref(J(ts), J(pay), J(ids), J(t))
    pallas = j_sk.search_pallas(J(ts), J(pay), J(ids), J(t), block_b=8,
                                interpret=True)
    for got in (t_sref.search_ref(tt(ts), tt(pay), tt(ids), tt(t)),
                t_sops.search(tt(ts), tt(pay), tt(ids), tt(t))):
        for a, p, b in zip(want, pallas, got):
            same(a, b)
            same(p, b)
    same(jnp.where(want[1], want[0], 0),
         t_sops.value_at(tt(ts), tt(pay), tt(ids), tt(t)))
    values = np.concatenate([tables, lengths[:, None]], axis=1)
    jrows, _, jfound = j_sref.search_gather_ref(J(ts), J(pay), J(values),
                                                J(ids), J(t))
    for got in (t_sops.search_gather(tt(ts), tt(pay), tt(values), tt(ids),
                                     tt(t)),
                t_sref.search_gather_ref(tt(ts), tt(pay), tt(values),
                                         tt(ids), tt(t))):
        same(jrows, got[0])
    tbl, lens = t_sops.view(tt(ts), tt(pay), tt(tables), tt(lengths),
                            tt(ids), tt(t))
    same(jrows[:, :MP], tbl)
    same(jnp.where(jfound, jrows[:, MP], 0), lens)
    assert bool(np.asarray(want[1]).any())


def _paged_engines(lanes=4):
    je = jengine.PagedKVEngine(4, 32, 4, 8, 1, 4,
                               gc=JGC(reader_lanes=lanes))
    te = PagedKVEngine(4, 32, 4, 8, 1, 4, gc=TGC(reader_lanes=lanes),
                       device="cpu")
    return je, te


def test_paged_engine_pin_minus_one_pins_the_last_lane():
    """``PagedKVEngine(4, 32, 4, 8, 1, 4)`` with 4 reader lanes:
    ``pin(-1)`` pins lane 3 in both packages, ``unpin(-1)`` releases it,
    and ``pin(-5)`` / ``pin(4)`` pin nothing."""
    je, te = _paged_engines()
    ids = np.arange(4, dtype=np.int32)
    for _ in range(3):
        kv = np.ones((4, 1, 4), np.float32)
        je.step(jnp.asarray(ids), jnp.asarray(kv), jnp.asarray(kv),
                jnp.ones(4, bool))
        te.step(torch.from_numpy(ids), torch.from_numpy(kv),
                torch.from_numpy(kv), torch.ones(4, dtype=torch.bool))
    assert je.pin(-1) == te.pin(-1)
    slots = to_numpy(te.st.mv.board.slots)
    assert slots[3] == int(te.st.mv.now) and (slots[:3] == EMPTY).all()
    same(je.st.mv.board.slots, te.st.mv.board.slots)
    for lane in (-5, 4):
        je.pin(lane)
        te.pin(lane)
        same(je.st.mv.board.slots, te.st.mv.board.slots)
    je.unpin(-1)
    te.unpin(-1)
    same(je.st.mv.board.slots, te.st.mv.board.slots)
    assert (to_numpy(te.st.mv.board.slots) == EMPTY).all()


@pytest.mark.parametrize("seq_ids", [[-1], [-1, 4, -5, 0, 100]])
def test_paged_engine_view_at_matches_jax(seq_ids):
    """``view_at`` on wrapped and clamped sequence ids: the page tables
    and lengths JAX's ``snapshot_view`` resolves."""
    je, te = _paged_engines()
    rng = np.random.default_rng(3)
    for step in range(6):
        mask = np.array([True, step % 2 == 0, True, step < 3])
        kv = rng.standard_normal((4, 1, 4)).astype(np.float32)
        je.step(jnp.arange(4, dtype=jnp.int32), jnp.asarray(kv),
                jnp.asarray(kv), jnp.asarray(mask))
        te.step(torch.arange(4, dtype=torch.int32), torch.from_numpy(kv),
                torch.from_numpy(kv), torch.from_numpy(mask))
    ts = je.pin(-1)
    assert te.pin(-1) == ts
    ids = np.array(seq_ids, np.int32)
    for t in (ts, ts - 3):
        for a, b in zip(je.view_at(t, jnp.asarray(ids)),
                        te.view_at(t, torch.from_numpy(ids))):
            same(a, b)
    assert int(to_numpy(te.view_at(ts, torch.from_numpy(ids))[1])[0]) > 0


def test_mv_serve_engine_pin_minus_one_pins_the_last_lane():
    """``MVServeEngine.pin(-1)`` pins lane 3 of 4 in both packages, and
    the engine's lengths at that pin agree."""
    cfg_j, cfg_t = jax_reduced("minitron-4b"), reduced_config("minitron-4b")
    pj = jtf.init_params(cfg_j, jax.random.PRNGKey(0))
    kw = dict(gc_policy="slrt", versions_per_slot=4, reader_lanes=4)
    je = jengine.MVServeEngine(cfg_j, JRun(model=cfg_j,
                                           shape=JSHAPES["decode_32k"], **kw),
                               pj, batch=2, max_len=16, dtype=jnp.float32)
    te = MVServeEngine(cfg_t, RunConfig(model=cfg_t,
                                        shape=SHAPES["decode_32k"], **kw),
                       params_from_numpy(cfg_t, pj, "cpu"), batch=2,
                       max_len=16, dtype=torch.float32, device="cpu")
    prompt = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    je.prefill(jnp.asarray(prompt))
    te.prefill(torch.from_numpy(prompt))
    ts = je.pin(-1)
    assert te.pin(-1) == ts
    same(je.state.mv.board.slots, te.state.mv.board.slots)
    slots = to_numpy(te.state.mv.board.slots)
    assert slots[3] == ts and (slots[:3] == EMPTY).all()
    same(je.lengths_at(ts), te.lengths_at(ts))
    je.pin(-9)
    te.pin(-9)
    same(je.state.mv.board.slots, te.state.mv.board.slots)
    je.unpin(-1)
    te.unpin(-1)
    assert (to_numpy(te.state.mv.board.slots) == EMPTY).all()
