"""The JAX package's property oracles of the main path, replayed on the
port's store, paged cache and engine (``repro_torch``).

Each test names the JAX test it replays and keeps its sizes, draws and
``max_examples``; only the objects under test are the port's:

* policy parity against ``repro.core.sim``
  (``tests/mvgc/test_policy_parity.py``): one trace of writes, pins,
  unpins and pressure events through a sim scheme (that module's
  ``SimReplay`` and ``gen_trace``, imported as they are) and through the
  port's store, whose freed sets must match at every pressure event; every
  policy and seeds 0-2, the single-slot burst, the interleaved pins, and
  ``reclaim_on_pressure``'s argument names against the sim's vocabulary;
* the space bound (``tests/mvgc/test_space_property.py``): live versions
  stay within the current and pinned versions plus the ring's buffer;
* the paged cache (``tests/serve/test_paged_mvkv.py``): a pin blocks
  recycling; random decode / fork / reset / pin / unpin / pressure
  interleavings keep every reachable page and table slot out of the free
  pools and every pinned view byte-stable (ebr, steam, slrt; fork and
  reset ids drawn from ``[-n, n)``, negative ids wrapping as in JAX, but
  no write through id -1 under slrt, which leaks as in JAX: trap C9); a
  pinned view survives a storm of forced reclaims;
* forks (``tests/serve/test_fork_property.py``): random fork / append /
  join / release / reclaim interleavings never leak a page or free a
  reachable one and never change a byte of a live child's prefix; a deep
  chain shares its root's pages, then frees them all.

``tests/test_torch_recovery.py`` replays the checkpoint pair.  Every
engine here runs on the CPU, in float32."""
import dataclasses
import importlib.util
import inspect
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from repro.core.sim.contention import ReclaimRequest
from repro.core.sim.schemes import SchemeBase

from repro_torch.core.mvgc import vstore
from repro_torch.core.telemetry import GCConfig
from repro_torch.mvkv import paged
from repro_torch.serve import forking
from repro_torch.serve.engine import PagedKVEngine

EMPTY = -1
HUGE = 10 ** 9
CPU = torch.device("cpu")
HERE = os.path.dirname(os.path.abspath(__file__))


def _jax_parity_module():
    """``tests/mvgc/test_policy_parity.py`` as a private module (its
    ``SimReplay`` and ``gen_trace``; the file itself is not changed)."""
    spec = importlib.util.spec_from_file_location(
        "_jax_policy_parity", os.path.join(HERE, "mvgc",
                                           "test_policy_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JP = _jax_parity_module()
POLICIES = JP.POLICIES            # ebr, steam, dlrt, slrt


def i32(*xs):
    return torch.tensor(xs, dtype=torch.int32)


def true(n=1):
    return torch.ones(n, dtype=torch.bool)


# ---------------------------------------------------------------------------
# policy parity against repro.core.sim (tests/mvgc/test_policy_parity.py)
# ---------------------------------------------------------------------------
class VstoreReplay:
    """The port's store under the replay loop of
    ``test_policy_parity.py``: the same clock (one tick a write), pins at
    the current time, and every reclamation through
    ``reclaim_on_pressure`` with an unbounded deficit."""

    def __init__(self, policy: str, n_slots: int, n_lanes: int, V: int = 48):
        self.policy = policy
        self.state = vstore.make_state(n_slots, V, n_lanes,
                                       ring_capacity=256, device=CPU)
        self.n_slots = n_slots
        self.issued = set()

    def write(self, slot: int, payload: int) -> None:
        self.state, _, ovf = vstore.write_step(
            self.state, i32(slot), i32(payload), true(), policy=self.policy)
        assert not bool(ovf.any()), "slab overflow would skew parity"
        self.issued.add(payload)

    def pin(self, lane: int) -> int:
        self.state, ts = vstore.begin_snapshot(self.state, i32(lane), true())
        return int(ts[0])

    def unpin(self, lane: int) -> None:
        self.state = vstore.end_snapshot(self.state, i32(lane), true())

    def pressure(self) -> int:
        hot = torch.arange(self.n_slots, dtype=torch.int32)
        self.state, _, n = vstore.reclaim_on_pressure(
            self.state, hot, HUGE, policy=self.policy)
        return int(n)

    def remaining(self) -> set:
        ts = self.state.store.ts.numpy()
        pay = self.state.store.payload.numpy()
        return set(pay[ts != EMPTY].tolist()) & self.issued


def replay_and_compare(policy, seed, n_slots=5, n_lanes=3, n_events=60):
    """``test_policy_parity.replay_and_compare`` with the port's store."""
    sim = JP.SimReplay(policy, n_slots, n_lanes)
    dep = VstoreReplay(policy, n_slots, n_lanes)
    trace = JP.gen_trace(seed, policy, n_slots, n_lanes, n_events)
    payload = sync_points = 0
    for i, op in enumerate(trace):
        if op[0] == "write":
            payload += 1
            sim.write(op[1], payload)
            dep.write(op[1], payload)
        elif op[0] == "pin":
            assert sim.pin(op[1]) == dep.pin(op[1]), \
                f"event {i}: pin timestamps diverged"
        elif op[0] == "unpin":
            sim.unpin(op[1])
            dep.unpin(op[1])
        else:
            sim.pressure()
            dep.pressure()
            sync_points += 1
            s_rem, d_rem = sim.remaining(), dep.remaining()
            assert s_rem == d_rem, (
                f"{policy} seed {seed} event {i}: sim kept "
                f"{sorted(s_rem - d_rem)} that the port freed; the port kept "
                f"{sorted(d_rem - s_rem)} that sim freed")
    assert sync_points >= 3
    written = len({op[1] for op in trace if op[0] == "write"})
    assert len(dep.remaining()) == written <= n_slots, \
        "after the drain exactly one current version per written slot"


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policy_parity_with_sim(policy, seed):
    """``test_policy_parity``: the sim scheme and the port's policy free
    the same versions at every pressure event."""
    replay_and_compare(policy, seed)


@pytest.mark.parametrize("policy", POLICIES)
def test_parity_write_burst_single_slot(policy):
    """``test_parity_write_burst_single_slot``: every write on one slot,
    a pin mid-burst."""
    sim, dep = JP.SimReplay(policy, 1, 2), VstoreReplay(policy, 1, 2)
    for p in range(1, 9):
        sim.write(0, p)
        dep.write(0, p)
    sim.pressure(), dep.pressure()
    assert sim.remaining() == dep.remaining() == {8}
    sim.pin(0), dep.pin(0)
    for p in range(9, 15):
        sim.write(0, p)
        dep.write(0, p)
    sim.pressure(), dep.pressure()
    assert sim.remaining() == dep.remaining()
    assert {8, 14} <= dep.remaining()
    sim.unpin(0), dep.unpin(0)
    sim.pressure(), dep.pressure()
    assert sim.remaining() == dep.remaining() == {14}


@pytest.mark.parametrize("policy", POLICIES)
def test_parity_interleaved_pins(policy):
    """``test_parity_interleaved_pins``: two staggered pins (one under
    ebr) with writes between every event."""
    n_lanes = 1 if policy == "ebr" else 2
    sim, dep = JP.SimReplay(policy, 3, n_lanes), VstoreReplay(policy, 3,
                                                                n_lanes)
    p = 0

    def w(slot):
        nonlocal p
        p += 1
        sim.write(slot, p)
        dep.write(slot, p)

    def sync():
        sim.pressure(), dep.pressure()
        assert sim.remaining() == dep.remaining()

    for s in (0, 1, 2, 0, 1):
        w(s)
    sync()
    sim.pin(0), dep.pin(0)
    for s in (0, 0, 1, 2):
        w(s)
    sync()
    if n_lanes > 1:
        sim.pin(1), dep.pin(1)
        for s in (1, 1, 0):
            w(s)
        sync()
        sim.unpin(1), dep.unpin(1)
    sim.unpin(0), dep.unpin(0)
    for s in (2, 2):
        w(s)
    sync()


def test_reclaim_on_pressure_signature_parity():
    """``test_reclaim_on_pressure_signature_parity``: the port's
    ``reclaim_on_pressure(state, hot_keys, deficit, ...)`` shares the sim's
    pressure vocabulary by argument name."""
    assert list(inspect.signature(SchemeBase.reclaim_on_pressure)
                .parameters)[:3] == ["self", "hot_keys", "deficit"]
    assert list(inspect.signature(vstore.reclaim_on_pressure)
                .parameters)[:3] == ["state", "hot_keys", "deficit"]
    assert [f.name for f in dataclasses.fields(ReclaimRequest)][:2] == \
        ["deficit", "hot_keys"]


# ---------------------------------------------------------------------------
# the space bound (tests/mvgc/test_space_property.py)
# ---------------------------------------------------------------------------
@settings(max_examples=8, deadline=None)
@given(data=hst.data())
def test_live_versions_bounded_by_needed_plus_buffer(data):
    """``test_live_versions_bounded_by_needed_plus_buffer``: under slrt,
    live versions <= the current and pinned versions plus the ring's
    occupancy, at every step of a random write / pin / gc interleaving,
    and no retire record is dropped."""
    rng = np.random.default_rng(data.draw(hst.integers(0, 2**31)))
    S, P = 8, 4
    B = S * (P + 1) + 16
    V = B // 2 + P + 2
    state = vstore.make_state(S, V, P, ring_capacity=B, device=CPU)
    pins = set()
    for _ in range(data.draw(hst.integers(5, 25))):
        k = int(rng.integers(1, 5))
        slots = rng.choice(S, size=k, replace=False).astype(np.int32)
        ids = torch.from_numpy(np.pad(slots, (0, 4 - k)))
        m = torch.tensor([True] * k + [False] * (4 - k))
        state, _, ovf = vstore.write_step(
            state, ids, torch.arange(4, dtype=torch.int32), m)
        assert not bool(ovf.any()), "slab overflow under slrt"
        if rng.random() < 0.3:
            lane = int(rng.integers(P))
            if lane in pins:
                state = vstore.end_snapshot(state, i32(lane), true())
                pins.discard(lane)
            else:
                state, _ = vstore.begin_snapshot(state, i32(lane), true())
                pins.add(lane)
        state, _ = vstore.gc_step(state)
        live = int(vstore.live_versions(state))
        bound = S * (1 + len(pins)) + B
        assert live <= bound, f"live {live} > bound {bound} ({len(pins)} pins)"
    assert int(state.dropped_retires) == 0


# ---------------------------------------------------------------------------
# the paged cache (tests/serve/test_paged_mvkv.py)
# ---------------------------------------------------------------------------
def paged_step(st, val, policy="slrt"):
    """``test_paged_mvkv.step``: one token of value ``val`` for both
    sequences."""
    kv = torch.full((2, 2, 8), float(val))
    st, ovf = paged.append_tokens(st, torch.arange(2, dtype=torch.int32),
                                  kv, kv, true(2), gc_policy=policy)
    assert not bool(ovf.any()), "unexpected overflow"
    return st


def test_pinned_snapshot_blocks_page_recycling():
    """``test_pinned_snapshot_blocks_page_recycling``: no page of a pinned
    table is free while pinned; after the unpin and a forced reclaim the
    current tables' pages stay live."""
    st = paged.make_paged_kv(2, 32, 4, 8, 2, 8, dtype=torch.float32,
                             gc=GCConfig(versions_per_slot=16), device=CPU)
    for i in range(4):
        st = paged_step(st, i)
    st, t = paged.begin_snapshot(st, 1)
    for i in range(4, 16):
        st = paged_step(st, i)
    ids = torch.arange(2, dtype=torch.int32)
    tbl_pin, _ = paged.snapshot_view(st, ids, t)
    pinned = [int(p) for p in tbl_pin.reshape(-1) if p >= 0]
    assert pinned and not bool(st.free[pinned].any()), "a pinned page is free"
    st = paged.end_snapshot(st, 1)
    st, _ = paged.reclaim_on_pressure(st, paged.hot_sequences(st, 2), HUGE,
                                      gc_policy="slrt")
    tables, _ = paged.snapshot_view(st, ids, st.mv.now)
    current = [int(p) for p in tables.reshape(-1) if p >= 0]
    assert current and not bool(st.free[current].any())


PROP_B, PROP_PS, PROP_MP = 3, 2, 3


def prop_engine(policy: str) -> PagedKVEngine:
    """``test_paged_mvkv._mk_engine``: 3 sequences, 12 pages of 2 tokens,
    5 table versions a sequence, 2 reader lanes."""
    return PagedKVEngine(PROP_B, 12, PROP_PS, PROP_MP, 1, 4,
                         gc=GCConfig(policy=policy, versions_per_slot=5,
                                     reader_lanes=2),
                         dtype=torch.float32, device=CPU)


def check_reachability(eng: PagedKVEngine) -> None:
    """No table slot a live descriptor version names, and no page such a
    table references, sits in a free pool."""
    st = eng.st
    ts = st.mv.store.ts.reshape(-1).numpy()
    pay = st.mv.store.payload.reshape(-1).numpy()
    tables, table_free = st.tables.numpy(), st.table_free.numpy()
    page_free = st.free.numpy()
    for slot in pay[ts != EMPTY]:
        assert not table_free[slot], \
            f"table slot {slot} is live but in the free pool"
        for p in tables[slot]:
            assert p < 0 or not page_free[p], \
                f"page {p} is reachable via table {slot} but free"


def view_sig(eng: PagedKVEngine, t: int) -> tuple:
    """Each sequence's visible length and every visible K value at ``t``."""
    tbl, ln = (x.numpy() for x in eng.view_at(t))
    k = eng.st.k_pages[:, :, 0, 0].numpy()
    return tuple(
        (int(ln[s]), tuple(float(k[int(tbl[s, j // PROP_PS]), j % PROP_PS])
                           for j in range(int(ln[s]))))
        for s in range(tbl.shape[0]))


def force_reclaim(eng: PagedKVEngine) -> None:
    eng.st, _ = paged.reclaim_on_pressure(
        eng.st, paged.hot_sequences(eng.st, PROP_B), HUGE,
        gc_policy=eng.gc_policy)


def draw_id(data, policy: str) -> int:
    """A sequence id from ``[-n, n)`` (negative ids wrap, as in JAX),
    without -1 under slrt: a write through id -1 there leaks a retire
    record in JAX and in the port alike (trap C9)."""
    return data.draw(hst.sampled_from(
        [i for i in range(-PROP_B, PROP_B) if i != -1 or policy != "slrt"]))


@settings(max_examples=4, deadline=None)
@given(data=hst.data(), policy=hst.sampled_from(["ebr", "steam", "slrt"]))
def test_random_interleaving_reachability_and_pins(data, policy):
    """``test_random_interleaving_reachability_and_pins``: after every
    operation no reachable page or table slot is free, every pinned view
    resolves byte for byte as at its pin (forced reclaims included), and
    every handle ``freed_pages()`` drains is free."""
    eng = prop_engine(policy)
    seq_ids = torch.arange(PROP_B, dtype=torch.int32)
    pins, token = {}, 0.0
    for _ in range(data.draw(hst.integers(12, 24))):
        op = data.draw(hst.sampled_from(
            ["step", "step", "step", "fork", "reset", "pin", "unpin",
             "pressure"]))
        if op == "step":
            token += 1.0
            base = torch.arange(PROP_B, dtype=torch.float32) + PROP_B * token
            kv = base[:, None, None].expand(PROP_B, 1, 4).contiguous()
            m = torch.tensor([data.draw(hst.booleans())
                              for _ in range(PROP_B)])
            eng.step(seq_ids, kv, kv, m)
        elif op == "fork":
            src, dst = draw_id(data, policy), draw_id(data, policy)
            if src % PROP_B != dst % PROP_B:
                eng.fork(i32(src), i32(dst), true())
        elif op == "reset":
            m = torch.zeros(PROP_B, dtype=torch.bool)
            m[data.draw(hst.integers(0, PROP_B - 1))] = True
            eng.reset(seq_ids, m)
        elif op == "pin":
            lane = data.draw(hst.integers(0, 1))
            if lane not in pins:
                t = eng.pin(lane)
                pins[lane] = (t, view_sig(eng, t))
        elif op == "unpin":
            if pins:
                lane = sorted(pins)[0]
                eng.unpin(lane)
                del pins[lane]
        else:
            force_reclaim(eng)
        free_now = eng.st.free.numpy()
        for h in eng.freed_pages():
            assert free_now[h], f"freed_pages() handed out live page {h}"
        check_reachability(eng)
        for t, ref in pins.values():
            assert view_sig(eng, t) == ref, \
                f"pinned view at t={t} drifted after {op} ({policy})"
    for lane in list(pins):
        eng.unpin(lane)


@settings(max_examples=3, deadline=None)
@given(data=hst.data())
def test_pinned_view_survives_forced_reclaim_storm(data):
    """``test_pinned_view_survives_forced_reclaim_storm``: a pin taken
    mid-decode stays byte-stable through resets and back-to-back forced
    reclaims, then its pages go after the unpin and one more reclaim."""
    eng = prop_engine("slrt")
    seq_ids = torch.arange(PROP_B, dtype=torch.int32)
    every = true(PROP_B)
    for i in range(1, 5):
        kv = torch.full((PROP_B, 1, 4), float(i))
        eng.step(seq_ids, kv, kv, every)
    lane = data.draw(hst.integers(0, 1))
    t = eng.pin(lane)
    ref = view_sig(eng, t)
    live_at_pin = int(paged.live_pages(eng.st))
    for i in range(5, 5 + data.draw(hst.integers(3, 8))):
        kv = torch.full((PROP_B, 1, 4), float(i))
        eng.step(seq_ids, kv, kv, every)
        eng.reset(seq_ids, every)
        force_reclaim(eng)
        check_reachability(eng)
        assert view_sig(eng, t) == ref, "pinned view drifted mid-storm"
    eng.unpin(lane)
    force_reclaim(eng)
    check_reachability(eng)
    assert int(paged.live_pages(eng.st)) < live_at_pin


# ---------------------------------------------------------------------------
# forks (tests/serve/test_fork_property.py)
# ---------------------------------------------------------------------------
FB, FPAGES, FPS, FMP, FV = 4, 14, 2, 3, 5
NOW = 2**31 - 2


class ForkModel:
    """``test_fork_property._Model`` over the port's engine: which slots
    are live, the prefix obligations, and the checks after each op."""

    def __init__(self, policy):
        self.eng = PagedKVEngine(
            FB, FPAGES, FPS, FMP, 1, 4,
            gc=GCConfig(policy=policy, versions_per_slot=FV, reader_lanes=2),
            dtype=torch.float32, device=CPU)
        self.live = {0}
        self.validator = forking.ForkValidator()
        self.token = 0.0
        self._append([0])

    def _views(self):
        return tuple(x.numpy() for x in self.eng.view_at(NOW))

    def _append(self, slots):
        self.token += 1.0
        mask = torch.zeros(FB, dtype=torch.bool)
        mask[list(slots)] = True
        base = torch.arange(FB, dtype=torch.float32) + FB * self.token
        kv = base[:, None, None].expand(FB, 1, 4).contiguous()
        self.eng.step(torch.arange(FB, dtype=torch.int32), kv, kv, mask)

    def append(self, slots):
        self._append([s for s in slots if s in self.live])

    def fork(self, parent, child):
        if parent not in self.live or child in self.live:
            return
        if not bool(self.eng.fork(i32(parent), i32(child), true())[0]):
            self.live.add(child)
            tbl, ln = self._views()
            self.validator.note_fork(self.eng.st, child, tbl[child],
                                     int(ln[child]))

    def join(self, child, target):
        if child not in self.live or target not in self.live or \
                child == target:
            return
        if not bool(self.eng.join(i32(child), i32(target), true())[0]):
            self.live.discard(child)
            self.validator.drop(child)
            self.validator.drop(target)

    def release(self, slot):
        if slot not in self.live or len(self.live) == 1:
            return
        if not bool(self.eng.release(i32(slot), true())[0]):
            self.live.discard(slot)
            self.validator.drop(slot)

    def reclaim(self):
        self.eng.reclaim(FPAGES)

    def check(self):
        ok, leaked, premature = forking.check_no_leak(self.eng.st)
        assert ok, f"leaked={leaked.tolist()} premature={premature.tolist()}"
        free_now = self.eng.st.free.numpy()
        for h in self.eng.freed_pages():
            assert free_now[h], f"freed_pages() handed out live page {h}"
        tbl, ln = self._views()
        for s in sorted(self.live):
            assert self.validator.check(self.eng.st, s, tbl[s], int(ln[s])), \
                self.validator.examples
        assert set(self.eng.dag.nodes) <= self.live
        for s in self.eng.dag.nodes:
            assert s not in self.eng.dag.ancestors(s)


@settings(max_examples=5, deadline=None)
@given(data=hst.data(), policy=hst.sampled_from(POLICIES))
def test_random_fork_interleavings_never_leak_or_free_reachable(data, policy):
    """``test_random_fork_interleavings_never_leak_or_free_reachable``:
    after every op a page is free exactly when no live table references
    it, drained handles are free, and every live child's inherited prefix
    holds its bytes."""
    m = ForkModel(policy)
    for _ in range(data.draw(hst.integers(15, 30))):
        op = data.draw(hst.sampled_from(
            ["append", "append", "fork", "fork", "join", "release",
             "reclaim"]))
        if op == "append":
            m.append(sorted(m.live)[:data.draw(hst.integers(1, FB))])
        elif op == "fork":
            frees = sorted(set(range(FB)) - m.live)
            if frees:
                m.fork(data.draw(hst.sampled_from(sorted(m.live))),
                       data.draw(hst.sampled_from(frees)))
        elif op == "join":
            if len(m.live) > 1:
                pair = sorted(m.live)
                m.join(data.draw(hst.sampled_from(pair)),
                       data.draw(hst.sampled_from(pair)))
        elif op == "release":
            m.release(data.draw(hst.sampled_from(sorted(m.live))))
        else:
            m.reclaim()
        m.check()
    assert m.validator.violations == 0
    assert m.eng.forks >= m.eng.joins


@settings(max_examples=3, deadline=None)
@given(data=hst.data())
def test_deep_fork_chains_share_then_free(data):
    """``test_deep_fork_chains_share_then_free``: a chain root -> c1 -> c2
    -> c3 shares the root's pages all the way down; released in a random
    order, it returns every page but the root's."""
    m = ForkModel("slrt")
    for _ in range(FPS * 2):
        m.append([0])
    chain = []
    for child in range(1, FB):
        m.fork(chain[-1] if chain else 0, child)
        chain.append(child)
        m.append([child])
        m.check()
    assert forking.shared_page_count(m.eng.st) > 0
    while chain:
        m.release(chain.pop(data.draw(hst.integers(0, len(chain) - 1))))
        m.check()
    m.reclaim()
    m.check()
    refs = forking.page_refcounts(m.eng.st)
    assert int((~m.eng.st.free).sum()) == int((refs > 0).sum())
