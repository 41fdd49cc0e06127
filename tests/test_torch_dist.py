"""The port's multi-host layer (``repro_torch.dist``) against the JAX
package's (``repro.dist``), on the CPU, float32.

* The building blocks (``stack_states``, ``lwm_contributions``,
  ``age_out_stale``, ``global_lwm``, ``pressure()``) equal JAX's.
* With the inert ``TS_MAX`` global pin, the port's per-host ops land in the
  state of its single-host ops, and in JAX's vmapped stacked state, leaf
  for leaf (``tests/distrib/test_sharded_mvgc.py``'s differential test).
* ``ShardedPagedKVEngine`` equals JAX's on seeded traces of steps, resets,
  forks, explicit reclaims, pins on rotating hosts and a stall, for every
  policy and 2 and 4 hosts: failed masks after every op, ``space()`` after
  every step, then the stacked state, ``lwm_advances`` and the stats.
* The protocol tests of ``tests/distrib/test_sharded_mvgc.py``, ported.
* ``chip_smoke.py``'s dist-tier loop reproduces BENCH_dist.json; in the
  stall tier under steam the port gives what the JAX engine gives with
  trap C5 (an inert lane's write over a compaction) removed, which moves
  four of the committed row's counters (trap C11).
* Checkpoints interchange with JAX's engine in both directions.
* The port's ``StepWatchdog`` and ``HeartbeatFile`` pass JAX's tests.
* The ring all-reduce over 4 gloo processes is bit-equal to JAX's ring
  over 4 CPU devices, in float32 sum and mean, and gives the min in int32.
"""
import dataclasses
import functools
import importlib.util
import math
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.core.mvgc import vstore as j_vs
from repro.core.sim.measure import DistMeasurement
from repro.core.telemetry import GCConfig as JGC
from repro.dist import mvgc as jd
from repro.mvkv import paged as jp

from repro_torch.convert import to_numpy
from repro_torch.core.telemetry import GCConfig as TGC
from repro_torch.dist import mvgc as td
from repro_torch.dist.overlap import ring_all_reduce
from repro_torch.dist.straggler import HeartbeatFile, StepWatchdog
from repro_torch.mvkv import paged as tp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TS_MAX = 2**31 - 1
B, NP, PS, MP, KVH, HD = 4, 12, 4, 3, 1, 4
CPU = torch.device("cpu")


def _gc(policy="slrt", **kw):
    kw = dict(policy=policy, versions_per_slot=6, reader_lanes=4, **kw)
    return JGC(**kw), TGC(**kw)


def engines(hosts, policy="slrt", **kw):
    jg, tg = _gc(policy, **kw)
    return (jd.ShardedPagedKVEngine(hosts, B, NP, PS, MP, KVH, HD, gc=jg),
            td.ShardedPagedKVEngine(hosts, B, NP, PS, MP, KVH, HD, gc=tg,
                                    device=CPU))


def same_tree(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), jax.tree.leaves(to_numpy(ttree))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _seq(hosts):
    return np.broadcast_to(np.arange(B, dtype=np.int32), (hosts, B)).copy()


def _kv(hosts, step):
    """Per-(host, step, seq) distinct payloads: a wrongly reclaimed page
    shows as a value mismatch."""
    base = (np.arange(hosts * B, dtype=np.float32).reshape(hosts, B)
            + hosts * B * (step + 1))
    return np.broadcast_to(base[:, :, None, None],
                           (hosts, B, KVH, HD)).copy()


def _churn(eng, steps, start=0):
    """Append/reset churn that retires versions and recycles pages on every
    host."""
    hosts = eng.hosts
    seq, on = _seq(hosts), np.ones((hosts, B), bool)
    for step in range(start, start + steps):
        eng.step(seq, _kv(hosts, step), _kv(hosts, step), on)
        if step % 3 == 2:
            done = np.zeros((hosts, B), bool)
            done[:, step % B] = True
            eng.reset(seq, done)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def chip_smoke():
    return _chip_smoke()


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
def test_stack_states_matches_jax():
    jg, tg = _gc()
    base_j = jp.make_paged_kv(B, NP, PS, MP, KVH, HD, gc=jg,
                                dtype=jnp.float32)
    base_t = tp.make_paged_kv(B, NP, PS, MP, KVH, HD, torch.float32, gc=tg,
                              device=CPU)
    st = td.stack_states(base_t, 3)
    same_tree(jd.stack_states(base_j, 3), st)
    for leaf, orig in zip(jax.tree.leaves(to_numpy(st)),
                          jax.tree.leaves(to_numpy(base_t))):
        assert leaf.shape == (3,) + orig.shape


def test_lwm_contributions_sentinel_and_pins():
    j, t = engines(3)
    for e in (j, t):
        _churn(e, 2)
    got = td.lwm_contributions(t.stacked())
    assert got.dtype == torch.int32 and (got == TS_MAX).all()
    assert j.pin(1, 0) == t.pin(1, 0)
    np.testing.assert_array_equal(np.asarray(jd.lwm_contributions(j.st)),
                                  td.lwm_contributions(t.stacked()).numpy())
    assert td.lwm_contributions(t.stacked()).tolist()[0] == TS_MAX


@pytest.mark.parametrize("contrib,ages,budget", [
    ([15, 7, TS_MAX], [0.0, 100.0, 100.0], 5.0),
    ([15, 7, 9, TS_MAX], [6.0, 5.0, 4.0, 7.0], [5.0, 4.0, 4.0, 1.0]),
    ([TS_MAX, TS_MAX], [0.0, 0.0], math.inf),
])
def test_age_out_stale_and_global_lwm_match_jax(contrib, ages, budget):
    j_aged, j_n = jd.age_out_stale(jnp.asarray(contrib, jnp.int32),
                                   np.asarray(ages, np.float32), budget)
    t_aged, t_n = td.age_out_stale(torch.tensor(contrib, dtype=torch.int32),
                                   np.asarray(ages, np.float32), budget)
    np.testing.assert_array_equal(np.asarray(j_aged), t_aged.numpy())
    assert t_aged.dtype == t_n.dtype == torch.int32
    assert int(j_n) == int(t_n)
    assert int(jd.global_lwm(j_aged)) == int(td.global_lwm(t_aged))
    assert int(jd.global_lwm(jnp.asarray(contrib, jnp.int32))) == \
        int(td.global_lwm(torch.tensor(contrib, dtype=torch.int32)))


def test_pressure_is_a_signal_with_host_dim_as_jax():
    j, t = engines(2)
    for e in (j, t):
        _churn(e, 5)
    js, ts = j.pressure(), t.pressure()
    assert type(ts).__name__ == "PressureSignal"
    for f in js._fields:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert b.shape == (2,) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the inert TS_MAX pin: sharding changes placement, never the protocol
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["ebr", "steam", "dlrt", "slrt"])
def test_sentinel_pin_trace_matches_single_host_and_jax(policy):
    """The same trace through (a) the port's single-host ops, no pin, (b)
    its ops on each of 3 hosts with the TS_MAX pin, and (c) JAX's vmapped
    stacked ops with the TS_MAX pin: (b) equals (a) on every host and (c)
    leaf for leaf."""
    jg, tg = _gc(policy)
    hosts = 3
    single = tp.make_paged_kv(B, NP, PS, MP, KVH, HD, torch.float32, gc=tg,
                              device=CPU)
    shards = [tp.make_paged_kv(B, NP, PS, MP, KVH, HD, torch.float32,
                               gc=tg, device=CPU) for _ in range(hosts)]
    stacked = jd.stack_states(jp.make_paged_kv(
        B, NP, PS, MP, KVH, HD, gc=jg, dtype=jnp.float32), hosts)
    pin_t = torch.full((1,), TS_MAX, dtype=torch.int32)
    pins_j = jnp.full((hosts, 1), TS_MAX, jnp.int32)
    apph = jax.jit(jax.vmap(lambda s, q, k, v, m, p: jp.append_tokens(
        s, q, k, v, m, gc_policy=policy, extra_pins=p)))
    rsth = jax.jit(jax.vmap(lambda s, q, m, p: jp.reset_sequence(
        s, q, m, gc_policy=policy, extra_pins=p)))
    rech = jax.jit(jax.vmap(lambda s, h, d, p: jp.reclaim_on_pressure(
        s, h, d, gc_policy=policy, extra_pins=p)))
    hoth = jax.vmap(functools.partial(jp.hot_sequences, k=2))
    seq = torch.arange(B, dtype=torch.int32)
    on = torch.ones(B, dtype=torch.bool)
    for step in range(12):
        kv = torch.as_tensor(_kv(1, step)[0])
        kvh = jnp.broadcast_to(jnp.asarray(kv.numpy())[None],
                               (hosts, B, KVH, HD))
        single, f1 = tp.append_tokens(single, seq, kv, kv, on,
                                      gc_policy=policy)
        for h in range(hosts):
            shards[h], fh = tp.append_tokens(shards[h], seq, kv, kv, on,
                                             gc_policy=policy,
                                             extra_pins=pin_t)
            assert torch.equal(fh, f1)
        stacked, fj = apph(stacked, jnp.asarray(_seq(hosts)), kvh, kvh,
                           jnp.ones((hosts, B), bool), pins_j)
        np.testing.assert_array_equal(np.asarray(fj[1]), f1.numpy())
        if step % 4 == 3:
            done = on & (seq == step % B)
            single, _ = tp.reset_sequence(single, seq, done,
                                          gc_policy=policy)
            for h in range(hosts):
                shards[h], _ = tp.reset_sequence(shards[h], seq, done,
                                                 gc_policy=policy,
                                                 extra_pins=pin_t)
            stacked, _ = rsth(stacked, jnp.asarray(_seq(hosts)),
                              jnp.broadcast_to(jnp.asarray(done.numpy()),
                                               (hosts, B)), pins_j)
        if step % 5 == 4:
            single, _ = tp.reclaim_on_pressure(
                single, tp.hot_sequences(single, 2), 4, gc_policy=policy)
            for h in range(hosts):
                shards[h], _ = tp.reclaim_on_pressure(
                    shards[h], tp.hot_sequences(shards[h], 2), 4,
                    gc_policy=policy, extra_pins=pin_t)
            stacked, _ = rech(stacked, hoth(stacked),
                              jnp.full((hosts,), 4, jnp.int32), pins_j)
    for h in range(hosts):
        for a, b in zip(jax.tree.leaves(to_numpy(shards[h])),
                        jax.tree.leaves(to_numpy(single))):
            np.testing.assert_array_equal(a, b)
    same_tree(stacked, td.stack_states(single, hosts))


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hosts", [2, 4])
@pytest.mark.parametrize("policy", ["ebr", "steam", "dlrt", "slrt", "sweep"])
def test_engine_matches_jax(policy, hosts):
    """Seeded random masks, resets, COW forks (distinct destinations),
    pins and unpins on rotating hosts, reclaim(None), reclaim(NP) and a
    stall through ``virtual_ages_s`` of the host that pins at step 17 and
    keeps its pin, under a finite staleness budget."""
    j, t = engines(hosts, policy, stale_after_s=5.0)
    stalled = (17 // 5) % hosts
    rng = np.random.default_rng(hosts * 10 + len(policy))
    seq = _seq(hosts)

    def both(op):
        fj, ft = op(j, jnp.asarray), op(t, torch.as_tensor)
        np.testing.assert_array_equal(np.asarray(fj), to_numpy(ft))

    pins = {}
    for step in range(24):
        kv = rng.standard_normal((hosts, B, KVH, HD)).astype(np.float32)
        m = rng.random((hosts, B)) < 0.9
        both(lambda e, c: e.step(c(seq), c(kv), c(kv), c(m)))
        if step % 4 == 3:
            done = rng.random((hosts, B)) < 0.4
            both(lambda e, c: e.reset(c(seq), c(done)))
        if step % 7 == 5:
            dst = np.stack([np.roll(seq[h], 1 + rng.integers(0, B - 1))
                            for h in range(hosts)])
            fm = np.zeros((hosts, B), bool)
            fm[np.arange(hosts), rng.integers(0, B, hosts)] = True
            both(lambda e, c: e.fork(c(seq), c(dst), c(fm)))
        if step % 5 == 2:
            key = ((step // 5) % hosts, step % 4)
            pins[key] = j.pin(*key)
            assert t.pin(*key) == pins[key]
        held = [k for k in pins if step < 18 or k[0] != stalled]
        if step % 5 == 4 and held:
            key = min(held)
            j.unpin(*key)
            t.unpin(*key)
            del pins[key]
        if step == 10:
            assert j.reclaim(None) == t.reclaim(None)
        if step == 16:
            assert j.reclaim(NP) == t.reclaim(NP)
        if step == 18:
            ages = np.zeros(hosts, np.float32)
            ages[stalled] = 100.0
            j.virtual_ages_s = t.virtual_ages_s = ages
        assert j.space() == t.space()
    same_tree(j.st, t.stacked())
    assert j.lwm_advances == t.lwm_advances
    assert dataclasses.asdict(j.stats) == dataclasses.asdict(t.stats)
    assert t.stats.stale_lanes_aged > 0 and t.stats.reclaimed > 0
    assert sum(t.pages_reclaimed_by_host) == t.stats.reclaimed


# ---------------------------------------------------------------------------
# global-LWM safety and straggler tolerance (tests/distrib/
# test_sharded_mvgc.py:173-266, on the port's engine)
# ---------------------------------------------------------------------------
def _port_engine(hosts, **kw):
    return td.ShardedPagedKVEngine(hosts, B, NP, PS, MP, KVH, HD,
                                   gc=_gc(**kw)[1], device=CPU)


def test_sharded_engine_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        td.ShardedPagedKVEngine(2, B, NP, PS, MP, KVH, HD)
    eng = td.ShardedPagedKVEngine(2, B, NP, PS, MP, KVH, HD, device="cpu")
    assert all(s.free.device.type == "cpu" for s in eng.shards)


def test_pin_on_one_host_protects_every_shard(chip_smoke):
    """A pin on host 0 protects the views of every host's shard at that
    timestamp under churn and forced reclaims; with the LWM neutered a
    remote view is corrupted, so the global LWM is what protects them."""
    def view(eng, h, ts):
        return chip_smoke._view_checksum(eng.host_state(h),
                                         *eng.view_at(h, ts), PS)

    def run(neuter_lwm):
        eng = _port_engine(4)
        if neuter_lwm:
            sentinel = torch.full((eng.hosts, 1), TS_MAX, dtype=torch.int32)
            eng.lwm_pins = lambda: sentinel
        _churn(eng, 4)
        ts = eng.pin(0, 0)
        refs = {h: view(eng, h, ts) for h in range(eng.hosts)}
        _churn(eng, 8, start=4)
        eng.reclaim(deficit=NP)
        _churn(eng, 4, start=12)
        return sum(view(eng, h, ts) != refs[h] for h in range(eng.hosts))

    assert run(neuter_lwm=False) == 0
    assert run(neuter_lwm=True) > 0


def test_lwm_tracks_min_over_hosts():
    eng = _port_engine(3)
    _churn(eng, 3)
    t0 = eng.pin(0, 0)
    _churn(eng, 2, start=3)
    t1 = eng.pin(1, 0)
    assert t1 > t0
    pins = eng.lwm_pins()
    assert pins.shape == (3, 1) and (pins == t0).all()
    eng.unpin(0, 0)
    assert (eng.lwm_pins() == t1).all()
    assert eng.lwm_advances >= 1


def test_stalled_host_is_aged_out_and_reclamation_proceeds(chip_smoke):
    eng = _port_engine(4, stale_after_s=5.0)
    _churn(eng, 4)
    ts = eng.pin(1, 0)
    assert (eng.lwm_pins() == ts).all()
    ages = np.zeros((4,), np.float32)
    ages[1] = 100.0
    eng.virtual_ages_s = ages
    assert (eng.lwm_pins() == TS_MAX).all()
    assert eng.stats.stale_lanes_aged >= 1
    before = eng.stats.reclaimed
    _churn(eng, 6, start=4)
    eng.reclaim(deficit=NP)
    assert eng.stats.reclaimed > before
    # the stalled host's own board still protects its shard
    ref = chip_smoke._view_checksum(eng.host_state(1), *eng.view_at(1, ts),
                                    PS)
    _churn(eng, 3, start=10)
    assert chip_smoke._view_checksum(eng.host_state(1), *eng.view_at(1, ts),
                                     PS) == ref
    row = eng.space()
    assert row["stale_lanes_aged"] >= 1 and row["pages_reclaimed"] > 0


def test_fresh_hosts_never_aged_with_infinite_budget():
    eng = _port_engine(2)
    _churn(eng, 3)
    assert eng.stats.stale_lanes_aged == 0
    assert (eng.budget_s() > 0).all() and np.isfinite(eng.budget_s()).all()


# ---------------------------------------------------------------------------
# BENCH_dist.json through chip_smoke.py's phase-9 loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["ebr", "steam", "dlrt", "slrt"])
@pytest.mark.parametrize("tier", ["smoke", "standard", "stall"])
def test_dist_tier_matches_bench_dist(chip_smoke, tier, policy):
    """Every field of the committed row but ``wall_s`` (C11's fields taken
    from ``DIST_C11_FIELDS``), no pin violation, and a stalled host aged
    out."""
    want = chip_smoke.expected_dist_rows()[(tier, policy)]
    got = chip_smoke.dist_cell(tier, policy, CPU)
    assert DistMeasurement(**got, wall_s=want["wall_s"]).to_row() == want
    assert got["pin_violations"] == 0
    assert (got["stale_lanes_aged"] > 0) == (tier == "stall") \
        == (got["stalled_hosts"] > 0)


def test_dist_tiers_cover_bench_dist(chip_smoke):
    assert set(chip_smoke.bench_dist_rows()) == {
        (t, p) for t in chip_smoke.DIST_TIERS
        for p in chip_smoke.DIST_POLICIES}


def test_c11_c5_is_all_that_moves_the_stall_steam_row(chip_smoke,
                                                      monkeypatch):
    """BENCH_dist.json's stall/steam row came from the JAX engine through
    trap C5: a hot-slot sweep whose inert lane, clamped onto slot 0,
    writes slot 0's old row back over its compaction (XLA keeps the last
    write).  With the inert lanes dropped instead (what the port does),
    ``dist_bench.run_cell`` gives the port's row field for field, and it
    differs from the committed row in ``DIST_C11_FIELDS`` and nowhere
    else."""
    spec = importlib.util.spec_from_file_location(
        "dist_bench", os.path.join(ROOT, "benchmarks", "dist_bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    sweep_slots = j_vs._sweep_slots

    def c5_free(state, slot_ids, mask, **kw):
        return sweep_slots(state, jnp.where(mask, slot_ids,
                                            state.store.ts.shape[0]),
                           mask, **kw)

    monkeypatch.setattr(j_vs, "_sweep_slots", c5_free)
    key = ("stall", "steam")
    jax_row = bench.run_cell(*key).to_row()
    got = chip_smoke.dist_cell(*key, CPU)
    assert {f: jax_row[f] for f in got} == got
    committed = chip_smoke.bench_dist_rows()[key]
    moved = {f: v for f, v in got.items() if committed[f] != v}
    assert moved == chip_smoke.DIST_C11_FIELDS[key]


# ---------------------------------------------------------------------------
# checkpoint interchange (tests/ckpt/test_recovery.py:181, both directions)
# ---------------------------------------------------------------------------
def _drive(pair, steps, start, rng):
    seq = _seq(2)
    for step in range(start, start + steps):
        kv = rng.standard_normal((2, B, KVH, HD)).astype(np.float32)
        f = [e.step(c(seq), c(kv), c(kv), c(np.ones((2, B), bool)))
             for e, c in zip(pair, (jnp.asarray, torch.as_tensor))]
        np.testing.assert_array_equal(np.asarray(f[0]), to_numpy(f[1]))
        if step % 3 == 2:
            done = np.zeros((2, B), bool)
            done[:, step % B] = True
            for e, c in zip(pair, (jnp.asarray, torch.as_tensor)):
                e.reset(c(seq), c(done))


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_checkpoint_interchanges_with_jax(tmp_path, saver):
    """One engine drives 5 steps and checkpoints; a fresh engine of the
    other package restores it.  The trees and the counters are equal, and
    4 steps later both still agree."""
    kw = dict(hot_k=4)
    src_pair, dst_pair = engines(2, **kw), engines(2, **kw)
    rng = np.random.default_rng(0)
    _drive(src_pair, 5, 0, rng)
    src_pair[0].pin(1, 0)
    src_pair[1].pin(1, 0)
    if saver == "port":       # JAX's engine restores the port's files
        pair = (dst_pair[0], src_pair[1])
        step_no = pair[1].checkpoint(tmp_path)
        assert pair[0].restore(tmp_path) == step_no
    else:                     # and the port's engine JAX's
        pair = (src_pair[0], dst_pair[1])
        step_no = pair[0].checkpoint(tmp_path)
        assert pair[1].restore(tmp_path) == step_no
    same_tree(pair[0].st, pair[1].stacked())
    for f in ("forks", "ckpt_max", "lwm_advances", "_last_lwm"):
        assert getattr(pair[0], f) == getattr(pair[1], f)
    assert pair[1].ckpt_max == int(jnp.min(pair[0].st.mv.now))
    assert dataclasses.asdict(pair[0].stats) == \
        dataclasses.asdict(pair[1].stats)
    _drive(pair, 4, 5, rng)
    same_tree(pair[0].st, pair[1].stacked())
    assert pair[0].space() == pair[1].space()


def test_restore_refuses_another_host_count(tmp_path):
    eng = _port_engine(2)
    eng.checkpoint(tmp_path)
    with pytest.raises(ValueError):
        _port_engine(3).restore(tmp_path)


# ---------------------------------------------------------------------------
# straggler (tests/distrib/test_dist_unit.py:260-323, on the port's copy)
# ---------------------------------------------------------------------------
class TestStraggler:
    def test_watchdog_no_false_positives_during_warmup(self):
        wd = StepWatchdog(k_sigma=3.0, min_budget_s=0.0)
        wd.start()
        time.sleep(0.02)
        wd.stop(0)
        assert wd.suspect_steps == []

    def test_watchdog_outlier_excluded_from_stats(self):
        wd = StepWatchdog(k_sigma=3.0, min_budget_s=0.0)
        for i in range(10):
            wd.start()
            time.sleep(0.001)
            wd.stop(i)
        thr_before = wd.threshold()
        wd.start()
        time.sleep(0.05)
        wd.stop(42)
        assert 42 in wd.suspect_steps
        assert wd.threshold() == pytest.approx(thr_before, rel=1e-6)

    def test_watchdog_min_budget_floor(self):
        wd = StepWatchdog(k_sigma=0.0, min_budget_s=10.0)
        for i in range(20):
            wd.start()
            wd.stop(i)
        assert wd.suspect_steps == []

    def test_heartbeat_roundtrip(self, tmp_path):
        hb = HeartbeatFile(str(tmp_path / "sub" / "hb.json"), host_id=3)
        assert hb.read() is None and hb.age_s() == float("inf")
        hb.beat(17)
        rec = hb.read()
        assert rec["host_id"] == 3 and rec["step"] == 17
        assert hb.age_s() < 60
        assert os.listdir(tmp_path / "sub") == ["hb.json"]

    def test_heartbeat_corrupt_file_is_dead(self, tmp_path):
        p = tmp_path / "hb.json"
        p.write_text("{not json")
        hb = HeartbeatFile(str(p), host_id=0)
        assert hb.read() is None
        assert hb.age_s() == float("inf")

    def test_budget_is_finite_during_warmup(self):
        wd = StepWatchdog(min_budget_s=0.25)
        assert wd.threshold() == float("inf")
        assert wd.budget_s() == pytest.approx(3.0 * 0.25)
        assert wd.is_stale(float("inf"))
        assert not wd.is_stale(0.0)

    def test_never_beaten_heartbeat_counts_stale(self, tmp_path):
        hb = HeartbeatFile(str(tmp_path / "hb.json"), host_id=1)
        assert StepWatchdog().is_stale(hb.age_s())

    def test_budget_tracks_threshold_after_warmup(self):
        wd = StepWatchdog(k_sigma=0.0, min_budget_s=2.0, warmup_steps=1)
        wd.start()
        wd.stop(0)
        assert wd.threshold() == pytest.approx(2.0)
        assert wd.budget_s(grace_steps=4.0) == pytest.approx(8.0)
        assert wd.is_stale(8.5, grace_steps=4.0)
        assert not wd.is_stale(7.5, grace_steps=4.0)


# ---------------------------------------------------------------------------
# the ring all-reduce: 4 gloo processes against JAX's ring on 4 CPU devices
# ---------------------------------------------------------------------------
RANKS = 4
# float32 shards of 9 elements (chunks padded to 3) and int32 LWM boards
RING_CASES = {
    "sum": ("f4", "sum"),
    "mean": ("f4", "mean"),
    "min": ("i4", "min"),
    "min_pin_free": ("i4", "min"),
}

_TORCH_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.dist.overlap import ring_all_reduce
rank, store, io = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store,
                        rank=rank, world_size={ranks})
try:
    for name, reduce in {cases}:
        x = np.load(f"{{io}}/{{name}}_in.npy")[rank]
        out = ring_all_reduce(torch.from_numpy(x), reduce=reduce)
        np.save(f"{{io}}/{{name}}_torch_{{rank}}.npy", out.numpy())
finally:
    dist.destroy_process_group()
"""

_JAX_RING = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.dist.overlap import make_ring_all_reduce
io = sys.argv[1]
mesh = jax.make_mesh(({ranks},), ("hosts",))
for name, reduce in {cases}:
    x = np.load(f"{{io}}/{{name}}_in.npy")
    fn = jax.jit(make_ring_all_reduce(mesh, "hosts", reduce=reduce))
    out = np.asarray(fn(jnp.asarray(x.reshape(-1))))
    np.save(f"{{io}}/{{name}}_jax.npy", out.reshape(x.shape))
"""


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """Run both rings once over the same seeded inputs; returns the io
    directory."""
    io = tmp_path_factory.mktemp("ring")
    rng = np.random.default_rng(0)
    for name, (dtype, _) in RING_CASES.items():
        if dtype == "f4":
            x = rng.standard_normal((RANKS, 9)).astype(np.float32) * 1e3
        elif name == "min_pin_free":
            x = np.full((RANKS, 5), TS_MAX, np.int32)
        else:
            x = rng.integers(0, 1000, (RANKS, 5)).astype(np.int32)
            x[2] = TS_MAX                        # a pin-free host
        np.save(io / f"{name}_in.npy", x)
    cases = [(n, r) for n, (_, r) in RING_CASES.items()]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={RANKS}")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c",
         _JAX_RING.format(ranks=RANKS, cases=cases), str(io)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    code = _TORCH_RANK.format(ranks=RANKS, cases=cases)
    ranks = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(io / "store"), str(io)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(RANKS)]
    try:
        for p in [jax_proc] + ranks:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, out.decode()
    finally:
        for p in [jax_proc] + ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    return io


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_all_reduce_matches_jax_ring(ring_runs, name):
    """float32 sum and mean bit-equal to JAX's ring on every rank (the same
    chunking and hop order); int32 min is the min everywhere, TS_MAX when
    every board is pin-free."""
    x = np.load(ring_runs / f"{name}_in.npy")
    want = np.load(ring_runs / f"{name}_jax.npy")
    for r in range(RANKS):
        got = np.load(ring_runs / f"{name}_torch_{r}.npy")
        assert got.dtype == want.dtype == x.dtype
        np.testing.assert_array_equal(got, want[r])
    if RING_CASES[name][1] == "min":
        np.testing.assert_array_equal(want[0], x.min(axis=0))
    if name == "min_pin_free":
        assert (want == TS_MAX).all()
    if name == "sum":       # and it is a sum, to float32 rounding
        np.testing.assert_allclose(want[0], x.sum(axis=0), rtol=1e-6)


@pytest.mark.parametrize("reduce", ["sum", "mean", "min"])
def test_ring_all_reduce_single_rank_identity(reduce):
    """A process with no process group is a group of one: the identity
    (``mean`` divides by 1.0, as JAX's does)."""
    x = torch.tensor([7.0, 3.0, 11.0])
    out = ring_all_reduce(x, reduce=reduce)
    assert torch.equal(out, x) and out is not x
    i = torch.tensor([7, 3, 11], dtype=torch.int32)
    assert torch.equal(ring_all_reduce(i, reduce="min"), i)


def test_ring_all_reduce_rejects_unknown_reduce():
    with pytest.raises(ValueError):
        ring_all_reduce(torch.zeros(3), reduce="max")


def test_global_lwm_takes_a_ring():
    contrib = torch.tensor([23, 5, TS_MAX], dtype=torch.int32)
    ring = functools.partial(ring_all_reduce, reduce="min")
    assert int(td.global_lwm(contrib, ring)) == 5
