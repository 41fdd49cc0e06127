"""The port's ``PagedKVEngine`` against the JAX engine on the same traces.

* The ``benchmarks/serve_bench.py`` trace (continuous decode, resets at
  random target lengths, pinned snapshot readers re-resolving their view
  every step) at the ``smoke`` and ``storm`` geometries, for the four
  policies that bench runs: every deterministic counter, the freed-page
  list of every call and the final state must match, with zero
  pinned-view violations.  The committed ``BENCH_serve.json`` rows of those
  tiers are a second check.
* A ``benchmarks/fork_bench.py``-style beam trace (fork / join / release,
  COW and eager copy) and a checkpoint-eviction trace armed through
  ``engine.ckpt_max``.
"""
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.core.telemetry import GCConfig as JGC
from repro.serve.engine import PagedKVEngine as JEngine

from repro_torch.convert import to_numpy
from repro_torch.core.telemetry import GCConfig as TGC
from repro_torch.serve.engine import PagedKVEngine as TEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# geometry of benchmarks/serve_bench.py TIERS["smoke"] and ["storm"]
TIERS = {
    "smoke": dict(num_seqs=4, num_pages=16, page_size=4, max_pages_per_seq=3,
                  versions_per_seq=6, steps=24, min_len=4, max_len=10,
                  pin_every=6, pin_hold=3, seed=0),
    "storm": dict(num_seqs=8, num_pages=24, page_size=4, max_pages_per_seq=3,
                  versions_per_seq=6, steps=160, min_len=4, max_len=12,
                  pin_every=5, pin_hold=3, seed=0),
}
KV_HEADS, HEAD_DIM, READER_LANES = 1, 4, 4
COUNTERS = ("pressure_events", "reclaims_triggered", "pages_reclaimed",
            "peak_pages", "peak_pages_post_reclaim", "give_ups")


def make_engine(pkg, num_seqs, num_pages, page_size, max_pages, policy, V,
                hot_k=8, eager_fork=False):
    if pkg == "jax":
        return JEngine(num_seqs, num_pages, page_size, max_pages, KV_HEADS,
                       HEAD_DIM, gc=JGC(policy=policy, versions_per_slot=V,
                                        reader_lanes=READER_LANES,
                                        hot_k=hot_k),
                       eager_fork=eager_fork, dtype=jnp.float32)
    return TEngine(num_seqs, num_pages, page_size, max_pages, KV_HEADS,
                   HEAD_DIM, gc=TGC(policy=policy, versions_per_slot=V,
                                    reader_lanes=READER_LANES, hot_k=hot_k),
                   eager_fork=eager_fork, dtype=torch.float32, device="cpu")


def view_checksum(eng, tables, lengths, page_size):
    """Exact K values of every visible token (serve_bench's fingerprint)."""
    k = np.asarray(eng.st.k_pages)[:, :, 0, 0]
    return tuple(
        tuple(float(k[int(tables[s, i // page_size]), i % page_size])
              for i in range(int(lengths[s])))
        for s in range(tables.shape[0]))


def serve_trace(pkg, tier, policy):
    """serve_bench.run_cell's op sequence; returns what it observed."""
    p = TIERS[tier]
    B, ps = p["num_seqs"], p["page_size"]
    eng = make_engine(pkg, B, p["num_pages"], ps, p["max_pages_per_seq"],
                      policy, p["versions_per_seq"])
    rng = random.Random(p["seed"])
    targets = [rng.randrange(p["min_len"], p["max_len"] + 1)
               for _ in range(B)]
    cur_len = [0] * B
    ids = np.arange(B, dtype=np.int32)
    all_mask = np.ones(B, bool)
    out = dict(tokens=0, completed=0, pins=0, validated=0, violations=0,
               freed=[])
    live_pins, next_lane = {}, 0

    def drain():
        free_now = np.asarray(eng.st.free)
        got = eng.freed_pages()
        out["violations"] += sum(not bool(free_now[h]) for h in got)
        out["freed"].append(got)

    for step in range(p["steps"]):
        base = np.arange(B, dtype=np.float32) + B * (step + 1)
        kv = np.ascontiguousarray(np.broadcast_to(
            base[:, None, None], (B, KV_HEADS, HEAD_DIM)))
        failed = np.asarray(eng.step(ids, kv, kv, all_mask))
        drain()
        for s in range(B):
            if not failed[s]:
                out["tokens"] += 1
                cur_len[s] += 1
        done = np.array([cur_len[s] >= targets[s] for s in range(B)])
        if done.any():
            eng.reset(ids, done)
            drain()
            for s in np.flatnonzero(done):
                out["completed"] += 1
                cur_len[int(s)] = 0
                targets[int(s)] = rng.randrange(p["min_len"],
                                                p["max_len"] + 1)
        if step % p["pin_every"] == 0 and len(live_pins) < READER_LANES:
            lane = next_lane % READER_LANES
            next_lane += 1
            while lane in live_pins:
                lane = (lane + 1) % READER_LANES
            ts = eng.pin(lane)
            tbl, ln = eng.view_at(ts)
            ref = view_checksum(eng, np.asarray(tbl), np.asarray(ln), ps)
            live_pins[lane] = [ts, ref, p["pin_hold"]]
            out["pins"] += 1
        for lane in list(live_pins):
            ts, ref, hold = live_pins[lane]
            tbl, ln = eng.view_at(ts)
            out["validated"] += 1
            if view_checksum(eng, np.asarray(tbl), np.asarray(ln), ps) != ref:
                out["violations"] += 1
            live_pins[lane][2] = hold - 1
            if live_pins[lane][2] <= 0:
                eng.unpin(lane)
                del live_pins[lane]
    for lane in list(live_pins):
        eng.unpin(lane)
    out.update({c: getattr(eng, c) for c in COUNTERS})
    out["space"] = eng.space()
    return eng, out


def assert_engines_equal(je, te):
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            je.st))
    got = jax.tree_util.tree_leaves(to_numpy(te.st))
    for a, b in zip(want, got, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("policy", ["ebr", "steam", "dlrt", "slrt"])
@pytest.mark.parametrize("tier", ["smoke", "storm"])
def test_serve_trace_matches_jax_engine(tier, policy):
    je, want = serve_trace("jax", tier, policy)
    te, got = serve_trace("torch", tier, policy)
    assert got["violations"] == 0
    for key in want:
        if key != "space":
            assert got[key] == want[key], key
    space = dict(got["space"])
    assert {k: space[k] for k in want["space"]} == want["space"]
    assert_engines_equal(je, te)
    if tier == "storm":
        assert got["pressure_events"] > 0 and got["pages_reclaimed"] > 0 \
            or policy == "steam"


def test_serve_counters_match_committed_bench():
    """BENCH_serve.json rows for smoke and storm, produced by the JAX
    engine, hold for the port too (storm: ebr 59/59/361, dlrt and slrt
    59/59/362, steam 3/3/0 pressure events / reclaims / pages)."""
    with open(os.path.join(ROOT, "BENCH_serve.json")) as f:
        rows = json.load(f)["rows"]
    checked = 0
    for row in rows:
        tier = row["figure"].split("/")[1]
        if tier not in TIERS:
            continue
        _, got = serve_trace("torch", tier, row["scheme"])
        for key in COUNTERS:
            assert got[key] == row[key], (tier, row["scheme"], key)
        assert got["tokens"] == row["tokens_appended"]
        assert got["violations"] == row["scan_violations"] == 0
        checked += 1
    assert checked == 8


def beam_trace(pkg, policy, eager):
    """fork_bench's beam workload at its smoke geometry: a root forks two
    children per round, they decode, one joins back, the rest release."""
    eng = make_engine(pkg, 6, 24, 4, 6, policy, 8, hot_k=6, eager_fork=eager)
    B, ids = 6, np.arange(6, dtype=np.int32)
    step_no = [0]

    def append(mask):
        step_no[0] += 1
        base = np.arange(B, dtype=np.float32) + B * step_no[0]
        kv = np.ascontiguousarray(np.broadcast_to(
            base[:, None, None], (B, KV_HEADS, HEAD_DIM)))
        return np.asarray(eng.step(ids, kv, kv, mask)).tolist()

    log = []
    root = np.zeros(B, bool)
    root[0] = True
    for _ in range(6):
        log.append(append(root))
    for rnd in range(3):
        kids = [1 + 2 * (rnd % 2), 2 + 2 * (rnd % 2)]
        pairs = np.array([0, 0], np.int32), np.array(kids, np.int32)
        log.append(np.asarray(eng.fork(*pairs, np.ones(2, bool))).tolist())
        kid_mask = np.zeros(B, bool)
        kid_mask[kids] = True
        for _ in range(2):
            log.append(append(kid_mask))
        log.append(append(root))
        tbl, ln = eng.view_at(2**31 - 2)
        log.append((np.asarray(tbl).tolist(), np.asarray(ln).tolist()))
        if rnd % 2:
            eng.join(np.array([kids[0]], np.int32), np.array([0], np.int32),
                     np.ones(1, bool))
            eng.release(np.array([kids[1]], np.int32), np.ones(1, bool))
        else:
            eng.release(np.array(kids, np.int32), np.ones(2, bool))
        log.append(eng.freed_pages())
    counts = {c: getattr(eng, c) for c in COUNTERS + ("forks", "joins",
                                                      "releases")}
    return eng, log, counts, eng.dag.as_dict()


@pytest.mark.parametrize("eager", [False, True], ids=["cow", "eager"])
@pytest.mark.parametrize("policy", ["ebr", "steam", "dlrt", "slrt"])
def test_fork_join_release_trace_matches_jax(policy, eager):
    je, jlog, jcounts, jdag = beam_trace("jax", policy, eager)
    te, tlog, tcounts, tdag = beam_trace("torch", policy, eager)
    assert tlog == jlog
    assert tcounts == jcounts and tdag == jdag
    assert tcounts["forks"] == 6 and tcounts["joins"] == 1
    assert_engines_equal(je, te)


@pytest.mark.parametrize("policy", ["ebr", "slrt"])
def test_ckpt_max_eviction_matches_jax(policy):
    """fork_bench's ckpt_churn schedule, armed by setting ``ckpt_max``:
    five sequences go idle, the rest keep decoding under an undersized
    pool, and a forced reclaim evicts the idle sole survivors."""
    results = []
    for pkg in ("jax", "torch"):
        eng = make_engine(pkg, 8, 20, 4, 6, policy, 8, hot_k=8)
        ids = np.arange(8, dtype=np.int32)
        active = np.arange(8) >= 5
        for step in range(25):
            if step == 8:
                eng.ckpt_max = int(eng.st.mv.now)
            kv = np.full((8, KV_HEADS, HEAD_DIM), step, np.float32)
            eng.step(ids, kv, kv, np.ones(8, bool) if step < 8 else active)
            if step == 9:
                eng.reclaim(64)
        results.append((eng, eng.space(), eng.freed_pages()))
    (je, jspace, jfreed), (te, tspace, tfreed) = results
    assert tspace == jspace and tfreed == jfreed
    assert tspace["ckpt_pages_freed"] > 0
    assert_engines_equal(je, te)
