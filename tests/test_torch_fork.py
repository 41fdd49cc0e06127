"""The port's fork helpers and the fork_bench tiers against the JAX
package.

* ``page_refcounts``, ``check_no_leak``, ``shared_page_count``,
  ``prefix_values`` and ``ForkValidator`` equal the JAX package's on
  seeded fork / join / release traces run through both engines, a planted
  page corruption included; ``ForkDAG.ancestors / descendants /
  from_dict`` equal JAX's on the same lineage.
* ``chip_smoke.py``'s fork-tier loop, run here on the CPU, reproduces the
  deterministic fields of all 16 rows of the committed BENCH_fork.json.
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.core.telemetry import GCConfig as JGC
from repro.serve import forking as jf
from repro.serve.engine import PagedKVEngine as JEngine

from repro_torch.convert import to_numpy
from repro_torch.core.telemetry import GCConfig as TGC
from repro_torch.serve import forking as tf
from repro_torch.serve.engine import PagedKVEngine as TEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQS, PAGES, PS, MP, V = 8, 40, 4, 6, 8
NOW = 2**31 - 2


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def engines(policy, eager=False):
    return (JEngine(SEQS, PAGES, PS, MP, 1, 4,
                    gc=JGC(policy=policy, versions_per_slot=V,
                           reader_lanes=4, hot_k=SEQS),
                    eager_fork=eager, dtype=jnp.float32),
            TEngine(SEQS, PAGES, PS, MP, 1, 4,
                    gc=TGC(policy=policy, versions_per_slot=V,
                           reader_lanes=4, hot_k=SEQS),
                    eager_fork=eager, dtype=torch.float32, device="cpu"))


def views(eng):
    tbl, ln = eng.view_at(NOW)
    return np.asarray(tbl), np.asarray(ln)


def helpers(st, fk):
    ok, leaked, premature = fk.check_no_leak(st)
    return (fk.page_refcounts(st).tolist(), ok, leaked.tolist(),
            premature.tolist(), fk.shared_page_count(st))


def lineage(dag):
    slots = range(SEQS)
    return ([dag.ancestors(s) for s in slots],
            [sorted(dag.descendants(s)) for s in slots], dag.as_dict())


@pytest.mark.parametrize("eager", [False, True], ids=["cow", "eager"])
@pytest.mark.parametrize("policy", ["ebr", "steam", "dlrt", "slrt"])
def test_fork_helpers_match_jax(policy, eager):
    """A seeded trace of forks (grandchildren included), decode steps,
    joins and releases through the port's engine; after every op the JAX
    helpers, run on a numpy copy of the port's state, and a JAX
    ``ForkValidator`` and ``ForkDAG`` fed the same calls must agree with
    the port's.  (The engines themselves are held against each other in
    tests/test_torch_engine.py; the steam/eager trace here reaches trap
    C5 of the JAX engine, so the helpers are compared on one state.)"""
    rng = np.random.default_rng(7)
    eng = engines(policy, eager)[1]
    jdag = jf.ForkDAG()
    vals = (jf.ForkValidator(), tf.ForkValidator())
    ids = np.arange(SEQS, dtype=np.int32)
    live = [0]

    def states():
        return to_numpy(eng.st), eng.st

    def same_everywhere():
        jst, tst = states()
        assert helpers(jst, jf) == helpers(tst, tf)
        assert lineage(jdag) == lineage(eng.dag)
        tb, ln = views(eng)
        for s in live:
            assert jf.prefix_values(jst, tb[s], ln[s]) == \
                tf.prefix_values(tst, tb[s], ln[s])
            got = [v.check(st, s, tb[s], ln[s])
                   for v, st in zip(vals, (jst, tst))]
            assert got[0] == got[1]
        assert (vals[0].checked, vals[0].violations, vals[0].examples) == \
            (vals[1].checked, vals[1].violations, vals[1].examples)

    for step in range(40):
        mask = np.zeros(SEQS, bool)
        mask[live] = rng.random(len(live)) < 0.8
        kv = np.full((SEQS, 1, 4), step, np.float32) + ids[:, None, None]
        eng.step(ids, kv, kv, mask)
        free = [s for s in range(SEQS) if s not in live]
        r = rng.random()
        if r < 0.35 and free:
            src, dst = int(rng.choice(live)), free[0]
            failed = eng.fork(np.array([src], np.int32),
                              np.array([dst], np.int32), np.ones(1, bool))
            if not bool(failed[0]):
                jdag.fork(src, dst, *eng.dag.as_dict()["nodes"][str(dst)][1:])
                tb, ln = views(eng)
                for v, st in zip(vals, states()):
                    v.note_fork(st, dst, tb[dst], ln[dst])
                live.append(dst)
        elif r < 0.55 and len(live) > 1:
            child = int(rng.choice(live[1:]))
            if rng.random() < 0.5:
                failed = eng.join(np.array([child], np.int32),
                                  np.array([0], np.int32), np.ones(1, bool))
                done = (lambda: jdag.join(child, 0))
            else:
                failed = eng.release(np.array([child], np.int32),
                                     np.ones(1, bool))
                done = (lambda: jdag.release(child))
            if not bool(failed[0]):
                done()
                for v in vals:
                    v.drop(child)
                live.remove(child)
        same_everywhere()
    assert eng.forks > 3 and vals[1].checked > 0
    assert vals[1].violations == 0
    assert any(len(a) > 1 for a in lineage(eng.dag)[0]), "no grandchild"
    dag = tf.ForkDAG.from_dict(json.loads(json.dumps(eng.dag.as_dict())))
    assert dag == eng.dag
    assert lineage(jf.ForkDAG.from_dict(eng.dag.as_dict())) == lineage(dag)


def test_validator_reports_a_corrupt_shared_page_like_jax():
    """Overwrite a page a child shares with its parent: both validators
    flag the same violation, with the same example."""
    pair = engines("slrt")
    vals = (jf.ForkValidator(), tf.ForkValidator())
    ids = np.arange(SEQS, dtype=np.int32)
    root = np.zeros(SEQS, bool)
    root[0] = True
    for step in range(6):
        kv = np.full((SEQS, 1, 4), step + 1, np.float32)
        for eng in pair:
            eng.step(ids, kv, kv, root)
    for eng, v in zip(pair, vals):
        eng.fork(np.array([0], np.int32), np.array([1], np.int32),
                 np.ones(1, bool))
        tb, ln = views(eng)
        v.note_fork(eng.st, 1, tb[1], ln[1])
    page = int(views(pair[1])[0][1][0])
    pair[0].st = pair[0].st._replace(
        k_pages=pair[0].st.k_pages.at[page, 2].set(99.0))
    pair[1].st.k_pages[page, 2] = 99.0
    out = []
    for eng, v in zip(pair, vals):
        tb, ln = views(eng)
        out.append((v.check(eng.st, 1, tb[1], ln[1]), v.checked,
                    v.violations, v.examples))
    assert out[0] == out[1]
    assert out[1][:3] == (False, 1, 1)


@pytest.fixture(scope="module")
def chip_smoke():
    return _chip_smoke()


@pytest.mark.parametrize("policy", ["ebr", "steam", "dlrt", "slrt"])
@pytest.mark.parametrize("tier", ["smoke", "beam", "spec", "ckpt_churn"])
def test_fork_tier_matches_bench_fork(chip_smoke, tier, policy):
    """The card's phase-7 loop on the CPU: every deterministic field of the
    committed row, no prefix violation, no leak."""
    want = chip_smoke.bench_fork_rows()[(tier, policy)]
    got, _ = chip_smoke.fork_cell(chip_smoke.FORK_TIERS[tier], policy,
                                  torch.device("cpu"))
    assert {f: got[f] for f in chip_smoke.FORK_FIELDS} == \
        {f: want[f] for f in chip_smoke.FORK_FIELDS}
    assert got["prefix_violations"] == 0
    assert got["leak_checks_failed"] == got["control_leak_checks_failed"] == 0
    if tier == "ckpt_churn":
        assert got["ckpt_pages_freed"] > 0 == got["control_ckpt_pages_freed"]
    elif tier != "smoke":
        assert got["shared_savings_pages"] > 0


def test_fork_tiers_cover_bench_fork(chip_smoke):
    assert set(chip_smoke.bench_fork_rows()) == {
        (t, p) for t in chip_smoke.FORK_TIERS
        for p in chip_smoke.FORK_POLICIES}
