"""The port's placement over ranks on the CPU: 4 gloo rank processes,
spawned once for the module (``tests/_torch_ranks.py``), against the
one-process port and the JAX package.

* ``ShardedPagedKVEngine`` on meshes of 2 and 4 ranks (hosts spread over
  them, the LWM over the ``min`` ring): the four protocol tests of
  ``tests/distrib/test_sharded_mvgc.py`` (``:117``, ``:173``, ``:208``,
  ``:226``) give on every rank what the one-process engine gives, field
  for field; the smoke and stall tiers of ``BENCH_dist.json`` through
  ``chip_smoke.dist_cell`` give the committed rows (C11's fields from
  ``DIST_C11_FIELDS``); checkpoints interchange with JAX's engine at 4
  ranks in both directions.
* ``pipeline_forward`` over 4 stage ranks at S 4, M 6, mb 2, d 16 with
  ``tanh(h @ w)`` (``tests/launch/test_distributed.py:42``): within atol
  1e-5 of the sequential forward and of JAX's ``pipeline_forward`` on the
  same numpy inputs (one JAX subprocess with 4 fake CPU devices).
* The sharded step on a 2 x 2 (data, model) mesh with ``fsdp=True``: at
  JAX's test's reduced minitron-4b (``:64``; d_model 64, 4 heads, 4 KV
  heads, d_ff 128, vocab 256, B 8 x T 16, lr 1e-3) on its all-ones batch,
  the loss within rtol 1e-4 of JAX's single-device step and each rank's
  shard shapes JAX's per-device shapes.  Then on distinct rows
  (SyntheticLM), 3 steps, so that the last loss reads parameters that a
  nonzero rate updated: that model ("dense") and reduced
  deepseek-moe-16b ("moe": a loss mask whose rows differ in their
  counts, buckets that overflow), each against the port's one-rank step
  and against JAX's sharded step on 4 fake devices (the limits at
  ``check_run``).
* Data parallelism through ``make_grad_reduce`` over the mesh's data
  groups of 2 (each rank half of each batch's rows): the same limits
  against the one-rank step on the whole batch.
* Planted faults, run by the ranks beside the real runs: the shards'
  update skipped, both data rows on the batch's first half, and both
  data-parallel ranks on the first half.  Each must fail its check.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.configs import SHAPES as JSHAPES
from repro.configs import reduced_config as jax_reduced
from repro.configs.base import RunConfig as JRunConfig
from repro.core.telemetry import GCConfig as JGC
from repro.dist import mvgc as jd
from repro.dist import sharding as js
from repro.train.step import init_state as jinit_state
from repro.train.step import train_step as jtrain_step

from repro_torch.ckpt.manager import CheckpointManager, tree_flatten
from repro_torch.configs import reduced_config
from repro_torch.convert import train_state_from_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_ranks as R  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
CPU = torch.device("cpu")

_JAX_SUB = """
import functools, json, sys
import numpy as np
import jax, jax.numpy as jnp
import repro  # noqa: F401  (installs jax.set_mesh, jax.P on this jax)
from repro.configs import SHAPES, reduced_config
from repro.configs.base import RunConfig
from repro.dist.sharding import batch_sharding, param_shardings
from repro.train.pipeline_parallel import pipeline_forward
from repro.train.step import init_state, train_step
io, cases = sys.argv[1], json.loads(sys.argv[2])
inp = np.load(io + "/pipeline_in_0.npz")
S = inp["ws"].shape[0]
mesh = jax.make_mesh((S,), ("stage",),
                     axis_types=(jax.sharding.AxisType.Auto,))
with jax.set_mesh(mesh):
    y = pipeline_forward(lambda w, h: jnp.tanh(h @ w),
                         jnp.asarray(inp["ws"]), jnp.asarray(inp["x"]),
                         mesh=mesh, axis="stage")
np.save(io + "/pipeline_jax.npy", np.asarray(y))
# the sharded step of tests/launch/test_distributed.py:64 on each case's
# batches, the batch placed by batch_sharding
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
rep = jax.NamedSharding(mesh, jax.P())
for case, (arch, over, lr) in cases.items():
    cfg = reduced_config(arch, **over)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], lr=lr)
    state = init_state(cfg, jax.random.PRNGKey(0))
    data = dict(np.load(io + f"/train_batches_{case}.npz"))
    with jax.set_mesh(mesh):
        psh = param_shardings(state.params, mesh, fsdp=True)
        state = jax.device_put(state, state._replace(
            params=psh, opt=state.opt._replace(step=rep, mu=psh, nu=psh),
            err=jax.tree.map(lambda _: rep, state.err), step=rep))
        step = jax.jit(functools.partial(train_step, cfg=cfg, run=run))
        losses, norms = [], []
        for i in range(data["tokens"].shape[0]):
            batch = {k: jnp.asarray(v[i]) for k, v in data.items()}
            batch = jax.device_put(batch, batch_sharding(batch, mesh))
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    np.savez(io + f"/jax_sharded_{case}.npz", losses=np.asarray(losses),
             grad_norms=np.asarray(norms),
             **{f"param_{i}": np.asarray(x)
                for i, x in enumerate(jax.tree.leaves(state.params))})
"""


def _jax_engine():
    return jd.ShardedPagedKVEngine(
        R.CKPT_HOSTS, R.B, R.NP, R.PS, R.MP, R.KVH, R.HD,
        gc=JGC(policy="slrt", versions_per_slot=6, reader_lanes=4, hot_k=4))


def _cfgs(case="dense"):
    arch, over, _ = R.TRAIN_CASES[case]
    return jax_reduced(arch, **over), reduced_config(arch, **over)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Write the inputs, run the 4 rank processes (engine, pipeline,
    train) and JAX's pipeline and sharded steps beside them once; returns
    the io directory, the JAX engine that saved ``ckpt_jax`` and each
    case's JAX initial state."""
    io = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(0)
    S, M, mb, d = (R.PIPE[k] for k in ("S", "M", "mb", "d"))
    np.savez(io / "pipeline_in_0.npz",
             ws=(rng.standard_normal((S, d, d)) * 0.3).astype(np.float32),
             x=rng.standard_normal((M, mb, d)).astype(np.float32))
    jstates = {}
    for case in R.TRAIN_CASES:
        jcfg, cfg = _cfgs(case)
        jstates[case] = jinit_state(jcfg, jax.random.PRNGKey(0))
        CheckpointManager(str(io / f"train_state_{case}")).save(
            0, train_state_from_numpy(cfg, jstates[case], device=CPU))
        batches = R.train_batches(case)
        np.savez(io / f"train_batches_{case}.npz",
                 **{k: np.stack([b[k] for b in batches])
                    for k in batches[0]})
    jeng = _jax_engine()
    R.drive_ckpt(jeng, 5, 0, np.random.default_rng(0))
    jeng.pin(1, 0)
    jeng.checkpoint(str(io / "ckpt_jax"))

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={S}")
    cases = {c: [a, o, R.TRAIN_LR] for c, (a, o, _) in R.TRAIN_CASES.items()}
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SUB, str(io), json.dumps(cases)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        R.spawn(WORLD, str(io), "cpu", ["engine", "pipeline", "train"],
                timeout=400)
        out, _ = jax_proc.communicate(timeout=300)
        assert jax_proc.returncode == 0, out.decode()
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    return {"io": str(io), "jeng": jeng, "jstates": jstates}


def engine_records(ranks, rank):
    return json.loads(str(R.load(ranks["io"], "engine", rank)["records"]))


_ONE = {}


def one_process(name):
    """The protocol on the one-process engine (no mesh: every host here),
    through a JSON round trip as the ranks' records take."""
    if name not in _ONE:
        _ONE[name] = json.loads(json.dumps(R.PROTOCOLS[name](
            lambda hosts, **kw: R.engine(hosts, CPU, None, **kw)),
            sort_keys=True))
    return _ONE[name]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [2, WORLD])
@pytest.mark.parametrize("name", list(R.PROTOCOLS))
def test_engine_protocol_equals_one_process(ranks, name, n):
    """Every rank (a mesh of 2 leaves ranks 2 and 3 off it: they hold
    every host themselves) returns the one-process engine's record."""
    want = one_process(name)
    for rank in range(WORLD):
        got = engine_records(ranks, rank)[f"{name}@{n}"]
        assert got.keys() == want.keys()
        for key in want:
            assert got[key] == want[key], (rank, key)


def test_protocols_hold(ranks):
    """The protocol tests' own assertions, on rank 0's records."""
    recs = engine_records(ranks, 0)
    for n in (2, WORLD):
        trace = recs[f"sentinel_trace@{n}"]
        # the same traffic on every host under the inert pin: every
        # host's shard is the same state
        for leaf in trace["state"]:
            assert all(h == leaf[0] for h in leaf)
        assert all(p == [R.TS_MAX] for p in trace["lwm"])
        pins = recs[f"pin_protects@{n}"]
        assert pins["bad"] == 0 and pins["bad_neutered"] > 0
        lwm = recs[f"lwm_min@{n}"]
        assert lwm["t1"] > lwm["t0"]
        assert lwm["first"] == [[lwm["t0"]]] * 4
        assert lwm["second"] == [[lwm["t1"]]] * 4
        assert lwm["lwm_advances"] >= 1
        stall = recs[f"stall@{n}"]
        assert stall["before_stall"] == [[stall["ts"]]] * 4
        assert stall["aged"] == [[R.TS_MAX]] * 4
        assert stall["stats"]["stale_lanes_aged"] >= 1
        assert stall["stats"]["reclaimed"] > stall["reclaimed_before"]
        assert stall["view_kept"]
        assert stall["space"]["pages_reclaimed"] > 0


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tier,policy", R.TIERS)
def test_dist_tier_at_four_ranks_matches_bench_dist(ranks, chip_smoke, tier,
                                                    policy):
    """The committed row, every field but ``wall_s``, on every rank (the
    smoke tier's 2 hosts on a mesh of 2, the stall tier's 4 on 4)."""
    from repro.core.sim.measure import DistMeasurement
    want = chip_smoke.expected_dist_rows()[(tier, policy)]
    for rank in range(WORLD):
        got = engine_records(ranks, rank)[f"tier:{tier}/{policy}"]
        assert DistMeasurement(**got, wall_s=want["wall_s"]).to_row() == want
        assert got["pin_violations"] == 0


def _same(jtree, leaves):
    jl = jax.tree.leaves(jtree)
    assert len(jl) == len(leaves)
    for a, b in zip(jl, leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_from_four_ranks_restores_in_jax(ranks):
    """The port's engine saves at 4 ranks (one host each); JAX's engine
    restores the files into the state and counters of a JAX engine driven
    the same way."""
    jdriven, jfresh = _jax_engine(), _jax_engine()
    R.drive_ckpt(jdriven, 5, 0, np.random.default_rng(0))
    jdriven.pin(1, 0)
    for rank in range(WORLD):
        rec = engine_records(ranks, rank)["ckpt_port"]
        assert rec["step"] == int(jnp.min(jdriven.st.mv.now))
        _same(jdriven.st, rec["state"])
    assert jfresh.restore(os.path.join(ranks["io"], "ckpt_port")) \
        == rec["step"]
    _same(jdriven.st, tree_flatten(jax.tree.map(np.asarray, jfresh.st)))
    assert dataclasses.asdict(jfresh.stats) == rec["stats"]
    assert jfresh.lwm_advances == rec["lwm_advances"]
    assert jfresh.ckpt_max == rec["step"]


def test_checkpoint_from_jax_restores_at_four_ranks(ranks):
    """JAX's engine saved; the port's engine at 4 ranks restores it (each
    rank its host), and 4 steps later agrees with JAX's engine driven on
    from the same state."""
    jeng = ranks["jeng"]
    restored = jax.tree.map(np.asarray, jeng.st)
    failed = R.drive_ckpt(jeng, 4, 5, np.random.default_rng(1))
    for rank in range(WORLD):
        rec = engine_records(ranks, rank)["ckpt_jax"]
        _same(restored, rec["restored"]["state"])
        assert rec["failed"] == failed
        _same(jeng.st, rec["state"])
        assert rec["space"] == jeng.space()
        assert rec["stats"] == dataclasses.asdict(jeng.stats)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------
def test_pipeline_matches_sequential_and_jax(ranks):
    inp = R.load(ranks["io"], "pipeline_in", 0)
    want = torch.from_numpy(inp["x"])
    for w in inp["ws"]:
        want = torch.tanh(want @ torch.from_numpy(w))
    jax_y = np.load(os.path.join(ranks["io"], "pipeline_jax.npy"))
    for rank in range(WORLD):
        y = R.load(ranks["io"], "pipeline", rank)["y"]
        np.testing.assert_allclose(y, want.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(y, jax_y, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the sharded step and data parallelism
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def one_rank(ranks):
    """Each case's one-rank step in the port on the CPU from JAX's initial
    state on the same whole batches."""
    return {case: R.one_rank(train_state_from_numpy(
        _cfgs(case)[1], ranks["jstates"][case], device=CPU), case, CPU)
        for case in R.TRAIN_CASES}


def test_sharded_step_loss_matches_jax_single_device(ranks):
    """JAX's test: the all-ones batch, one step."""
    jcfg, _ = _cfgs()
    run = JRunConfig(model=jcfg, shape=JSHAPES["train_4k"], lr=R.TRAIN_LR)
    _, m = jtrain_step(ranks["jstates"]["dense"],
                       {"tokens": jnp.ones(R.TRAIN_BATCH, jnp.int32)},
                       jcfg, run)
    for rank in range(WORLD):
        got = float(R.load(ranks["io"], "train", rank)["ones_loss"])
        np.testing.assert_allclose(got, float(m["loss"]), rtol=1e-4)


def test_sharded_step_shards_have_jax_per_device_shapes(ranks):
    """Each rank's local shard of every leaf has the shape a device of
    JAX's 2 x 2 mesh holds of the same leaf (``fsdp=True``)."""
    jcfg, cfg = _cfgs()
    mesh = {"data": 2, "model": 2}
    stand_in = type("StandIn", (), {"shape": mesh})()
    by_path = {}
    jax.tree_util.tree_map_with_path(
        lambda kp, x: by_path.setdefault(js._keypath_parts(kp), x),
        ranks["jstates"]["dense"].params)
    for rank in range(WORLD):
        out = R.load(ranks["io"], "train", rank)
        paths = json.loads(str(out["paths"]))
        shapes = json.loads(str(out["shapes"]))
        assert len(paths) == len(shapes) > 0
        for path, shape in zip(paths, shapes):
            jparts, stacked = R.jax_path(cfg, path.split("/"))
            leaf = by_path[jparts]
            spec = tuple(js._leaf_spec(jparts, leaf, stand_in, fsdp=True,
                                       attn_hd_shard=False,
                                       moe_replicate=False))
            per_device = [s // (mesh[a] if a else 1) for s, a in zip(
                leaf.shape, list(spec) + [None] * leaf.ndim)]
            assert shape == per_device[1 if stacked else 0:], path


@pytest.mark.parametrize("case", list(R.TRAIN_CASES))
def test_sharded_step_matches_one_rank(ranks, one_rank, case):
    ref = one_rank[case]
    R.check_run(R.placed(ranks["io"], case, case), ref, ref["p0"])


@pytest.mark.parametrize("case", list(R.TRAIN_CASES))
def test_sharded_step_matches_jax_sharded(ranks, one_rank, case):
    """The port's placed run against JAX's sharded step on 4 fake devices
    (GSPMD, the batch placed by ``batch_sharding``), the same state and
    batches: losses, gradient norms and each parameter's change, leaves
    in JAX's layout (``convert.params_to_numpy``; the entries held to
    UPDATE_RTOL picked by the port's one-rank second moments)."""
    from repro_torch.ckpt.manager import tree_unflatten
    from repro_torch.convert import params_to_numpy
    _, cfg = _cfgs(case)

    def jax_layout(leaves):
        return jax.tree.leaves(params_to_numpy(cfg, tree_unflatten(
            R.like_params(case), [torch.from_numpy(x) for x in leaves])))
    got = R.placed(ranks["io"], case, case)
    got["params"] = jax_layout(got["params"])
    jrec = dict(np.load(os.path.join(ranks["io"],
                                     f"jax_sharded_{case}.npz")))
    want = {"losses": jrec["losses"], "grad_norms": jrec["grad_norms"],
            "params": [jrec[f"param_{i}"]
                       for i in range(len(got["params"]))]}
    p0 = [np.asarray(x) for x in
          jax.tree.leaves(ranks["jstates"][case].params)]
    R.check_run(got, want, p0, moments=False, rtol=R.JAX_RTOL,
                nu=jax_layout(one_rank[case]["nu"]))


def test_data_parallel_step_matches_one_rank(ranks, one_rank):
    ref = one_rank["dense"]
    for rec in R.data_parallel(ranks["io"], "dp"):
        R.check_run(rec, ref, ref["p0"])


@pytest.mark.parametrize("fault", ["fault_skip", "fault_half",
                                   "fault_dp_half"])
def test_planted_fault_fails_its_check(ranks, one_rank, fault):
    """The checks above see each planted fault: the shards never updated,
    both data rows on the batch's first half (placed), both
    data-parallel ranks on the first half."""
    ref = one_rank["dense"]
    with pytest.raises(AssertionError):
        if fault == "fault_dp_half":
            for rec in R.data_parallel(ranks["io"], fault):
                R.check_run(rec, ref, ref["p0"])
        else:
            R.check_run(R.placed(ranks["io"], fault), ref, ref["p0"])
