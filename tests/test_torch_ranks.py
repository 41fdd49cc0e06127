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
  same numpy inputs (one JAX subprocess with 4 fake CPU devices).  Its
  gradient (GPipe's reverse schedule): ``sum(y * c)`` at M 6, 2 and 1,
  each rank's stage weight and every rank's ``x.grad`` within atol 1e-5
  of ``jax.grad`` through JAX's ``pipeline_forward`` and of the port's
  layers in sequence; a pytree stage with a frozen leaf; reduced
  minitron-4b's blocks (float32, plain K6 and K6b) bit-equal to the
  layers in sequence; under no_grad nothing saved and the forward-only
  loop's bits.  Three planted faults of the backward (the ranks'
  cotangents summed, a microbatch dropped, the reverse hop sent the wrong
  way) must fail the gradient check.
* The sharded step on a 2 x 2 (data, model) mesh with ``fsdp=True``: at
  JAX's test's reduced minitron-4b (``:64``; d_model 64, 4 heads, 4 KV
  heads, d_ff 128, vocab 256, B 8 x T 16, lr 1e-3) on its all-ones batch,
  the loss within rtol 1e-4 of JAX's single-device step and each rank's
  shard shapes JAX's per-device shapes.  Then on distinct rows
  (SyntheticLM), 3 steps, so that the last loss reads parameters that a
  nonzero rate updated: that model ("dense"), reduced deepseek-moe-16b
  ("moe": a loss mask whose rows differ in their counts, buckets that
  overflow), reduced recurrentgemma-9b ("rglru"), xlstm-125m ("xlstm")
  and whisper-tiny with frames ("encdec"), each against the port's
  one-rank step and against JAX's sharded step on 4 fake devices (the
  limits at ``check_run``), each rank's shards JAX's per-device shapes.
* The step computes on its shards over ``model``, as JAX's GSPMD step
  does: no rank ever holds a leaf that the specs split over ``model``
  whole (attention, MLP, expert, RG-LRU, xLSTM, encoder, cross-attention
  and embedding leaves: the largest tensor the placement made of each is
  the leaf's shape over ``model``), and planted faults of that compute
  (``g`` skipped after ``wo``, the loss's log-sum-exp over the local
  vocabulary only, ``f``'s backward all-reduce skipped; an xLSTM norm's
  statistic over the local width, a sliced leaf's gradient not summed
  over ``model``, the encoder's output into cross-attention without
  ``f``) each fail the check against the one-rank step.
* Int8 gradient compression on the placed state (the error carry placed
  by the parameters' specs, each scale the whole leaf's): losses and
  gradient norms within PORT_RTOL of the one-rank compressed step, every
  scale within PORT_RTOL, every int8 entry equal or one step off at a
  bin edge.
* Data parallelism through ``make_grad_reduce`` over the mesh's data
  groups of 2 (each rank half of each batch's rows): the same limits
  against the one-rank step on the whole batch.
* Planted faults, run by the ranks beside the real runs: the shards'
  update skipped, both data rows on the batch's first half, and both
  data-parallel ranks on the first half.  Each must fail its check.
* The placed serve step (``ServePlacement``: JAX's decode and prefill
  cells on a 2 x 2 mesh), computing on its shards over ``model`` as
  GSPMD computes those cells: reduced gemma2-2b (KV heads on ``model``, a
  local ring's ``pos`` split over it and gathered at use), reduced
  recurrentgemma-9b (the sequence on ``model``: sequence-split decode;
  the RG-LRU on its width), reduced deepseek-moe-16b (its block of
  experts), reduced xlstm-125m (the mLSTM and sLSTM on their heads, the
  state whole over ``model``) and reduced whisper-tiny (its encoder over
  frames and cross-attention on their heads), prefill and 4 decode steps
  in float32 against
  the one-rank step in float32 and in float64 (``_torch_ranks.
  check_serve``): lengths, stats and ``MVState`` bit-equal; each logit
  row and cache leaf within ``SERVE_K`` times the float32 one-rank
  step's distance from float64; tokens equal where the float64 margin
  requires.  Against JAX's GSPMD prefill and decode cells on 4 fake
  devices, on the same weights and prompt: lengths, stats and store
  equal, logits within the one-rank port's limit against JAX, tokens
  equal where the margin requires.  Five planted faults (a cache piece in
  the wrong shard, ``g`` skipped after ``wo``, the vocab argmax without
  the rank's row offset, the sequence-split softmax normalised by the
  local row sum, an xLSTM state's other heads left stale) must fail that
  check, and no rank may make a tensor of
  a ``model``-split leaf larger than its shard but a heads-split ring's
  ``pos``.
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
io, cases, serves = sys.argv[1], json.loads(sys.argv[2]), json.loads(
    sys.argv[3])
pipes = sys.argv[4:]
# the pipeline of tests/launch/test_distributed.py:42 and jax.grad of
# sum(pipeline_forward(tanh(h @ w)) * c) with respect to ws and x
for case in pipes:
    inp = np.load(io + f"/pipeline_in_{case}_0.npz")
    S = inp["ws"].shape[0]
    mesh = jax.make_mesh((S,), ("stage",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    ws, x, c = (jnp.asarray(inp[k]) for k in ("ws", "x", "c"))

    def run(ws, x):
        return pipeline_forward(lambda w, h: jnp.tanh(h @ w), ws, x,
                                mesh=mesh, axis="stage")
    with jax.set_mesh(mesh):
        y = run(ws, x)
        gws, gx = jax.grad(lambda ws, x: jnp.sum(run(ws, x) * c),
                           argnums=(0, 1))(ws, x)
    np.savez(io + f"/pipeline_jax_{case}.npz", y=np.asarray(y),
             gws=np.asarray(gws), gx=np.asarray(gx))
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
# the placed serve step: JAX's GSPMD prefill and decode cells on the same
# mesh (the parameters by param_shardings(fsdp=False), the cache by
# cache_shardings, the store by mv_shardings; build_serve_cell's specs) in
# float32 on each serve case's weights and prompt: the tokens, lengths,
# stats and logits of every greedy pick, and the store at the end
from repro.launch.specs import cache_shardings, mv_shardings
from repro.models import transformer as tf
from repro.serve import engine as eng
rows = jax.NamedSharding(mesh, jax.P("data", None))
for case, (arch, B, L, steps) in serves.items():
    cfg = reduced_config(arch)
    run = RunConfig(model=cfg, shape=SHAPES["decode_32k"])
    inp = np.load(io + f"/serve_jax_in_{case}.npz")
    tree = jax.tree.structure(jax.eval_shape(
        lambda: tf.init_params(cfg, jax.random.PRNGKey(0))))
    params = jax.tree.unflatten(tree, [jnp.asarray(inp[f"p{i}"])
                                       for i in range(tree.num_leaves)])
    # an encoder-decoder's frames, and enc_out as JAX's callers compute it
    frames = jnp.asarray(inp["frames"]) if "frames" in inp else None

    def prefill(s, t, fr):
        logits = tf.prefill(s.params, cfg, t, s.cache,
                            frontend_embeds=fr)[0][:, -1]
        return logits, eng.prefill_step(s, cfg, run, t, fr)

    def decode(s, enc):
        logits = tf.decode_step(s.params, cfg, s.last_tokens, s.cache,
                                s.cache_len, enc_out=enc)[0][:, -1]
        s, _, _, stats = eng.decode_one(s, cfg, run, enc)
        return logits, s, jnp.stack(list(stats.values()))
    with jax.set_mesh(mesh):
        st = eng.make_serve_state(cfg, run, params, B, L, jnp.float32)
        ssh = eng.ServeState(
            params=param_shardings(params, mesh, fsdp=False),
            cache=cache_shardings(st.cache, mesh, cfg, B),
            cache_len=jax.NamedSharding(mesh, jax.P("data")),
            mv=mv_shardings(st.mv, mesh, B), last_tokens=rows)
        st = jax.device_put(st, ssh)
        if frames is not None:
            frames = jax.device_put(frames, jax.NamedSharding(
                mesh, jax.P("data", None, None)))
        logits, st = jax.jit(prefill, out_shardings=(rep, ssh))(
            st, jax.device_put(jnp.asarray(inp["tokens"]), rows), frames)
        enc = None if frames is None else jax.jit(
            lambda p, fr: tf._run_encoder(p, cfg, fr))(st.params, frames)
        out = {"logits_0": logits, "toks_0": st.last_tokens,
               "lens_0": st.cache_len}
        step = jax.jit(decode, out_shardings=(rep, ssh, rep))
        for i in range(1, steps + 1):
            logits, st, stats = step(st, enc)
            out.update({f"logits_{i}": logits, f"toks_{i}": st.last_tokens,
                        f"lens_{i}": st.cache_len,
                        f"stats_{i}": stats})
        out.update({f"mv_{j}": x for j, x in
                    enumerate(jax.tree.leaves(st.mv))})
    np.savez(io + f"/serve_jax_{case}.npz",
             **{k: np.asarray(v) for k, v in out.items()})
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
    R.pipeline_inputs(str(io))
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
    from repro_torch.convert import params_to_numpy
    for case in R.SERVE_CASES:
        cfg, params, tokens, frames = R.serve_inputs(case, CPU)
        extra = {} if frames is None else {"frames": frames.numpy()}
        np.savez(io / f"serve_jax_in_{case}.npz", tokens=tokens.numpy(),
                 **extra, **{f"p{i}": x for i, x in enumerate(
                     jax.tree.leaves(params_to_numpy(cfg, params)))})
    serves = {c: [a, b, n, steps]
              for c, (a, b, n, _, steps) in R.SERVE_CASES.items()}
    jeng = _jax_engine()
    R.drive_ckpt(jeng, 5, 0, np.random.default_rng(0))
    jeng.pin(1, 0)
    jeng.checkpoint(str(io / "ckpt_jax"))

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count="
               f"{R.PIPE['S']}")
    cases = {c: [a, o, R.TRAIN_LR] for c, (a, o, _) in R.TRAIN_CASES.items()}
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SUB, str(io), json.dumps(cases),
         json.dumps(serves), *R.PIPE_CASES],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        R.spawn(WORLD, str(io), "cpu",
                ["engine", "pipeline", "train", "serve"], timeout=400)
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
def _pipe(ranks, rank):
    return R.load(ranks["io"], "pipeline", rank)


def _tanh_want(ranks, case):
    """The sequential port's and JAX's y and gradients of ``case``."""
    jax = dict(np.load(os.path.join(ranks["io"],
                                    f"pipeline_jax_{case}.npz")))
    return [R.tanh_reference(ranks["io"], case), jax]


def test_pipeline_matches_sequential_and_jax(ranks):
    seq, jax_ = _tanh_want(ranks, "m6")
    for rank in range(WORLD):
        y = _pipe(ranks, rank)["m6_y"]
        np.testing.assert_allclose(y, seq["y"], atol=R.PIPE_ATOL, rtol=0)
        np.testing.assert_allclose(y, jax_["y"], atol=R.PIPE_ATOL, rtol=0)


@pytest.mark.parametrize("case", list(R.PIPE_CASES))
def test_pipeline_gradient_matches_sequential_and_jax(ranks, case):
    """jax.grad of ``sum(pipeline_forward(tanh(h @ w)) * c)`` on 4 fake
    devices, and the same layers in sequence in the port: each rank's
    stage gradient and every rank's ``x.grad`` (stage 0's, broadcast)
    within atol 1e-5 of both, at M 6, at M 2 < S and at M 1."""
    wants = _tanh_want(ranks, case)
    R.check_pipe_grads(ranks["io"], case, wants)
    for rank in range(WORLD):
        np.testing.assert_allclose(_pipe(ranks, rank)[f"{case}_y_grad"],
                                   wants[1]["y"], atol=R.PIPE_ATOL, rtol=0)


@pytest.mark.parametrize("fault", list(R.PIPE_FAULTS))
def test_pipeline_planted_fault_fails_its_check(ranks, fault):
    """The gradient check above sees each planted fault of the backward:
    the ranks' output cotangents summed (every gradient 4x), the first
    microbatch summed dropped, the reverse hop sent to ``sid + 1``."""
    wants = _tanh_want(ranks, "m6")
    with pytest.raises(AssertionError):
        R.check_pipe_grads(ranks["io"], f"m6_{fault}", wants)


def test_pipeline_no_grad_saves_nothing_and_gives_the_parents_output(ranks):
    """Under no_grad the call saves no tensor and its output has the
    forward-only loop's bits; recorded, it saves the M stage inputs and
    the stage's weight, and gives the same bits."""
    for rank in range(WORLD):
        got = _pipe(ranks, rank)
        for case, M in R.PIPE_CASES.items():
            assert int(got[f"{case}_saved_nograd"]) == 0
            assert int(got[f"{case}_saved"]) == M + 1
            np.testing.assert_array_equal(got[f"{case}_y"],
                                          got[f"{case}_y_parent"])
            np.testing.assert_array_equal(got[f"{case}_y_grad"],
                                          got[f"{case}_y"])


def test_pipeline_pytree_stage_with_a_frozen_leaf(ranks):
    """A ``{"w": [w1, w2], "b": b}`` stage, ``b`` frozen: ``b`` gets no
    gradient; ``w1``, ``w2`` and ``x`` match the sequential port."""
    inp = R.load(ranks["io"], "pipeline_tree_in", 0)
    stages = [{"w": [torch.from_numpy(w).requires_grad_() for w in ws],
               "b": torch.from_numpy(b)}
              for *ws, b in zip(inp["w1s"], inp["w2s"], inp["bs"])]
    _, gx = R.sequential(R._tree_apply, stages, inp["x"], inp["c"])
    gws = [[w.grad.numpy() for w in st["w"]] for st in stages]
    for rank in range(WORLD):
        got = _pipe(ranks, rank)
        sid = int(got["stage"])
        assert bool(got["tree_b_grad_none"])
        assert int(got["tree_saved"]) == R.PIPE_TREE["M"] + 3
        for k in (0, 1):
            np.testing.assert_allclose(got[f"tree_gw{k + 1}"], gws[sid][k],
                                       atol=R.PIPE_ATOL, rtol=0)
        np.testing.assert_allclose(got["tree_gx"], gx, atol=R.PIPE_ATOL,
                                   rtol=0)


def test_pipeline_model_blocks_gradient_equals_sequential_layers(ranks):
    """Reduced minitron-4b, 8 layers over the 4 stages, float32, M 3, mb
    2, T 16, through block_apply(mode="train") on the plain K6 and K6b:
    every layer leaf's gradient and ``x.grad`` bit-equal to the port's
    layers in sequence (:func:`_torch_ranks.pipe_model_reference`)."""
    inp = R.load(ranks["io"], "pipeline_model_in", 0)
    want = R.pipe_model_reference(inp["x"], inp["c"])
    per = R.PIPE_MODEL["num_layers"] // WORLD
    for rank in range(WORLD):
        got = _pipe(ranks, rank)
        sid = int(got["stage"])
        np.testing.assert_array_equal(got["model_gx"], want["gx"])
        grads = [want[f"layer{i}"] for i in range(sid * per,
                                                  (sid + 1) * per)]
        flat = [g for layer in grads for g in layer]
        assert len([k for k in got if k.startswith("model_g")
                    and k != "model_gx"]) == len(flat)
        for i, g in enumerate(flat):
            np.testing.assert_array_equal(got[f"model_g{i}"], g,
                                          err_msg=f"rank {rank} leaf {i}")


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


@pytest.mark.parametrize("case", list(R.TRAIN_CASES))
def test_sharded_step_shards_have_jax_per_device_shapes(ranks, case):
    """Each rank's local shard of every leaf has the shape a device of
    JAX's 2 x 2 mesh holds of the same leaf (``fsdp=True``), in each
    case (the dense case's as placed for JAX's all-ones step, the others'
    after their placed runs)."""
    from repro_torch.dist.sharding import _paths
    jcfg, cfg = _cfgs(case)
    mesh = {"data": 2, "model": 2}
    stand_in = type("StandIn", (), {"shape": mesh})()
    by_path = {}
    jax.tree_util.tree_map_with_path(
        lambda kp, x: by_path.setdefault(js._keypath_parts(kp), x),
        ranks["jstates"][case].params)
    for rank in range(WORLD):
        out = R.load(ranks["io"], "train", rank)
        if case == "dense":
            paths = json.loads(str(out["paths"]))
            shapes = json.loads(str(out["shapes"]))
        else:
            paths = ["/".join(p) for p, _ in _paths(R.like_params(case))]
            shapes = json.loads(str(out[f"shapes_{case}"]))
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


#: the matrices of a case that the specs do not split over ``model`` (a
#: dim that does not divide): reduced recurrentgemma-9b's single KV head
WHOLE_MATRICES = {"rglru": ("wk", "wv")}


@pytest.mark.parametrize("case", list(R.TRAIN_CASES))
def test_no_rank_holds_a_model_split_leaf_whole(ranks, case):
    """Each case's placed run: for every leaf that the specs split over
    ``model`` on the dim its layer computes on (on the 2 x 2 mesh with
    ``fsdp=True``: attention, MLP, expert, RG-LRU, mLSTM and sLSTM leaves,
    an encoder's layers and cross-attention, the (un)embedding), the
    largest tensor the placement made of it on every rank is the leaf's
    shape with its ``model`` dim halved (its ``data`` dim gathered): the
    layer computed on its shard.  Every other leaf (the routers, the
    leaves a recurrent layer slices) was gathered whole."""
    from repro_torch.dist.sharding import (_SLICED, _local_dim, _paths,
                                           param_shardings)
    stand_in = type("StandIn", (), {"shape": {"data": 2, "model": 2}})()
    like = R.like_params(case)
    specs = dict(_paths(param_shardings(like, stand_in, fsdp=True)))
    n_local = 0
    for rank in range(WORLD):
        made = json.loads(str(R.load(ranks["io"], "train",
                                     rank)[f"made_{case}"]))
        for path, leaf in _paths(like):
            name, spec = "/".join(path), specs[path]
            d = _local_dim(path, leaf.ndim)
            want = list(leaf.shape)
            if d is not None and spec[d] == "model":
                want[d] //= 2
                n_local += 1
            assert made[name] == want, (case, rank, name)
        if case == "moe":
            # reduced deepseek-moe-16b's experts: [E / 2, d, f] a rank
            assert made["layers/0/ffn/wg"] == [2, 64, 128], made
            assert made["layers/0/ffn/router"] == [64, 4], made
        if case == "encdec":
            # an encoder layer's and a decoder layer's cross-attention
            # heads: 2 of reduced whisper-tiny's 4 a rank
            for part in ("encoder/layers/0/mixer", "layers/1/cross"):
                assert made[f"{part}/wq"] == [64, 2, 16], made
                assert made[f"{part}/wo"] == [2, 16, 64], made
    # every matrix of the case but the routers, the leaves a recurrent
    # layer slices and WHOLE_MATRICES divides over model
    matrices = [p for p, x in _paths(like)
                if x.ndim >= 2 and p[-1] != "router" and p[-1] not in _SLICED
                and p[-1] not in WHOLE_MATRICES.get(case, ())]
    assert n_local == WORLD * len(matrices) > 0, case


@pytest.mark.parametrize("fault", list(R.TP_FAULTS))
def test_model_axis_planted_fault_fails_its_check(ranks, one_rank, fault):
    """The check against the one-rank step sees each planted fault of the
    compute over ``model``: ``g`` skipped after ``wo`` (each rank keeps
    its heads' partial output), the loss's log-sum-exp and label logit
    over this rank's vocabulary only, ``f``'s backward all-reduce skipped
    (the replicated norms' gradients each rank's share)."""
    ref = one_rank["dense"]
    with pytest.raises(AssertionError):
        R.check_run(R.placed(ranks["io"], fault), ref, ref["p0"])


@pytest.mark.parametrize("fault", list(R.LAYER_FAULTS))
def test_layer_planted_fault_fails_its_check(ranks, one_rank, fault):
    """The check against the one-rank step sees each planted fault of the
    recurrent mixers' and the encoder-decoder's compute over ``model``:
    an xLSTM norm's statistic over this rank's slice of the width only,
    a sliced replicated leaf's gradient (the RG-LRU's gate matrices and
    per-channel leaves) not summed over ``model``, the encoder's output
    entering cross-attention without ``f``."""
    case = R.LAYER_FAULTS[fault][1]
    ref = one_rank[case]
    with pytest.raises(AssertionError):
        R.check_run(R.placed(ranks["io"], fault, case), ref, ref["p0"])


@pytest.mark.parametrize("fault", list(R.MOE_FAULTS))
def test_expert_parallel_planted_fault_fails_its_check(ranks, one_rank,
                                                       fault):
    """The check against the one-rank step sees each planted fault of the
    mixture of experts over ``model`` (the MoE case): a rank running the
    next rank's block of experts, the combine without its ``g``, ``f``
    skipped on the gate weights (the router's gradient one rank's share),
    the load-balance loss from the local experts' counts only."""
    ref = one_rank["moe"]
    with pytest.raises(AssertionError):
        R.check_run(R.placed(ranks["io"], fault, "moe"), ref, ref["p0"])


def test_compressed_placed_step_matches_one_rank(ranks):
    """Int8 error-feedback compression on the placed 2 x 2 state, the
    dense case, 3 steps, against the one-rank compressed step from the
    same state: every leaf's scale (the whole leaf's, on every rank)
    within PORT_RTOL; every int8 entry equal, or one step off only where
    the one-rank value lies within float32 rounding of a bin edge
    (``edge_band``) and each run rounded its own value, or at the step
    right after such a flip, the way its error-feedback carry moves it;
    then the run (losses, gradient norms, each parameter's change,
    AdamW's moments) by ``check_run``, the entries that were one step off
    (their gradient an int8 step apart) held to twice the rates' sum."""
    _, cfg = _cfgs("dense")
    ref = R.one_rank(train_state_from_numpy(
        cfg, ranks["jstates"]["dense"], device=CPU), "dense", CPU,
        compression=True)
    n = len(tree_flatten(R.like_params("dense")))
    at_edge, carried, flipped = R.check_compressed(
        R.compressed_quant(ranks["io"]), ref["quant"], n)
    print(f"int8 entries one step off: {at_edge} at a bin edge, {carried} "
          "carried by the error feedback of the step before; "
          f"{sum(int(m.sum()) for m in flipped)} entries in all")
    R.check_run(R.placed(ranks["io"], "compressed"), ref, ref["p0"],
                other_grads=flipped)


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


# ---------------------------------------------------------------------------
# the placed serve step
# ---------------------------------------------------------------------------
def _serve(ranks, name):
    return [R.load(ranks["io"], name, rank) for rank in range(WORLD)]


def _serve_refs(ranks, case):
    return (R.load(ranks["io"], f"serve_ref_{case}", 0),
            R.load(ranks["io"], f"serve_ref64_{case}", 0))


@pytest.mark.parametrize("case", list(R.SERVE_CASES))
def test_placed_serve_step_equals_one_rank(ranks, case):
    """The placed float32 step on 2 x 2, computing on its shards over
    ``model``, against the one-rank step (R.check_serve): the lengths,
    stats and store bit-equal on every rank; each logit row and each
    cache leaf within R.SERVE_K times the float32 one-rank step's
    distance from the float64 one-rank step; the tokens equal wherever
    the float64 margin requires it.  Reports the steps at which a row's
    margin stopped the comparison (none is expected at these sizes)."""
    out = R.check_serve(_serve(ranks, f"serve_{case}"),
                        *_serve_refs(ranks, case))
    print(f"{case}: rows stopped by their margin at steps "
          f"{out['closed'] or 'none'}; worst error / d32 {out['worst']:.3f}"
          f" (limit {R.SERVE_K})")


#: the placed serve step's logits against JAX's GSPMD cells': the limit
#: the one-rank port's logits are held to against JAX
#: (tests/test_torch_model.py's LOGITS)
JAX_LOGITS = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", list(R.SERVE_CASES))
def test_placed_serve_matches_jax_sharded(ranks, case):
    """The placed float32 step against JAX's GSPMD prefill and decode
    cells on 4 fake devices (the same specs, weights and prompt): the
    lengths, stats and store equal on every rank; each row of logits of
    every greedy pick within JAX_LOGITS of JAX's, and the tokens equal,
    while the row's float64 top-2 margin exceeds twice that limit (from
    the first step where it does not, a row may take another token, and
    is no longer compared).  Reports the steps at which a row stopped."""
    jrec = dict(np.load(os.path.join(ranks["io"], f"serve_jax_{case}.npz")))
    got = _serve(ranks, f"serve_{case}")
    want64 = _serve_refs(ranks, case)[1]
    for key in (k for k in jrec if k.startswith(("lens_", "stats_", "mv_"))):
        for rec in got:
            np.testing.assert_array_equal(rec[key], jrec[key], err_msg=key)
    steps = sum(1 for k in jrec if k.startswith("logits_"))
    live = np.ones(jrec["toks_0"].shape[0], dtype=bool)
    closed, worst = {}, 0.0
    for s in range(steps):
        lp, lj = R._assemble(got, f"logits_{s}"), jrec[f"logits_{s}"]
        top2 = np.sort(want64[f"logits_{s}"], axis=-1)[:, -2:]
        for b in np.flatnonzero(live):
            np.testing.assert_allclose(lp[b], lj[b], **JAX_LOGITS,
                                       err_msg=f"step {s} row {b}")
            limit = JAX_LOGITS["atol"] + JAX_LOGITS["rtol"] * np.abs(lj[b])
            worst = max(worst, float((np.abs(lp[b] - lj[b]) / limit).max()))
            if top2[b, 1] - top2[b, 0] <= 2 * limit.max():
                live[b] = False
                closed[int(b)] = s
                continue
            assert all(rec[f"toks_{s}"][b] == jrec[f"toks_{s}"][b]
                       for rec in got), f"step {s} row {b}: tokens differ"
    print(f"{case}: rows stopped by their margin at steps "
          f"{closed or 'none'}; worst share of JAX_LOGITS {worst:.4f}")


@pytest.mark.parametrize("fault", list(R.SERVE_FAULTS))
def test_placed_serve_planted_fault_fails(ranks, fault):
    """Each planted fault of the compute over ``model`` fails the check
    on the records of all four ranks: a cache piece in the wrong shard
    (rank 1, the gemma2 case: its ring's ``pos``, gathered whole at use),
    ``g`` skipped after ``wo``, the vocab-parallel argmax without the
    rank's row offset, the sequence-split decode normalised by the local
    row sum, and an xLSTM layer's new state not gathered over ``model``
    (each rank's heads written into the state it read, the others'
    stale)."""
    case = R.SERVE_FAULTS[fault][1]
    with pytest.raises(AssertionError):
        R.check_serve(_serve(ranks, f"serve_fault_{fault}"),
                      *_serve_refs(ranks, case))


#: the largest tensors the placed serve step may make of a leaf split over
#: ``model``, by case: a local ring's ``pos`` where its K/V go on heads
#: (gemma2's layer 0: [B / 2, W] gathered at use, as the layer needs the
#: whole ring's positions); nothing else, parameter or cache
SERVE_MADE = {"gemma2": {"cache/0/pos": [2, 16]}, "recurrentgemma": {},
              "moe": {}, "xlstm": {}, "whisper": {}}


@pytest.mark.parametrize("case", list(R.SERVE_CASES))
def test_placed_serve_makes_no_model_split_leaf_whole(ranks, case):
    """No rank makes a tensor of a ``model``-split parameter larger than
    its shard (no such leaf is gathered at all: each part of these layers
    computes on its shards), nor of a KV, ring or RG-LRU cache leaf, but
    for a heads-split ring's ``pos`` (SERVE_MADE)."""
    for rec in _serve(ranks, f"serve_{case}"):
        assert json.loads(str(rec["made"])) == SERVE_MADE[case]
