"""The port's training path against the JAX package, on CPU.

AdamW (clipping on and off, steps 1 and 50), the cosine schedule, the
int8 quantizer and the error-feedback carry, ``SyntheticLM`` (batches,
shards, resume), the 10-step ``train_step`` trajectory from JAX's
``init_state(PRNGKey(0))`` on the same batches at reduced minitron-4b,
gemma2-2b and granite-moe-1b-a400m (plain, 4 microbatches, and with
gradient compression), the ``grad_reduce`` hook, and the launcher's
crash and resume.  Inputs are numpy arrays from seeds; JAX state crosses
over with ``repro_torch.convert``.

Tolerances (float32): AdamW's parameters and moments within rtol 1e-6,
atol 1e-9 (the same operations in the same order; ``pow``, ``sqrt`` and
``cos`` may round an ulp apart); the quantizer, the carry and the data
bit for bit; the trajectory's loss within 1e-4 relative at every step,
its learning rate within 1e-6, its gradient norm within 1e-4 relative
(measured: 4e-7 at most) and within 2e-3 under compression: there the
norm is taken of the dequantized gradient, and a float32 rounding
difference that moves one element across a rounding boundary moves it by
a whole int8 step (``max|g| / 127``), which the error carry then keeps;
measured 5.7e-4 at most, while the losses stay within 2.3e-6.
"""
import json
import os
import re
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
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.train.step import init_state as jinit_state
from repro.train.step import train_step as jtrain_step

from repro_torch.ckpt.manager import tree_flatten, tree_unflatten
from repro_torch.configs import SHAPES, reduced_config
from repro_torch.configs.base import RunConfig
from repro_torch.convert import train_state_from_numpy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.optim import adamw, compress
from repro_torch.train.step import init_state, make_grad_reduce, train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = dict(rtol=1e-6, atol=1e-9)


def rand_tree(rng, scale=1.0):
    """A small parameter-like tree: a dict holding a list of dicts."""
    def r(*s):
        return (rng.standard_normal(s) * scale).astype(np.float32)
    return {"embed": r(6, 4), "layers": [{"w": r(4, 3), "b": r(3)},
                                         {"w": r(4, 3), "b": r(3)}]}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def assert_trees(got, want, **tol):
    got_l = [x.detach().numpy() for x in tree_flatten(got)]
    want_l = [np.asarray(x) for x in jax.tree.leaves(want)]
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g, w, **tol)


# ---------------------------------------------------------------------------
# optimizer and compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
@pytest.mark.parametrize("step", [0, 49])
def test_adamw_apply_matches_jax(grad_clip, step):
    rng = np.random.default_rng(step + int(grad_clip))
    params, grads = rand_tree(rng), rand_tree(rng, scale=3.0)
    mu, nu = rand_tree(rng, 0.1), jax.tree.map(np.abs, rand_tree(rng, 0.1))
    lr = np.float32(3e-3)
    jp, jst, jm = jadamw.apply(
        to_jax(params), to_jax(grads),
        jadamw.AdamWState(jnp.int32(step), to_jax(mu), to_jax(nu)),
        lr=jnp.asarray(lr), grad_clip=grad_clip)
    tp, tst, tm = adamw.apply(
        to_torch(params), to_torch(grads),
        adamw.AdamWState(torch.tensor(step, dtype=torch.int32),
                         to_torch(mu), to_torch(nu)),
        lr=torch.tensor(lr), grad_clip=grad_clip)
    assert int(tst.step) == int(jst.step) == step + 1
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    if grad_clip:
        assert float(jm["grad_norm"]) > grad_clip     # clipping acted
    assert_trees(tp, jp, **OPT)
    assert_trees(tst.mu, jst.mu, **OPT)
    assert_trees(tst.nu, jst.nu, **OPT)


@pytest.mark.parametrize("step", [0, 50, 100, 5000, 10000])
def test_cosine_schedule_matches_jax(step):
    want = jadamw.cosine_schedule(jnp.int32(step), base_lr=3e-3)
    got = adamw.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                base_lr=3e-3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if step == 0:
        assert float(got) == 0.0


def test_quantize_is_bit_equal_to_jax():
    rng = np.random.default_rng(4)
    g = (rng.standard_normal((64, 33)) * 0.01).astype(np.float32)
    g[0, :4] = [0.5, -0.5, 1.5 / 127, 2.5 / 127]      # ties at the scale
    for x in (g, np.zeros((3, 3), np.float32)):
        qj, sj = jcompress.quantize(jnp.asarray(x))
        qt, st = compress.quantize(torch.from_numpy(x))
        assert qt.dtype == torch.int8
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert st.numpy().tobytes() == np.asarray(sj).tobytes()


def test_error_feedback_carry_matches_jax_over_five_rounds():
    rng = np.random.default_rng(5)
    tree = rand_tree(rng)
    ej = jcompress.init_error(to_jax(tree))
    et = compress.init_error(to_torch(tree))
    for _ in range(5):
        g = rand_tree(rng, scale=0.02)
        qj, sj, ej = jcompress.compress_tree(to_jax(g), ej)
        qt, st, et = compress.compress_tree(to_torch(g), et)
        for a, b in zip(tree_flatten(qt), jax.tree.leaves(qj)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_flatten(et), jax.tree.leaves(ej)):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
        dj = jcompress.decompress_tree(qj, sj)
        dt = compress.decompress_tree(qt, st)
        for a, b in zip(tree_flatten(dt), jax.tree.leaves(dj)):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1234, 77])
def test_synthetic_lm_is_bit_equal_to_jax(seed):
    jd = JSyntheticLM(JDataConfig(300, 40, 6, seed=seed, copy_period=8))
    td = SyntheticLM(DataConfig(300, 40, 6, seed=seed, copy_period=8))
    for step in range(4):
        jb, tb = jd.batch_at(step), td.batch_at(step)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])
        for shard in range(3):
            for k, v in td.shard_batch(tb, shard, 3).items():
                np.testing.assert_array_equal(
                    v, jd.shard_batch(jb, shard, 3)[k])


def test_synthetic_lm_resumes_from_its_state_dict():
    a = SyntheticLM(DataConfig(100, 16, 4))
    for _ in range(3):
        next(a)
    b = SyntheticLM(DataConfig(100, 16, 4))
    b.load_state_dict(a.state_dict())
    ja = JSyntheticLM(JDataConfig(100, 16, 4))
    ja.load_state_dict({"step": 3})
    for _ in range(2):
        x, y, z = next(a), next(b), next(ja)
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
        np.testing.assert_array_equal(x["tokens"], z["tokens"])


# ---------------------------------------------------------------------------
# train_step
# ---------------------------------------------------------------------------
def _trajectory(arch, steps=10, **run_kw):
    cfg_j, cfg_t = jax_reduced(arch), reduced_config(arch)
    compression = run_kw.get("grad_compression", False)
    run_j = JRunConfig(model=cfg_j, shape=JSHAPES["train_4k"], lr=3e-3,
                       **run_kw)
    run_t = RunConfig(model=cfg_t, shape=SHAPES["train_4k"], lr=3e-3,
                      **run_kw)
    sj = jinit_state(cfg_j, jax.random.PRNGKey(0), compression=compression)
    st = train_state_from_numpy(cfg_t, sj, "cpu")
    data = JSyntheticLM(JDataConfig(cfg_j.vocab_size, 16, 8, copy_period=8))
    step_j = jax.jit(lambda s, b: jtrain_step(s, b, cfg_j, run_j))
    for i in range(steps):
        batch = data.batch_at(i)
        sj, mj = step_j(sj, {k: jnp.asarray(v) for k, v in batch.items()})
        st, mt = train_step(st, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, cfg_t, run_t)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-4, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]),
                                   rtol=2e-3 if compression else 1e-4,
                                   err_msg=f"grad_norm, step {i}")
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]),
                                   rtol=1e-6, err_msg=f"lr, step {i}")
    assert int(st.step) == int(sj.step) == steps
    assert int(st.opt.step) == steps


@pytest.mark.parametrize("arch", ["minitron-4b", "gemma2-2b",
                                  "granite-moe-1b-a400m"])
@pytest.mark.parametrize("variant", ["plain", "microbatches",
                                     "compression"])
def test_train_step_trajectory_matches_jax(arch, variant):
    kw = {"plain": {}, "microbatches": {"microbatches": 4},
          "compression": {"grad_compression": True}}[variant]
    _trajectory(arch, **kw)


def _clone(state):
    return tree_unflatten(state, [x.detach().clone()
                                  for x in tree_flatten(state)])


def test_grad_reduce_hook_sits_on_the_gradient_path():
    """An identity ``grad_reduce`` changes nothing; a zeroing one freezes
    the parameters at step 0 (JAX's
    ``tests/distrib/test_dist_unit.py::test_train_step_grad_reduce_hook``);
    ``make_grad_reduce`` in a process with no group is the identity."""
    cfg = reduced_config("minitron-4b")
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], lr=1e-2)
    data = {"tokens": torch.ones((4, 16), dtype=torch.int32)}
    state = init_state(cfg, torch.Generator().manual_seed(0))
    s_plain, m_plain = train_step(_clone(state), data, cfg, run)
    s_id, m_id = train_step(_clone(state), data, cfg, run,
                            grad_reduce=lambda g: g)
    s_ring, _ = train_step(_clone(state), data, cfg, run,
                           grad_reduce=make_grad_reduce())
    assert float(m_plain["loss"]) == float(m_id["loss"])
    for a, b, c in zip(tree_flatten(s_plain.params),
                       tree_flatten(s_id.params),
                       tree_flatten(s_ring.params)):
        assert torch.equal(a, b) and torch.equal(a, c)

    def zero(g):
        return tree_unflatten(g, [torch.zeros_like(x)
                                  for x in tree_flatten(g)])

    s_z, _ = train_step(_clone(state), data, cfg, run, grad_reduce=zero)
    for a, b in zip(tree_flatten(state.params), tree_flatten(s_z.params)):
        assert torch.equal(a, b)


def test_init_state_error_carry_matches_jax_layout():
    cfg = reduced_config("minitron-4b")
    gen = torch.Generator().manual_seed(0)
    off = init_state(cfg, gen)
    assert all(e.shape == (1,) and not e.any() for e in tree_flatten(off.err))
    on = init_state(cfg, torch.Generator().manual_seed(0), compression=True)
    assert [e.shape for e in tree_flatten(on.err)] == \
        [p.shape for p in tree_flatten(on.params)]
    assert int(on.step) == 0 and int(on.opt.step) == 0


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------
def _launch(ckpt, *flags):
    """The launcher on the CPU in one thread: with several, the CPU BLAS
    splits its sums by the threads it finds free, so two runs of the same
    step can differ in the last bit (measured here: 3 uninterrupted runs
    gave 2 different losses at step 5; with one thread, 4 of 4 agreed)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "minitron-4b", "--reduced", "--device", "cpu", "--steps", "12",
         "--ckpt-every", "5", "--log-every", "1", "--ckpt-dir", str(ckpt),
         *flags], capture_output=True, text=True, env=env, timeout=300)


def _losses(out):
    return dict(re.findall(r"step\s+(\d+)\s+loss (\S+)", out))


def test_launcher_crash_and_resume_is_bit_equal(tmp_path):
    full = _launch(tmp_path / "full")
    assert full.returncode == 0, full.stderr
    crash = _launch(tmp_path / "ft", "--simulate-crash-at", "7")
    assert crash.returncode == 42, crash.stderr
    assert "[crash] simulated failure at step 7" in crash.stdout
    resume = _launch(tmp_path / "ft")
    assert resume.returncode == 0, resume.stderr
    assert "[restore] resumed from step 5" in resume.stdout
    want, got = _losses(full.stdout), _losses(resume.stdout)
    assert sorted(got, key=int) == [str(i) for i in range(5, 12)]
    for i in range(5, 12):
        assert got[str(i)] == want[str(i)], f"step {i}"
    with open(tmp_path / "ft" / "heartbeat.json") as f:
        hb = json.load(f)
    assert hb["host_id"] == 0 and hb["step"] == 11


def test_launcher_refuses_whisper(tmp_path):
    out = _launch(tmp_path, "--arch", "whisper-tiny")
    assert out.returncode == 2
    assert "frame" in out.stderr and "SyntheticLM" in out.stderr
