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
measured 5.7e-4 at most, while the losses stay within 2.3e-6.  One bf16
step (C14) is held at looser limits, stated in its test.
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
from repro_torch.convert import params_to_numpy, train_state_from_numpy
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


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (float32 spacing times 2**16)."""
    return np.spacing(np.abs(x).astype(np.float32)) * np.float32(2.0**16)


def _f32_leaves(tree) -> list:
    """A tree's leaves in JAX's order, as float32 numpy copies (the port's
    AdamW updates its tensors in place)."""
    return [np.array(np.asarray(x, np.float32)) for x in jax.tree.leaves(
        tree)]


@pytest.fixture(scope="module")
def bf16_jax_steps():
    """JAX's side of the bf16 test below, run once: the state from
    ``init_state(PRNGKey(0), dtype=bfloat16)`` at reduced minitron-4b,
    two batches of B 2 x T 16, and each ``train_step``'s state and
    metrics at lr 1e-3."""
    cfg = jax_reduced("minitron-4b")
    run = JRunConfig(model=cfg, shape=JSHAPES["train_4k"], lr=1e-3)
    state = jinit_state(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    out = dict(init=state, batches=[], params=[], mu=[], metrics=[])
    rng = np.random.default_rng(0)
    step = jax.jit(lambda s, b: jtrain_step(s, b, cfg, run))
    for _ in range(2):
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(
            np.int32)}
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        out["batches"].append(batch)
        out["params"].append(_f32_leaves(state.params))
        out["mu"].append(_f32_leaves(state.opt.mu))
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["params0"] = _f32_leaves(out["init"].params)
    return out


def _bf16_port_steps(jx) -> dict:
    """The port's two steps from JAX's initial state, carried across with
    ``train_state_from_numpy``, on the same batches, collected as
    ``bf16_jax_steps`` collects JAX's."""
    cfg = reduced_config("minitron-4b")
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], lr=1e-3)
    st = train_state_from_numpy(cfg, jx["init"], "cpu")
    assert {x.dtype for x in tree_flatten(st.params)} == {torch.bfloat16}
    assert {x.dtype for x in tree_flatten(st.opt.mu)} == {torch.float32}
    out = dict(params=[], mu=[], metrics=[])
    for batch in jx["batches"]:
        st, m = train_step(st, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, cfg, run)
        assert {x.dtype for x in tree_flatten(st.params)} == \
            {torch.bfloat16}
        out["params"].append(_f32_leaves(params_to_numpy(cfg, st.params)))
        out["mu"].append(_f32_leaves(params_to_numpy(cfg, st.opt.mu)))
        out["metrics"].append({k: float(v) for k, v in m.items()})
    return out


def _bf16_limits(jx, pt) -> dict:
    """Each limit of ``test_bf16_train_step_matches_jax`` as (measured,
    allowed); a limit holds where measured <= allowed."""
    def rel(key):
        return max(abs(a[key] - b[key]) / abs(b[key])
                   for a, b in zip(pt["metrics"], jx["metrics"]))

    mu = max(float(np.abs(a - b).max() / np.abs(b).max())
             for a, b in zip(pt["mu"][0], jx["mu"][0]))
    flips = moved_j = moved_diff = 0
    update = 0.0
    lr1 = jx["metrics"][1]["lr"]
    for a, b, p, m in zip(pt["params"][1], jx["params"][1], jx["params0"],
                          jx["mu"][1]):
        m = np.abs(m)
        known = m > 2.0**-5 * m.max()
        flips += int((((a - p) * (b - p) < 0) & known).sum())
        limit = 2 * _bf16_ulp(np.maximum(np.abs(a), np.abs(b))) + lr1 / 2
        update = max(update, float((np.abs(a - b) / limit).max()))
        moved_j += int((b != p).sum())
        moved_diff += int(((a != p) != (b != p)).sum())
    return {"loss": (rel("loss"), 1e-3),
            "grad_norm": (rel("grad_norm"), 5e-3),
            "mu": (mu, 2.0**-5),
            "update": (update, 1.0),
            "direction": (flips, 0),
            "moved": (moved_diff, 0.05 * moved_j)}


def test_bf16_train_step_matches_jax(bf16_jax_steps):
    """C14: two ``train_step`` calls from JAX's
    ``init_state(dtype=bfloat16)`` at reduced minitron-4b, B 2 x T 16, lr
    1e-3, carried across with ``train_state_from_numpy``: bf16 parameters,
    float32 moments, both packages.

    Step 0 runs at the schedule's rate 0, so its parameters equal those
    before it, bit for bit, on both sides, and its gradient is compared
    through AdamW's first moment (mu = 0.1 g, clipped), leaf by leaf.
    Step 1 runs at the warmup's rate 1e-5: the bf16 update (AdamW in
    float32 on the bf16 leaves, then the cast back) is held against JAX's.

    Limits (``_bf16_limits``), from the bf16 rounding at other places in
    the two packages: JAX scales q in bf16 before the product (trap T6),
    the port's CPU attention computes in float32 from the bf16 values,
    and every bf16 matmul output rounds to 2**-9 of itself.
    - loss: 1e-3 relative at each step, a few 2**-9 roundings of the
      logits' sum (measured 1.3e-4; 2.6e-5 in the probe that found C14);
    - grad_norm: 5e-3 relative, about two bf16 steps (2**-8) of the norm,
      which adds every leaf's rounding (measured 1.9e-3; 4.3e-4 in the
      probe);
    - mu: each leaf within 2**-5 of its largest magnitude, a few bf16
      roundings of the largest gradient terms (measured 1.6 %);
    - update: each entry within 2 bf16 steps of JAX's plus half the
      step-1 rate.  Most entries move by less than half a bf16 step and
      keep their bits; Adam's update is about lr whatever the gradient's
      size, so where the gradient is at rounding-noise level, as for the
      norm scales that start at 0, the two updates can differ by a
      fraction of lr (measured 0.43 of this limit at most);
    - direction: no entry whose gradient is well determined (|mu| above
      2**-5 of its leaf's largest, the mu limit) moves the other way;
    - moved: the entries that moved are the same in both packages, at
      most 5 % differ (measured 25 of about 3130, 0.8 %, each an update
      that lands near a rounding boundary).
    ``test_bf16_limits_fail_a_step_missing_a_term`` shows each limit
    failing once one term of the gradient (of the forward, for the loss)
    is removed: by 13 to 28 times the relative limits, with 54 entries
    moving the other way."""
    jx = bf16_jax_steps
    pt = _bf16_port_steps(jx)
    assert [m["lr"] for m in pt["metrics"]] == \
        [m["lr"] for m in jx["metrics"]]
    assert jx["metrics"][0]["lr"] == 0.0 and jx["metrics"][1]["lr"] > 0
    for a, b, p in zip(pt["params"][0], jx["params"][0], jx["params0"]):
        np.testing.assert_array_equal(a, p)
        np.testing.assert_array_equal(b, p)
    assert all(np.abs(b).max() > 0 for b in jx["mu"][0])
    n = sum(x.size for x in jx["params0"])
    assert sum(int((b != p).sum()) for b, p in zip(
        jx["params"][1], jx["params0"])) > 0.01 * n
    limits = _bf16_limits(jx, pt)
    assert all(got <= allowed for got, allowed in limits.values()), limits


def _without_first_kv_tile(fn, grad: bool):
    """``attention_lse_ref`` (``grad`` False) or ``attention_bwd_ref``
    (``grad`` True) with the share of the first 8 KV columns removed from
    the attention output or from dq.  The share comes from the same
    function on those columns alone with the full row's statistics: the
    full LSE rescales the output's share, and the full o and LSE give the
    columns' own P and dX."""
    def fwd(q, k, v, **kw):
        out, lse = fn(q, k, v, **kw)
        part, lse_part = fn(q, k[:, :, :8], v[:, :, :8], **kw)
        share = torch.exp(lse_part - lse)[..., None] * part.float()
        return (out.float() - share).to(out.dtype), lse

    def bwd(q, k, v, o, do, lse, **kw):
        dq, dk, dv = fn(q, k, v, o, do, lse, **kw)
        share = fn(q, k[:, :, :8], v[:, :, :8], o, do, lse, **kw)[0]
        return (dq.float() - share.float()).to(dq.dtype), dk, dv

    return bwd if grad else fwd


@pytest.mark.parametrize("term,fails", [
    ("dq", {"grad_norm", "mu", "update", "direction", "moved"}),
    ("output", {"loss"}),
])
def test_bf16_limits_fail_a_step_missing_a_term(bf16_jax_steps, monkeypatch,
                                                term, fails):
    """The limits of ``test_bf16_train_step_matches_jax`` catch a wrong
    step: the same port run with the first 8 KV columns' share removed
    from every attention layer's dq (a term of the gradient) fails the
    gradient's, mu's and the update's limits.  The loss limit holds a
    forward value (step 0's rate is 0, so no gradient reaches a loss), so
    its case removes the same columns' share from the attention output."""
    from repro_torch.kernels.flash_prefill import ops as flash_ops
    name = "attention_bwd_ref" if term == "dq" else "attention_lse_ref"
    monkeypatch.setattr(flash_ops, name, _without_first_kv_tile(
        getattr(flash_ops, name), grad=term == "dq"))
    limits = _bf16_limits(bf16_jax_steps, _bf16_port_steps(bf16_jax_steps))
    failed = {k for k, (got, allowed) in limits.items() if got > allowed}
    assert fails <= failed, limits


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
