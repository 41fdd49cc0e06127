"""The port's ``MVServeEngine`` against the JAX engine, both in float32.

One trace per GC policy (slrt, ebr): a prefill of 4 x 16 tokens, 12 greedy
decode steps, snapshot readers pinned on two lanes, ``lengths_at``,
``snapshot_score`` and ``unpin``.  Four versions per slot make the pressure
branch fire.  Every step's tokens and ``last_stats`` must be equal, the
``MVState`` byte-identical at the end, and the snapshot scores within
atol = rtol = 1e-4 (float32 sums in other orders).  ``snapshot_score`` must
leave the port's state bit-identical (trap T1), and the decode steps after
it must still agree with JAX.  The launcher runs at reduced size on CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.configs import reduced_config as jax_reduced
from repro.configs.base import RunConfig as JRun
from repro.configs.base import SHAPES as JSHAPES
from repro.models import transformer as jtf
from repro.serve import engine as jengine

from repro_torch.configs import SHAPES, reduced_config
from repro_torch.configs.base import RunConfig
from repro_torch.convert import params_from_numpy, serve_state_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.serve.engine import MVServeEngine

ARCH, B, T, STEPS, MAX_LEN, V = "minitron-4b", 4, 16, 12, 32, 4
PINS = {2: 0, 5: 1}          # step -> lane pinned after it
SCORE_AT, UNPIN_AT = 7, 9    # lane 0 is read and scored, then unpinned
TOL = dict(atol=1e-4, rtol=1e-4)


def engines(policy):
    cfg_j, cfg_t = jax_reduced(ARCH), reduced_config(ARCH)
    pj = jtf.init_params(cfg_j, jax.random.PRNGKey(7))
    kw = dict(gc_policy=policy, versions_per_slot=V, reader_lanes=4)
    je = jengine.MVServeEngine(cfg_j, JRun(model=cfg_j,
                                           shape=JSHAPES["decode_32k"], **kw),
                               pj, batch=B, max_len=MAX_LEN,
                               dtype=jnp.float32)
    te = MVServeEngine(cfg_t, RunConfig(model=cfg_t,
                                        shape=SHAPES["decode_32k"], **kw),
                       params_from_numpy(cfg_t, pj, "cpu"), batch=B,
                       max_len=MAX_LEN, dtype=torch.float32, device="cpu")
    return cfg_j, cfg_t, je, te


def snapshot(x):
    """Every tensor in ``x`` (nested tuples and lists), cloned."""
    if torch.is_tensor(x):
        return [x.clone()]
    return [t for v in x for t in snapshot(v)]


def assert_mv_equal(mv_j, mv_t):
    for name, a, b in zip(("store", "board", "ring"),
                          (mv_j.store, mv_j.board, mv_j.ring),
                          (mv_t.store, mv_t.board, mv_t.ring)):
        for f, x, y in zip(a._fields, a, b):
            np.testing.assert_array_equal(np.asarray(x), y,
                                          err_msg=f"{name}.{f}")
    for f in ("now", "overflow_count", "dropped_retires"):
        np.testing.assert_array_equal(np.asarray(getattr(mv_j, f)),
                                      getattr(mv_t, f), err_msg=f)


@pytest.mark.parametrize("policy", ["slrt", "ebr"])
def test_engine_matches_jax(policy):
    cfg_j, cfg_t, je, te = engines(policy)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg_j.vocab_size, (B, T)).astype(np.int32)
    je.prefill(jnp.asarray(prompt))
    te.prefill(prompt)
    np.testing.assert_array_equal(te.state.last_tokens.numpy(),
                                  np.asarray(je.state.last_tokens))
    pins, reclaims = {}, 0
    for i in range(STEPS):
        tj, tt = je.step(), te.step()
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj),
                                      err_msg=f"tokens, step {i}")
        assert te.last_stats == je.last_stats, f"stats, step {i}"
        reclaims += te.last_stats["reclaims_triggered"]
        if i in PINS:
            lane = PINS[i]
            pins[lane] = je.pin(lane)
            assert te.pin(lane) == pins[lane]
        if i == SCORE_AT:
            t0 = pins[0]
            np.testing.assert_array_equal(te.lengths_at(t0).numpy(),
                                          np.asarray(je.lengths_at(t0)))
            cand = rng.integers(0, cfg_j.vocab_size, (B, 1)).astype(np.int32)
            want = jengine.snapshot_score(je.state, cfg_j, jnp.asarray(cand),
                                          jnp.int32(t0))
            live = (te.state.cache, te.state.cache_len, te.state.mv,
                    te.state.last_tokens)
            before = snapshot(live)
            got = te.score(cand, t0)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            after = snapshot(live)
            assert all(torch.equal(a, b) for a, b in zip(before, after)), \
                "snapshot_score changed the serving state (T1)"
        if i == UNPIN_AT:
            je.unpin(0)
            te.unpin(0)
    assert reclaims >= 1, "the pressure branch never fired"
    assert te.space() == je.space()
    assert_mv_equal(je.state.mv, te.state.mv)
    np.testing.assert_array_equal(te.state.cache_len.numpy(),
                                  np.asarray(je.state.cache_len))


def test_score_of_a_reader_pinned_before_a_new_prefill():
    """A reader pinned before a shorter prompt is prefilled sees lengths
    past the engine's longest sequence: the score is sized from the
    snapshot's lengths and still agrees with JAX."""
    cfg_j, cfg_t, je, te = engines("slrt")
    rng = np.random.default_rng(5)
    first, second, cand = (
        rng.integers(0, cfg_j.vocab_size, shape).astype(np.int32)
        for shape in ((B, T), (B, T // 2), (B, 1)))
    je.prefill(jnp.asarray(first))
    te.prefill(first)
    for _ in range(3):
        je.step()
        te.step()
    t0 = je.pin(0)
    assert te.pin(0) == t0
    je.prefill(jnp.asarray(second))
    te.prefill(second)
    assert te.state.longest == int(te.state.cache_len.max()) == T // 2
    assert te.lengths_at(t0).tolist() == [T + 3] * B
    want = jengine.snapshot_score(je.state, cfg_j, jnp.asarray(cand),
                                  jnp.int32(t0))
    np.testing.assert_allclose(te.score(cand, t0).numpy(), np.asarray(want),
                               **TOL)


def test_serve_state_from_numpy_round_trip():
    """A JAX ServeState crosses over whole: the port decodes on from it
    exactly as the JAX engine does."""
    cfg_j, cfg_t, je, te = engines("slrt")
    prompt = np.random.default_rng(4).integers(
        0, cfg_j.vocab_size, (B, T)).astype(np.int32)
    je.prefill(jnp.asarray(prompt))
    te.state = serve_state_from_numpy(cfg_t, je.state, "cpu")
    for i in range(3):
        tj, tt = je.step(), te.step()
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        assert te.last_stats == je.last_stats
    assert_mv_equal(je.state.mv, te.state.mv)


def test_launcher_reduced_on_cpu(capsys):
    rep = launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--steps", "17"])
    assert rep["score_mismatches"] == 0 and rep["readers"] == 3
    assert tuple(rep["tokens"].shape) == (4, 17)
    assert int(rep["tokens"].min()) >= 0
    assert int(rep["tokens"].max()) < reduced_config(ARCH).vocab_size
    assert rep["snapshot_lengths"][0] == [17] * 4   # pinned after step 0
    assert "[done] space report" in capsys.readouterr().out
