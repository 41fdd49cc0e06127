"""The port's ``MVServeEngine`` against the JAX engine, both in float32.

One trace per GC policy (all five) and model family (dense minitron-4b,
gemma2-2b's local ring caches, granite-moe-1b-a400m's mixture of experts,
xlstm-125m's mLSTM/sLSTM and recurrentgemma-9b's RG-LRU with local rings):
a prefill of 4 x 16 tokens, 12 greedy decode steps, snapshot readers
pinned on two lanes, ``lengths_at``, ``snapshot_score`` and ``unpin``.
Four versions per slot make the pressure branch fire.  Every step's
tokens and ``last_stats`` must be equal, the ``MVState`` byte-identical at
the end, and the snapshot scores within atol = rtol = 1e-4 (float32 sums
in other orders).  ``snapshot_score`` must leave the port's state
bit-identical (trap T1), and the decode steps after it must still agree
with JAX.  Trap C10 (a pinned score changes once a local ring wraps) is
reproduced from JAX, state crosses over with rings and routers, and the
launcher runs at reduced size on CPU.
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
from repro_torch.convert import (params_from_numpy, serve_state_from_numpy,
                                 to_numpy)
from repro_torch.launch import serve as launcher
from repro_torch.serve.engine import MVServeEngine

ARCH, B, T, STEPS, MAX_LEN, V = "minitron-4b", 4, 16, 12, 32, 4
PINS = {2: 0, 5: 1}          # step -> lane pinned after it
SCORE_AT, UNPIN_AT = 7, 9    # lane 0 is read and scored, then unpinned
TOL = dict(atol=1e-4, rtol=1e-4)
POLICIES = ["slrt", "ebr", "dlrt", "steam", "sweep"]
# a dense model, local ring caches (the reduced window of 16 wraps during
# the trace: the scores are compared as both packages compute them, C10
# included), a mixture of experts, and the recurrent families (their
# scores follow the newest state in both packages: C12)
FAMILIES = ["minitron-4b", "gemma2-2b", "granite-moe-1b-a400m",
            "xlstm-125m", "recurrentgemma-9b"]


def engines(policy, arch=ARCH, **overrides):
    cfg_j = jax_reduced(arch, **overrides)
    cfg_t = reduced_config(arch, **overrides)
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


# the dense cases keep their ids from before the other families came
@pytest.mark.parametrize("policy,arch", [
    pytest.param(p, a, id=p if a == ARCH else f"{p}-{a}")
    for a in FAMILIES for p in POLICIES])
def test_engine_matches_jax(policy, arch):
    cfg_j, cfg_t, je, te = engines(policy, arch)
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


def test_k3_callers_equal_the_search_they_replaced():
    """K3's callers, each one ``value_at`` launch now, against what they
    computed before: ``snapshot_lengths`` and ``lengths_at`` against
    ``search`` over ``arange`` ids masked to 0, and against JAX's
    ``snapshot_lengths`` masked the same way, at every timestamp of a
    trace (before the first write too); the every-slot ``snapshot_read``
    (phase 5's read in ``chip_smoke.py``) against explicit ids."""
    from repro_torch.core.mvgc import vstore
    from repro_torch.serve import engine as tengine
    cfg_j, cfg_t, je, te = engines("slrt")
    prompt = np.random.default_rng(8).integers(
        0, cfg_j.vocab_size, (B, T)).astype(np.int32)
    je.prefill(jnp.asarray(prompt))
    te.prefill(prompt)
    for _ in range(6):
        je.step()
        te.step()
    ids = torch.arange(B, dtype=torch.int32)
    for t in range(int(te.state.mv.now) + 2):
        pay, found = vstore.snapshot_read(te.state.mv, ids, t)
        old = torch.where(found, pay, 0)
        jl, jf = jengine.snapshot_lengths(je.state, jnp.int32(t))
        np.testing.assert_array_equal(old.numpy(),
                                      np.where(np.asarray(jf), jl, 0))
        assert torch.equal(tengine.snapshot_lengths(te.state, t), old)
        assert torch.equal(te.lengths_at(t), old)
        for a, b in zip(vstore.snapshot_read(te.state.mv, None, t),
                        (pay, found), strict=True):
            assert torch.equal(a, b)
        if t == 0:
            assert not bool(found.any())


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


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-moe-16b"])
def test_serve_state_round_trip_carries_rings_and_routers(arch):
    """``serve_state_from_numpy`` with ``dtype=torch.bfloat16`` and back
    with ``to_numpy``: a local ring's ``pos`` stays int32 and exact, a
    router stays float32 and exact, every other leaf is the bf16 rounding
    of JAX's; the bf16 state then decodes on."""
    cfg_j, cfg_t, je, te = engines("slrt", arch)
    prompt = np.random.default_rng(6).integers(
        0, cfg_j.vocab_size, (B, T)).astype(np.int32)
    je.prefill(jnp.asarray(prompt))
    for _ in range(2):
        je.step()
    ts = serve_state_from_numpy(cfg_t, je.state, "cpu", dtype=torch.bfloat16)
    back = to_numpy(ts)

    def bf16(x):
        return torch.from_numpy(np.array(x)).to(torch.bfloat16).float(
        ).numpy()

    rings = 0
    for i, c in enumerate(back.cache):
        r, j = divmod(i, len(cfg_j.layer_pattern))
        cj = je.state.cache["sb"][f"l{j}"]
        np.testing.assert_array_equal(c.k, bf16(np.asarray(cj.k)[r]))
        if cfg_t.layer_pattern[j] == "local":
            rings += 1
            assert ts.cache[i].pos.dtype == torch.int32
            assert c.pos.dtype == np.int32
            np.testing.assert_array_equal(c.pos, np.asarray(cj.pos)[r])
    assert rings == (cfg_t.num_layers // 2 if arch == "gemma2-2b" else 0)
    routers = 0
    for i, layer in enumerate(back.params["layers"]):
        r, j = divmod(i, len(cfg_j.layer_pattern))
        ffn = je.state.params["sb"][f"l{j}"]["ffn"]
        if "router" in ffn:
            routers += 1
            assert ts.params["layers"][i]["ffn"]["router"].dtype \
                == torch.float32
            np.testing.assert_array_equal(layer["ffn"]["router"],
                                          np.asarray(ffn["router"])[r])
            assert ts.params["layers"][i]["ffn"]["wg"].dtype \
                == torch.bfloat16
        np.testing.assert_array_equal(layer["ffn"]["wd"],
                                      bf16(np.asarray(ffn["wd"])[r]))
    assert routers == (cfg_t.num_layers if cfg_t.num_experts else 0)
    np.testing.assert_array_equal(back.cache_len,
                                  np.asarray(je.state.cache_len))
    te.state = ts
    toks = te.step()
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg_t.vocab_size


@pytest.mark.parametrize("window,wraps", [(0, True), (64, False)],
                         ids=["wraps", "no_wrap"])
def test_c10_pinned_score_changes_once_the_ring_wraps_as_in_jax(window,
                                                               wraps):
    """Trap C10, a JAX fault the port reproduces.  Reduced gemma2-2b with
    a 16-token prompt fills its ring (window 16); a reader pinned after
    one decode step scores the same candidates after each further step.
    Decode overwrites ring slot ``p % W`` whether or not a pinned window
    covers it, so from the 2nd step on the score differs from the one at
    the pin, in both packages and at the same steps, and the two packages'
    scores agree at every step.  With a window of 64 (a ring of the
    cache's 32 slots that never wraps here) the score never changes."""
    over = {"local_window": window} if window else {}
    cfg_j, cfg_t, je, te = engines("slrt", "gemma2-2b", **over)
    rng = np.random.default_rng(10)
    prompt = rng.integers(0, cfg_j.vocab_size, (B, T)).astype(np.int32)
    cand = rng.integers(0, cfg_j.vocab_size, (B, 1)).astype(np.int32)
    je.prefill(jnp.asarray(prompt))
    te.prefill(prompt)
    je.step()
    te.step()
    t0 = je.pin(0)
    assert te.pin(0) == t0

    def scores():
        sj = np.asarray(jengine.snapshot_score(je.state, cfg_j,
                                               jnp.asarray(cand),
                                               jnp.int32(t0)))
        st = te.score(cand, t0)
        np.testing.assert_allclose(st.numpy(), sj, **TOL)
        return sj, st

    base_j, base_t = scores()
    same_j, same_t = [], []
    for _ in range(8):
        je.step()
        te.step()
        sj, st = scores()
        same_j.append(bool(np.array_equal(sj, base_j)))
        same_t.append(bool(torch.equal(st, base_t)))
    assert same_t == same_j
    assert same_j == ([True] + [False] * 7 if wraps else [True] * 8)


def test_launcher_reduced_on_cpu(capsys):
    rep = launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--steps", "17"])
    assert rep["score_mismatches"] == 0 and rep["readers"] == 3
    assert tuple(rep["tokens"].shape) == (4, 17)
    assert int(rep["tokens"].min()) >= 0
    assert int(rep["tokens"].max()) < reduced_config(ARCH).vocab_size
    assert rep["snapshot_lengths"][0] == [17] * 4   # pinned after step 0
    assert "[done] space report" in capsys.readouterr().out


@pytest.mark.parametrize("arch,flags", [
    ("gemma2-2b", ["--prompt-len", "8", "--steps", "8"]),
    ("deepseek-moe-16b", ["--steps", "9"])], ids=["gemma2", "deepseek"])
def test_launcher_reduced_new_families_on_cpu(arch, flags):
    """gemma2-2b at flags that keep every position inside its 16-token
    window (no wrap, so the readers' scores hold: trap C10), and
    deepseek-moe-16b."""
    rep = launcher.main(["--arch", arch, "--reduced", "--device", "cpu",
                         *flags])
    steps = int(flags[flags.index("--steps") + 1])
    assert rep["score_mismatches"] == 0 and rep["readers"] == -(-steps // 8)
    assert tuple(rep["tokens"].shape) == (4, steps)
    assert 0 <= int(rep["tokens"].min())
    assert int(rep["tokens"].max()) < reduced_config(arch).vocab_size


def test_launcher_names_c10_when_a_pinned_ring_wraps(capsys):
    """The reader check stays strict: reduced gemma2-2b's default flags
    (16-token prompt, 32 steps) wrap its ring under pinned readers, the
    scores change (C10) and the launcher fails, naming the trap."""
    with pytest.raises(SystemExit, match="C10"):
        launcher.main(["--arch", "gemma2-2b", "--reduced", "--device",
                       "cpu"])
