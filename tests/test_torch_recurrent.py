"""The recurrent mixers in the port against the JAX package: RG-LRU
(recurrentgemma-9b) and mLSTM / sLSTM (xlstm-125m), at reduced widths in
float32, and trap C12 (a pinned reader's score is not stable under a
recurrent layer) reproduced from JAX.

The inputs are numpy arrays from a seed; JAX parameters cross over with
``repro_torch.convert``.  Tolerances: module outputs and states within
atol = rtol = 1e-5 (matmuls and exponentials in another order), except the
RG-LRU scan alone, which :func:`test_scan_matches_lax_associative_scan`
holds to the rounding bound of a log-depth scan (see there); logits within
``tests/test_torch_model.py``'s 1e-4.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.configs import reduced_config as jax_reduced
from repro.configs.base import RunConfig as JRun
from repro.configs.base import SHAPES as JSHAPES
from repro.models import mlstm as jm
from repro.models import rglru as jr
from repro.models import transformer as jtf
from repro.serve import engine as jengine

from repro_torch.configs import SHAPES, reduced_config
from repro_torch.configs.base import RunConfig
from repro_torch.convert import (params_from_numpy, serve_state_from_numpy,
                                 tensor_from_numpy, to_numpy)
from repro_torch.launch import serve as launcher
from repro_torch.models import mlstm as tm
from repro_torch.models import rglru as tr
from repro_torch.serve.engine import MVServeEngine

MODULE = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=1e-4, rtol=1e-4)
RG, XL = "recurrentgemma-9b", "xlstm-125m"


def t(x):
    return tensor_from_numpy(np.asarray(x), "cpu")


def tree(p):
    if isinstance(p, dict):
        return {k: tree(v) for k, v in p.items()}
    return t(p)


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def assert_state(st_t, st_j, tol=MODULE):
    assert type(st_t).__name__ == type(st_j).__name__
    for f, a, b in zip(st_j._fields, st_t, st_j, strict=True):
        assert a.dtype == torch.float32, f
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f,
                                   **tol)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------
def _rglru(seed):
    cfg_j, cfg_t = jax_reduced(RG), reduced_config(RG)
    p = jr.init_rglru(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, cfg_t, p, tree(p)


def _rglru_state(rng, cfg):
    w = cfg.rnn_width
    return jr.RGLRUState(h=jnp.asarray(rand(rng, 2, w, scale=0.3)),
                         conv=jnp.asarray(rand(rng, 2, cfg.conv_width - 1, w)))


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no_state", "state"])
def test_conv1d_matches_jax(with_state):
    cfg_j, cfg_t, pj, pt = _rglru(1)
    rng = np.random.default_rng(1)
    u = rand(rng, 2, 7, cfg_j.rnn_width)
    conv = rand(rng, 2, cfg_j.conv_width - 1, cfg_j.rnn_width) \
        if with_state else None
    oj, sj = jr._conv1d(pj, cfg_j, jnp.asarray(u),
                        None if conv is None else jnp.asarray(conv))
    ot, st = tr._conv1d(pt, cfg_t, torch.from_numpy(u),
                        None if conv is None else torch.from_numpy(conv))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **MODULE)
    assert st.dtype == torch.float32
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **MODULE)


@pytest.mark.parametrize("T", [1, 5, 16, 37])
def test_scan_matches_lax_associative_scan(T):
    """The port's log-depth scan against JAX's ``lax.associative_scan`` of
    the same combine.  Both sum the terms ``b_s prod a`` of each ``h_t``
    in a tree of depth at most ``2 ceil(log2 T)``, each level one float32
    rounding of a product and one of a sum, so each differs from the exact
    ``h_t`` by at most about ``2 (2 ceil(log2 T) + 1) 2**-24`` times the
    same recurrence on ``|b|`` (every term's magnitude summed); the bound
    below is twice that, for the two of them."""
    rng = np.random.default_rng(T)
    a = rng.uniform(0.05, 1.0, (2, T, 24)).astype(np.float32)
    b = rand(rng, 2, T, 24)

    def combine(x1, x2):
        return x1[0] * x2[0], x2[0] * x1[1] + x2[1]

    _, hj = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                               jnp.asarray(b)), axis=1)
    ht = tr._scan(torch.from_numpy(a), torch.from_numpy(b))
    habs = tr._scan(torch.from_numpy(a), torch.from_numpy(np.abs(b))).double()
    depth = 2 * math.ceil(math.log2(T)) if T > 1 else 0
    bound = 4 * (depth + 1) * 2.0**-24 * habs + 1e-30
    err = (ht.double() - torch.from_numpy(np.array(hj)).double()).abs()
    assert bool((err <= bound).all()), float((err / bound).max())
    # and exactly the recurrence's order of terms at T = 1, 2
    if T <= 2:
        np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no_state", "carried_state"])
def test_rglru_matches_jax(with_state):
    """The prefill pass (scan), a carried state folded into step 0."""
    cfg_j, cfg_t, pj, pt = _rglru(2)
    rng = np.random.default_rng(2)
    x = rand(rng, 2, 13, cfg_j.d_model, scale=0.5)
    sj0 = _rglru_state(rng, cfg_j) if with_state else None
    st0 = None if sj0 is None else tr.RGLRUState(t(sj0.h), t(sj0.conv))
    oj, sj = jr.rglru(pj, cfg_j, jnp.asarray(x), sj0)
    ot, st = tr.rglru(pt, cfg_t, torch.from_numpy(x), st0)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **MODULE)
    assert_state(st, sj)
    if st0 is not None:          # the given state is left as it was
        np.testing.assert_array_equal(st0.h.numpy(), np.asarray(sj0.h))


def test_rglru_decode_matches_jax():
    cfg_j, cfg_t, pj, pt = _rglru(3)
    rng = np.random.default_rng(3)
    sj = _rglru_state(rng, cfg_j)
    st = tr.RGLRUState(t(sj.h), t(sj.conv))
    for i in range(4):
        x = rand(rng, 2, 1, cfg_j.d_model, scale=0.5)
        oj, sj = jr.rglru_decode(pj, cfg_j, jnp.asarray(x), sj)
        ot, st = tr.rglru_decode(pt, cfg_t, torch.from_numpy(x), st)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **MODULE,
                                   err_msg=f"step {i}")
        assert_state(st, sj)


def test_rglru_scan_equals_stepwise():
    """The port's own scan against its own decode steps, as JAX's
    ``tests/models/test_archs_smoke.py`` holds JAX's."""
    cfg = reduced_config(RG)
    p = tr.init_rglru(torch.Generator().manual_seed(5), cfg)
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(6)) * 0.5
    out_scan, st_scan = tr.rglru(p, cfg, x)
    st = tr.rglru_init_state(cfg, 2)
    outs = []
    for i in range(16):
        o, st = tr.rglru_decode(p, cfg, x[:, i:i + 1], st)
        outs.append(o)
    torch.testing.assert_close(out_scan, torch.cat(outs, dim=1), **MODULE)
    torch.testing.assert_close(st_scan.h, st.h, **MODULE)
    torch.testing.assert_close(st_scan.conv, st.conv, **MODULE)


def test_rglru_gates_stay_float32_in_bf16():
    """``wa``, ``ba``, ``wx``, ``bx``, ``lambda`` and the state are float32
    in a bf16 block; its output is bf16."""
    cfg = reduced_config(RG)
    p = tr.init_rglru(torch.Generator().manual_seed(7), cfg,
                      dtype=torch.bfloat16)
    assert {k for k, v in p.items() if v.dtype == torch.float32} == {
        "wa", "ba", "wx", "bx", "lambda"}
    x = torch.randn((2, 5, cfg.d_model)).to(torch.bfloat16)
    out, st = tr.rglru(p, cfg, x)
    assert out.dtype == torch.bfloat16
    assert st.h.dtype == st.conv.dtype == torch.float32
    out, st = tr.rglru_decode(p, cfg, x[:, :1], st)
    assert out.dtype == torch.bfloat16 and st.h.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_state_owns_its_memory(dtype):
    """The state a prefill returns holds its own storage, not a view of
    the scan's [B, T, w] output or the conv history: a view kept every
    layer's whole scan alive between passes (12.6 GiB at
    recurrentgemma-9b's full-width prefill on an H100)."""
    cfg = reduced_config(RG)
    p = tr.init_rglru(torch.Generator().manual_seed(9), cfg, dtype=dtype)
    x = torch.randn((2, 40, cfg.d_model)).to(dtype)
    for st in (tr.rglru(p, cfg, x)[1],
               tr.rglru_decode(p, cfg, x[:, :1], tr.rglru_init_state(
                   cfg, 2))[1]):
        for t_ in st:
            assert t_.untyped_storage().nbytes() == t_.numel() * 4


# ---------------------------------------------------------------------------
# mLSTM / sLSTM
# ---------------------------------------------------------------------------
def _xl(init, seed):
    cfg_j, cfg_t = jax_reduced(XL), reduced_config(XL)
    p = init(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, cfg_t, p, tree(p)


def _mlstm_state(rng, cfg):
    s = jm.mlstm_init_state(cfg, 2)
    return jm.MLSTMState(C=jnp.asarray(rand(rng, *s.C.shape, scale=0.2)),
                         n=jnp.asarray(np.abs(rand(rng, *s.n.shape))))


@pytest.mark.parametrize("T,with_state", [(16, False), (13, True), (5, True)],
                         ids=["chunks", "ragged-state", "short-state"])
def test_mlstm_chunkwise_matches_jax(T, with_state):
    """T 13 over chunks of 8: the ragged tail padded with ``li = NEG`` and
    ``lf = 0``; T 5, shorter than a chunk."""
    cfg_j, cfg_t, pj, pt = _xl(jm.init_mlstm, 4)
    rng = np.random.default_rng(4)
    x = rand(rng, 2, T, cfg_j.d_model, scale=0.5)
    sj0 = _mlstm_state(rng, cfg_j) if with_state else None
    st0 = None if sj0 is None else tm.MLSTMState(t(sj0.C), t(sj0.n))
    oj, sj = jm.mlstm_chunkwise(pj, cfg_j, jnp.asarray(x), sj0)
    ot, st = tm.mlstm_chunkwise(pt, cfg_t, torch.from_numpy(x), st0)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **MODULE)
    assert_state(st, sj)


def test_mlstm_decode_matches_jax():
    cfg_j, cfg_t, pj, pt = _xl(jm.init_mlstm, 5)
    rng = np.random.default_rng(5)
    sj = _mlstm_state(rng, cfg_j)
    st = tm.MLSTMState(t(sj.C), t(sj.n))
    for T in (1, 1, 3):
        x = rand(rng, 2, T, cfg_j.d_model, scale=0.5)
        oj, sj = jm.mlstm_decode(pj, cfg_j, jnp.asarray(x), sj)
        ot, st = tm.mlstm_decode(pt, cfg_t, torch.from_numpy(x), st)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **MODULE)
        assert_state(st, sj)


def test_mlstm_chunkwise_equals_recurrent():
    """The port's chunkwise pass against its own step recurrence, as JAX's
    ``tests/models/test_archs_smoke.py`` holds JAX's (a ragged T here)."""
    cfg = reduced_config(XL, mlstm_chunk=8)
    p = tm.init_mlstm(torch.Generator().manual_seed(3), cfg)
    x = torch.randn((2, 30, cfg.d_model),
                    generator=torch.Generator().manual_seed(4)) * 0.5
    out_c, st_c = tm.mlstm_chunkwise(p, cfg, x)
    out_r, st_r = tm.mlstm_decode(p, cfg, x, tm.mlstm_init_state(cfg, 2))
    torch.testing.assert_close(out_c, out_r, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(st_c.C, st_r.C, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(st_c.n, st_r.n, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no_state", "carried_state"])
def test_slstm_matches_jax(with_state):
    """Sequential over T; the stabiliser ``m`` starts at -1e30."""
    cfg_j, cfg_t, pj, pt = _xl(jm.init_slstm, 6)
    rng = np.random.default_rng(6)
    x = rand(rng, 2, 9, cfg_j.d_model, scale=0.5)
    sj0 = None
    if with_state:
        shape = jm.slstm_init_state(cfg_j, 2).c.shape
        sj0 = jm.SLSTMState(*(jnp.asarray(rand(rng, *shape, scale=0.3))
                              for _ in range(4)))
    st0 = None if sj0 is None else tm.SLSTMState(*(t(a) for a in sj0))
    oj, sj = jm.slstm(pj, cfg_j, jnp.asarray(x), sj0)
    ot, st = tm.slstm(pt, cfg_t, torch.from_numpy(x), st0)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **MODULE)
    assert_state(st, sj)
    if not with_state:
        init = tm.slstm_init_state(cfg_t, 2)
        assert bool((init.m == tm.NEG).all())


def test_xlstm_float32_leaves_in_bf16():
    """``w_if`` and the sLSTM bias ``b`` stay float32 in bf16 blocks."""
    cfg = reduced_config(XL)
    g = torch.Generator().manual_seed(8)
    pm = tm.init_mlstm(g, cfg, dtype=torch.bfloat16)
    ps = tm.init_slstm(g, cfg, dtype=torch.bfloat16)
    assert [k for k, v in pm.items() if v.dtype == torch.float32] == ["w_if"]
    assert [k for k, v in ps.items() if v.dtype == torch.float32] == ["b"]


# ---------------------------------------------------------------------------
# the engine: states cross over, and trap C12
# ---------------------------------------------------------------------------
B, T, MAX_LEN = 2, 8, 32


def _engines(arch, **overrides):
    cfg_j = jax_reduced(arch, **overrides)
    cfg_t = reduced_config(arch, **overrides)
    pj = jtf.init_params(cfg_j, jax.random.PRNGKey(11))
    kw = dict(gc_policy="slrt", versions_per_slot=8, reader_lanes=4)
    je = jengine.MVServeEngine(
        cfg_j, JRun(model=cfg_j, shape=JSHAPES["decode_32k"], **kw), pj,
        batch=B, max_len=MAX_LEN, dtype=jnp.float32)
    te = MVServeEngine(
        cfg_t, RunConfig(model=cfg_t, shape=SHAPES["decode_32k"], **kw),
        params_from_numpy(cfg_t, pj, "cpu"), batch=B, max_len=MAX_LEN,
        dtype=torch.float32, device="cpu")
    return cfg_j, cfg_t, je, te


@pytest.mark.parametrize("arch,changes", [(XL, True), (RG, True),
                                          ("minitron-4b", False)],
                         ids=["xlstm", "recurrentgemma", "minitron"])
def test_c12_pinned_score_changes_under_a_recurrent_layer_as_in_jax(
        arch, changes):
    """Trap C12, a JAX fault the port reproduces.  ``snapshot_score``
    versions only the lengths; a recurrent layer's state is its state now,
    so a reader pinned after one decode step scores against the newest
    state.  Scored again after each of 3 more steps, the score differs
    from the one at the pin in both packages at the same steps (every
    step), and the two packages agree at every step; reduced minitron-4b
    (attention only) never changes.  The reduced window of 16 holds the 12
    positions here, so no ring wraps (C10 stays out)."""
    cfg_j, cfg_t, je, te = _engines(arch)
    rng = np.random.default_rng(12)
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
        np.testing.assert_allclose(st.numpy(), sj, **LOGITS)
        return sj, st

    base_j, base_t = scores()
    same_j, same_t = [], []
    for _ in range(3):
        je.step()
        te.step()
        sj, st = scores()
        same_j.append(bool(np.array_equal(sj, base_j)))
        same_t.append(bool(torch.equal(st, base_t)))
        np.testing.assert_array_equal(te.lengths_at(t0).numpy(),
                                      np.asarray(je.lengths_at(t0)))
    assert same_t == same_j == [not changes] * 3


@pytest.mark.parametrize("arch", [XL, RG])
def test_launcher_names_c12(arch):
    """The reader check stays strict: every reader of a recurrent model is
    held across decode steps, its score changes (C12) and the launcher
    fails, naming the trap.  With ``--prompt-len 4 --steps 10`` reduced
    recurrentgemma-9b's ring of 16 never wraps, so C10 is not named; the
    readers pinned after steps 0 and 8 are both held across a step."""
    with pytest.raises(SystemExit, match="C12") as err:
        launcher.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--prompt-len", "4", "--steps", "10"])
    assert "C10" not in str(err.value)
    assert str(err.value).startswith("2 pinned readers")


def test_launcher_serves_a_recurrent_model_on_cpu():
    """``serve()`` itself runs: tokens in the vocabulary, each reader's
    ``lengths_at`` exactly the lengths at its pin, every reader's score
    changed but the one pinned after the last step, which no step follows
    (C12)."""
    args = launcher.parse_args(["--arch", RG, "--reduced", "--device", "cpu",
                                "--prompt-len", "4", "--steps", "9"])
    cfg, engine, prompt = launcher.build(args)
    rep = launcher.serve(engine, prompt, steps=9, pin_every=8,
                         log=lambda line: None)
    assert rep["readers"] == 2 and rep["score_mismatches"] == 1
    assert rep["snapshot_lengths"] == {0: [5] * 4, 1: [13] * 4}
    toks = rep["tokens"]
    assert tuple(toks.shape) == (4, 9)
    assert 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size


@pytest.mark.parametrize("arch", [XL, RG])
def test_serve_state_round_trip_carries_recurrent_states(arch):
    """A JAX ServeState with recurrent states (stacked over superblocks as
    NamedTuples) crosses over in bf16: states stay float32 and exact, the
    float32 gate leaves too; the port decodes on from it as JAX does (in
    float32)."""
    cfg_j, cfg_t, je, te = _engines(arch)
    prompt = np.random.default_rng(13).integers(
        0, cfg_j.vocab_size, (B, T)).astype(np.int32)
    je.prefill(jnp.asarray(prompt))
    je.step()
    bf = serve_state_from_numpy(cfg_t, je.state, "cpu", dtype=torch.bfloat16)
    back = to_numpy(bf)
    states = 0
    for i, (c, cb) in enumerate(zip(bf.cache, back.cache)):
        r, j = divmod(i, len(cfg_j.layer_pattern))
        cj = je.state.cache["sb"][f"l{j}"]
        if hasattr(c, "k"):
            continue
        states += 1
        assert type(c).__name__ == type(cj).__name__
        for f, a, b in zip(c._fields, c, cj):
            assert a.dtype == torch.float32, f
            np.testing.assert_array_equal(getattr(cb, f), np.asarray(b)[r])
    kinds = [cfg_t.layer_pattern[i % len(cfg_t.layer_pattern)]
             for i in range(cfg_t.num_layers)]
    assert states == sum(k != "local" for k in kinds)
    for layer, kind in zip(bf.params["layers"], kinds):
        f32 = {k for k, v in layer["mixer"].items()
               if v.dtype == torch.float32}
        assert f32 == {"rglru": {"wa", "ba", "wx", "bx", "lambda"},
                       "mlstm": {"w_if"}, "slstm": {"b"},
                       "local": set()}[kind]
    te.state = serve_state_from_numpy(cfg_t, je.state, "cpu")
    for i in range(3):
        tj, tt = je.step(), te.step()
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj),
                                      err_msg=f"step {i}")
        assert te.last_stats == je.last_stats
