"""The encoder-decoder (whisper-tiny) and the VLM prefix (internvl2-2b) in
the port against the JAX package, at reduced widths in float32, and trap
C13 (whisper cannot go through ``MVServeEngine``, and its snapshot score
ignores the encoder) reproduced from JAX.

The encoder (sinusoidal positions, bidirectional attention with RoPE, the
final norm), cross-attention (prefill width and one decode row), the VLM
prefill (lengths ``T + Nf``) and ``prefill_step`` / ``decode_one`` over
both families, with weights carried by ``repro_torch.convert``.  The
port's cache-free attention runs K6's plain version here (its CPU route).
Tolerances: module outputs within atol = rtol = 1e-5, logits within
``tests/test_torch_model.py``'s 1e-4; lengths, tokens and ``MVState``
exact.
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
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.serve import engine as jengine

from repro_torch.configs import SHAPES, reduced_config
from repro_torch.configs.base import RunConfig
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.serve import engine as tengine

MODULE = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=1e-4, rtol=1e-4)
WH, VL = "whisper-tiny", "internvl2-2b"
B, T, MAX_LEN = 3, 9, 32


def t(x):
    return tensor_from_numpy(np.asarray(x), "cpu")


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _model(arch, seed=1):
    cfg_j, cfg_t = jax_reduced(arch), reduced_config(arch)
    pj = jtf.init_params(cfg_j, jax.random.PRNGKey(seed))
    return cfg_j, cfg_t, pj, params_from_numpy(cfg_t, pj, "cpu")


def frames(cfg, rng, n=None):
    """Frame or patch embeddings at scale 0.02, as the JAX package's
    ``tests/models/test_archs_smoke.py`` makes them."""
    n = n or cfg.encoder_tokens or cfg.frontend_tokens
    return rand(rng, B, n, cfg.d_model, scale=0.02)


def _attn(seed):
    cfg_j, cfg_t = jax_reduced(WH), reduced_config(WH)
    p = jattn.init_attention(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, cfg_t, p, {k: t(v) for k, v in p.items()}


def test_run_encoder_matches_jax():
    cfg_j, cfg_t, pj, pt = _model(WH)
    fe = frames(cfg_j, np.random.default_rng(1))
    want = jtf._run_encoder(pj, cfg_j, jnp.asarray(fe))
    got = ttf._run_encoder(pt, cfg_t, torch.from_numpy(fe))
    assert got.shape == (B, cfg_t.encoder_tokens, cfg_t.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE)


@pytest.mark.parametrize("causal", [False, True],
                         ids=["bidirectional", "causal"])
def test_cache_free_attention_matches_jax(causal):
    """JAX's train mode (no cache): the encoder's layer is bidirectional,
    with RoPE since whisper's config sets ``rope``."""
    cfg_j, cfg_t, pj, pt = _attn(2)
    rng = np.random.default_rng(2)
    x = rand(rng, B, 11, cfg_j.d_model)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (B, 11)).copy()
    yj, cj = jattn.attention(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos),
                             causal=causal)
    yt, ct = tattn.attention(pt, cfg_t, torch.from_numpy(x),
                             torch.from_numpy(pos), causal=causal)
    assert cj is None and ct is None
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **MODULE)


@pytest.mark.parametrize("Tq", [7, 1], ids=["prefill", "decode_row"])
def test_cross_attention_matches_jax(Tq):
    """Queries of the decoder over the encoder's output: never causal, no
    RoPE, no window; one query row is a decode step's call."""
    cfg_j, cfg_t, pj, pt = _attn(3)
    rng = np.random.default_rng(3)
    x, enc = rand(rng, B, Tq, cfg_j.d_model), rand(rng, B, 16, cfg_j.d_model)
    pos = np.full((B, Tq), 5, np.int32)
    yj, _ = jattn.attention(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos),
                            causal=False, x_kv=jnp.asarray(enc),
                            use_rope=False)
    yt, _ = tattn.attention(pt, cfg_t, torch.from_numpy(x),
                            torch.from_numpy(pos), causal=False,
                            x_kv=torch.from_numpy(enc), use_rope=False)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **MODULE)
    # with no enc_out the sublayer attends over x itself (trap C13)
    yj, _ = jattn.attention(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos),
                            causal=False, x_kv=None, use_rope=False)
    yt, _ = tattn.attention(pt, cfg_t, torch.from_numpy(x),
                            torch.from_numpy(pos), causal=False, x_kv=None,
                            use_rope=False)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **MODULE)


def _cache_np(cfg, cache):
    k, v = np.asarray(cache["sb"]["l0"].k), np.asarray(cache["sb"]["l0"].v)
    return [(k[i], v[i]) for i in range(cfg.num_layers)]


@pytest.mark.parametrize("arch", [VL, WH])
def test_prefill_then_decode_matches_jax(arch):
    """internvl2-2b with 8 patch embeddings before a 9-token prompt
    (lengths 17 = T + Nf); whisper-tiny over 16 frames, then decode steps
    with ``enc_out`` from ``_run_encoder``, as JAX's callers do."""
    cfg_j, cfg_t, pj, pt = _model(arch, 4)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg_j.vocab_size, (B, T)).astype(np.int32)
    fe = frames(cfg_j, rng)
    cj = jtf.init_cache(cfg_j, B, MAX_LEN, jnp.float32)
    lj, cj, lens_j = jtf.prefill(pj, cfg_j, jnp.asarray(tokens), cj,
                                 frontend_embeds=jnp.asarray(fe))
    ct = ttf.init_cache(cfg_t, B, MAX_LEN, torch.float32, "cpu")
    lt, ct, lens_t = ttf.prefill(pt, cfg_t, torch.from_numpy(tokens), ct,
                                 frontend_embeds=torch.from_numpy(fe))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGITS)
    np.testing.assert_array_equal(lens_t.numpy(), np.asarray(lens_j))
    assert lens_t.tolist() == [T + (fe.shape[1] if arch == VL else 0)] * B
    enc_j = enc_t = None
    if arch == WH:
        enc_j = jtf._run_encoder(pj, cfg_j, jnp.asarray(fe))
        enc_t = ttf._run_encoder(pt, cfg_t, torch.from_numpy(fe))
    for _ in range(2):
        step = rng.integers(0, cfg_j.vocab_size, (B, 1)).astype(np.int32)
        dj, cj = jtf.decode_step(pj, cfg_j, jnp.asarray(step), cj, lens_j,
                                 enc_out=enc_j)
        dt, ct = ttf.decode_step(pt, cfg_t, torch.from_numpy(step), ct,
                                 lens_t, enc_out=enc_t)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **LOGITS)
        for (kj, vj), c in zip(_cache_np(cfg_j, cj), ct):
            np.testing.assert_allclose(c.k.numpy(), kj, **MODULE)
            np.testing.assert_allclose(c.v.numpy(), vj, **MODULE)
        lens_j, lens_t = lens_j + 1, lens_t + 1


def _states(arch, seed=5):
    cfg_j, cfg_t, pj, pt = _model(arch, seed)
    kw = dict(gc_policy="slrt", versions_per_slot=4, reader_lanes=4)
    rj = JRun(model=cfg_j, shape=JSHAPES["decode_32k"], **kw)
    rt = RunConfig(model=cfg_t, shape=SHAPES["decode_32k"], **kw)
    sj = jengine.make_serve_state(cfg_j, rj, pj, B, MAX_LEN, jnp.float32)
    st = tengine.make_serve_state(cfg_t, rt, pt, B, MAX_LEN, torch.float32,
                                  "cpu")
    return cfg_j, cfg_t, rj, rt, sj, st


@pytest.mark.parametrize("arch", [VL, WH])
def test_prefill_step_and_decode_one_match_jax(arch):
    """The serving steps with patches (internvl2-2b) or frames
    (whisper-tiny): the next tokens, every step's stats, the lengths and
    the ``MVState`` exactly as JAX's; ``longest`` is ``T + Nf`` after a
    VLM prefill.  Four versions per slot make the pressure branch fire."""
    cfg_j, cfg_t, rj, rt, sj, st = _states(arch)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg_j.vocab_size, (B, T)).astype(np.int32)
    fe = frames(cfg_j, rng)
    sj = jengine.prefill_step(sj, cfg_j, rj, jnp.asarray(tokens),
                              jnp.asarray(fe))
    st = tengine.prefill_step(st, cfg_t, rt, torch.from_numpy(tokens),
                              torch.from_numpy(fe))
    total = T + (fe.shape[1] if arch == VL else 0)
    assert st.longest == int(st.cache_len.max()) == total
    np.testing.assert_array_equal(st.cache_len.numpy(),
                                  np.asarray(sj.cache_len))
    np.testing.assert_array_equal(st.last_tokens.numpy(),
                                  np.asarray(sj.last_tokens))
    enc_j = enc_t = None
    if arch == WH:
        enc_j = jtf._run_encoder(sj.params, cfg_j, jnp.asarray(fe))
        enc_t = ttf._run_encoder(st.params, cfg_t, torch.from_numpy(fe))
    reclaims = 0
    for i in range(6):
        sj, tj, _, stats_j = jengine.decode_one(sj, cfg_j, rj, enc_out=enc_j)
        st, tt, _, stats_t = tengine.decode_one(st, cfg_t, rt, enc_out=enc_t)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj),
                                      err_msg=f"tokens, step {i}")
        assert {k: int(v) for k, v in stats_t.items()} == \
            {k: int(v) for k, v in stats_j.items()}, f"stats, step {i}"
        reclaims += int(stats_t["reclaims_triggered"])
    assert reclaims >= 1
    assert st.longest == total + 6
    np.testing.assert_array_equal(st.cache_len.numpy(),
                                  np.asarray(sj.cache_len))
    for a, b in ((sj.mv.store, st.mv.store), (sj.mv.board, st.mv.board),
                 (sj.mv.ring, st.mv.ring)):
        for f, x, y in zip(a._fields, a, b):
            np.testing.assert_array_equal(np.asarray(x), y.numpy(),
                                          err_msg=f)
    assert int(st.mv.now) == int(sj.mv.now)


def test_c13_whisper_snapshot_score_ignores_the_encoder_as_in_jax():
    """Trap C13, a JAX fault the port reproduces.  ``snapshot_score``
    passes no ``enc_out``, so the decoder's cross-attention falls back to
    ``x_kv = x``: a whisper snapshot score attends over the scored tokens
    themselves, not the audio.  Confirmed by probe in both packages: the
    score equals ``decode_step`` with ``enc_out=None`` bit for bit, and
    differs from ``decode_step`` over the real encoder output; the two
    packages agree within the logits' tolerance."""
    cfg_j, cfg_t, rj, rt, sj, st = _states(WH, 6)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg_j.vocab_size, (B, T)).astype(np.int32)
    cand = rng.integers(0, cfg_j.vocab_size, (B, 1)).astype(np.int32)
    fe = frames(cfg_j, rng)
    sj = jengine.prefill_step(sj, cfg_j, rj, jnp.asarray(tokens),
                              jnp.asarray(fe))
    st = tengine.prefill_step(st, cfg_t, rt, torch.from_numpy(tokens),
                              torch.from_numpy(fe))
    enc_j = jtf._run_encoder(sj.params, cfg_j, jnp.asarray(fe))
    enc_t = ttf._run_encoder(st.params, cfg_t, torch.from_numpy(fe))
    sj, _, _, _ = jengine.decode_one(sj, cfg_j, rj, enc_out=enc_j)
    st, _, _, _ = tengine.decode_one(st, cfg_t, rt, enc_out=enc_t)
    sj, ts = jengine.begin_snapshot(sj, jnp.int32(0))
    st, ts_t = tengine.begin_snapshot(st, 0)
    assert int(ts_t) == int(ts)
    lj, found = jengine.snapshot_lengths(sj, ts)
    lens_j = jnp.where(found, lj, 0)
    score_j = np.asarray(jengine.snapshot_score(sj, cfg_j, jnp.asarray(cand),
                                                ts))
    no_enc_j = np.asarray(jtf.decode_step(sj.params, cfg_j,
                                          jnp.asarray(cand), sj.cache,
                                          lens_j)[0])
    with_enc_j = np.asarray(jtf.decode_step(sj.params, cfg_j,
                                            jnp.asarray(cand), sj.cache,
                                            lens_j, enc_out=enc_j)[0])
    np.testing.assert_array_equal(score_j, no_enc_j)
    assert not np.allclose(score_j, with_enc_j, **LOGITS)
    score_t = tengine.snapshot_score(st, cfg_t, torch.from_numpy(cand),
                                     int(ts))
    lens_t = tengine.snapshot_lengths(st, int(ts))
    no_enc_t = ttf.decode_step(st.params, cfg_t, torch.from_numpy(cand),
                               st.cache, lens_t)[0]
    with_enc_t = ttf.decode_step(st.params, cfg_t, torch.from_numpy(cand),
                                 st.cache, lens_t, enc_out=enc_t)[0]
    assert torch.equal(score_t, no_enc_t)
    assert not torch.allclose(score_t, with_enc_t, **LOGITS)
    np.testing.assert_allclose(score_t.numpy(), score_j, **LOGITS)
    np.testing.assert_allclose(with_enc_t.numpy(), with_enc_j, **LOGITS)


def test_c13_mv_serve_engine_cannot_prefill_whisper_in_either_package():
    """``MVServeEngine.prefill`` takes no frames: JAX's fails on ``None``
    (``AttributeError`` in ``_run_encoder``); the port's refuses with an
    error that names C13."""
    cfg_j, cfg_t, pj, pt = _model(WH, 7)
    tokens = np.zeros((B, T), np.int32)
    kw = dict(gc_policy="slrt", versions_per_slot=4, reader_lanes=4)
    je = jengine.MVServeEngine(
        cfg_j, JRun(model=cfg_j, shape=JSHAPES["decode_32k"], **kw), pj,
        batch=B, max_len=MAX_LEN)
    with pytest.raises(AttributeError):
        je.prefill(jnp.asarray(tokens))
    te = tengine.MVServeEngine(
        cfg_t, RunConfig(model=cfg_t, shape=SHAPES["decode_32k"], **kw), pt,
        batch=B, max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="C13"):
        te.prefill(tokens)


def test_launcher_refuses_whisper_naming_c13():
    with pytest.raises(SystemExit, match="C13"):
        launcher.main(["--arch", WH, "--reduced", "--device", "cpu"])


def test_launcher_serves_internvl2_without_patches_on_cpu():
    """internvl2-2b through the launcher as JAX's launcher runs it: text
    only, no patches; every reader's score holds."""
    rep = launcher.main(["--arch", VL, "--reduced", "--device", "cpu",
                         "--steps", "9"])
    assert rep["score_mismatches"] == 0 and rep["readers"] == 2
    assert tuple(rep["tokens"].shape) == (4, 9)
    assert rep["snapshot_lengths"][1] == [16 + 9] * 4
    assert int(rep["tokens"].max()) < reduced_config(VL).vocab_size
