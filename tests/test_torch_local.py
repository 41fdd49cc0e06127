"""gemma2-2b's local ring cache in the port against the JAX package.

``_prefill_local_ring`` with a prompt shorter than the ring, as long as it
and longer (the positions before ``T - W`` go to JAX's drop slot), and
``_local_ring_decode`` step by step across a wrap, compared in their
outputs and in the ring's ``k``, ``v`` and ``pos``; then reduced gemma2-2b
whole, prefill and decode steps that wrap every local layer's ring.  The
inputs are numpy arrays from a seed, and JAX parameters cross over with
``repro_torch.convert``.  Tolerances are ``tests/test_torch_model.py``'s:
outputs and logits within 1e-4, caches within 1e-5; ``pos`` is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.configs import reduced_config as jax_reduced
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import transformer as jtf

from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import transformer as ttf

LOGITS = dict(atol=1e-4, rtol=1e-4)
CACHE = dict(atol=1e-5, rtol=1e-5)
ARCH = "gemma2-2b"       # reduced: window 16, head dim 16, 4 q / 2 kv heads


def t(x):
    return tensor_from_numpy(np.asarray(x), "cpu")


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _mixer(seed):
    cfg_j, cfg_t = jax_reduced(ARCH), reduced_config(ARCH)
    p = jattn.init_attention(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, cfg_t, p, {k: t(v) for k, v in p.items()}


def assert_ring(ring_t, ring_j):
    np.testing.assert_allclose(ring_t.k.numpy(), np.asarray(ring_j.k), **CACHE)
    np.testing.assert_allclose(ring_t.v.numpy(), np.asarray(ring_j.v), **CACHE)
    assert ring_t.pos.dtype == torch.int32
    np.testing.assert_array_equal(ring_t.pos.numpy(), np.asarray(ring_j.pos))


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("T", [11, 16, 27], ids=["T<W", "T=W", "T>W"])
def test_prefill_local_ring_matches_jax(T, inplace):
    cfg_j, cfg_t, pj, pt = _mixer(2)
    B, L = 2, 32
    W = cfg_j.local_window
    x = rand(np.random.default_rng(T), B, T, cfg_j.d_model)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    ring_j = jblocks.init_block_cache(cfg_j, "local", B, L, jnp.float32)
    yj, ring_j = jblocks._prefill_local_ring(pj, cfg_j, jnp.asarray(x),
                                             jnp.asarray(pos), ring_j)
    ring = tblocks.init_block_cache(cfg_t, "local", B, L, torch.float32)
    yt, ring_t = tattn._prefill_local_ring(pt, cfg_t, torch.from_numpy(x),
                                             torch.from_numpy(pos), ring,
                                             inplace)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **LOGITS)
    assert_ring(ring_t, ring_j)
    # the ring holds the last min(T, W) positions, each at its slot
    held = sorted(int(p) for p in ring_t.pos[0] if p >= 0)
    assert held == list(range(max(0, T - W), T))
    assert (ring_t.k is ring.k) == inplace
    if not inplace:
        assert bool((ring.pos == -1).all()) and bool((ring.k == 0).all())


@pytest.mark.parametrize("inplace", [False, True])
def test_local_ring_decode_across_a_wrap_matches_jax(inplace):
    """Two sequences at different lengths decode one token per step from
    a prefilled ring; the longer one wraps the ring at step 2, the shorter
    at step 7.  Every step's output and ring agree with JAX, and each
    step's pass reads only the first ``min(span, W)`` slots."""
    cfg_j, cfg_t, pj, pt = _mixer(3)
    B, L, T = 2, 32, 14
    W = cfg_j.local_window
    rng = np.random.default_rng(3)
    x = rand(rng, B, T, cfg_j.d_model)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    ring_j = jblocks.init_block_cache(cfg_j, "local", B, L, jnp.float32)
    _, ring_j = jblocks._prefill_local_ring(pj, cfg_j, jnp.asarray(x),
                                            jnp.asarray(pos), ring_j)
    ring_t = tblocks.init_block_cache(cfg_t, "local", B, L, torch.float32)
    _, ring_t = tattn._prefill_local_ring(pt, cfg_t, torch.from_numpy(x),
                                            torch.from_numpy(pos), ring_t,
                                            True)
    lens = np.array([T, T - 5], np.int32)
    for step in range(12):
        xs = rand(rng, B, 1, cfg_j.d_model)
        p = lens[:, None].copy()
        yj, ring_j = jblocks._local_ring_decode(pj, cfg_j, jnp.asarray(xs),
                                                jnp.asarray(p), ring_j)
        before = ring_t
        yt, ring_t = tattn._local_ring_decode(
            pt, cfg_t, torch.from_numpy(xs), torch.from_numpy(p), ring_t,
            span=int(lens.max()) + 1, inplace=inplace)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **LOGITS,
                                   err_msg=f"step {step}")
        assert_ring(ring_t, ring_j)
        assert (ring_t.pos is before.pos) == inplace
        lens += 1
    assert int(ring_t.pos.max()) >= W + 8, "the ring never wrapped"


def test_init_block_cache_ring_geometry():
    """W = min(window, L); pos is int32 and -1 under a bf16 cache."""
    cfg = reduced_config(ARCH)
    ring = tblocks.init_block_cache(cfg, "local", 3, 64, torch.bfloat16)
    assert isinstance(ring, tattn.LocalKVCache)
    assert tuple(ring.k.shape) == (3, cfg.local_window, cfg.num_kv_heads,
                                   cfg.hd)
    assert ring.k.dtype == torch.bfloat16 and ring.pos.dtype == torch.int32
    assert bool((ring.pos == -1).all())
    short = tblocks.init_block_cache(cfg, "local", 3, 10, torch.bfloat16)
    assert tuple(short.pos.shape) == (3, 10)
    glob = tblocks.init_block_cache(cfg, "attn", 3, 64, torch.bfloat16)
    assert not isinstance(glob, tattn.LocalKVCache)


def _per_layer_np(cfg_j, cache):
    """JAX stacked cache -> one tuple of numpy leaves per layer."""
    p = len(cfg_j.layer_pattern)
    out = []
    for r in range(cfg_j.pattern_repeats):
        for j in range(p):
            c = cache["sb"][f"l{j}"]
            out.append(tuple(np.asarray(x)[r] for x in c))
    return out


def assert_caches(cfg_j, cache_j, cache_t):
    for i, (cj, ct) in enumerate(zip(_per_layer_np(cfg_j, cache_j), cache_t,
                                     strict=True)):
        assert len(cj) == len(ct), f"layer {i}"
        np.testing.assert_allclose(ct.k.numpy(), cj[0], **CACHE)
        np.testing.assert_allclose(ct.v.numpy(), cj[1], **CACHE)
        if isinstance(ct, tattn.LocalKVCache):
            np.testing.assert_array_equal(ct.pos.numpy(), cj[2])


@pytest.mark.parametrize("T", [10, 21], ids=["prompt<W", "prompt>W"])
def test_gemma2_prefill_then_wrapping_decode_matches_jax(T):
    """Reduced gemma2-2b (one local and one global layer, sandwich norms,
    softcaps, GeGLU, embedding scale): prefill, then decode steps until
    every local ring has wrapped; logits and every layer's cache agree
    with JAX after each step."""
    cfg_j, cfg_t = jax_reduced(ARCH), reduced_config(ARCH)
    assert cfg_t.layer_pattern == ("local", "attn")
    pj = jtf.init_params(cfg_j, jax.random.PRNGKey(4))
    pt = params_from_numpy(cfg_t, pj, "cpu")
    B, L = 2, 48
    rng = np.random.default_rng(T)
    tokens = rng.integers(0, cfg_j.vocab_size, (B, T)).astype(np.int32)
    cj = jtf.init_cache(cfg_j, B, L, jnp.float32)
    lj, cj, lens_j = jtf.prefill(pj, cfg_j, jnp.asarray(tokens), cj)
    ct = ttf.init_cache(cfg_t, B, L, torch.float32)
    lt, ct, lens_t = ttf.prefill(pt, cfg_t, torch.from_numpy(tokens), ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGITS)
    assert_caches(cfg_j, cj, ct)
    for step in range(10):
        tok = rng.integers(0, cfg_j.vocab_size, (B, 1)).astype(np.int32)
        dj, cj = jtf.decode_step(pj, cfg_j, jnp.asarray(tok), cj, lens_j)
        dt, ct = ttf.decode_step(pt, cfg_t, torch.from_numpy(tok), ct,
                                 lens_t)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **LOGITS,
                                   err_msg=f"step {step}")
        assert_caches(cfg_j, cj, ct)
        lens_j, lens_t = lens_j + 1, lens_t + 1
    assert int(ct[0].pos.max()) >= cfg_t.local_window, "no wrap"
