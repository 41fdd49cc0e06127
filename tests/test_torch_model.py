"""The port's model stack against the JAX package on the same weights.

``rms_norm``, ``rope``, the MLP, attention (prefill and decode, decode
including a write at position L-1 and a dropped write at L), and the whole
model's ``prefill`` and ``decode_step`` at reduced widths, in float32 (the
recurrent families' states too), and the parameter trees of the last four
families against JAX's.  The inputs are numpy arrays from a seed; JAX
parameters cross over with ``repro_torch.convert``.  Tolerances: logits
and activations within
atol = rtol = 1e-4 (matmuls and the flash softmax sum in other orders; the
port's prefill runs K6's plain version, which scales the float32 logits,
where JAX's ``_xla_flash`` scales ``q`` first), KV caches within 1e-5 (one
projection and RoPE, no softmax).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.configs import reduced_config as jax_reduced
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import transformer as jtf

from repro_torch.configs import reduced_config
from repro_torch.convert import (_per_layer, params_from_numpy,
                                 tensor_from_numpy)
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttf
from repro_torch.models.blocks import init_block_cache

LOGITS = dict(atol=1e-4, rtol=1e-4)
CACHE = dict(atol=1e-5, rtol=1e-5)


def t(x):
    return tensor_from_numpy(np.asarray(x), "cpu")


def params_tree(p):
    if isinstance(p, dict):
        return {k: params_tree(v) for k, v in p.items()}
    return t(p)


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, s = rand(rng, 2, 5, 64), rand(rng, 64, scale=0.1)
    want = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6)
    got = tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CACHE)


@pytest.mark.parametrize("shape", [(2, 7, 3, 16), (2, 7, 16)])
def test_rope_is_pair_interleaved(shape):
    rng = np.random.default_rng(1)
    x = rand(rng, *shape)
    pos = rng.integers(0, 500, shape[:2]).astype(np.int32)
    want = jcommon.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = tcommon.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CACHE)


@pytest.mark.parametrize("arch", ["minitron-4b", "starcoder2-7b",
                                  "gemma2-2b"])
def test_mlp(arch):
    """SwiGLU, the classic GELU FFN and GeGLU (tanh GELU)."""
    cfg_j, cfg_t = jax_reduced(arch), reduced_config(arch)
    p = jmlp.init_mlp(jax.random.PRNGKey(3), cfg_j)
    x = rand(np.random.default_rng(3), 2, 5, cfg_j.d_model)
    want = jmlp.mlp(p, cfg_j, jnp.asarray(x))
    got = tmlp.mlp(params_tree(p), cfg_t, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def _attn_setup(arch, seed):
    cfg_j, cfg_t = jax_reduced(arch), reduced_config(arch)
    p = jattn.init_attention(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, cfg_t, p, params_tree(p)


@pytest.mark.parametrize("arch", ["minitron-4b", "qwen2.5-32b"])
def test_attention_prefill(arch):
    cfg_j, cfg_t, pj, pt = _attn_setup(arch, 4)
    if cfg_j.qkv_bias:   # the init zeroes the biases: make them matter
        rng = np.random.default_rng(9)
        for b in ("bq", "bk", "bv"):
            pj[b] = jnp.asarray(rand(rng, *pj[b].shape, scale=0.1))
            pt[b] = t(pj[b])
    B, T, L = 2, 11, 16
    x = rand(np.random.default_rng(4), B, T, cfg_j.d_model)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    empty = jattn.KVCache(jnp.zeros((B, L, cfg_j.num_kv_heads, cfg_j.hd)),
                          jnp.zeros((B, L, cfg_j.num_kv_heads, cfg_j.hd)))
    yj, cj = jattn.attention(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos),
                             fill_cache=empty)
    cache = init_block_cache(cfg_t, "attn", B, L, torch.float32)
    yt, ct = tattn.attention(pt, cfg_t, torch.from_numpy(x),
                             torch.from_numpy(pos), span=T, fill_cache=cache)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **LOGITS)
    np.testing.assert_allclose(ct.k.numpy(), np.asarray(cj.k), **CACHE)
    np.testing.assert_allclose(ct.v.numpy(), np.asarray(cj.v), **CACHE)
    assert torch.all(cache.k == 0), "the default must leave the cache as is"


@pytest.mark.parametrize("arch", ["minitron-4b", "qwen2.5-32b"])
@pytest.mark.parametrize("inplace", [False, True])
def test_attention_decode_writes_at_end_and_drops_past_it(arch, inplace):
    """Sequence 0 appends at L-1 (the cache's last slot); sequence 1 is
    full (cache_len = L), so its write is dropped (trap T2) and it attends
    over the cache alone."""
    cfg_j, cfg_t, pj, pt = _attn_setup(arch, 5)
    B, L = 2, 8
    rng = np.random.default_rng(5)
    x = rand(rng, B, 1, cfg_j.d_model)
    kc = rand(rng, B, L, cfg_j.num_kv_heads, cfg_j.hd)
    vc = rand(rng, B, L, cfg_j.num_kv_heads, cfg_j.hd)
    clen = np.array([L - 1, L], np.int32)
    pos = clen[:, None].copy()
    yj, cj = jattn.attention(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos),
                             cache=jattn.KVCache(jnp.asarray(kc),
                                                 jnp.asarray(vc)),
                             cache_len=jnp.asarray(clen))
    cache = tattn.KVCache(torch.from_numpy(kc.copy()),
                          torch.from_numpy(vc.copy()))
    yt, ct = tattn.attention(pt, cfg_t, torch.from_numpy(x),
                             torch.from_numpy(pos), span=L + 1, cache=cache,
                             cache_len=torch.from_numpy(clen),
                             inplace=inplace)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **LOGITS)
    np.testing.assert_allclose(ct.k.numpy(), np.asarray(cj.k), **CACHE)
    np.testing.assert_allclose(ct.v.numpy(), np.asarray(cj.v), **CACHE)
    np.testing.assert_array_equal(ct.k[1].numpy(), kc[1])   # dropped
    assert not np.array_equal(ct.k[0, L - 1].numpy(), kc[0, L - 1])
    assert (ct.k is cache.k) == inplace
    if not inplace:
        np.testing.assert_array_equal(cache.k.numpy(), kc)


# gemma2's dense-layer features on an all-attn model: sandwich norms,
# embedding scale, attention and final logit softcaps, GeGLU
GEMMA_STYLE = dict(post_norms=True, embed_scale=True, attn_softcap=50.0,
                   final_softcap=30.0, act="geglu")


def _model(arch, seed=0, **overrides):
    cfg_j = jax_reduced(arch, **overrides)
    cfg_t = reduced_config(arch, **overrides)
    pj = jtf.init_params(cfg_j, jax.random.PRNGKey(seed))
    return cfg_j, cfg_t, pj, params_from_numpy(cfg_t, pj, "cpu")


def assert_caches(cfg_j, cache_j, cache_t):
    """A JAX stacked cache (KV caches, rings, recurrent states) against
    the port's per-layer list: every field within ``CACHE``, a ring's
    ``pos`` exactly."""
    layers = _per_layer(cfg_j, cache_j)
    assert len(layers) == len(cache_t) == cfg_j.num_layers
    for i, (cj, ct) in enumerate(zip(layers, cache_t)):
        assert cj._fields == ct._fields, i
        for f, a, b in zip(cj._fields, cj, ct):
            if f == "pos":
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            else:
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           err_msg=f"layer {i} {f}",
                                           **CACHE)


@pytest.mark.parametrize("arch,overrides", [
    ("minitron-4b", {}), ("starcoder2-7b", {}),
    ("minitron-4b", GEMMA_STYLE), ("xlstm-125m", {}),
    ("recurrentgemma-9b", {})],
    ids=["minitron", "starcoder2", "softcaps", "xlstm", "recurrentgemma"])
def test_prefill_then_decode_matches_jax(arch, overrides):
    """xlstm-125m's mLSTM and sLSTM states and recurrentgemma-9b's RG-LRU
    states and local rings too (T 13 over the reduced mLSTM's chunks of 8:
    a ragged tail)."""
    cfg_j, cfg_t, pj, pt = _model(arch, 1, **overrides)
    B, T, L = 3, 13, 24
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg_j.vocab_size, (B, T)).astype(np.int32)
    cj = jtf.init_cache(cfg_j, B, L, jnp.float32)
    lj, cj, lens_j = jtf.prefill(pj, cfg_j, jnp.asarray(tokens), cj)
    ct = ttf.init_cache(cfg_t, B, L, torch.float32)
    lt, ct, lens_t = ttf.prefill(pt, cfg_t, torch.from_numpy(tokens), ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGITS)
    np.testing.assert_array_equal(lens_t.numpy(), np.asarray(lens_j))
    assert_caches(cfg_j, cj, ct)

    step = rng.integers(0, cfg_j.vocab_size, (B, 1)).astype(np.int32)
    dj, cj2 = jtf.decode_step(pj, cfg_j, jnp.asarray(step), cj, lens_j)
    dt, ct2 = ttf.decode_step(pt, cfg_t, torch.from_numpy(step), ct, lens_t)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **LOGITS)
    assert_caches(cfg_j, cj2, ct2)


def _leaves(tree, prefix=""):
    """{path: tensor or array} of nested dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("arch", ["xlstm-125m", "internvl2-2b",
                                  "recurrentgemma-9b", "whisper-tiny"])
def test_family_params_match_the_jax_tree(arch):
    """The four families of the last slice: ``params_from_numpy`` of JAX's
    ``init_params`` and the port's own ``init_params`` give the same keys,
    shapes and dtypes, in float32 and in bf16 (the gate leaves that both
    packages make float32 stay float32: RG-LRU's ``wa``, ``ba``, ``wx``,
    ``bx``, ``lambda``, the mLSTM's ``w_if``, the sLSTM's ``b``), and the
    JAX tree's leaves, unstacked, are the port's values."""
    cfg_j, cfg_t = jax_reduced(arch), reduced_config(arch)
    pj = jtf.init_params(cfg_j, jax.random.PRNGKey(2))
    f32 = {"wa", "ba", "wx", "bx", "lambda", "w_if", "b"}
    for dtype in (torch.float32, torch.bfloat16):
        got = _leaves(params_from_numpy(cfg_t, pj, "cpu", dtype=dtype))
        own = _leaves(ttf.init_params(cfg_t, torch.Generator().manual_seed(0),
                                      dtype))
        assert sorted(got) == sorted(own)
        for path, x in own.items():
            assert got[path].shape == x.shape, path
            assert got[path].dtype == x.dtype, path
            name = path.rsplit("/", 1)[-1]
            want = torch.float32 if "/mixer/" in path and name in f32 \
                else dtype
            assert x.dtype == want, path
    if cfg_t.encoder_layers:
        enc = _leaves(params_from_numpy(cfg_t, pj, "cpu")["encoder"])
        assert len({p.split("/")[1] for p in enc if p.startswith("layers")}) \
            == cfg_t.encoder_layers
        np.testing.assert_array_equal(
            enc["layers/1/mixer/wq"].numpy(),
            np.asarray(pj["encoder"]["sb"]["l0"]["mixer"]["wq"])[1])
        assert "cross" in params_from_numpy(cfg_t, pj, "cpu")["layers"][0]


def test_init_matches_the_jax_distributions():
    """Random weights from a torch.Generator: truncated normal within 2 std
    of std 1/sqrt(fan_in), embeddings normal with std 0.02."""
    cfg = reduced_config("minitron-4b", d_model=256, d_ff=512)
    p = ttf.init_params(cfg, torch.Generator().manual_seed(0))
    w = p["layers"][0]["ffn"]["wu"]
    assert float(w.abs().max()) <= 2 / np.sqrt(cfg.d_model) + 1e-7
    assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 0.88) < 0.02
    assert abs(float(p["embed"].std()) - 0.02) < 1e-3
    q = ttf.init_params(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(q["embed"], p["embed"])
