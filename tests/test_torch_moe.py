"""The port's mixture-of-experts feed-forward against the JAX package.

``moe_global`` and ``moe_grouped`` with and without shared experts (reduced
deepseek-moe-16b has one, reduced granite-moe-1b-a400m none), with a
capacity that drops tokens, and with ties in the router, which
``lax.top_k`` breaks towards the lower expert; then reduced granite and
deepseek whole, prefill and decode.  JAX's own grouped-dispatch tests
(``tests/models/test_moe_grouped.py``) are the oracle's checks: grouped
equals global when dropless, and dispatch follows ``moe_dispatch``.  The
inputs are numpy arrays from a seed, and JAX parameters cross over with
``repro_torch.convert``.  Tolerances are ``tests/test_torch_model.py``'s:
outputs and logits within 1e-4, caches within 1e-5; the aux loss within
1e-5 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.configs import reduced_config as jax_reduced
from repro.models import moe as jmoe
from repro.models import transformer as jtf

from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf

LOGITS = dict(atol=1e-4, rtol=1e-4)
CACHE = dict(atol=1e-5, rtol=1e-5)
ARCHS = ["granite-moe-1b-a400m", "deepseek-moe-16b"]
DISPATCH = {"global": (jmoe.moe_global, tmoe.moe_global),
            "grouped": (jmoe.moe_grouped, tmoe.moe_grouped)}


def t(x):
    return tensor_from_numpy(np.asarray(x), "cpu")


def tree(p):
    if isinstance(p, dict):
        return {k: tree(v) for k, v in p.items()}
    return t(p)


def setup(arch, seed=0, **overrides):
    cfg_j = jax_reduced(arch, **overrides)
    cfg_t = reduced_config(arch, **overrides)
    pj = jmoe.init_moe(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, cfg_t, pj, tree(pj)


def run_both(dispatch, cfg_j, cfg_t, pj, pt, x):
    fj, ft = DISPATCH[dispatch]
    oj, aj = fj(pj, cfg_j, jnp.asarray(x))
    ot, at = ft(pt, cfg_t, torch.from_numpy(x))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **LOGITS)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)
    return ot


def loads(cfg, pt, x, groups):
    """Assignments per expert in each dispatch group (the port's router)."""
    _, idx, _, _ = tmoe._route(pt, cfg, torch.from_numpy(x))
    idx = idx.reshape(groups, -1)
    return torch.stack([torch.bincount(r, minlength=cfg.num_experts)
                        for r in idx])


@pytest.mark.parametrize("dispatch", ["global", "grouped"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_jax(arch, dispatch):
    cfg_j, cfg_t, pj, pt = setup(arch)
    assert bool(cfg_t.num_shared_experts) == (arch == "deepseek-moe-16b")
    x = (np.random.default_rng(1).standard_normal((2, 16, cfg_j.d_model))
         * 0.5).astype(np.float32)
    run_both(dispatch, cfg_j, cfg_t, pj, pt, x)


@pytest.mark.parametrize("dispatch", ["global", "grouped"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_capacity_drops_tokens_as_jax_does(arch, dispatch):
    """A capacity factor of 0.1 over 2 x 256 tokens, the router skewed
    towards expert 0: the pool is past the dropless floor, and expert 0
    is assigned more tokens than its capacity, so some are dropped."""
    cfg_j, cfg_t, pj, pt = setup(arch, 1, moe_capacity_factor=0.1)
    rng = np.random.default_rng(2)
    router = np.asarray(pj["router"]).copy()
    router[:, 0] += 0.5
    pj["router"], pt["router"] = jnp.asarray(router), t(router)
    x = (rng.standard_normal((2, 256, cfg_j.d_model)) * 0.5).astype(
        np.float32)
    groups = 1 if dispatch == "global" else 2
    n = x.shape[0] * x.shape[1] // groups
    C = tmoe.capacity(cfg_t, n)
    assert C == max(1, int(0.1 * n * cfg_t.top_k / cfg_t.num_experts),
                    min(n * cfg_t.top_k, 128))
    assert int(loads(cfg_t, pt, x, groups).max()) > C, "nothing dropped"
    run_both(dispatch, cfg_j, cfg_t, pj, pt, x)


@pytest.mark.parametrize("dispatch", ["global", "grouped"])
@pytest.mark.parametrize("tie", ["all", "some"])
def test_router_ties_follow_lax_top_k(tie, dispatch):
    """Equal router columns give equal probabilities: ``lax.top_k`` takes
    the lower expert first, and so must the port (trap C2).  With every
    column equal each token goes to experts 0 and 1; with columns 2 and 3
    equal, 2 comes first, and alone where they tie for the last place."""
    cfg_j, cfg_t, pj, pt = setup("deepseek-moe-16b", 2)
    router = np.asarray(pj["router"]).copy()
    if tie == "all":
        router[:] = router[:, :1]
    else:
        router[:, 3] = router[:, 2]
    pj["router"], pt["router"] = jnp.asarray(router), t(router)
    x = (np.random.default_rng(3).standard_normal((2, 24, cfg_j.d_model))
         * 0.5).astype(np.float32)
    _, idx_j = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x) @ jnp.asarray(router), axis=-1), cfg_j.top_k)
    _, idx_t, _, _ = tmoe._route(pt, cfg_t, torch.from_numpy(x))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    if tie == "all":
        assert bool((idx_t == torch.tensor([0, 1])).all())
    else:   # 3 is only ever taken after 2, and 2 alone where they tie last
        rows = idx_t.reshape(-1, cfg_t.top_k).tolist()
        assert all(r.index(2) < r.index(3) for r in rows if 3 in r)
        assert any(2 in r and 3 not in r for r in rows)
    run_both(dispatch, cfg_j, cfg_t, pj, pt, x)


@pytest.mark.parametrize("dispatch", ["global", "grouped"])
def test_moe_combine_gives_the_same_bits_twice(dispatch):
    cfg_j, cfg_t, pj, pt = setup("deepseek-moe-16b", 3)
    x = torch.from_numpy((np.random.default_rng(4).standard_normal(
        (2, 64, cfg_t.d_model))).astype(np.float32))
    fn = DISPATCH[dispatch][1]
    a, b = fn(pt, cfg_t, x)[0], fn(pt, cfg_t, x)[0]
    assert torch.equal(a, b)


def test_dispatch_follows_the_config_and_grouped_equals_global_dropless():
    """JAX's oracle checks on the port: ``moe`` dispatches by
    ``moe_dispatch``, and the two dispatches agree where neither drops."""
    cfg_t = reduced_config("deepseek-moe-16b")
    pt = tmoe.init_moe(torch.Generator().manual_seed(0), cfg_t)
    x = torch.randn((2, 16, cfg_t.d_model),
                    generator=torch.Generator().manual_seed(1)) * 0.5
    grouped = dataclasses.replace(cfg_t, moe_dispatch="grouped")
    out_g, aux_g = tmoe.moe(pt, cfg_t, x)
    out_p, aux_p = tmoe.moe(pt, grouped, x)
    assert torch.equal(out_g, tmoe.moe_global(pt, cfg_t, x)[0])
    assert torch.equal(out_p, tmoe.moe_grouped(pt, cfg_t, x)[0])
    torch.testing.assert_close(out_g, out_p, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(aux_g, aux_p, atol=0, rtol=1e-5)


def test_router_stays_float32():
    """``init_moe`` and ``params_from_numpy`` keep the router float32 under
    bf16 weights, as JAX's ``init_moe`` does."""
    cfg_t = reduced_config("deepseek-moe-16b")
    p = tmoe.init_moe(torch.Generator().manual_seed(0), cfg_t,
                      dtype=torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert p["wg"].dtype == p["shared"]["wu"].dtype == torch.bfloat16
    cfg_j = jax_reduced("deepseek-moe-16b")
    pj = jtf.init_params(cfg_j, jax.random.PRNGKey(0), jnp.bfloat16)
    pt = params_from_numpy(cfg_t, pj, "cpu", dtype=torch.bfloat16)
    for layer in pt["layers"]:
        assert layer["ffn"]["router"].dtype == torch.float32
        assert layer["ffn"]["wd"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        pt["layers"][1]["ffn"]["router"].numpy(),
        np.asarray(pj["sb"]["l0"]["ffn"]["router"])[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_model_prefill_then_decode_matches_jax(arch):
    cfg_j, cfg_t = jax_reduced(arch), reduced_config(arch)
    pj = jtf.init_params(cfg_j, jax.random.PRNGKey(5))
    pt = params_from_numpy(cfg_t, pj, "cpu")
    B, T, L = 3, 13, 24
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg_j.vocab_size, (B, T)).astype(np.int32)
    cj = jtf.init_cache(cfg_j, B, L, jnp.float32)
    lj, cj, lens_j = jtf.prefill(pj, cfg_j, jnp.asarray(tokens), cj)
    ct = ttf.init_cache(cfg_t, B, L, torch.float32)
    lt, ct, lens_t = ttf.prefill(pt, cfg_t, torch.from_numpy(tokens), ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGITS)
    for step in range(3):
        tok = rng.integers(0, cfg_j.vocab_size, (B, 1)).astype(np.int32)
        dj, cj = jtf.decode_step(pj, cfg_j, jnp.asarray(tok), cj, lens_j)
        dt, ct = ttf.decode_step(pt, cfg_t, torch.from_numpy(tok), ct,
                                 lens_t)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **LOGITS,
                                   err_msg=f"step {step}")
        lens_j, lens_t = lens_j + 1, lens_t + 1
    k = np.asarray(cj["sb"]["l0"].k)
    for i, c in enumerate(ct):
        np.testing.assert_allclose(c.k.numpy(), k[i], **CACHE)
