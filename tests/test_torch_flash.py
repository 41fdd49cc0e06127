"""K6, the port's flash prefill attention, against the JAX package on CPU.

On CPU tensors the wrapper runs its plain version
(``repro_torch.kernels.flash_prefill.ref.attention_ref``).  The same numpy
inputs go through the Pallas kernel ``flash_attention_pallas`` in interpret
mode (128 x 128 blocks, its defaults) and through the JAX
``attention_ref``.  Tolerance atol = rtol = 1e-5 in float32: the dense and
the blockwise versions sum in other orders.  The CUDA kernel itself is held
against the plain version on the card (``tests/test_torch_gpu.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.kernels.flash_prefill.kernel import flash_attention_pallas
from repro.kernels.flash_prefill.ref import attention_ref as jax_ref

from repro_torch.kernels.flash_prefill import ops
from repro_torch.kernels.flash_prefill.ref import attention_ref

TOL = dict(atol=1e-5, rtol=1e-5)


def inputs(seed, B, Hq, Hkv, T, D):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.5).astype(np.float32)
            for s in ((B, Hq, T, D), (B, Hkv, T, D), (B, Hkv, T, D))]


# T divisible by 128 and not; G = Hq / Hkv in {1, 3, 4}; window in {0, 5};
# softcap in {0, 50}
CASES = [
    (2, 2, 2, 256, 32, 0, 0.0),
    (1, 3, 1, 200, 16, 0, 0.0),
    (1, 8, 2, 256, 32, 5, 0.0),
    (1, 2, 2, 130, 16, 5, 50.0),
    (2, 6, 2, 128, 16, 0, 50.0),
    (1, 4, 1, 200, 32, 5, 50.0),
    (1, 3, 3, 96, 64, 0, 0.0),
]


@pytest.mark.parametrize("B,Hq,Hkv,T,D,window,cap", CASES)
def test_plain_path_matches_pallas_and_ref(B, Hq, Hkv, T, D, window, cap):
    q, k, v = inputs(T + Hq + window, B, Hq, Hkv, T, D)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True,
                              window=window, softcap=cap).numpy()
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True,
                                    window=window, softcap=cap,
                                    interpret=True)
    ref = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, window=window, softcap=cap)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("window", [0, 7])
def test_non_causal_matches_ref(window):
    q, k, v = inputs(5, 1, 4, 2, 40, 16)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=False, window=window)
    want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=False, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_row_that_sees_no_column_is_zero():
    """S < T with a window: rows whose window lies past the last key see
    nothing and give 0 (the kernel's l == 0 guard); the others are a dense
    softmax over the columns they see."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 2, 12, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 1, 4, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 1, 4, 8)).astype(np.float32))
    out = attention_ref(q, k, v, causal=True, window=3)
    assert torch.all(out[:, :, 6:] == 0)          # rows 6.. see cols > 3
    for i in range(6):
        cols = [j for j in range(4) if j <= i and j > i - 3]
        s = (q[0, :, i] @ k[0, 0, cols].T) / np.sqrt(8)
        want = torch.softmax(s, -1) @ v[0, 0, cols]
        torch.testing.assert_close(out[0, :, i], want, **TOL)


def test_wrapper_counts_no_launch_on_cpu():
    before = ops.flash_attention.launches
    q, k, v = (torch.from_numpy(x) for x in inputs(0, 1, 2, 1, 8, 8))
    ops.flash_attention(q, k, v)
    assert ops.flash_attention.launches == before
