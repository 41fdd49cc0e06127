"""Parity of the port's five-policy store with the JAX package.

Replays random write / pin / gc / pressure traces (the shape of the trace
in ``tests/mvgc/test_vstore.py``) through both packages, for every policy,
with and without the checkpoint post-pass.  After every op the whole
``MVState`` must be byte-identical and the freed-handle multisets equal;
snapshot reads and gathers must agree at every pinned timestamp.  The JAX
side runs its default lax path (``use_kernel=False``): its search+gather
Pallas kernel cannot run on this jax (trap C3)."""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.core.mvgc import vstore as jv

from repro_torch.convert import to_numpy
from repro_torch.core.mvgc import vstore as tv

EMPTY = -1

# the JAX side, jitted once per policy and shape (eager dispatch of these
# functions costs seconds per trace; the results are the same)
j_write = jax.jit(jv.write_step, static_argnames=("policy",))
j_gc = jax.jit(jv.gc_step, static_argnames=("policy",))
j_reclaim = jax.jit(jv.reclaim_on_pressure, static_argnames=("policy",))
j_gate = jax.jit(jv.capacity_gate)
j_read = jax.jit(jv.snapshot_read)
j_gather = jax.jit(jv.snapshot_gather)


def assert_states_equal(j, t):
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, j))
    got = jax.tree_util.tree_leaves(to_numpy(t))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def handles(freed):
    arr = np.asarray(freed).reshape(-1)
    return sorted(arr[arr != EMPTY].tolist())


def tt(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("with_ckpt", [False, True], ids=["plain", "ckpt"])
@pytest.mark.parametrize("policy", ["ebr", "steam", "dlrt", "slrt", "sweep"])
def test_random_trace_matches_jax(policy, with_ckpt):
    rng = random.Random(sum(map(ord, policy)) + with_ckpt)
    S, V, P = 12, 16, 4
    j = jv.make_state(S, V, P, ring_capacity=64)
    t = tv.make_state(S, V, P, ring_capacity=64, device="cpu")
    assert_states_equal(j, t)
    values = np.arange(S * V * 3, dtype=np.int32).reshape(S * V, 3)
    pins, ctr = {}, 0
    for _ in range(30):
        k = rng.randint(1, 3)
        ids = np.array(rng.sample(range(S), k), np.int32)
        pl = np.array([(ctr + i) % (S * V) for i in range(k)], np.int32)
        ctr += k
        m = np.ones(k, bool)
        j, fj, oj = j_write(j, jnp.asarray(ids), jnp.asarray(pl),
                                  jnp.asarray(m), policy=policy)
        t, ft, ot = tv.write_step(t, tt(ids), tt(pl), tt(m), policy=policy)
        assert handles(fj) == handles(to_numpy(ft))
        np.testing.assert_array_equal(np.asarray(oj), to_numpy(ot))
        assert_states_equal(j, t)
        if rng.random() < 0.3:
            lane = rng.randrange(P)
            al, am = np.array([lane], np.int32), np.array([True])
            if lane in pins:
                j = jv.end_snapshot(j, jnp.asarray(al), jnp.asarray(am))
                t = tv.end_snapshot(t, tt(al), tt(am))
                del pins[lane]
            else:
                j, ts_j = jv.begin_snapshot(j, jnp.asarray(al), jnp.asarray(am))
                t, ts_t = tv.begin_snapshot(t, tt(al), tt(am))
                assert int(ts_j[0]) == int(ts_t[0])
                pins[lane] = int(ts_j[0])
            assert_states_equal(j, t)
        ckpt = max(int(j.now) - 3, 0) if with_ckpt else None
        if rng.random() < 0.4:
            j, fj = j_gc(j, policy=policy, ckpt_max=None if ckpt is None
                         else jnp.int32(ckpt))
            t, ft = tv.gc_step(t, policy=policy, ckpt_max=ckpt)
            assert handles(fj) == handles(to_numpy(ft))
            assert_states_equal(j, t)
        if rng.random() < 0.15:
            hot_j, hot_t = jv.hot_slots(j, 4), tv.hot_slots(t, 4)
            np.testing.assert_array_equal(np.asarray(hot_j), to_numpy(hot_t))
            deficit = rng.randint(1, 8)
            j, fj, nj = j_reclaim(
                j, hot_j, jnp.int32(deficit), policy=policy,
                ckpt_max=None if ckpt is None else jnp.int32(ckpt))
            t, ft, nt = tv.reclaim_on_pressure(t, hot_t, deficit,
                                               policy=policy, ckpt_max=ckpt)
            assert int(nj) == int(nt)
            assert handles(fj) == handles(to_numpy(ft))
            assert_states_equal(j, t)
        gate_j, gate_t = j_gate(j), tv.capacity_gate(t)
        for a, b in zip(gate_j, gate_t):
            np.testing.assert_array_equal(np.asarray(a), to_numpy(b))
        assert jv.space_report(j) == tv.space_report(t)
        q = np.arange(S, dtype=np.int32)
        for ts in pins.values():
            for a, b in zip(j_read(j, jnp.asarray(q), jnp.int32(ts)),
                            tv.snapshot_read(t, tt(q), ts)):
                np.testing.assert_array_equal(np.asarray(a), to_numpy(b))
            for a, b in zip(
                    j_gather(j, jnp.asarray(q), jnp.int32(ts),
                             jnp.asarray(values)),
                    tv.snapshot_gather(t, tt(q), ts, tt(values))):
                np.testing.assert_array_equal(np.asarray(a), to_numpy(b))


@pytest.mark.parametrize("policy", ["ebr", "steam", "dlrt", "slrt", "sweep"])
def test_checkpoint_eviction_matches_jax(policy):
    """The sole-survivor post-pass with and without an external pin."""
    S, V, P = 4, 4, 2
    j = jv.make_state(S, V, P, ring_capacity=16)
    t = tv.make_state(S, V, P, ring_capacity=16, device="cpu")
    for slots, pls in (([0, 1, 2], [10, 11, 12]), ([3], [33])):
        ids, pl, m = (np.array(slots, np.int32), np.array(pls, np.int32),
                      np.ones(len(slots), bool))
        j, _, _ = jv.write_step(j, jnp.asarray(ids), jnp.asarray(pl),
                                jnp.asarray(m), policy=policy)
        t, _, _ = tv.write_step(t, tt(ids), tt(pl), tt(m), policy=policy)
    for extra in (None, np.array([1], np.int32)):
        kj = jv.ckpt_kill_mask(j, jnp.int32(1), extra_pins=extra)
        kt = tv.ckpt_kill_mask(t, 1, extra_pins=extra)
        np.testing.assert_array_equal(np.asarray(kj), to_numpy(kt))
        j2, fj, nj = jv.evict_checkpointed(j, jnp.int32(1), extra_pins=extra)
        t2, ft, nt = tv.evict_checkpointed(t, 1, extra_pins=extra)
        assert int(nj) == int(nt) and handles(fj) == handles(to_numpy(ft))
        assert_states_equal(j2, t2)
    assert handles(fj) == []                 # the external pin blocks it
