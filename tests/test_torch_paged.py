"""Parity of the port's multiversion paged KV cache with the JAX package,
and of ``snapshot_view`` -> ``paged_decode`` with the JAX decode reference.

Random traces of append / reset / fork (COW and eager copy) / pin / unpin /
reclaim / checkpoint eviction run through both packages; after every op the
whole ``PagedKV`` (pages, free maps, tables, lengths and the ``MVState``)
must be identical and ``snapshot_view`` must resolve the same tables."""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.core.telemetry import GCConfig as JGC
from repro.kernels.decode_attention.kernel import paged_decode_pallas
from repro.kernels.decode_attention.ref import paged_decode_ref
from repro.mvkv import paged as jp

from repro_torch.convert import paged_kv_from_numpy, to_numpy
from repro_torch.core.telemetry import GCConfig as TGC
from repro_torch.kernels.decode_attention import ops as t_dops
from repro_torch.kernels.version_search import ops as t_sops
from repro_torch.kernels.version_search.ref import view_ref
from repro_torch.mvkv import paged as tp

SEQS, PAGES, PS, MP, HKV, D, V, LANES = 4, 12, 2, 4, 2, 4, 4, 2

j_append = jax.jit(jp.append_tokens, static_argnames=("gc_policy",))
j_reset = jax.jit(jp.reset_sequence, static_argnames=("gc_policy",))
j_fork = jax.jit(jp.fork_sequence, static_argnames=("gc_policy",
                                                    "copy_pages"))
j_reclaim = jax.jit(jp.reclaim_on_pressure, static_argnames=("gc_policy",))
j_evict = jax.jit(jp.evict_checkpointed)
j_view = jax.jit(jp.snapshot_view)


def assert_same(j, t):
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, j))
    got = jax.tree_util.tree_leaves(to_numpy(t))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def tt(x):
    return torch.as_tensor(np.asarray(x))


def make_both(policy):
    j = jp.make_paged_kv(SEQS, PAGES, PS, MP, HKV, D, dtype=jnp.float32,
                         gc=JGC(policy=policy, versions_per_slot=V,
                                reader_lanes=LANES))
    t = tp.make_paged_kv(SEQS, PAGES, PS, MP, HKV, D, dtype=torch.float32,
                         gc=TGC(policy=policy, versions_per_slot=V,
                                reader_lanes=LANES), device="cpu")
    return j, t


@pytest.mark.parametrize("copy_pages", [False, True], ids=["cow", "eager"])
@pytest.mark.parametrize("policy", ["ebr", "steam", "dlrt", "slrt", "sweep"])
def test_random_paged_trace_matches_jax(policy, copy_pages):
    rng = random.Random(sum(map(ord, policy)) + copy_pages)
    nrng = np.random.default_rng(rng.randrange(1 << 30))
    j, t = make_both(policy)
    ids = np.arange(SEQS, dtype=np.int32)
    pins = {}
    for _ in range(40):
        op = rng.random()
        if op < 0.5:
            mask = nrng.random(SEQS) < 0.8
            kv = nrng.standard_normal((SEQS, HKV, D)).astype(np.float32)
            j, fj = j_append(j, ids, kv, kv * 2, mask, gc_policy=policy)
            t, ft = tp.append_tokens(t, tt(ids), tt(kv), tt(kv * 2),
                                     tt(mask), gc_policy=policy)
        elif op < 0.6:
            mask = nrng.random(SEQS) < 0.4
            j, fj = j_reset(j, ids, mask, gc_policy=policy)
            t, ft = tp.reset_sequence(t, tt(ids), tt(mask), gc_policy=policy)
        elif op < 0.72:
            src = np.array(rng.sample(range(SEQS), 2), np.int32)
            dst = np.array([s for s in range(SEQS) if s not in src][:2],
                           np.int32)
            mask = np.ones(2, bool)
            j, fj = j_fork(j, src, dst, mask, gc_policy=policy,
                           copy_pages=copy_pages)
            t, ft = tp.fork_sequence(t, tt(src), tt(dst), tt(mask),
                                     gc_policy=policy, copy_pages=copy_pages)
        elif op < 0.82:
            lane = rng.randrange(LANES)
            if lane in pins:
                j, t = jp.end_snapshot(j, lane), tp.end_snapshot(t, lane)
                del pins[lane]
            else:
                j, ts_j = jp.begin_snapshot(j, jnp.int32(lane))
                t, ts_t = tp.begin_snapshot(t, lane)
                assert int(ts_j) == int(ts_t)
                pins[lane] = int(ts_j)
            fj = ft = np.zeros(0, bool)
        elif op < 0.95:
            gate_j, gate_t = jp.page_pressure(j), tp.page_pressure(t)
            for a, b in zip(gate_j, gate_t):
                np.testing.assert_array_equal(np.asarray(a), to_numpy(b))
            hot_j, hot_t = jp.hot_sequences(j, 3), tp.hot_sequences(t, 3)
            np.testing.assert_array_equal(np.asarray(hot_j), to_numpy(hot_t))
            deficit = rng.randint(1, 6)
            j, fj = j_reclaim(j, hot_j, jnp.int32(deficit), gc_policy=policy)
            t, ft = tp.reclaim_on_pressure(t, hot_t, deficit,
                                           gc_policy=policy)
        else:
            ckpt = max(int(j.mv.now) - 2, 0)
            j, fj, nj = j_evict(j, jnp.int32(ckpt))
            t, ft, nt = tp.evict_checkpointed(t, ckpt)
            assert int(nj) == int(nt)
        np.testing.assert_array_equal(np.asarray(fj), to_numpy(ft))
        assert_same(j, t)
        assert int(jp.live_pages(j)) == int(tp.live_pages(t))
        for ts in list(pins.values()) + [int(j.mv.now)]:
            for a, b in zip(j_view(j, ids, jnp.int32(ts)),
                            tp.snapshot_view(t, tt(ids), ts)):
                np.testing.assert_array_equal(np.asarray(a), to_numpy(b))


def _decode_state(dtype):
    """A cache with a long, a reset (length 0), a never-written (not found)
    and a forked sequence; the view has NO_PAGE (-1) padding."""
    nrng = np.random.default_rng(7)
    j = jp.make_paged_kv(SEQS, PAGES, PS, MP, HKV, D, dtype=dtype,
                         gc=JGC(versions_per_slot=V, reader_lanes=LANES))
    ids = np.arange(SEQS, dtype=np.int32)
    for step in range(7):
        mask = np.array([True, step < 3, True, False])
        kv = nrng.standard_normal((SEQS, HKV, D)).astype(np.float32)
        j, _ = j_append(j, ids, jnp.asarray(kv, dtype),
                        jnp.asarray(-kv, dtype), mask, gc_policy="slrt")
    j, _ = j_reset(j, ids, np.array([False, False, True, False]),
                   gc_policy="slrt")
    j, _ = j_fork(j, np.array([0], np.int32), np.array([2], np.int32),
                  np.array([True]), gc_policy="slrt", copy_pages=False)
    return j


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_snapshot_view_feeds_paged_decode(dtype):
    j = _decode_state(dtype)
    t = paged_kv_from_numpy(jax.tree_util.tree_map(np.asarray, j), "cpu")
    assert_same(j, t)
    ids = np.arange(SEQS, dtype=np.int32)
    tbl_j, len_j = jp.snapshot_view(j, ids, j.mv.now)
    tbl_t, len_t = tp.snapshot_view(t, tt(ids), int(j.mv.now))
    np.testing.assert_array_equal(np.asarray(tbl_j), to_numpy(tbl_t))
    np.testing.assert_array_equal(np.asarray(len_j), to_numpy(len_t))
    assert tbl_t.is_contiguous()         # the decode kernel's contract
    lens = to_numpy(len_t)
    assert (to_numpy(tbl_t) == -1).any() and (lens == 0).any() and lens.max() > PS
    q = np.random.default_rng(3).standard_normal(
        (SEQS, 2 * HKV, D)).astype(np.float32)
    want = paged_decode_ref(jnp.asarray(q, dtype), j.k_pages, j.v_pages,
                            tbl_j, len_j)
    got = t_dops.paged_decode(
        torch.from_numpy(q).to(t.k_pages.dtype), t.k_pages, t.v_pages,
        tbl_t, len_t)
    assert t_dops.paged_decode.launches == 0       # CPU: the plain version
    want = np.asarray(want, np.float32)
    got = to_numpy(got).astype(np.float32)
    # f32: only the order of the sums differs; bf16: the output is rounded
    # to bf16 once on each side, so it may land one bf16 step (2**-7
    # relative) away
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == np.float32 \
        else dict(atol=4e-3, rtol=2**-7)
    np.testing.assert_allclose(got, want, **tol)
    assert (got[lens == 0] == 0).all()
    if dtype == np.float32:
        pallas = paged_decode_pallas(jnp.asarray(q), j.k_pages, j.v_pages,
                                     tbl_j, len_j, interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), **tol)


VIEW_TIMES = {
    # name: the view's t, from the state's clock ``now``
    "now": lambda rng, now, B: now,
    "before_any_version": lambda rng, now, B: 0,
    "per_sequence": lambda rng, now, B: rng.integers(0, now + 2, B),
}


VIEW_CASES = [(when, form) for when in ("now", "before_any_version")
              for form in ("int", "0-d", "[B]")] + [("per_sequence", "[B]")]


@pytest.mark.parametrize("when,form", VIEW_CASES)
def test_snapshot_view_matches_jax(when, form):
    """``view_ref`` and the port's ``snapshot_view`` against
    ``repro.mvkv.paged.snapshot_view`` on a cache with a never-written
    sequence (not found), a reset one (length 0) and NO_PAGE padding, with
    repeated and reordered ids, and ``t`` a Python int, a 0-d tensor or
    one per sequence."""
    j = _decode_state(np.float32)
    t = paged_kv_from_numpy(jax.tree_util.tree_map(np.asarray, j), "cpu")
    rng = np.random.default_rng(len(when) + len(form))
    ids = np.array([3, 0, 2, 1, 0, 3, 2], np.int32)
    now = int(j.mv.now)
    ts = np.asarray(VIEW_TIMES[when](rng, now, len(ids)), np.int32)
    if form == "[B]":
        ts = np.broadcast_to(ts, ids.shape).copy()
        t_arg = tt(ts)
    else:
        t_arg = int(ts) if form == "int" else torch.tensor(int(ts),
                                                           dtype=torch.int32)
    want = jp.snapshot_view(j, jnp.asarray(ids), jnp.asarray(ts))
    st = t.mv.store
    for got in (tp.snapshot_view(t, tt(ids), t_arg),
                view_ref(st.ts, st.payload, t.tables, t.lengths, tt(ids),
                         t_arg)):
        for a, b in zip(want, got, strict=True):
            np.testing.assert_array_equal(np.asarray(a), to_numpy(b))
    tbl, lens = (np.asarray(x) for x in want)
    assert (tbl == -1).any()
    if when == "before_any_version":
        assert (tbl == -1).all() and (lens == 0).all()
    else:
        assert (lens[ids == 3] == 0).all() and lens.max() > PS
    assert t_sops.view.launches == t_sops.search_gather.launches == 0


def test_convert_round_trip():
    j = _decode_state(np.float32)
    t = paged_kv_from_numpy(jax.tree_util.tree_map(np.asarray, j), "cpu")
    back = to_numpy(t)
    assert type(back) is tp.PagedKV
    assert_same(j, t)
    assert back.mv.now.dtype == np.int32 and back.free.dtype == np.bool_
