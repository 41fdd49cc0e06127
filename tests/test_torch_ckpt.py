"""The port's checkpoint manager and ``PagedKVEngine.checkpoint()/restore()``
against the JAX package.

* The manager: nested NamedTuple / tuple / list / dict trees of float32,
  int32, bool, 0-d and bfloat16 tensors round-trip bit-exact, ``None``
  subtrees included; a leftover ``.tmp-<step>`` (a crash mid-save) is
  invisible; ``gc()`` deletes the same steps as the JAX manager's.
* The format: the port flattens a ``PagedKV`` in ``jax.tree.flatten``'s
  order, and a float32 engine checkpoint interchanges with the JAX engine
  in both directions: the restored engine equals the saved one and both
  continue a seeded trace of decode / fork / join / release / pin /
  reclaim with equal state, counters and ``freed_pages()`` at every step.
"""
import dataclasses
import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.ckpt.manager import CheckpointManager as JManager
from repro.core.telemetry import GCConfig as JGC
from repro.serve.engine import PagedKVEngine as JEngine

from repro_torch.ckpt.manager import CheckpointManager as TManager
from repro_torch.ckpt.manager import tree_flatten, tree_unflatten
from repro_torch.convert import paged_kv_from_numpy, to_numpy
from repro_torch.core.telemetry import GCConfig as TGC
from repro_torch.serve.engine import PagedKVEngine as TEngine

SEQS, PAGES, PS, MP, HKV, D, V, LANES = 6, 28, 4, 6, 1, 4, 6, 4


class Inner(NamedTuple):
    x: torch.Tensor
    y: tuple


class Outer(NamedTuple):
    inner: Inner
    items: list
    table: dict
    now: torch.Tensor


def sample_tree(seed):
    g = torch.Generator().manual_seed(seed)
    return Outer(
        inner=Inner(x=torch.randn((3, 4), generator=g),
                    y=(torch.randint(-5, 5, (7,), generator=g,
                                     dtype=torch.int32), None,
                       torch.rand((2, 2), generator=g) < 0.5)),
        items=[torch.randn((5, 2), generator=g).to(torch.bfloat16),
               torch.tensor(3.5)],
        table={"zeta": torch.tensor(-1, dtype=torch.int32),
               "alpha": torch.randn((2,), generator=g).to(torch.bfloat16),
               "mid": torch.zeros((0, 3), dtype=torch.int32)},
        now=torch.tensor(2**31 - 1, dtype=torch.int32))


def assert_trees_bit_equal(a, b):
    assert type(a) is type(b)
    la, lb = tree_flatten(a), tree_flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_manager_round_trip_bit_exact(tmp_path, seed):
    tree = sample_tree(seed)
    mgr = TManager(str(tmp_path))
    mgr.save(5, tree, extra={"note": seed})
    # a crash mid-save of a later step leaves only a .tmp directory
    os.makedirs(tmp_path / ".tmp-9")
    np.save(tmp_path / ".tmp-9" / "leaf_00000.npy", np.zeros(3))
    assert mgr.steps() == [5] and mgr.latest_step() == 5
    like = sample_tree(seed + 100)
    got, extra = mgr.restore(5, like, device="cpu")
    assert extra == {"note": seed}
    assert_trees_bit_equal(tree, got)
    assert got.now.dim() == 0 and got.inner.y[1] is None
    assert list(got.table) == list(tree.table)      # key order kept
    with open(tmp_path / "ckpt_00000005" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["num_leaves"] == 9
    assert manifest["dtypes"][2] == "bool"
    assert set(manifest) >= {"step", "num_leaves", "extra", "time"}


def test_flatten_order_matches_jax():
    tree = sample_tree(0)
    jtree = jax.tree.map(
        lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()), tree)
    jleaves = jax.tree.flatten(jtree)[0]
    tleaves = tree_flatten(tree)
    assert [tuple(x.shape) for x in jleaves] == \
        [tuple(x.shape) for x in tleaves]
    assert [x.dtype.name for x in jleaves] == \
        [str(x.dtype).removeprefix("torch.") for x in tleaves]
    rebuilt = tree_unflatten(tree, tleaves)
    assert_trees_bit_equal(tree, rebuilt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kv_leaf_order_matches_jax(dtype):
    je = JEngine(SEQS, PAGES, PS, MP, HKV, D, gc=JGC(versions_per_slot=V),
                 dtype=getattr(jnp, dtype))
    te = TEngine(SEQS, PAGES, PS, MP, HKV, D, gc=TGC(versions_per_slot=V),
                 dtype=getattr(torch, dtype), device="cpu")
    jleaves = jax.tree.flatten(je.st)[0]
    tleaves = tree_flatten(te.st)
    assert len(jleaves) == len(tleaves) == 16
    for a, b in zip(jleaves, tleaves):
        assert tuple(a.shape) == tuple(b.shape)
        assert a.dtype.name == str(b.dtype).removeprefix("torch.")


@pytest.mark.parametrize("seed", range(6))
def test_gc_deletes_the_same_steps_as_jax(tmp_path, seed):
    rng = np.random.default_rng(seed)
    steps = sorted(rng.choice(60, size=int(rng.integers(1, 9)),
                              replace=False).tolist())
    readers = {f"r{i}": int(rng.integers(0, 65))
               for i in range(int(rng.integers(0, 4)))}
    keep = int(rng.integers(1, 3))
    deleted = []
    for pkg, mgr_cls, leaf in (("jax", JManager, jnp.zeros((2,))),
                               ("torch", TManager, torch.zeros((2,)))):
        mgr = mgr_cls(str(tmp_path / pkg))
        for s in steps:
            mgr.save(s, {"w": leaf})
        for name, step in readers.items():
            mgr.announce(name, step)
        if readers:
            mgr.unannounce("r0")
        deleted.append((mgr.gc(keep_last=keep), mgr.steps()))
    assert deleted[0] == deleted[1]


def test_jax_bf16_leaf_restores_as_bf16_bits(tmp_path):
    """A bfloat16 leaf the JAX manager wrote (raw 2-byte records without
    ml_dtypes) reads back as bfloat16 where the ``like`` leaf is one."""
    vals = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    JManager(str(tmp_path)).save(1, {"k": jnp.asarray(vals).astype(
        jnp.bfloat16), "n": jnp.int32(4)})
    like = {"k": torch.zeros((3, 4), dtype=torch.bfloat16),
            "n": torch.tensor(0, dtype=torch.int32)}
    got, _ = TManager(str(tmp_path)).restore(1, like, device="cpu")
    want = torch.from_numpy(vals).to(torch.bfloat16)
    assert got["k"].dtype == torch.bfloat16
    assert torch.equal(got["k"].view(torch.int16), want.view(torch.int16))
    assert int(got["n"]) == 4 and got["n"].dim() == 0


BF16_SHAPES = {"scalar": (), "empty": (0,), "row": (7,), "matrix": (3, 5),
               "pages": (2, 4, 1, 3)}


def bf16_bits(shape):
    """16-bit patterns of bfloat16 values, both packages' leaves made from
    them bit for bit: signed zeros, infinities, NaNs of either sign, a
    subnormal, the largest finite value and random ones."""
    edge = np.array([0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC0, 0xFFC1, 0x0001,
                     0x7F7F, 0x3EAB], np.uint16)
    n = int(np.prod(shape))
    rand = np.random.default_rng(n).integers(0, 2**16, n, dtype=np.uint16)
    bits = np.where(np.arange(n) < len(edge), np.resize(edge, n), rand)
    return bits.view(np.int16).reshape(shape)


def jax_bf16(bits):
    return jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16)


def torch_bf16(bits):
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


@pytest.mark.parametrize("name", sorted(BF16_SHAPES))
def test_bf16_leaf_files_equal_the_jax_managers(tmp_path, name):
    """Trap C7: the port writes a bfloat16 leaf as the JAX manager does
    (descr ``'<V2'`` and the 16-bit patterns), byte for byte, and restores
    its own file bit for bit."""
    bits = bf16_bits(BF16_SHAPES[name])
    tree_t = {"k": torch_bf16(bits), "n": torch.tensor(4, dtype=torch.int32)}
    JManager(str(tmp_path / "jax")).save(3, {"k": jax_bf16(bits),
                                             "n": jnp.int32(4)})
    TManager(str(tmp_path / "port")).save(3, tree_t)
    for leaf in ("leaf_00000.npy", "leaf_00001.npy"):
        files = [(tmp_path / pkg / "ckpt_00000003" / leaf).read_bytes()
                 for pkg in ("jax", "port")]
        assert files[0] == files[1], leaf
    got, _ = TManager(str(tmp_path / "port")).restore(3, tree_t,
                                                      device="cpu")
    assert got["k"].dtype == torch.bfloat16
    assert np.array_equal(got["k"].view(torch.int16).numpy(), bits)


@pytest.mark.parametrize("name", sorted(BF16_SHAPES))
def test_jax_bf16_checkpoint_restores_bit_for_bit(tmp_path, name):
    """The JAX manager's bfloat16 checkpoint (no ``dtypes`` list in its
    manifest) reads back into the port bit for bit where the ``like``
    leaf is bfloat16, beside a float32 leaf of the same shape."""
    bits = bf16_bits(BF16_SHAPES[name])
    f32 = bits.astype(np.float32)
    JManager(str(tmp_path)).save(2, [jax_bf16(bits), jnp.asarray(f32)])
    like = [torch.zeros(bits.shape, dtype=torch.bfloat16),
            torch.zeros(bits.shape)]
    got, _ = TManager(str(tmp_path)).restore(2, like, device="cpu")
    assert got[0].dtype == torch.bfloat16 and got[0].shape == bits.shape
    assert np.array_equal(got[0].view(torch.int16).numpy(), bits)
    assert np.array_equal(got[1].numpy(), f32)


def test_jax_refuses_a_bf16_leaf_as_it_refuses_its_own(tmp_path):
    """``jnp.asarray`` of a loaded bfloat16 leaf raises on the port's file
    exactly as on the JAX manager's (what ``PagedKVEngine.restore`` calls
    on every leaf): a JAX restore of a port checkpoint fails loudly
    instead of reading int16 values."""
    bits = bf16_bits((2, 3))
    JManager(str(tmp_path / "jax")).save(1, {"k": jax_bf16(bits)})
    TManager(str(tmp_path / "port")).save(1, {"k": torch_bf16(bits)})
    errors = []
    for pkg in ("jax", "port"):
        tree, _ = JManager(str(tmp_path / pkg)).restore(
            1, {"k": jnp.zeros((2, 3), jnp.bfloat16)})
        leaf = tree["k"]
        assert leaf.dtype.kind == "V" and leaf.dtype.itemsize == 2
        with pytest.raises(TypeError) as err:
            jnp.asarray(leaf)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_restore_defaults_to_the_gpu(tmp_path, monkeypatch):
    mgr = TManager(str(tmp_path))
    mgr.save(0, {"a": torch.ones(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mgr.restore(0, {"a": torch.zeros(2)})
    got, _ = mgr.restore(0, {"a": torch.zeros(2)}, device="cpu")
    assert torch.equal(got["a"], torch.ones(2))


# ---------------------------------------------------------------------------
# engine checkpoints across the two packages
# ---------------------------------------------------------------------------
def make_engine(pkg, policy):
    if pkg == "jax":
        return JEngine(SEQS, PAGES, PS, MP, HKV, D,
                       gc=JGC(policy=policy, versions_per_slot=V,
                              reader_lanes=LANES, hot_k=SEQS),
                       dtype=jnp.float32)
    return TEngine(SEQS, PAGES, PS, MP, HKV, D,
                   gc=TGC(policy=policy, versions_per_slot=V,
                          reader_lanes=LANES, hot_k=SEQS),
                   dtype=torch.float32, device="cpu")


def make_trace(seed, n=90):
    """Seeded ops: decode steps over random masks, forks into free slots,
    joins, releases, resets, pins and unpins, explicit reclaims and drains
    of ``freed_pages()`` (pending frees build up in between)."""
    rng = np.random.default_rng(seed)
    ops, live, pins = [], {0, 1}, set()
    for i in range(n):
        r = rng.random()
        free = sorted(set(range(SEQS)) - live)
        kids = sorted(live - {0})
        if r < 0.45 or not free and r < 0.57 or not kids and r < 0.67:
            ops.append(("step", rng.random(SEQS) < 0.5, i))
        elif r < 0.57:
            dst = int(free[0])
            ops.append(("fork", int(rng.choice(sorted(live))), dst))
            live.add(dst)
        elif r < 0.67:
            child = int(rng.choice(kids))
            live.discard(child)
            ops.append(("join", child, 0) if rng.random() < 0.5
                       else ("release", child))
        elif r < 0.75:
            ops.append(("reset", int(rng.choice(sorted(live)))))
        elif r < 0.83:
            lane = int(rng.integers(0, LANES))
            ops.append(("unpin" if lane in pins else "pin", lane))
            pins ^= {lane}
        elif r < 0.95:
            ops.append(("reclaim", int(rng.integers(1, 12))))
        else:
            ops.append(("drain",))
    return ops


def apply(eng, op):
    """Run one op; returns what the caller sees."""
    kind = op[0]
    one = np.ones((1,), bool)
    if kind == "step":
        kv = np.full((SEQS, HKV, D), float(op[2]), np.float32)
        kv += np.arange(SEQS, dtype=np.float32)[:, None, None] / 8
        return np.asarray(eng.step(np.arange(SEQS, dtype=np.int32), kv, kv,
                                   op[1])).tolist()
    if kind in ("fork", "join"):
        f = eng.fork if kind == "fork" else eng.join
        return np.asarray(f(np.array([op[1]], np.int32),
                            np.array([op[2]], np.int32), one)).tolist()
    if kind in ("release", "reset"):
        f = eng.release if kind == "release" else eng.reset
        return np.asarray(f(np.array([op[1]], np.int32), one)).tolist()
    if kind == "pin":
        return eng.pin(op[1])
    if kind == "unpin":
        return eng.unpin(op[1])
    if kind == "reclaim":
        return eng.reclaim(op[1])
    return eng.freed_pages()


def host_state(eng):
    return (eng.space(), dataclasses.asdict(eng.stats), eng.dag.as_dict(),
            list(eng._freed_pages), eng.ckpt_max)


def assert_engines_equal(je, te):
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            je.st))
    got = tree_flatten(te.st)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b.numpy())
    assert host_state(je) == host_state(te)


def manifest_extra(directory, step):
    with open(os.path.join(directory, f"ckpt_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)["extra"]


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("policy", ["ebr", "steam", "dlrt", "slrt"])
def test_engine_checkpoint_interchanges_with_jax(tmp_path, policy,
                                                 direction):
    ops = make_trace(4)
    je, te = make_engine("jax", policy), make_engine("torch", policy)
    # checkpoint at the first point past op 30 with frees pending
    cut = 0
    while cut < 30 or not je._freed_pages and cut < len(ops) - 20:
        assert apply(je, ops[cut]) == apply(te, ops[cut]), ops[cut]
        assert_engines_equal(je, te)
        cut += 1
    # both packages checkpoint the same state: the same manifest extras
    # (stats, DAG, pending frees, ckpt_max)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    js, ts = je.checkpoint(jdir), te.checkpoint(tdir)
    assert js == ts
    assert manifest_extra(jdir, js) == manifest_extra(tdir, ts)
    assert je._freed_pages, "the trace leaves no pending frees to carry"
    if direction == "jax_to_torch":
        saved, restored = je, make_engine("torch", policy)
        assert restored.restore(jdir) == js
        want = paged_kv_from_numpy(je.st, device="cpu")
        for a, b in zip(tree_flatten(want), tree_flatten(restored.st)):
            assert torch.equal(a, b)
        pair = (saved, restored)
    else:
        saved, restored = te, make_engine("jax", policy)
        assert restored.restore(tdir) == ts
        pair = (restored, saved)
    assert host_state(restored) == host_state(saved)
    assert restored.ckpt_max == int(je.st.mv.now)
    for op in ops[cut:]:
        assert apply(pair[0], op) == apply(pair[1], op), op
        assert_engines_equal(*pair)
    assert pair[0].forks > 0 and pair[0].pages_reclaimed > 0
