"""The port's cell specs (``repro_torch.launch.specs``) against the JAX
package's ``repro.launch.specs``, in one process.

* ``input_specs`` (shapes and dtypes), ``run_config``,
  ``batch_shardings`` and ``_pad_heads_cfg`` for every runnable arch x
  shape.
* ``cache_shardings`` and ``mv_shardings``: every leaf of all ten
  configs' caches and stores at decode_32k (B 128 x 32768: the batch over
  the data axes) and long_500k's shape (B 1: the sequence over data and
  model), on the (16, 16) and (2, 16, 16) stand-in meshes of
  ``tests/test_torch_sharding.py`` (JAX's rules read only
  ``mesh.shape``; its ``NamedSharding`` is replaced by the bare spec).
  A port leaf's spec is JAX's spec of its stacked leaf with the leading
  ``[R]`` entry dropped (a tail layer's: as it is).
* ``shard_shape`` and the cell builders' shard shapes on a 4-rank fake
  group (a subprocess: one fake default group a process).
* The training cell's state specs (``train_state_specs``) against JAX's
  ``build_train_cell``: params and the error-feedback carry, with and
  without gradient compression.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.configs import runnable as jrunnable
from repro.dist import sharding as js
from repro.launch import specs as jspecs
from repro.models import transformer as jtf
from repro.serve import engine as jeng

from repro_torch.configs import LONG_CONTEXT_ARCHS, get_config, runnable
from repro_torch.configs.base import SHAPES
from repro_torch.core.mvgc import vstore
from repro_torch.dist.sharding import Spec
from repro_torch.dist.sharding import _paths as ts_paths
from repro_torch.launch import specs
from repro_torch.models import transformer as tf

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_ranks import jax_path  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list_archs()
CELLS = [(a, s) for a in ARCHS for s in JSHAPES if jrunnable(a, s)]
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class StandIn:
    """A mesh as the rules read it: axis names -> sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _dtype(jd) -> torch.dtype:
    return {jnp.dtype(jnp.bfloat16): torch.bfloat16,
            jnp.dtype(jnp.float32): torch.float32,
            jnp.dtype(jnp.int32): torch.int32}[jnp.dtype(jd)]


def test_configs_helpers_equal_jax():
    from repro.configs import LONG_CONTEXT_ARCHS as JLONG
    assert LONG_CONTEXT_ARCHS == JLONG
    for arch in ARCHS:
        assert get_config(arch).active_param_count() == \
            jget_config(arch).active_param_count()
        for shape in JSHAPES:
            assert runnable(arch, shape) == jrunnable(arch, shape)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_and_run_config_equal_jax(arch, shape):
    want = jspecs.input_specs(arch, shape)
    got = specs.input_specs(arch, shape)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == tuple(want[k].shape)
        assert got[k].dtype == _dtype(want[k].dtype)
    jrun, run = jspecs.run_config(arch, shape), specs.run_config(arch, shape)
    assert (run.fsdp, run.microbatches, run.gc_policy) == \
        (jrun.fsdp, jrun.microbatches, jrun.gc_policy)
    assert run.shape == SHAPES[shape] and run.model == get_config(arch)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_pad_heads_equal_jax(mesh):
    m = StandIn(MESHES[mesh])
    for arch in ARCHS:
        want = jspecs._pad_heads_cfg(jget_config(arch), m)
        got = specs._pad_heads_cfg(get_config(arch), m)
        assert (got.num_heads, got.num_kv_heads, got.head_dim) == \
            (want.num_heads, want.num_kv_heads, want.head_dim)


def _jax_specs(tree):
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda kp, s: out.setdefault(js._keypath_parts(kp), Spec(tuple(s))),
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return out


@pytest.fixture
def bare_specs(monkeypatch):
    """JAX's specs module returning the bare ``PartitionSpec`` for a
    stand-in mesh."""
    monkeypatch.setattr(jspecs, "NamedSharding", lambda mesh, spec: spec)
    return jspecs


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_shardings_equal_jax(bare_specs, mesh):
    m = StandIn(MESHES[mesh])
    for arch, shape in CELLS:
        B = JSHAPES[shape].global_batch
        want = bare_specs.batch_shardings(
            jspecs.input_specs(arch, shape), m, B)
        got = specs.batch_shardings(specs.input_specs(arch, shape), m, B)
        assert got == {k: Spec(tuple(v)) for k, v in want.items()}, \
            (arch, shape)
    assert specs.replicate({"a": [specs.Shaped((2,), torch.int32)]}) == \
        {"a": [Spec()]}


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_and_mv_shardings_equal_jax(bare_specs, mesh, shape):
    m = StandIn(MESHES[mesh])
    sh = SHAPES[shape]
    B, L = sh.global_batch, sh.seq_len
    n_checked = 0
    for arch in ARCHS:
        if not runnable(arch, shape) and shape == "long_500k":
            continue
        jcfg, cfg = jget_config(arch), get_config(arch)
        jcache = jax.eval_shape(lambda: jtf.init_cache(jcfg, B, L,
                                                       jnp.bfloat16))
        want = _jax_specs(bare_specs.cache_shardings(jcache, m, jcfg, B))
        cache = specs.shapes_of(lambda dev: tf.init_cache(
            cfg, B, L, torch.bfloat16, dev))
        got = specs.cache_shardings(cache, m, cfg, B)
        for i, layer in enumerate(got):
            for field, spec in zip(layer._fields, layer):
                jparts, stacked = jax_path(cfg, ("layers", str(i), field))
                jspec = want[jparts]
                assert spec == (Spec(tuple(jspec)[1:]) if stacked
                                else jspec), (arch, i, field)
                n_checked += 1
        # the descriptor store
        run = jspecs.run_config(arch, "decode_32k")
        jstate = jax.eval_shape(lambda: jeng.make_serve_state(
            jcfg, run, None, B, 1, jnp.bfloat16))
        want_mv = _jax_specs(bare_specs.mv_shardings(jstate.mv, m, B))
        mv = specs.shapes_of(lambda dev: vstore.make_state(
            B, run.gc.versions_per_slot, run.gc.reader_lanes,
            run.gc.ring_capacity or max(16, B * 2), device=dev))
        got_mv = specs.mv_shardings(mv, m, B)
        flat = {}

        def walk(t, path):
            if isinstance(t, Spec):
                flat[path] = t
            else:
                for f, v in zip(t._fields, t):
                    walk(v, path + (f,))
        walk(got_mv, ())
        assert flat == want_mv
        n_checked += len(flat)
    assert n_checked > 100


_BUILD_SUB = r"""
import json
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_host_mesh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = make_host_mesh(2, 2, device="cpu")
out = {}
_, (state, batch), _ = S.build_train_cell("gemma2-2b", mesh, "train_4k")
out["train"] = [list(state.params["embed"].shape),
                list(state.params["layers"][0]["mixer"]["wq"].shape),
                list(state.opt.mu["embed"].shape), list(batch["tokens"].shape)]
_, (st,), pl = S.build_serve_cell("recurrentgemma-9b", mesh, "decode_32k")
out["decode"] = [list(st.cache[0].h.shape), list(st.cache[2].k.shape),
                 list(st.cache_len.shape), list(st.mv.store.ts.shape),
                 st.longest, pl.group.n]
print(json.dumps(out))
"""


def test_cell_shards_on_a_2x2_fake_group():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _BUILD_SUB], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    # gemma2-2b: vocab rows over model (2), heads 8 over model
    assert got["train"] == [[128000, 2304], [2304, 4, 256], [128000, 2304],
                            [256, 4096]]
    # recurrentgemma-9b (1 KV head): RG-LRU width over model, the ring's
    # 2048 slots over model, rows over data; the store whole
    assert got["decode"] == [[64, 2048], [64, 1024, 1, 256], [64],
                             [128, 8], 32767, 2]


def test_shard_shape():
    m = StandIn({"pod": 2, "data": 16, "model": 16})
    assert specs.shard_shape((128, 32768, 8, 64),
                             Spec((("pod", "data"), "model", None, None)),
                             m) == (4, 2048, 8, 64)
    assert specs.shard_shape((1, 524288), Spec((None, ("data", "model"))),
                             m) == (1, 2048)
    assert specs.shard_shape((7,), Spec(()), m) == (7,)
    assert dataclasses.is_dataclass(specs.Shaped((1,), torch.int32))


@pytest.mark.parametrize("compression", [False, True])
def test_train_state_specs_equal_jax(bare_specs, monkeypatch, compression):
    """The training cell's state specs on the (16, 16) stand-in mesh for
    every arch: params, both moments and, the error-feedback carry
    ``err`` (by the params' specs under ``grad_compression``, as JAX's
    ``launch/specs.py:215`` places it; replicated otherwise) equal to
    JAX's ``build_train_cell``'s ``state_shard``.  Both packages' run
    configs carry the flag (JAX's ``build_train_cell`` reads it from
    ``run_config``)."""
    m = StandIn(MESHES["16x16"])
    real = jspecs.run_config
    monkeypatch.setattr(js, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jspecs, "run_config", lambda *a, **k: dataclasses
                        .replace(real(*a, **k),
                                 grad_compression=compression))
    from repro_torch.train.step import init_state
    n_checked = 0
    for arch in ARCHS:
        if not jrunnable(arch, "train_4k"):
            continue
        _, _, (jshard, _), _ = jspecs.build_train_cell(arch, m, "train_4k")
        cfg = get_config(arch)
        run = dataclasses.replace(specs.run_config(arch, "train_4k"),
                                  grad_compression=compression)
        state = specs.shapes_of(lambda dev: init_state(
            cfg, torch.Generator(device=dev), dtype=specs.COMPUTE_DTYPE,
            compression=compression))
        got = specs.train_state_specs(state, m, run)
        for field in ("params", "err"):
            want = _jax_specs(getattr(jshard, field))
            for parts, spec in ts_paths(getattr(got, field)):
                jparts, stacked = jax_path(cfg, parts)
                jspec = want[jparts]
                assert spec == (Spec(tuple(jspec)[1:]) if stacked
                                else jspec), (arch, field, parts)
                n_checked += 1
        for name in ("mu", "nu"):
            assert getattr(got.opt, name) == got.params
    assert n_checked > 100
