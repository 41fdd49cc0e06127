"""The port's sharding rules (``repro_torch.dist.sharding``) and mesh
constructors (``repro_torch.launch.mesh``) against the JAX package's, in one
process.

JAX's ``_leaf_spec`` reads only ``mesh.shape`` (``_axis_size``), so a
stand-in whose ``shape`` maps axis names to sizes gives JAX's specs for a
512-chip mesh without fake devices.  For every leaf of all ten configs'
reduced parameters, on the meshes (1, 1), (2, 2), (2, 3) and (2, 16, 16)
with ``fsdp``, ``attn_hd_shard`` and ``moe_replicate`` on and off, the
port's spec is JAX's spec of the same leaf in JAX's stacked tree, with its
leading ``[R]`` entry (always ``None``) dropped.  Then ``batch_spec``,
``host_spec``, the divisibility fallback (``tests/distrib/
test_dist_unit.py:73``), the DTensor placements, and the mesh constructors'
clamping in a gloo group of one.
"""
import itertools
import os
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

jax.config.update("jax_platform_name", "cpu")

from repro.configs import list_archs
from repro.configs import reduced_config as jax_reduced
from repro.dist import sharding as js
from repro.models import transformer as jtf

from repro_torch.configs import reduced_config
from repro_torch.dist import sharding as ts
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as tf

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_ranks import jax_path  # noqa: E402

ARCHS = list_archs()
MESHES = {"1x1": {"data": 1, "model": 1}, "2x2": {"data": 2, "model": 2},
          "2x3": {"data": 2, "model": 3},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
FLAGS = list(itertools.product((False, True), repeat=3))


class StandIn:
    """A mesh as the rules read it: axis names -> sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)


_PARAMS = {}


def params(arch):
    """(JAX's reduced parameter shapes by keypath, the port's reduced
    parameters), once per arch."""
    if arch not in _PARAMS:
        shapes = jax.eval_shape(lambda: jtf.init_params(
            jax_reduced(arch), jax.random.PRNGKey(0)))
        by_path = {}
        jax.tree_util.tree_map_with_path(
            lambda kp, x: by_path.setdefault(js._keypath_parts(kp), x),
            shapes)
        port = tf.init_params(reduced_config(arch),
                              torch.Generator().manual_seed(0))
        _PARAMS[arch] = (by_path, port)
    return _PARAMS[arch]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_spec_equals_jax(arch, mesh):
    jax_leaves, port = params(arch)
    cfg = reduced_config(arch)
    m = StandIn(MESHES[mesh])
    n_checked = 0
    for fsdp, hd, moe in FLAGS:
        kw = dict(fsdp=fsdp, attn_hd_shard=hd, moe_replicate=moe)
        specs = dict(ts._paths(ts.param_shardings(port, m, **kw)))
        leaves = dict(ts._paths(port))
        assert set(specs) == set(leaves)
        for parts, spec in specs.items():
            jparts, stacked = jax_path(cfg, parts)
            jleaf = jax_leaves[jparts]
            want = tuple(js._leaf_spec(jparts, jleaf, m, **kw))
            if stacked:
                assert want[:1] in ((None,), ())
                want = want[1:]
            assert tuple(spec) == want, (parts, kw)
            assert isinstance(spec, ts.Spec)
            # the port's leaf is JAX's stacked leaf without its [R] dim
            assert tuple(leaves[parts].shape) == \
                tuple(jleaf.shape)[1 if stacked else 0:]
            n_checked += 1
    assert n_checked == 8 * len(leaves)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", [(8, 16), (6, 16), (3, 5), (32,), ()])
def test_batch_spec_equals_jax(mesh, shape):
    m = StandIn(MESHES[mesh])
    leaf = np.zeros(shape, np.int32)
    assert tuple(ts.batch_spec(leaf, m)) == tuple(js.batch_spec(leaf, m))
    assert tuple(ts.batch_spec(leaf, m, batch_size=32)) == \
        tuple(js.batch_spec(leaf, m, batch_size=32))
    assert ts.batch_axes(m) == js.batch_axes(m)
    batch = {"tokens": torch.zeros(shape, dtype=torch.int32)}
    assert ts.batch_sharding(batch, m) == {"tokens": ts.batch_spec(leaf, m)}


@pytest.mark.parametrize("shape", [(4, 8, 3), (2,), ()])
def test_host_spec_equals_jax(shape):
    leaf = np.zeros(shape, np.float32)
    assert tuple(ts.host_spec(leaf)) == tuple(js.host_spec(leaf))
    assert tuple(ts.host_spec(leaf, "hosts")) == \
        tuple(js.host_spec(leaf, "hosts"))
    tree = {"a": torch.zeros(shape), "b": [torch.zeros(shape)]}
    assert ts.host_stacked_sharding(tree) == {
        "a": ts.host_spec(leaf), "b": [ts.host_spec(leaf)]}


def test_indivisible_dims_fall_back_to_replicated():
    """tests/distrib/test_dist_unit.py:73 on the port: 3 model shards
    divide neither 4 heads nor 64 nor 128, so no such dim is assigned."""
    cfg = reduced_config("minitron-4b", num_heads=4, num_kv_heads=4)
    port = tf.init_params(cfg, torch.Generator().manual_seed(0))
    m = StandIn(MESHES["2x3"])
    specs = dict(ts._paths(ts.param_shardings(port, m, fsdp=True)))
    assigned = 0
    for parts, x in ts._paths(port):
        for i, ax in enumerate(specs[parts]):
            if ax is not None:
                assert x.shape[i] % m.shape[ax] == 0, (parts, specs[parts])
                assigned += 1
    assert assigned > 0


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    m = StandIn(MESHES["2x2"])
    assert ts.placements(ts.Spec(("data", None, "model")), m) == (
        Shard(0), Shard(2))
    assert ts.placements(ts.Spec((None, "model")), m) == (
        Replicate(), Shard(1))
    assert ts.placements(ts.Spec(), m) == (Replicate(), Replicate())


@pytest.fixture
def group_of_one():
    assert not dist.is_initialized()
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_mesh_constructors_clamp_in_a_group_of_one(group_of_one):
    """As JAX's constructors clamp to ``len(jax.devices())``: one rank gives
    one position on every axis; the production mesh refuses."""
    cpu = torch.device("cpu")
    host = tmesh.make_host_mesh(2, 4, device=cpu)
    assert dist.get_world_size() == 1
    assert host.mesh_dim_names == ("data", "model")
    assert tuple(host.mesh.shape) == (1, 1)
    assert ts.axis_sizes(host) == {"data": 1, "model": 1}
    gc = tmesh.make_gc_mesh(4, device=cpu)
    assert gc.mesh_dim_names == ("gc_hosts",) and gc.mesh.shape == (1,)
    assert tmesh.make_gc_mesh(0, "hosts", device=cpu).mesh_dim_names == \
        ("hosts",)
    with pytest.raises(ValueError):
        tmesh.make_production_mesh(device=cpu)
    assert tmesh.production_shape() == ((16, 16), ("data", "model"))
    assert tmesh.production_shape(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))
    # the engine on a one-position mesh: every host here, no ring
    from repro_torch.dist.mvgc import ShardedPagedKVEngine
    eng = ShardedPagedKVEngine(2, 4, 8, 4, 2, 1, 4, device=cpu)
    assert eng.mesh is not None and eng.group is None
    assert list(eng.local_hosts) == [0, 1]


def test_placement_of_a_state_in_a_group_of_one(group_of_one):
    """On a (1, 1) mesh every shard is the whole leaf, the gathered tree is
    the tree, and the placed step gives the one-rank step's numbers."""
    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import RunConfig
    from repro_torch.train.step import init_state, train_step
    cfg = reduced_config("minitron-4b")
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], lr=1e-3)
    cpu = torch.device("cpu")
    mesh = tmesh.make_host_mesh(1, 1, device=cpu)
    ref = init_state(cfg, device=cpu)
    placed, pl = ts.place_train_state(init_state(cfg, device=cpu), mesh,
                                      fsdp=True)
    for a, b in zip(ts._paths(ref.params), ts._paths(placed.params)):
        assert torch.equal(a[1], b[1])
    batch = {"tokens": torch.arange(64, dtype=torch.int32).reshape(4, 16)
             % cfg.vocab_size}
    for _ in range(2):
        ref, m1 = train_step(ref, batch, cfg, run)
        placed, m2 = train_step(placed, batch, cfg, run, placement=pl)
        torch.testing.assert_close(m2["loss"], m1["loss"], rtol=1e-6,
                                   atol=0)
        torch.testing.assert_close(m2["grad_norm"], m1["grad_norm"],
                                   rtol=1e-6, atol=0)
    for a, b in zip(ts._paths(ref.params), ts._paths(placed.params)):
        torch.testing.assert_close(b[1], a[1], rtol=1e-6, atol=1e-9)
