"""Mesh constructors (port of ``repro.launch.mesh``): ``DeviceMesh``es over the
ranks of the default process group.

JAX builds a mesh over the devices one controller sees; here each rank is
a process, and a mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over ranks, which every rank of the default group builds together (it
makes the groups of the mesh's axes, a collective).  The default group is
gloo: NCCL refuses two ranks of one group on one GPU, and the card is one
H100, so ``init_device_mesh("cuda", ...)``, which would start NCCL, is not
used.  A process with no default group is a world of one, and the
constructors start that group themselves (gloo on an in-memory store), as
``init_device_mesh`` starts the default group.  Ranks clamp as JAX's
constructors clamp to ``len(jax.devices())``.

Functions, not module-level constants: importing this module starts no
group.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch._tensor import DeviceLike, resolve_device


def world_size() -> int:
    """Ranks in the default group, starting a gloo world of one when the
    process has none."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.get_world_size()


def _mesh(shape: Sequence[int], axes: Tuple[str, ...],
          dev: torch.device) -> DeviceMesh:
    n = world_size()
    size = 1
    for s in shape:
        size *= s
    if size > n:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {size} "
                         f"ranks; the default group has {n}")
    return DeviceMesh(dev.type, torch.arange(size).reshape(tuple(shape)),
                      mesh_dim_names=axes)


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The production mesh's shape and axis names.  Single pod: (16, 16) =
    256 chips, axes (data, model).  Multi-pod: (2, 16, 16) = 512 chips,
    axes (pod, data, model); the pod axis crosses the data-centre network,
    which the int8 compression path targets."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    """The production mesh over 256 (512) ranks; with fewer ranks in the
    default group it raises ``ValueError``, as ``jax.make_mesh`` does with
    fewer devices."""
    return _mesh(*production_shape(multi_pod), resolve_device(device))


def make_host_mesh(data: int = 1, model: int = 1,
                   device: DeviceLike = None) -> DeviceMesh:
    """A small (data, model) mesh over however many ranks exist (tests,
    examples): ``data`` clamped to the world, ``model`` to what is left."""
    dev = resolve_device(device)
    n = world_size()
    data = min(data, n)
    return _mesh((data, max(1, min(model, n // data))), ("data", "model"),
                 dev)


def make_gc_mesh(hosts: int = 0, axis: str = "gc_hosts",
                 device: DeviceLike = None) -> DeviceMesh:
    """A 1-D mesh for the sharded MVGC stack (``repro_torch.dist.mvgc``):
    one position per rank along ``axis``, ``hosts`` clamped to the world
    (0: every rank).  The global-LWM ring all-reduce runs over this axis
    (DESIGN.md §13)."""
    dev = resolve_device(device)
    n = world_size()
    hosts = n if hosts <= 0 else min(hosts, n)
    return _mesh((hosts,), (axis,), dev)
