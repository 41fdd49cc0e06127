"""Dry run of every (arch x shape x mesh) cell: rank 0's program of the
cell, traced on fake tensors (port of ``repro.launch.dryrun``).

JAX lowers and compiles each cell's jitted step for a production mesh of
fake CPU devices (``XLA_FLAGS``), and the compiled module is the
per-device SPMD program.  Every rank of the port runs the same code on its
shard, so the port runs rank 0's program itself:

* a ``fake`` process group of the mesh's size (256 ranks for ``pod``, 512
  for ``multipod``, 1 for ``host``, 2 for ``host2``), started in this
  process (trap "the fake group is per process": one default group a
  process; a gloo group in the same process is refused);
* the mesh builders of :mod:`repro_torch.launch.mesh` over it;
* the cell's state built as shapes first (:func:`repro_torch.launch.specs.
  shapes_of`, the counterpart of ``jax.eval_shape``: no RNG is drawn),
  then as this rank's shards, fake tensors made with ``torch.empty`` on
  the dry run's device inside a ``FakeTensorMode`` (no data is made, no
  kernel built or launched: each wrapper's shape-only route);
* the step under :class:`repro_torch.launch.op_cost.OpCounter`, which
  counts what the rank dispatches and charges the kernels and collectives,
  and explores the paths through the step's host reads (a decode cell's
  gate: the pressure branch and the cadence pass, the larger charged).

The dry run's device is the card's (``cuda``) where torch has one.  A torch
without CUDA cannot record autograd over a CUDA tensor, fake or not (it
aborts the process), so there the fake tensors stand on ``cpu``: the same
ops, kernels and collectives, without the host copies that stage a
collective's CUDA tensors (``overlap.wire``), which the counter does not
charge in either case.  Trap "resolve_device": the mesh is built on that
device, so ``resolve_device("cuda")`` is never asked without a card.
Trap "meta tensors cannot cross to host memory": ``wire`` stages every
collective through the host, which a ``meta`` tensor refuses and a fake
one allows, so the dry run uses ``FakeTensorMode``, not ``device="meta"``.

A record keeps JAX's schema where it means something in the port (no
``fused_*`` bytes, eager ops are unfused; no ``xla_raw_flops``) and adds
``kernels`` (the census: launches, flops, bytes by kernel), ``trace_s``
and ``device``.  ``memory``: ``argument_bytes`` is the rank's state and
batch at entry; ``temp_bytes`` the peak of live fake-tensor bytes during
the step above them; ``output_bytes`` the step's outputs; ``alias_bytes``
the arguments the step writes in place (JAX's ``donate_argnums=(0,)``).
The op trace is saved beside the record (``<cell>.ops.json.gz``) for
:mod:`repro_torch.launch.reanalyze`.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
      PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
          --shape train_4k --mesh pod
      PYTHONPATH=src python -m repro_torch.launch.dryrun --smoke
          # smallest arch x train_4k on a 1-rank host mesh, seconds
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import list_archs, runnable
from repro_torch.configs.base import SHAPES
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.op_cost import OpCounter

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
MESH_RANKS = {"host": 1, "host2": 2, "pod": 256, "multipod": 512}


def dry_device() -> torch.device:
    """The card where torch has one, else the CPU (see the module
    docstring)."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def start_group(world: int) -> None:
    """A fake default group of ``world`` ranks, this process rank 0.

    ``torch.testing._internal.distributed.fake_pg`` is internal to torch;
    checked on torch 2.13 (CPU) and the card's torch 2.11."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                "the dry run needs a fake default group, and this process "
                f"has a {dist.get_backend()} one: run it in a process of "
                "its own")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _mesh_for(mesh_name: str, dev: torch.device):
    start_group(MESH_RANKS[mesh_name])
    if mesh_name == "host":          # --smoke: one rank
        return make_host_mesh(1, 1, device=dev)
    if mesh_name == "host2":         # --smoke --mesh host2: 2-rank data mesh
        return make_host_mesh(2, 1, device=dev)
    return make_production_mesh(multi_pod=(mesh_name == "multipod"),
                                device=dev)


def _storages(tree, dev: torch.device) -> Dict[int, int]:
    """storage key -> bytes of every tensor of ``tree`` on ``dev``."""
    out = {}
    S.map_leaves(tree, lambda t: out.setdefault(
        t.untyped_storage()._cdata, t.untyped_storage().nbytes())
        if isinstance(t, torch.Tensor) and t.device.type == dev.type else t)
    return out


def trace_cell(arch: str, shape, mesh_name: str, **overrides):
    """Rank 0's step of the cell on fake tensors under an op counter.
    Returns ``(counter, memory, chips)``."""
    dev = dry_device()
    mesh = _mesh_for(mesh_name, dev)
    build = (S.build_train_cell if S._shape(shape).kind == "train"
             else S.build_serve_cell)
    step, args, _ = build(arch, mesh, shape, **overrides)
    counter, memory = trace(step, args, dev)
    return counter, memory, mesh.mesh.numel()


def trace(step, args, dev: torch.device):
    """``step(*args)`` on fake tensors of ``args``' shapes (:class:`repro_
    torch.launch.specs.Shaped` leaves) on ``dev``, under an op counter
    that explores its host reads.  Returns ``(counter, memory)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    counter = OpCounter(dev.type)
    with FakeTensorMode(), counter:
        fake = S.map_leaves(args, lambda x: torch.empty(x.shape, dtype=x.dtype,
                                                  device=dev))
        entry = _storages(fake, dev)
        counter.mark_entry(entry)
        out = counter.explore(lambda: step(*fake))
        outs = _storages(out, dev)
        memory = {
            "argument_bytes": sum(entry.values()),
            "output_bytes": sum(outs.values()),
            "temp_bytes": counter.temp_bytes,
            "alias_bytes": counter.written_entry_bytes,
        }
        del out, fake
    return counter, memory


def dryrun_cell(arch: str, shape: str, mesh_name: str,
                variant: str = "baseline", **overrides) -> Dict[str, Any]:
    sh = S._shape(shape)
    t0 = time.time()
    counter, memory, chips = trace_cell(arch, shape, mesh_name, **overrides)
    t_trace = time.time() - t0
    hc = counter.result()
    os.makedirs(RESULTS_DIR, exist_ok=True)
    with gzip.open(ops_path(arch, sh.name, mesh_name, variant), "wt") as f:
        json.dump([[rec, n] for rec, n in counter.trace.items()], f)
    return {
        "arch": arch, "shape": sh.name, "mesh": mesh_name,
        "variant": variant, "chips": int(chips),
        "seq_len": sh.seq_len, "global_batch": sh.global_batch,
        "kind": sh.kind,
        "flops_per_device": float(hc["flops"]),
        "bytes_per_device": float(hc["traffic_bytes"]),
        "transcendentals": float(hc["transcendentals"]),
        "collectives": hc["collectives"],
        "collective_bytes_per_device": float(hc["collective_bytes"]),
        "memory": memory,
        "kernels": hc["kernels"],
        "device": dry_device().type,
        "trace_s": round(t_trace, 2),
    }


def cell_path(arch: str, shape: str, mesh_name: str,
              variant: str = "baseline") -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    suffix = "" if variant == "baseline" else f"__{variant}"
    return os.path.join(
        RESULTS_DIR, f"{arch}__{shape}__{mesh_name}{suffix}.json")


def ops_path(arch: str, shape: str, mesh_name: str,
             variant: str = "baseline") -> str:
    return cell_path(arch, shape, mesh_name, variant).replace(
        ".json", ".ops.json.gz")


def load_trace(path: str) -> Dict[Any, int]:
    """A saved op trace: record -> count, records as tuples again."""
    def freeze(x):
        return tuple(freeze(v) for v in x) if isinstance(x, list) else x
    with gzip.open(path, "rt") as f:
        return {freeze(rec): n for rec, n in json.load(f)}


def run_and_save(arch: str, shape: str, mesh_name: str,
                 variant: str = "baseline", force: bool = False,
                 **overrides) -> Optional[Dict]:
    path = cell_path(arch, shape, mesh_name, variant)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    try:
        rec = dryrun_cell(arch, shape, mesh_name, variant, **overrides)
    except Exception as e:  # record the failure: it is a bug to fix
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
               "variant": variant, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def smallest_arch() -> str:
    """The arch with the fewest parameters (the smoke cell)."""
    from repro_torch.configs import get_config
    return min(list_archs(), key=lambda a: get_config(a).param_count())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None,
                    choices=[None, "pod", "multipod", "host", "host2"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="one cell: smallest arch x train_4k on a 1-rank "
                         "host mesh; with --mesh host2, on 2 ranks")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline")
    args = ap.parse_args(argv)

    if args.smoke:
        args.arch = args.arch or smallest_arch()
        args.shape = args.shape or "train_4k"
        args.mesh = args.mesh or "host"
        args.variant = ("smoke" if args.mesh == "host"
                        else f"smoke_{args.mesh}")
        args.force = True

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.mesh] if args.mesh else ["pod", "multipod"]

    ok = fail = skip = 0
    for arch in archs:
        for shape in shapes:
            if not runnable(arch, shape):
                print(f"SKIP  {arch:24s} {shape:12s} (documented skip)")
                skip += 1
                continue
            for mesh_name in meshes:
                t0 = time.time()
                rec = run_and_save(arch, shape, mesh_name,
                                   variant=args.variant, force=args.force)
                if "error" in rec:
                    fail += 1
                    print(f"FAIL  {arch:24s} {shape:12s} {mesh_name:8s} "
                          f"{rec['error'][:90]}", flush=True)
                else:
                    ok += 1
                    gf = rec["flops_per_device"] / 1e9
                    cb = rec["collective_bytes_per_device"] / 1e6
                    print(f"OK    {arch:24s} {shape:12s} {mesh_name:8s} "
                          f"{gf:10.1f} GF/dev  coll {cb:8.1f} MB/dev  "
                          f"mem {rec['memory']['argument_bytes']/1e9:6.2f}+"
                          f"{rec['memory']['temp_bytes']/1e9:5.2f} GB  "
                          f"[{time.time()-t0:5.1f}s]", flush=True)
    print(f"\n{ok} ok, {fail} failed, {skip} skipped")
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
