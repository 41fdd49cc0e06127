"""Roofline analysis over the dry run's records, and the H100's peaks and
each kernel's analytic cost (port of ``repro.launch.roofline``).

Per (arch x shape x mesh) cell, the three terms (seconds a step):

    compute    = flops_per_device / PEAK_FLOPS["bf16"]
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / COLLECTIVE_BW

**The H100 table.**  One NVIDIA H100 SXM5 80 GB (NVIDIA's datasheet, dense
rates without sparsity, at the full 700 W power limit; the card
``chip_smoke.py`` reports as "NVIDIA H100 80GB HBM3, 700.00 W"):
989 TFLOP/s bf16 on the tensor cores, 495 TFLOP/s tf32, 67 TFLOP/s
float32 and 67 TOP/s int32 on the CUDA cores, 3.35 TB/s of HBM3.  Between
cards: NVLink 4 moves 450 GB/s a direction within one 8-GPU node; past
the node, one 400 Gb/s NDR InfiniBand port per GPU moves about 50 GB/s.
The collective term uses ``IB_BW``: the production meshes hold 256 and
512 ranks, 32 and 64 nodes of 8, and a ring over any of their axes
crosses nodes, where its slowest hop is NDR.  ``NVLINK_BW`` is kept
beside it for the meshes of one node.

The compute term is at the bf16 rate: the cells compute in bf16
(``specs.COMPUTE_DTYPE``), as JAX's do.  ``MODEL_FLOPS`` uses ``6 N D``
(dense) or ``6 N_active D`` (MoE) plus an attention term, so the useful
compute ratio shows redundant work: the port's placed step computes each
whole layer on every ``model`` rank (``repro_torch.dist.sharding``), so on
``pod`` a tensor-parallel leaf's FLOPs are about 16 times XLA's share.
That is the port's real cost, not a fault of this counter.

**Kernels.**  :func:`bound` is the least time of a kernel's work on the
H100 (what ``chip_smoke.py`` phase 3 prints as ``bound_ms``).  Each
hand-written kernel's bytes and operations from its shapes (``*_cost``)
live beside the kernels, in :mod:`repro_torch.kernels.cost`, where the
wrappers charge them to :mod:`repro_torch.launch.op_cost`; they are
imported here so that a bound and its work are read in one place.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

from repro_torch.kernels.cost import (  # noqa: F401  (read from here)
    Cost, board_bytes, compact_cost, flash_backward_cost, flash_prefill_cost,
    needed_cost, paged_decode_cost, search_cost, search_gather_cost,
    sweep_cost, value_at_cost, view_cost, visible_pairs)

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12,
              "int32": 67e12}      # dense ops/s per card
HBM_BW = 3.35e12                   # B/s per card
NVLINK_BW = 450e9                  # B/s per card, one direction, in a node
IB_BW = 50e9                       # B/s per card past the node (NDR 400G)
COLLECTIVE_BW = IB_BW

# Conservative sustained DRAM stream bandwidth for the CPU CI runners that
# time the kernel bench's fallback path (BENCH_kernel rows record which
# backend produced their timings).
HOST_DRAM_BW = 25e9       # B/s

# Stated roofline targets for the fused GC/read primitives (BENCH_kernel,
# DESIGN.md §12): the fraction of the timed backend's bandwidth peak each
# kernel is expected to sustain at standard-tier shapes.  The compact sweep
# streams four descriptor tiles per pass but burns O(P) compares per
# element (announcement broadcast), so its stated fraction is below a pure
# copy; search+gather adds a data-dependent row gather per query on top of
# the streaming search, landing lower still.
KERNEL_BW_FRACTION = {
    "compact": 0.50,
    "search_gather": 0.35,
}


def kernel_bandwidth_target(kernel: str, backend: str = "cpu") -> Dict:
    """Per-row roofline target for a BENCH_kernel cell: the stated fraction
    of the timed backend's bandwidth peak (HBM on the card, ``"cuda"``;
    sustained DRAM stream on the CPU runners).  Returns ``{peak_bw_gb_s,
    target_frac, target_gb_s}``."""
    if kernel not in KERNEL_BW_FRACTION:
        raise KeyError(f"no stated bandwidth fraction for kernel {kernel!r} "
                       f"(have {sorted(KERNEL_BW_FRACTION)})")
    peak = HBM_BW if backend == "cuda" else HOST_DRAM_BW
    frac = KERNEL_BW_FRACTION[kernel]
    return {
        "peak_bw_gb_s": round(peak / 1e9, 3),
        "target_frac": frac,
        "target_gb_s": round(frac * peak / 1e9, 3),
    }


# ---------------------------------------------------------------------------
# kernels: the least time of their work, and their analytic cost
# ---------------------------------------------------------------------------
def bound(nbytes: float, ops: float, kind: str) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the operations over ``kind``'s peak rate."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_prefill_bound(cost: Cost) -> Tuple[float, str]:
    """K6's bound in its route's unit: bf16 at the bf16 rate; float32 as
    three tf32 products for each of the forward's two (split-TF32).
    ``bound(*cost)`` of a float32 cost is the CUDA-core bound of the
    design that route replaced."""
    nbytes, ops, kind = cost
    if kind == "f32":
        return bound(nbytes, 3 * ops, "tf32")
    return bound(nbytes, ops, kind)


def flash_backward_bound(cost: Cost) -> Tuple[float, str]:
    """K6b's bound in its route's unit, by K6's rule: bf16 at the bf16
    rate; float32 as three tf32 products for each of the backward's."""
    return flash_prefill_bound(cost)


# ---------------------------------------------------------------------------
# the dry run's records
# ---------------------------------------------------------------------------
RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def model_flops_per_device(rec: Dict) -> float:
    """Analytic useful FLOPs per device per step (forward[+backward]).

    Trap C15 (a JAX fault, reproduced): the divisor is 512 chips on
    ``multipod`` and 256 on every other mesh, not the record's own
    ``chips``, so a ``host`` (1 chip) cell's useful FLOPs are 256 times
    too small and a ``host2`` cell's 128 times."""
    from repro_torch.configs import ARCHS
    cfg = ARCHS[rec["arch"]]
    n_active = cfg.active_param_count()
    B, S = rec["global_batch"], rec["seq_len"]
    chips = 512 if rec["mesh"] == "multipod" else 256   # C15
    kinds = [cfg.layer_pattern[i % len(cfg.layer_pattern)]
             for i in range(cfg.num_layers)]

    def spans():
        for kind in kinds:
            if kind in ("attn", "local"):
                yield (min(S, cfg.local_window)
                       if kind == "local" and cfg.local_window else S)

    hq_hd = cfg.num_heads * cfg.hd
    if rec["kind"] == "train":
        # fwd 2ND + bwd 4ND; causal attention 6 B S^2 H hd a layer (fwd 2
        # + bwd 4), halved for causality, local layers capped at the window
        flops = 6 * n_active * B * S
        flops += sum(6 * B * S * span * hq_hd * 0.5 * 2 for span in spans())
    elif rec["kind"] == "prefill":
        flops = 2 * n_active * B * S
        flops += sum(2 * B * S * span * hq_hd * 0.5 * 2 for span in spans())
    else:  # decode: one token over a cache of S
        flops = 2 * n_active * B
        flops += sum(2 * B * 1 * span * hq_hd * 2 for span in spans())
    return flops / chips


def analyze(rec: Dict) -> Dict:
    if "error" in rec:
        return {**rec, "status": "FAILED"}
    t_comp = rec["flops_per_device"] / PEAK_FLOPS["bf16"]
    # eager ops are unfused: every op's operands and results cross HBM
    t_mem = rec["bytes_per_device"] / HBM_BW
    t_coll = rec["collective_bytes_per_device"] / COLLECTIVE_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(rec)
    useful = mf / rec["flops_per_device"] if rec["flops_per_device"] else 0.0
    longest = max(terms.values())
    # roofline fraction: useful model FLOPs vs what the dominant term allows
    frac = (mf / PEAK_FLOPS["bf16"]) / longest if longest > 0 else 0.0
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "variant": rec.get("variant", "baseline"),
        "t_compute_s": t_comp, "t_memory_s": t_mem, "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_per_device": mf,
        "useful_flops_ratio": useful,
        "roofline_fraction": frac,
        "hbm_per_device_gb": (rec["memory"]["argument_bytes"]
                              + rec["memory"]["temp_bytes"]) / 1e9,
        "collectives": rec["collectives"],
        "status": "ok",
    }


def load_all(variant: Optional[str] = None,
             results_dir: str = RESULTS_DIR) -> List[Dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if variant is not None and rec.get("variant", "baseline") != variant:
            continue
        out.append(analyze(rec))
    return out


def table(rows: List[Dict]) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'mesh':8s} {'comp(ms)':>9s} "
           f"{'mem(ms)':>9s} {'coll(ms)':>9s} {'bound':>10s} {'useful':>7s} "
           f"{'roofline':>8s} {'HBM(GB)':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.get("status") != "ok":
            lines.append(f"{r['arch']:24s} {r['shape']:12s} "
                         f"{r.get('mesh', '?'):8s} FAILED: "
                         f"{r.get('error', '')[:60]}")
            continue
        lines.append(
            f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:8s} "
            f"{r['t_compute_s']*1e3:9.2f} {r['t_memory_s']*1e3:9.2f} "
            f"{r['t_collective_s']*1e3:9.2f} {r['dominant']:>10s} "
            f"{r['useful_flops_ratio']:7.2f} {r['roofline_fraction']:8.3f} "
            f"{r['hbm_per_device_gb']:8.2f}")
    return "\n".join(lines)


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="roofline table of the dry run's records "
                    "(results/dryrun_torch)")
    ap.add_argument("--variant", default="baseline")
    args = ap.parse_args(argv)
    print(table(load_all(args.variant)))


if __name__ == "__main__":
    main()
