#!/usr/bin/env python3
"""Time the version-search (K3), needed (K5) and sweep and compact (K1)
kernels of one checkout of the port on the GPU, so that two checkouts can
be compared on one card in one run.

    python3 tools/time_search_needed.py [--root DIR] [--label NAME]
                                        [--reps N] [--only OP]

This module also holds what ``chip_smoke.py``'s phase 3 shares with it:
the timing of one call (:func:`time_call`), K5's shapes and inputs
(:data:`NEEDED_SHAPES`, :func:`needed_inputs`) and K3's
``benchmarks/kernel_bench.py``-style inputs (:data:`SEARCH_BIG`,
:func:`search_inputs`), so both time the same calls on the same data.

``--root`` is the checkout whose ``src/repro_torch`` is imported and built
(default: the one holding this script).  ``--reps`` sets each time's
number of calls (25), ``--only`` times one op (``search``, ``needed``,
``sweep`` or ``compact``).  Prints one JSON line per shape with
:func:`time_call`'s keys.  ``value_at`` rows appear only where the
checkout has that op.  Each call's result is first checked against the
plain version.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

EMPTY, TS_MAX = -1, 2**31 - 1
# K5's shapes (R, V, P): compact's at phase 5's geometry, then
# benchmarks/kernel_bench.py's two largest compact shapes
NEEDED_SHAPES = [(2 * 256 * 8, 8, 16), (65536, 8, 256), (32768, 16, 1024)]
NEEDED_NOW = 4000
# K3's shapes (S, V, B): phase 5's 256 sequences of 8 versions, and
# benchmarks/kernel_bench.py's largest search_gather shape without the value
# rows; its data: stamps sorted per slot below its NOW, a quarter free
SEARCH_SERVE = (256, 8, 256)
SEARCH_BIG = (65536, 8, 8192)
KERNEL_BENCH_NOW = 1_000_000
SEARCH_T_ALL = KERNEL_BENCH_NOW // 64   # early enough that some find none
# K1's serving shapes (S, V, R, P): phase 3's slrt flush at phase 5's
# geometry under its 16 reader lanes, and with the sharded engine's LWM pin
# (17 entries)
SWEEP_SHAPES = [(256, 8, 4096, 16), (256, 8, 4096, 17)]


def time_call(fn, reps: int = 25, warmup: int = 3) -> dict:
    """Two times of one call, each the median of ``reps`` calls:
    ``call_ms`` between CUDA events around the call (it includes the
    host's time to issue the launches, which dominates a microsecond
    kernel), and ``device_ms``, the summed duration of the kernels the call
    ran on the card, from the profiler's kernel records, and
    ``device_mean_ms``, their mean (the card's timer ticks in 32 ns
    steps, so a median of microsecond kernels moves by whole ticks); and
    ``kernels``, the number of those records per call (the most in any
    call)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    per_call, kernels = [], 0
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if str(e.device_type).endswith("CUDA")]
        per_call.append(sum(e.time_range.elapsed_us() for e in device) / 1e3)
        kernels = max(kernels, len(device))
    return {"call_ms": statistics.median(times),
            "device_ms": statistics.median(per_call),
            "device_mean_ms": statistics.fmean(per_call), "kernels": kernels}


def needed_inputs(dev) -> list:
    """``(ts, succ, ann, now)`` for each of NEEDED_SHAPES, slabs drawn as
    ``benchmarks/kernel_bench.py`` draws compact's: a quarter never
    written, 30 % current, the rest closed; a quarter of the board idle
    (TS_MAX), duplicates allowed; ``now`` a tensor on the card."""
    g = torch.Generator(device=dev).manual_seed(5)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)
    out = []
    for R, V, P in NEEDED_SHAPES:
        ts = ints(0, NEEDED_NOW, (R, V))
        succ = ts + ints(1, NEEDED_NOW // 2, (R, V))
        succ[torch.rand((R, V), generator=g, device=dev) < 0.3] = TS_MAX
        hole = torch.rand((R, V), generator=g, device=dev) < 0.25
        ts[hole], succ[hole] = EMPTY, TS_MAX
        n_ann = P - P // 4
        ann = torch.cat([torch.sort(ints(0, NEEDED_NOW, (n_ann,))).values,
                         torch.full((P - n_ann,), TS_MAX, dtype=torch.int32,
                                    device=dev)])
        out.append((ts, succ, ann, torch.tensor(NEEDED_NOW,
                                                dtype=torch.int32,
                                                device=dev)))
    return out


def sweep_inputs(S: int, V: int, R: int, P: int, dev, seed: int = 17
                 ) -> tuple:
    """``(ts, succ, payload, slot_ids, mask, board, now)`` for K1: slabs
    drawn as :func:`needed_inputs` draws them, payloads, ``R`` lane ids
    (80 % masked; the rest on slot 0) and a sorted board of ``P``, half
    idle (TS_MAX)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)
    ts = ints(0, NEEDED_NOW, (S, V))
    succ = ts + ints(1, NEEDED_NOW // 2, (S, V))
    succ[torch.rand((S, V), generator=g, device=dev) < 0.3] = TS_MAX
    pay = ints(0, S * V, (S, V))
    mask = torch.rand((R,), generator=g, device=dev) < 0.8
    ids = torch.where(mask, ints(0, S, (R,)), 0)
    ann = ints(0, NEEDED_NOW, (P,))
    ann[torch.rand((P,), generator=g, device=dev) < 0.5] = TS_MAX
    return (ts, succ, pay, ids, mask, torch.sort(ann).values,
            torch.tensor(NEEDED_NOW, dtype=torch.int32, device=dev))


def search_inputs(S: int, V: int, B: int, dev, seed: int = 16) -> tuple:
    """``(ts, payload, ids, t)`` as ``benchmarks/kernel_bench.py`` draws
    its search data: per slot V stamps sorted below KERNEL_BENCH_NOW, a
    quarter of the entries free; B ids and one t each."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, KERNEL_BENCH_NOW, (S, V)), axis=1)
    hole = rng.random((S, V)) < 0.25
    ts[hole] = EMPTY
    pay = np.where(hole, EMPTY, rng.integers(0, S, (S, V)))
    ids = rng.integers(0, S, B)
    t = rng.integers(0, KERNEL_BENCH_NOW, B)
    return tuple(torch.from_numpy(x.astype(np.int32)).to(dev)
                 for x in (ts, pay, ids, t))


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    if not torch.cuda.is_available():
        raise SystemExit("time_search_needed: needs a CUDA device")
    from repro_torch.kernels import _build
    from repro_torch.kernels.compact import ops as compact_ops
    from repro_torch.kernels.compact.ref import (compact_ref, needed_ref,
                                                 sweep_ref)
    from repro_torch.kernels.version_search import ops as search_ops
    from repro_torch.kernels.version_search.ref import search_ref
    _build.build(force=True)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    label = args.label or os.path.abspath(args.root)

    def emit(**row):
        print(json.dumps(dict(label=label, card=smi, **row)), flush=True)

    def timed(op, fn) -> dict:
        return time_call(fn, reps=args.reps) if args.only in ("", op) \
            else {}

    for S, V, B in (SEARCH_SERVE, SEARCH_BIG):
        ts, pay, ids, t = search_inputs(S, V, B, dev)
        got = search_ops.search(ts, pay, ids, t)
        if not all(torch.equal(a, b)
                   for a, b in zip(got, search_ref(ts, pay, ids, t))):
            raise SystemExit(f"search != plain version at S={S} B={B}")
        emit(op="search", shape=f"S={S} V={V} B={B}",
             **timed("search", lambda: search_ops.search(ts, pay, ids, t)))
        if hasattr(search_ops, "value_at"):
            emit(op="value_at", shape=f"S={S} V={V} every slot",
                 **timed("search", lambda: search_ops.value_at(
                     ts, pay, None, SEARCH_T_ALL)))
    for (R, V, P), args_ in zip(NEEDED_SHAPES, needed_inputs(dev)):
        if not torch.equal(compact_ops.needed(*args_), needed_ref(*args_)):
            raise SystemExit(f"needed != plain version at R={R}")
        emit(op="needed", shape=f"S={R} V={V} P={P}",
             **timed("needed", lambda: compact_ops.needed(*args_)))
    for S, V, R, P in SWEEP_SHAPES:
        a = sweep_inputs(S, V, R, P, dev)
        if not all(torch.equal(x, y) for x, y in zip(
                compact_ops.sweep(*a), sweep_ref(*a))):
            raise SystemExit(f"sweep != plain version at P={P}")
        emit(op="sweep", shape=f"S={S} V={V} R={R} P={P}",
             **timed("sweep", lambda: compact_ops.sweep(*a)))
        rows = (a[0], a[1], a[2], a[4][:S], a[5], a[6])
        if not all(torch.equal(x, y) for x, y in zip(
                compact_ops.compact(*rows), compact_ref(*rows))):
            raise SystemExit(f"compact != plain version at P={P}")
        emit(op="compact", shape=f"R={S} V={V} P={P}",
             **timed("compact", lambda: compact_ops.compact(*rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
