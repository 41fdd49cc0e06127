#!/usr/bin/env python3
"""Phase 10e of ``chip_smoke.py`` for some of its cases alone, on the card.

    python3 tools/train_sharded_case.py CASE...     # cases of TRAIN_SHARDED

Builds the kernels, runs each case's one-rank reference as
``chip_smoke.py --train-reference`` does (a process a case, all at once),
then ``chip_smoke.rank_train_sharded`` for the cases in four rank
processes of this script (gloo through a file store, each on ``cuda:0``,
as ``chip_smoke.rank_main`` joins them), and holds their records with
``chip_smoke.check_train_sharded`` and the largest tensors the placement
made with ``SHARDED_MADE``.  Prints, one JSON object a line, each case's
check line (losses, gradient norms, the leaves' worst errors, step
seconds, bytes across host memory a step, peak memory and K6/K6b heads a
rank) and the card.  A failing check prints its message and the script
exits 1.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as c  # noqa: E402

RANKS = 4


class Failed(Exception):
    pass


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def rank_main(rank: int, io: str, cases: list) -> int:
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(io, "store"),
        rank=rank, world_size=RANKS, timeout=timedelta(seconds=300))
    c._build.lib()
    dev = torch.device("cuda", 0)
    try:
        out = {case: c.rank_train_sharded(dev, rank, RANKS, io, case)
               for case in cases}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(io, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def main(cases: list) -> int:
    smi = c.phase_device()
    c.phase_build()
    failed = None
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as io:
        t0 = time.perf_counter()
        c._wait(c._start(io, [["--train-reference", io, case]
                              for case in cases]))
        ref_wall = time.perf_counter() - t0
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
        t0 = time.perf_counter()
        logs = [open(os.path.join(io, f"rank{r}.log"), "w")
                for r in range(RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             io, *cases], env=env, cwd=ROOT, stdout=logs[r],
            stderr=subprocess.STDOUT) for r in range(RANKS)]
        try:
            rcs = [p.wait(timeout=c.RANKS_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        for r, rc in enumerate(rcs):
            if rc:
                with open(os.path.join(io, f"rank{r}.log")) as f:
                    print(f"rank {r} exited {rc}:", f.read()[-4000:],
                          flush=True)
        if any(rcs):
            raise SystemExit(f"train_sharded_case: ranks exited {rcs}")
        wall = time.perf_counter() - t0
        outs = []
        for r in range(RANKS):
            with open(os.path.join(io, f"rank{r}.json")) as f:
                outs.append(json.load(f))
        c.check = _check
        for case in cases:
            with open(os.path.join(io, f"reference_{case}.json")) as f:
                ref = json.load(f)
            trains = [o[case] for o in outs]
            try:
                worst, update = c.check_train_sharded(io, ref, trains, case)
                for r, x in enumerate(trains):
                    bad = {k: (x["largest_made"].get(k), v)
                           for k, v in c.SHARDED_MADE.get(case, {}).items()
                           if x["largest_made"].get(k) != v}
                    _check(not bad, f"{case}: rank {r} made (got, want) "
                           f"{bad}")
                c.emit({"case": case, "ok": True, "losses":
                        trains[0]["losses"], "ref_losses": ref["losses"],
                        "grad_norms": trains[0]["grad_norms"],
                        "ref_grad_norms": ref["grad_norms"],
                        "max_abs_err": worst, "update": update,
                        "step_s_by_rank": [x["step_s"] for x in trains],
                        "ref_step_s": ref["step_s"],
                        "ref_peak_gib": ref["peak_gib"],
                        "ref_wall_s": ref_wall,
                        "host_bytes_per_step_by_rank": [
                            x["host_bytes_per_step"] for x in trains],
                        "peak_gib_by_rank": [x["peak_gib"] for x in trains],
                        "k6_heads_by_rank": [x["k6_heads"] for x in trains],
                        "k6b_heads_by_rank": [x["k6b_heads"]
                                              for x in trains],
                        "largest_made_rank0": trains[0]["largest_made"],
                        "ranks_wall_s": wall})
            except (Failed, AssertionError) as e:
                failed = str(e)
                c.emit({"case": case, "ok": False, "failed": failed[:4000]})
    print(smi, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4:]))
    sys.exit(main(sys.argv[1:] or ["rglru", "xlstm", "whisper"]))
