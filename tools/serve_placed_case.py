#!/usr/bin/env python3
"""Phase 10h of ``chip_smoke.py`` for one of its models alone, on the card.

    python3 tools/serve_placed_case.py [CASE]      # CASE of SERVE_PLACED, moe

Builds the kernels, runs ``chip_smoke.rank_serve_placed`` for CASE in four
rank processes of this script (gloo through a file store, each on
``cuda:0``, as ``chip_smoke.rank_main`` joins them) and holds their records
with ``chip_smoke.check_serve_placed``.  Prints, one JSON object a line,
the card, the check's line, each row's largest logit error of the placed
step over the bf16 one-rank step's distance from float32 (``d16``) at
every step, and for a mixture of experts the prefill's routing: for each
layer, how many of the prompt's tokens the bf16 one-rank step and the
placed step send to another top-k than the float32 step, and which rows'
last tokens.  A failing check prints its message and the script exits 1
after the rest is printed.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

import numpy as np
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


def record_prefill_routes(io: str, rank: int) -> None:
    """Saves the top-k expert ids (ascending) of every token at each
    prefill call of a mixture's router to ``io``, in call order: on ranks
    0 and 1 the one-rank step's (float32, bf16) two layers, then the
    placed step's."""
    from repro_torch.models import moe
    real, calls = moe._route, [0]

    def route(params, cfg, x, group=None):
        out = real(params, cfg, x, group)
        if x.shape[1] > 1:
            np.save(os.path.join(io, f"route_{rank}_{calls[0]}.npy"),
                    torch.sort(out[1], dim=-1).values.cpu().numpy())
            calls[0] += 1
        return out
    moe._route = route


def rank_main(rank: int, io: str, case: str) -> int:
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(io, "store"),
        rank=rank, world_size=RANKS, timeout=timedelta(seconds=300))
    c._build.lib()
    c.SERVE_PLACED = {case: c.SERVE_PLACED[case]}
    record_prefill_routes(io, rank)
    try:
        out = c.rank_serve_placed(torch.device("cuda", 0), rank, RANKS, io)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(io, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def prefill_flips(io: str, outs: list, case: str) -> dict:
    """Each layer's count of prompt tokens routed to another top-k than
    the float32 one-rank step's, by the bf16 one-rank step and by the
    placed step (each data row's ranks once), and the rows whose last
    token is among them."""
    layers = c._serve_cfg(case).num_layers
    res = {}
    for layer in range(layers):
        f32 = np.load(os.path.join(io, f"route_0_{layer}.npy"))
        b16 = np.load(os.path.join(io, f"route_1_{layer}.npy"))
        moved_16 = (b16 != f32).any(-1)
        placed = np.zeros_like(moved_16)
        for r, o in enumerate(outs):
            d, m = o[case]["placed"]["coord"]
            if m:
                continue
            got = np.load(os.path.join(
                io, f"route_{r}_{layer + (layers if r < 2 else 0)}.npy"))
            b = got.shape[0]
            placed[d * b:(d + 1) * b] = (got != f32[d * b:(d + 1) * b]
                                         ).any(-1)
        res[layer] = {"tokens": int(moved_16.size),
                      "bf16_vs_f32": int(moved_16.sum()),
                      "placed_vs_f32": int(placed.sum()),
                      "last_token_rows_bf16": np.flatnonzero(
                          moved_16[:, -1]).tolist(),
                      "last_token_rows_placed": np.flatnonzero(
                          placed[:, -1]).tolist()}
    return res


def main(case: str) -> int:
    c.check = _check
    smi = c.phase_device()
    c.phase_build()
    c.SERVE_PLACED = {case: c.SERVE_PLACED[case]}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    failed = None
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as io:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
        t0 = time.perf_counter()
        logs = [open(os.path.join(io, f"rank{r}.log"), "w")
                for r in range(RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             io, case], env=env, cwd=ROOT, stdout=logs[r],
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
            raise SystemExit(f"serve_placed_case: ranks exited {rcs}")
        outs = []
        for r in range(RANKS):
            with open(os.path.join(io, f"rank{r}.json")) as f:
                outs.append(json.load(f))
        wall = time.perf_counter() - t0
        try:
            line = c.check_serve_placed(outs)[case]
            c.emit({"case": case, "ok": True, "ranks_wall_s": wall, **line})
        except Failed as e:
            failed = str(e)
            c.emit({"case": case, "ok": False, "failed": failed,
                    "ranks_wall_s": wall})
        d16 = np.asarray(outs[1][case]["ref16"]["d16"])
        err = np.zeros_like(d16)
        for x in (o[case]["placed"] for o in outs):
            e = np.asarray(x["err"])
            i = x["coord"][0] * e.shape[1]
            err[:, i:i + e.shape[1]] = np.maximum(err[:, i:i + e.shape[1]],
                                                  e)
        c.emit({"case": case, "err_over_d16_by_step_and_row": np.round(
            err / d16, 3).tolist(), "d16": d16.tolist()})
        if c._serve_cfg(case).num_experts:
            c.emit({"case": case,
                    "prefill_routes_moved": prefill_flips(io, outs, case)})
    print(smi, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "moe"))
