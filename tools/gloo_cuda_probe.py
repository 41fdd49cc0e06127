#!/usr/bin/env python3
"""Which of gloo's collectives take CUDA tensors, on this machine's torch.

    python3 tools/gloo_cuda_probe.py

For each collective the port uses, starts 2 rank processes on
``cuda:0`` joined by gloo through a file store, runs it on a CUDA tensor
and checks the result; prints one JSON line, ``{"torch": ..., "ops":
{name: "ok" | what went wrong}}``.  Each op gets processes of its own: a
CUDA tensor handed to gloo's TCP transport can abort the process.  The
port stages every collective's operands through host memory whatever
this says (``repro_torch.dist.overlap.wire``); the probe records why.
"""
import json
import os
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist


OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "reduce_scatter_tensor", "isend_irecv")


def rank_main(rank: int, store: str, name: str) -> int:
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=2)
    dev = torch.device("cuda", 0)
    x = torch.full((8,), float(rank + 1), device=dev)
    if name == "all_reduce":
        y = x.clone()
        dist.all_reduce(y)
        ok = bool((y == 3).all())
    elif name == "broadcast":
        y = x.clone()
        dist.broadcast(y, src=0)
        ok = bool((y == 1).all())
    elif name == "all_gather":
        ys = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(ys, x)
        ok = bool((ys[0] == 1).all() and (ys[1] == 2).all())
    elif name == "all_gather_into_tensor":
        y = torch.empty(16, device=dev)
        dist.all_gather_into_tensor(y, x)
        ok = bool((y[:8] == 1).all() and (y[8:] == 2).all())
    elif name == "reduce_scatter_tensor":
        y = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(y, x.clone())
        ok = bool((y == 3).all())
    else:
        y = torch.empty_like(x)
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x.clone(), 1 - rank),
                dist.P2POp(dist.irecv, y, 1 - rank)]):
            w.wait()
        ok = bool((y == 2 - rank).all())
    torch.cuda.synchronize()
    dist.destroy_process_group()
    return 0 if ok else 3


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    ops = {}
    for name in OPS:
        with tempfile.TemporaryDirectory() as tmp:
            procs = [subprocess.Popen(
                [sys.executable, __file__, "--rank", str(r),
                 os.path.join(tmp, "store"), name],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                for r in range(2)]
            outs = []
            for p in procs:
                try:
                    outs.append(p.communicate(timeout=120)[0].decode())
                except subprocess.TimeoutExpired:
                    p.kill()
                    outs.append(p.communicate()[0].decode())
        codes = [p.returncode for p in procs]
        if codes == [0, 0]:
            ops[name] = "ok"
        elif 3 in codes:
            ops[name] = "wrong result"
        else:
            last = [ln for o in outs for ln in o.splitlines()
                    if "Error" in ln or "what()" in ln]
            ops[name] = f"exit codes {codes}: " + (last[-1][:200] if last
                                                   else "")
    print(json.dumps({"torch": torch.__version__, "ops": ops}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        sys.exit(rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())
