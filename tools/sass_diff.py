#!/usr/bin/env python3
"""Compare the machine code (SASS) of one CUDA source's kernels in two
checkouts of the port, on a machine with the CUDA toolkit.

    python3 tools/sass_diff.py --a DIR --b DIR [--source compact.cu]
                               [--kernel NAME] [--out DIR]

Builds ``src/repro_torch/csrc/<source>`` of each checkout to a cubin with
the flags of ``repro_torch.kernels._build`` (``-O3`` for sm_90a), and for
every kernel of ``--b`` whose name holds ``--kernel``, against the first
such kernel of ``--a``, prints one JSON line: its instruction count, its
registers, and whether its instructions are the same as ``--a``'s (and the
same but for constants).  The SASS listings go to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]


def _cuda(tool: str) -> str:
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", tool)


def sass(root: str, source: str, out: str, tag: str) -> tuple:
    """({kernel: [instructions]}, {kernel: registers}) of ``source`` in
    checkout ``root``."""
    src = os.path.join(root, "src", "repro_torch", "csrc", source)
    cubin = os.path.join(out, f"{tag}.cubin")
    subprocess.run([_cuda("nvcc"), *ARCH, "-std=c++17", "-O3", "-cubin",
                    "-o", cubin, src], check=True)
    listing = subprocess.run([_cuda("cuobjdump"), "-sass", cubin],
                             check=True, capture_output=True,
                             text=True).stdout
    with open(os.path.join(out, f"{tag}.sass"), "w") as f:
        f.write(listing)
    code, cur = {}, None
    for line in listing.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            code[cur] = []
        elif cur and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            code[cur].append(re.sub(r"/\*[0-9a-f]{4}\*/", "",
                                    line.split(";")[0]).strip())
    usage = subprocess.run([_cuda("cuobjdump"), "-res-usage", cubin],
                           check=True, capture_output=True, text=True).stdout
    regs = dict(re.findall(r"Function (\S+):\s*\n\s*REG:(\d+)", usage))
    return code, {k: int(v) for k, v in regs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True)
    ap.add_argument("--b", required=True)
    ap.add_argument("--source", default="compact.cu")
    ap.add_argument("--kernel", default="sweep_kernel")
    ap.add_argument("--out", default="build/sass")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    a, a_regs = sass(args.a, args.source, args.out, "a")
    b, b_regs = sass(args.b, args.source, args.out, "b")
    base = next(k for k in a if args.kernel in k)

    def consts(xs):
        return [re.sub(r"0x[0-9a-f]+", "X", x) for x in xs]
    for k in (k for k in b if args.kernel in k):
        print(json.dumps({
            "kernel": k, "instructions": len(b[k]), "registers": b_regs.get(k),
            "a_kernel": base, "a_instructions": len(a[base]),
            "a_registers": a_regs.get(base), "identical": b[k] == a[base],
            "identical_but_constants": consts(b[k]) == consts(a[base])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
