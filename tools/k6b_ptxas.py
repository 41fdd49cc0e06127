#!/usr/bin/env python3
"""Registers and spills of K6b's kernels, as ``ptxas`` reports them.

    python3 tools/k6b_ptxas.py [--source PATH]

Compiles ``src/repro_torch/csrc/flash_backward.cu`` (or ``--source``)
for ``sm_90a`` with the flags of ``repro_torch.kernels._build`` plus
``-Xptxas -v`` into a temporary object, and prints one JSON line per
kernel: its demangled name and template arguments (the float32 route's
``flash_bwd_kernel<DP, KV_ROWS>``, the bf16 route's
``flash_bwd_dq_bf16<DP>`` and ``flash_bwd_dkv_bf16<DP>``), registers,
spill stores and loads in bytes, shared memory of the static kind, and
the count of each coded ``ptxas`` message that names it (``warnings``;
for example C7519, a ``warpgroup.arrive`` injected to let registers feed
``wgmma``, C7517, a ``warpgroup.wait`` injected before registers a
``wgmma`` defines are read, or C7510-C7515, ``wgmma`` serialized) with
the first text of each.  Needs ``nvcc``; runs no kernel.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

ENTRY = re.compile(r"Compiling entry function '(\w+)'")
REGS = re.compile(r"Used (\d+) registers")
SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
SMEM = re.compile(r"(\d+) bytes smem")
CODED = re.compile(r"\((C\d+)\)\s*(.*)")
NAMED = re.compile(r"'(_Z\w+)'")


def demangle(names):
    """``cu++filt`` of each name where the toolkit has it, else the name."""
    filt = Path(_build.nvcc()).with_name("cu++filt")
    if not filt.exists():
        return list(names)
    out = subprocess.run([str(filt)], input="\n".join(names), text=True,
                         capture_output=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def report(source: Path) -> list:
    """One dict per kernel of ``source``, in ptxas's order."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build.nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-Xptxas",
             "-v", "-c", str(source), "-o", str(Path(tmp) / "k.o")],
            capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + proc.stdout + proc.stderr)
    rows, cur, coded = [], None, {}
    for line in (proc.stdout + proc.stderr).splitlines():
        m, named = CODED.search(line), NAMED.findall(line)
        if m and named:
            seen = coded.setdefault(named[-1], {})
            text = re.split(r" in (?:the )?function", m.group(2))[0][:160]
            seen.setdefault(m.group(1), [0, text])[0] += 1
            continue
        m = ENTRY.search(line)
        if m:
            cur = dict(kernel=m.group(1))
            rows.append(cur)
            continue
        if cur is None:
            continue
        if (m := SPILL.search(line)):
            cur["spill_store_bytes"] = int(m.group(1))
            cur["spill_load_bytes"] = int(m.group(2))
        if (m := REGS.search(line)):
            cur["registers"] = int(m.group(1))
            if (s := SMEM.search(line)):
                cur["static_smem_bytes"] = int(s.group(1))
    for row, name in zip(rows, demangle([r["kernel"] for r in rows])):
        row["warnings"] = {code: dict(count=n, text=text) for code, (n, text)
                           in coded.get(row["kernel"], {}).items()}
        row["kernel"] = name
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path,
                    default=_build.CSRC / "flash_backward.cu")
    args = ap.parse_args()
    for row in report(args.source):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
