"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Every source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a`` into an object file; the objects are linked into
``build/libmvgc_kernels.so`` at the root of the checkout and loaded with
``ctypes``.  The sources have a plain C interface (no PyTorch headers), so a
build takes seconds.  Nothing is built when this module is imported: the
first :func:`lib` call builds (or reuses a library newer than every source)
and loads.

Each C entry point takes device pointers, int sizes and the CUDA stream, and
returns ``cudaGetLastError()`` after its launch; :func:`check` turns a
nonzero return into an exception.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
LIB_NAME = "libmvgc_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C signature of every entry point: pointers and the stream are c_void_p.
SIGNATURES = {
    # ts, succ, payload, mask, ann, now, out_ts, out_succ, out_pay,
    # out_freed, count, R, V, P, stream
    "mvgc_compact": [_P] * 11 + [_I] * 3 + [_P],
    # ts, payload, values, slot_ids, t, out_rows, out_pay, out_found,
    # S, V, T, M, B, stream
    "mvgc_search_gather": [_P] * 8 + [_I] * 5 + [_P],
    # q, k_pages, v_pages, page_table, lengths, out, B, N, Hq, Hkv, D, PS,
    # MP, is_bf16, stream
    "mvgc_paged_decode": [_P] * 6 + [_I] * 8 + [_P],
    # q, k, v, out, B, Hq, Hkv, T, S, D, causal, window, softcap, is_bf16,
    # stream
    "mvgc_flash_prefill": [_P] * 4 + [_I] * 8 + [ctypes.c_float, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
#: seconds the last build in this process took (0.0 before any build)
build_seconds = 0.0


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _stale(lib_path: Path) -> bool:
    if not lib_path.exists():
        return True
    built = lib_path.stat().st_mtime
    deps = _sources() + sorted(CSRC.glob("*.cuh"))
    return any(p.stat().st_mtime > built for p in deps)


def build(force: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` in parallel and link the shared library.
    Returns its path.  Output of a failed ``nvcc`` is raised verbatim."""
    global build_seconds
    lib_path = BUILD / LIB_NAME
    if not force and not _stale(lib_path):
        return lib_path
    t0 = time.perf_counter()
    BUILD.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [cc, *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                   "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [cc, *ARCH, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        # atomic: a concurrent loader sees the old or the new library
        os.replace(tmp_lib, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def stream() -> int:
    """PyTorch's current CUDA stream, as the pointer the C side takes."""
    return torch.cuda.current_stream().cuda_stream


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require_cuda_i32(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous int32 CUDA tensor."""
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous int32 CUDA "
                             f"tensors, got {t.dtype} on {t.device}")
