#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — requires CUDA; the card's name and power limit (nvidia-smi);
2. build  — builds the CUDA kernels from ``src/repro_torch/csrc``;
3. kernels — each kernel (compact, search, search+gather, paged decode,
   flash prefill) against its plain PyTorch version on the card at the
   serving phases' shapes, timed per call (device time from the profiler's
   kernel records, and CUDA events around the call; medians of 25), beside
   its bound; flash prefill also at a gemma2-2b shape and in float32;
4. storm  — the ``benchmarks/serve_bench.py`` storm trace for ebr, steam,
   dlrt and slrt; its counters must equal the committed BENCH_serve.json;
5. serve  — PagedKVEngine (policy slrt) at the KV geometry of one
   attention layer of minitron-4b: 256 sequences of up to 4096 tokens in a
   32768-page bf16 pool, continuous decode with resets, pinned readers whose
   view_at + paged decode must stay bit-identical while they hold the pin,
   run until the page pool has crossed its watermark; the kernel launch
   counts are zeroed just before this phase and read just after;
6. model  — minitron-4b at its full published widths and depth in bf16,
   random weights from a seed, through the port's launcher
   (``repro_torch.launch.serve``): MVServeEngine prefills 16 prompts of
   2048 tokens (flash prefill, K6, in every layer) into a 4096-token cache
   and decodes 64 steps under policy slrt, with a snapshot reader pinned
   every 8 steps whose score must stay bit-identical while it holds the
   pin; two prefills of the same prompt must give the same bits; the
   launch counts are zeroed just before the launcher's run and read just
   after; then a short profiled window of decode steps, whose idle share
   the phase's line carries;
7. the kernel table as one JSON line;
8. the result line ``{"ok": true, "device": {...}}``.

Any failure raises and exits nonzero; nothing is caught.  Without CUDA, or
without the package beside the script, it exits nonzero before any result.
"""
from __future__ import annotations

import json
import math
import os
import random
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.core.mvgc import vstore  # noqa: E402
from repro_torch.core.telemetry import GCConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.compact import ops as compact_ops  # noqa: E402
from repro_torch.kernels.compact.ref import compact_ref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import paged_decode_ref  # noqa: E402
from repro_torch.kernels.flash_prefill import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_prefill.ref import attention_ref  # noqa: E402
from repro_torch.kernels.version_search import ops as search_ops  # noqa: E402
from repro_torch.kernels.version_search.ref import (  # noqa: E402
    search_gather_ref, search_ref)
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve.engine import PagedKVEngine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int32": 67e12}
EMPTY, TS_MAX = -1, 2**31 - 1
# paged decode against its plain version: both sum in float32 in another
# order, so f32 agrees to rounding; a bf16 output may round to the
# neighbouring bf16 value (rtol = one bf16 step, 2**-7) and the atol is a
# few times the largest difference this phase measured on an H100 (9.8e-4)
DECODE_TOL = {"f32": dict(atol=1e-5, rtol=1e-5),
              "bf16": dict(atol=4e-3, rtol=2**-7)}

# phase 5 geometry: one attention layer of minitron-4b (Hkv=8, D=128,
# Hq=24), bf16 pages of 16 tokens, 4096-token context
SERVE = dict(num_seqs=256, num_pages=32768, page_size=16,
             max_pages_per_seq=256, kv_heads=8, head_dim=128, q_heads=24,
             versions_per_slot=8, reader_lanes=16, min_len=1024,
             max_len=4096, pin_every=16, pin_hold=4, max_steps=6000,
             max_seconds=420.0, steps_after_pressure=64, seed=0)
# phase 3's flash prefill cases: the model phase's prefill (minitron-4b
# heads, bf16, causal), a gemma2-2b local layer (head dim 256, window 512,
# softcap 50) and a float32 case
FLASH = {
    "serve": dict(B=16, Hq=24, Hkv=8, T=2048, D=128, window=0, softcap=0.0,
                  dtype="bf16"),
    "gemma2_local": dict(B=16, Hq=8, Hkv=4, T=2048, D=256, window=512,
                         softcap=50.0, dtype="bf16"),
    "f32": dict(B=4, Hq=24, Hkv=8, T=2048, D=128, window=0, softcap=0.0,
                dtype="f32"),
}
# phase 6: the launcher's flags (minitron-4b at full width, no --reduced)
MODEL_ARGS = ["--arch", "minitron-4b", "--batch", "16", "--prompt-len",
              "2048", "--max-len", "4096", "--steps", "64", "--pin-every",
              "8", "--gc-policy", "slrt", "--dtype",
              "bfloat16", "--device", "cuda"]
STORM = dict(num_seqs=8, num_pages=24, page_size=4, max_pages_per_seq=3,
             versions_per_seq=6, steps=160, min_len=4, max_len=12,
             pin_every=5, pin_hold=3, seed=0)
KERNELS = {
    "compact": ("src/repro_torch/csrc/compact.cu",
                "src/repro/kernels/compact/kernel.py:144"),
    "search_gather": ("src/repro_torch/csrc/version_search.cu",
                      "src/repro/kernels/version_search/kernel.py:140"),
    "search": ("src/repro_torch/csrc/version_search.cu",
               "src/repro/kernels/version_search/kernel.py:66"),
    "paged_decode": ("src/repro_torch/csrc/paged_decode.cu",
                     "src/repro/kernels/decode_attention/kernel.py:114"),
    "flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_prefill/kernel.py:125"),
}
WRAPPERS = {"compact": compact_ops.compact,
            "search_gather": search_ops.search_gather,
            "search": search_ops.search,
            "paged_decode": decode_ops.paged_decode,
            "flash_prefill": flash_ops.flash_attention}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _is_device(event) -> bool:
    return str(event.device_type).endswith("CUDA")


def time_call(fn, reps: int = 25, warmup: int = 3) -> dict:
    """Two times of one call, each the median of ``reps`` calls:
    ``call_ms`` between CUDA events around the call (it includes the
    host's time to issue the launches, which dominates a microsecond
    kernel), and ``device_ms``, the summed duration of the kernels the call
    ran on the card, from the profiler's kernel records."""
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
    per_call = []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        per_call.append(sum(e.time_range.elapsed_us() for e in prof.events()
                            if _is_device(e)) / 1e3)
    return {"call_ms": statistics.median(times),
            "device_ms": statistics.median(per_call)}


def timed(kernel, plain, library=None) -> dict:
    """The phase-3 timing keys: ``ms``/``plain_ms``/``library_ms`` are
    device times; the ``*call_ms`` keys are the event times per call."""
    k, p = time_call(kernel), time_call(plain)
    out = {"ms": k["device_ms"], "plain_ms": p["device_ms"],
           "call_ms": k["call_ms"], "plain_call_ms": p["call_ms"],
           "library_ms": None, "library_call_ms": None}
    if library is not None:
        lib = time_call(library)
        out.update(library_ms=lib["device_ms"],
                   library_call_ms=lib["call_ms"])
    return out


def bound(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------
def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds,
          "library": os.path.relpath(_build.BUILD / _build.LIB_NAME, ROOT)})


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at phase 5's shapes
# ---------------------------------------------------------------------------
def _store(gen, S, V, dev, first_ts=1, span=4000):
    """Version slabs with distinct timestamps per slot, closed and current
    intervals and free entries."""
    ts = torch.full((S, V), EMPTY, dtype=torch.int32)
    succ = torch.full((S, V), TS_MAX, dtype=torch.int32)
    n_live = torch.randint(0, V + 1, (S,), generator=gen)
    for s in range(S):
        n = int(n_live[s])
        stamps = torch.sort(torch.randperm(span, generator=gen)[:n]).values \
            + first_ts
        pos = torch.randperm(V, generator=gen)[:n]
        ts[s, pos] = stamps.to(torch.int32)
        succ[s, pos[:-1]] = stamps[1:].to(torch.int32)
    pay = torch.where(ts == EMPTY, EMPTY,
                      torch.randint(0, 2048, (S, V), generator=gen,
                                    dtype=torch.int32))
    return ts.to(dev), succ.to(dev), pay.to(dev)


def phase_kernels(dev) -> dict:
    g = torch.Generator().manual_seed(1)
    gd = torch.Generator(device=dev).manual_seed(1)
    p = SERVE
    S, V, P = p["num_seqs"], p["versions_per_slot"], p["reader_lanes"]
    max_ver = S * V
    ring = 2 * max_ver                        # make_paged_kv's ring size
    out = {}

    # K1 compact: the slrt flush sweep touches one row per ring entry
    for R, main_shape in ((ring, True), (ring - 3, False)):
        ts, succ, pay = _store(g, R, V, dev)
        mask = (torch.rand((R,), generator=g) < 0.8).to(dev)
        ann = torch.randint(0, 4000, (P,), generator=g, dtype=torch.int32)
        ann[torch.rand((P,), generator=g) < 0.5] = TS_MAX
        ann = torch.sort(ann).values.to(dev)
        now = torch.tensor(4000, dtype=torch.int32, device=dev)
        args = (ts, succ, pay, mask, ann, now)
        got = compact_ops.compact(*args)
        want = compact_ref(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"compact kernel != plain version at R={R}")
        check(int(got[4]) > 0, "compact killed nothing: weak check")
        if main_shape:
            nbytes = R * V * 4 * 3 + R + P * 4 + 4 + R * V * 4 * 4 + 4
            b_ms, b_by = bound(nbytes, R * V * (math.log2(P) + 8), "int32")
            out["compact"] = dict(
                shape=f"R={R} V={V} P={P}", max_abs_err=max_err(got, want),
                bound_ms=b_ms, bound_by=b_by,
                **timed(lambda: compact_ops.compact(*args),
                        lambda: compact_ref(*args)))

    # K2 / K3: snapshot_view's search+gather over all 256 sequences
    ts, _, pay = _store(g, S, V, dev)
    tables = torch.full((max_ver, p["max_pages_per_seq"]), -1,
                        dtype=torch.int32)
    ps, ctx = p["page_size"], p["page_size"] * p["max_pages_per_seq"]
    lens = torch.randint(0, ctx + 1, (max_ver,), generator=g,
                         dtype=torch.int32)
    for r in range(max_ver):
        n = (int(lens[r]) + ps - 1) // ps
        tables[r, :n] = torch.randint(0, p["num_pages"], (n,), generator=g,
                                      dtype=torch.int32)
    values = torch.cat([tables, lens[:, None]], dim=1).to(dev)
    ids = torch.arange(S, dtype=torch.int32, device=dev)
    t = torch.full((S,), 2000, dtype=torch.int32, device=dev)
    got = search_ops.search_gather(ts, pay, values, ids, t)
    want = search_gather_ref(ts, pay, values, ids, t)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "search_gather kernel != plain version")
    check(bool((got[0] == -1).any()) and not bool(got[2].all()),
          "search_gather check lacks -1 padding or not-found rows")
    M = values.shape[1]
    found = int(got[2].sum())
    nbytes = S * 4 * 2 + S * V * 4 * 2 + found * M * 4 + S * (M * 4 + 5)
    b_ms, b_by = bound(nbytes, S * V * 2, "int32")
    out["search_gather"] = dict(
        shape=f"B={S} V={V} M={M} T={max_ver}", max_abs_err=max_err(got, want),
        bound_ms=b_ms, bound_by=b_by,
        **timed(lambda: search_ops.search_gather(ts, pay, values, ids, t),
                lambda: search_gather_ref(ts, pay, values, ids, t)))
    got = search_ops.search(ts, pay, ids, t)
    want = search_ref(ts, pay, ids, t)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "search kernel != plain version")
    nbytes = S * 4 * 2 + S * V * 4 * 2 + S * 5
    b_ms, b_by = bound(nbytes, S * V * 2, "int32")
    out["search"] = dict(
        shape=f"B={S} V={V}", max_abs_err=max_err(got, want),
        bound_ms=b_ms, bound_by=b_by,
        **timed(lambda: search_ops.search(ts, pay, ids, t),
                lambda: search_ref(ts, pay, ids, t)))

    # K4 paged decode over a snapshot-view-shaped table: -1 padding past
    # each length, length-0 rows, distinct pages per sequence
    B, MP, PS = S, p["max_pages_per_seq"], p["page_size"]
    N, Hkv, D, Hq = p["num_pages"], p["kv_heads"], p["head_dim"], p["q_heads"]
    lengths = torch.randint(0, MP * PS + 1, (B,), generator=g,
                            dtype=torch.int32)
    lengths[:8] = 0
    perm = torch.randperm(N, generator=g).to(torch.int32)
    table = torch.full((B, MP), -1, dtype=torch.int32)
    cursor = 0
    for b in range(B):
        n = (int(lengths[b]) + PS - 1) // PS
        if cursor + n > N:
            lengths[b], n = 0, 0
        table[b, :n] = perm[cursor:cursor + n]
        cursor += n
    table, lengths = table.to(dev), lengths.to(dev)
    visible = int(lengths.sum())
    for dtype, kind in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        tol = DECODE_TOL[kind]
        kp = torch.randn((N, PS, Hkv, D), generator=gd, device=dev,
                         dtype=dtype)
        vp = torch.randn((N, PS, Hkv, D), generator=gd, device=dev,
                         dtype=dtype)
        q = torch.randn((B, Hq, D), generator=gd, device=dev, dtype=dtype)
        got = decode_ops.paged_decode(q, kp, vp, table, lengths)
        want = paged_decode_ref(q, kp, vp, table, lengths)
        torch.cuda.synchronize()
        err = max_err([got], [want])
        check(bool(torch.isfinite(got.float()).all()), "decode not finite")
        check(torch.allclose(got.float(), want.float(), **tol),
              f"paged_decode {kind} differs from plain version (max {err})")
        check(bool((got[lengths == 0] == 0).all()), "length-0 rows not 0")
        again = decode_ops.paged_decode(q, kp, vp, table, lengths)
        check(torch.equal(got, again), "paged_decode not deterministic")
        if kind != "bf16":
            emit({"phase": "kernels", "check": "paged_decode_f32",
                  "max_abs_err": err, **tol})
            del kp, vp
            torch.cuda.empty_cache()
            continue
        elt = 2
        nbytes = (2 * B * Hq * D * elt + B * 4 + int((table >= 0).sum()) * 4
                  + visible * Hkv * D * elt * 2)
        b_ms, b_by = bound(nbytes, 4.0 * visible * Hq * D, "bf16")
        # yardstick: SDPA over K/V gathered densely beforehand (the gather
        # is not timed), one query token, GQA, length mask
        kd = kp[table.long()].reshape(B, MP * PS, Hkv, D).transpose(1, 2)
        vd = vp[table.long()].reshape(B, MP * PS, Hkv, D).transpose(1, 2)
        amask = (torch.arange(MP * PS, device=dev)[None, :]
                 < lengths[:, None])[:, None, None, :]
        qd = q[:, :, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        out["paged_decode"] = dict(
            shape=f"B={B} Hq={Hq} Hkv={Hkv} D={D} PS={PS} MP={MP} bf16",
            max_abs_err=err, **tol, bound_ms=b_ms, bound_by=b_by,
            **timed(lambda: decode_ops.paged_decode(q, kp, vp, table,
                                                    lengths),
                    lambda: paged_decode_ref(q, kp, vp, table, lengths),
                    lambda: sdpa(qd, kd, vd, attn_mask=amask,
                                 enable_gqa=True)))
        del kp, vp, kd, vd
        torch.cuda.empty_cache()
    out.update(flash_cases(dev))
    for name, row in out.items():
        emit({"phase": "kernels", "kernel": name, **row})
    return out


def visible_pairs(T: int, window: int) -> int:
    """(row, column) pairs a causal prefill of T tokens attends to."""
    if window <= 0:
        return T * (T + 1) // 2
    w = min(window, T)
    return w * (w + 1) // 2 + (T - w) * w


def flash_cases(dev) -> dict:
    """K6 against its plain version at phase 3's FLASH shapes; the
    "serve" case is the kernel table's row."""
    gd = torch.Generator(device=dev).manual_seed(6)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for case, c in FLASH.items():
        dtype, kind = DTYPES[c["dtype"]], c["dtype"]
        B, Hq, Hkv, T, D = c["B"], c["Hq"], c["Hkv"], c["T"], c["D"]
        kw = dict(causal=True, window=c["window"], softcap=c["softcap"])
        q = torch.randn((B, Hq, T, D), generator=gd, device=dev, dtype=dtype)
        k = torch.randn((B, Hkv, T, D), generator=gd, device=dev, dtype=dtype)
        v = torch.randn((B, Hkv, T, D), generator=gd, device=dev, dtype=dtype)
        got = flash_ops.flash_attention(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = max_err([got], [want])
        check(bool(torch.isfinite(got.float()).all()), f"flash {case} not "
              "finite")
        # DECODE_TOL's limits: both versions sum in float32 in another
        # order.  K6's own largest differences on an H100 were 3.9e-3
        # ("serve") and 7.8e-3 ("gemma2_local"), above the bf16 atol: each
        # is one bf16 rounding step of its output, which rtol = 2**-7
        # allows.  The float32 case, held to 1e-5, is the check that
        # catches a masking or indexing error.
        check(torch.allclose(got.float(), want.float(), **DECODE_TOL[kind]),
              f"flash_prefill {case} differs from plain version (max {err})")
        check(torch.equal(got, flash_ops.flash_attention(q, k, v, **kw)),
              f"flash_prefill {case} not deterministic")
        del want
        elt = 2 if dtype == torch.bfloat16 else 4
        nbytes = 2 * (B * Hq * T * D + B * Hkv * T * D) * elt
        ops = 4.0 * B * Hq * D * visible_pairs(T, c["window"])
        b_ms, b_by = bound(nbytes, ops, kind)
        # yardstick: SDPA (causal, GQA) where it computes the same function;
        # it has no logit softcap or window flag
        library = None
        if c["window"] == 0 and c["softcap"] == 0:
            def library():
                return sdpa(q, k, v, is_causal=True, enable_gqa=True)
        rows["flash_prefill" if case == "serve" else f"flash_prefill_{case}"] \
            = dict(shape=f"B={B} Hq={Hq} Hkv={Hkv} T={T} D={D} "
                         f"window={c['window']} softcap={c['softcap']} {kind}",
                   max_abs_err=err, **DECODE_TOL[kind], bound_ms=b_ms,
                   bound_by=b_by,
                   **timed(lambda: flash_ops.flash_attention(q, k, v, **kw),
                           lambda: attention_ref(q, k, v, **kw), library))
        del q, k, v, got
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 4: the serve_bench storm tier on the card
# ---------------------------------------------------------------------------
def storm_cell(policy: str, dev) -> dict:
    p = STORM
    B, ps = p["num_seqs"], p["page_size"]
    eng = PagedKVEngine(B, p["num_pages"], ps, p["max_pages_per_seq"], 1, 4,
                        gc=GCConfig(policy=policy,
                                    versions_per_slot=p["versions_per_seq"],
                                    reader_lanes=4),
                        dtype=torch.float32, device=dev)
    rng = random.Random(p["seed"])
    targets = [rng.randrange(p["min_len"], p["max_len"] + 1) for _ in range(B)]
    cur = [0] * B
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    ones = torch.ones(B, dtype=torch.bool, device=dev)
    tokens = violations = 0
    pins, next_lane = {}, 0

    def checksum(tbl, ln):
        k = eng.st.k_pages[:, :, 0, 0].cpu().numpy()
        tbl, ln = tbl.cpu().numpy(), ln.cpu().numpy()
        return tuple(tuple(float(k[tbl[s, i // ps], i % ps])
                           for i in range(int(ln[s]))) for s in range(B))

    def drain():
        free = eng.st.free.cpu().numpy()
        return sum(not free[h] for h in eng.freed_pages())

    for step in range(p["steps"]):
        base = torch.arange(B, dtype=torch.float32, device=dev) + B * (step + 1)
        kv = base[:, None, None].expand(B, 1, 4).contiguous()
        failed = eng.step(ids, kv, kv, ones).cpu().numpy()
        violations += drain()
        for s in range(B):
            if not failed[s]:
                tokens += 1
                cur[s] += 1
        done = np.array([cur[s] >= targets[s] for s in range(B)])
        if done.any():
            eng.reset(ids, done)
            violations += drain()
            for s in np.flatnonzero(done):
                cur[s] = 0
                targets[s] = rng.randrange(p["min_len"], p["max_len"] + 1)
        if step % p["pin_every"] == 0 and len(pins) < 4:
            lane = next_lane % 4
            next_lane += 1
            while lane in pins:
                lane = (lane + 1) % 4
            ts = eng.pin(lane)
            pins[lane] = [ts, checksum(*eng.view_at(ts)), p["pin_hold"]]
        for lane in list(pins):
            ts, ref, hold = pins[lane]
            violations += checksum(*eng.view_at(ts)) != ref
            pins[lane][2] = hold - 1
            if hold - 1 <= 0:
                eng.unpin(lane)
                del pins[lane]
    return dict(pressure_events=eng.pressure_events,
                reclaims_triggered=eng.reclaims_triggered,
                pages_reclaimed=eng.pages_reclaimed,
                peak_pages=eng.peak_pages,
                peak_pages_post_reclaim=eng.peak_pages_post_reclaim,
                give_ups=eng.give_ups, tokens_appended=tokens,
                scan_violations=violations)


def phase_storm(dev) -> None:
    with open(os.path.join(ROOT, "BENCH_serve.json")) as f:
        rows = {r["scheme"]: r for r in json.load(f)["rows"]
                if r["figure"] == "paged_kv/storm"}
    for policy in ("ebr", "steam", "dlrt", "slrt"):
        t0 = time.perf_counter()
        got = storm_cell(policy, dev)
        want = {k: rows[policy][k] for k in got}
        emit({"phase": "storm", "policy": policy, **got,
              "matches_bench_serve": got == want,
              "seconds": time.perf_counter() - t0})
        check(got == want, f"storm/{policy} counters {got} != {want}")


# ---------------------------------------------------------------------------
# phase 5: full-size serving
# ---------------------------------------------------------------------------
def phase_serve(dev) -> dict:
    p = SERVE
    B, Hkv, D, Hq = p["num_seqs"], p["kv_heads"], p["head_dim"], p["q_heads"]
    eng = PagedKVEngine(
        B, p["num_pages"], p["page_size"], p["max_pages_per_seq"], Hkv, D,
        gc=GCConfig(policy="slrt", versions_per_slot=p["versions_per_slot"],
                    reader_lanes=p["reader_lanes"]),
        dtype=torch.bfloat16, device=dev)
    lo = max(1, int(eng.gc.page_watermark * p["num_pages"]))
    rng = random.Random(p["seed"])
    gen = torch.Generator(device=dev).manual_seed(p["seed"])
    targets = np.array([rng.randrange(p["min_len"], p["max_len"] + 1)
                        for _ in range(B)])
    cur = np.zeros(B, np.int64)
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    ones = torch.ones(B, dtype=torch.bool, device=dev)
    tokens = completed = pins = views_checked = violations = decodes = 0
    readers = {}
    pressure_step = None

    def decode(view, q):
        return decode_ops.paged_decode(q, eng.st.k_pages, eng.st.v_pages,
                                       *view)

    def decode_step() -> int:
        """One token for every sequence; finished ones reset."""
        k = torch.randn((B, Hkv, D), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        v = torch.randn((B, Hkv, D), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        failed = eng.step(ids, k, v, ones).cpu().numpy()
        cur[:] += ~failed
        done = cur >= targets
        if done.any():
            eng.reset(ids, done)
            cur[done] = 0
            targets[done] = [rng.randrange(p["min_len"], p["max_len"] + 1)
                             for _ in range(int(done.sum()))]
        return int((~failed).sum()), int(done.sum())

    for w in WRAPPERS.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step = 0
    while step < p["max_steps"]:
        appended, finished = decode_step()
        tokens += appended
        completed += finished
        if pressure_step is None and eng.peak_pages > p["num_pages"] - lo:
            pressure_step = step        # the pool crossed its watermark
        if step % p["pin_every"] == 0:
            lane = pins % p["reader_lanes"]
            ts = eng.pin(lane)
            view = eng.view_at(ts)
            # the descriptor read (search, K3) must name the table versions
            # whose rows the fused view gathered
            pay, found = vstore.snapshot_read(eng.st.mv, ids, ts)
            rows = eng.st.tables[pay.clamp(min=0).long()]
            check(torch.equal(torch.where(found[:, None], rows, -1), view[0]),
                  "snapshot_read disagrees with the fused view")
            q = torch.randn((B, Hq, D), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            readers[lane] = [ts, view, q, decode(view, q), p["pin_hold"]]
            pins += 1
            decodes += 1
        for lane in list(readers):
            ts, view, q, out, hold = readers[lane]
            now = eng.view_at(ts)
            views_checked += 1
            same = all(torch.equal(a, b) for a, b in zip(now, view))
            readers[lane][4] = hold - 1
            if hold - 1 <= 0:
                again = decode(now, q)
                decodes += 1
                same = same and torch.equal(again, out)
                check(bool(torch.isfinite(again.float()).all()),
                      "decode output not finite")
                eng.unpin(lane)
                del readers[lane]
            violations += not same
        step += 1
        if pressure_step is not None \
                and step > pressure_step + p["steps_after_pressure"]:
            break
        if time.perf_counter() - t0 > p["max_seconds"]:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    for lane in list(readers):
        eng.unpin(lane)
    res = dict(phase="serve", steps=step, seconds=wall,
               tokens_appended=tokens, tokens_per_s=tokens / wall,
               ms_per_step=wall / step * 1e3,
               sequences_completed=completed, snapshot_pins=pins,
               views_checked=views_checked, decodes=decodes,
               pool_watermark_crossed_at_step=pressure_step,
               pressure_events=eng.pressure_events,
               reclaims_triggered=eng.reclaims_triggered,
               pages_reclaimed=eng.pages_reclaimed,
               peak_pages=eng.peak_pages,
               peak_pages_post_reclaim=eng.peak_pages_post_reclaim,
               give_ups=eng.give_ups, violations=violations,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches)
    emit(res)
    check(pressure_step is not None,
          f"page pool never crossed its watermark in {step} steps")
    check(violations == 0, f"{violations} pinned-view violations")
    check(eng.pages_reclaimed > 0, "no page was reclaimed")
    for name in ("compact", "search_gather", "search", "paged_decode"):
        check(launches[name] > 0, f"{name} kernel never launched in serve")
    check(launches["flash_prefill"] == 0, "flash prefill ran in paged serve")
    profile_window(decode_step)
    return launches


def profile_window(decode_step, steps: int = 16, name: str = "serve") -> dict:
    """Where a serving step's time goes: device kernel time against wall
    time over a few more decode steps (torch.profiler; the full table goes
    to build/{name}_profile.txt).  Emits the summary and returns it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            decode_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device busy time: the union of the kernels' intervals on the card
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if _is_device(e))
    busy_us, reach = 0.0, float("-inf")
    for a, b in spans:
        if b > reach:
            busy_us += b - max(a, reach)
            reach = b
    per_kernel = {}
    for e in prof.events():
        if _is_device(e):
            n, t = per_kernel.get(e.name, (0, 0.0))
            per_kernel[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:10]
    # host waits on the card: each read of a device value back to the
    # host (and the window's closing synchronize) is one such call
    syncs = sum(1 for e in prof.events() if not _is_device(e)
                and e.name in ("cudaStreamSynchronize",
                               "cudaDeviceSynchronize"))
    ours = {k: [n, t / 1e3] for k, (n, t) in per_kernel.items()
            if any(f in k for f in ("compact_kernel", "search_kernel",
                                    "paged_decode_kernel",
                                    "flash_prefill_kernel"))}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", f"{name}_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                          row_limit=40))
    res = {"phase": f"{name}_profile", "steps": steps, "wall_ms": wall * 1e3,
           "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1 - busy_us / 1e3 / (wall * 1e3),
           "kernel_launches": sum(n for n, _ in per_kernel.values()),
           "host_syncs": syncs,
           "port_kernels_ms": ours,
           "top_device_ms": [[k, n, t / 1e3] for k, (n, t) in top]}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase 6: minitron-4b served at full width through the port's launcher
# ---------------------------------------------------------------------------
def phase_model(dev) -> dict:
    args = launcher.parse_args(MODEL_ARGS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, engine, prompt = launcher.build(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    B, T = prompt.shape
    check(cfg.num_layers == 32 and cfg.d_model == 3072 and cfg.hd == 128,
          "minitron-4b is not at its published widths")

    # two prefills of the same prompt give the same bits (and warm up)
    st = engine.state
    outs = []
    for _ in range(2):
        logits, cache, _ = tf.prefill(st.params, cfg, prompt, st.cache,
                                      inplace=True)
        outs.append((logits.clone(), cache[-1].k[:, :T].clone(),
                     cache[-1].v[:, :T].clone()))
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    check(same, "two prefills of the same prompt gave different bits")
    del outs, logits, cache

    for w in WRAPPERS.values():
        w.launches = 0
    rep = launcher.serve(engine, prompt, steps=args.steps,
                         pin_every=args.pin_every, log=lambda line: None)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    prof = profile_window(engine.step, steps=8, name="model")
    toks = rep["tokens"]
    res = dict(
        phase="model", arch=cfg.name, layers=cfg.num_layers,
        d_model=cfg.d_model, parameters=cfg.param_count(), dtype=args.dtype,
        batch=B, prompt_len=T, max_len=args.max_len, steps=args.steps,
        policy=args.gc_policy, build_s=build_s,
        prefill_ms=rep["prefill_s"] * 1e3,
        prefill_tokens_per_s=B * T / rep["prefill_s"],
        decode_ms_per_step=rep["decode_s"] / args.steps * 1e3,
        decode_tokens_per_s=B * args.steps / rep["decode_s"],
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        profile_device_idle_share=prof["device_idle_share"],
        profile_device_busy_ms_per_step=prof["device_busy_ms"] / prof["steps"],
        profile_host_syncs_per_step=prof["host_syncs"] / prof["steps"],
        launches=launches, flash_launches_per_prefill=launches[
            "flash_prefill"], readers=rep["readers"],
        score_mismatches=rep["score_mismatches"],
        prefill_bits_equal=same, stats_sum=rep["stats_sum"],
        space=rep["space"], tokens_head=toks[:2, :8].tolist())
    emit(res)
    check(tuple(toks.shape) == (B, args.steps), "wrong token shape")
    check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          "a token outside [0, vocab)")
    check(launches["flash_prefill"] == cfg.num_layers,
          f"flash prefill launched {launches['flash_prefill']} times in one "
          f"prefill of {cfg.num_layers} layers")
    for name in ("compact", "search"):
        check(launches[name] > 0, f"{name} kernel never launched in model")
    check(rep["readers"] == min(-(-args.steps // args.pin_every),
                                launcher.READER_LANES),
          "fewer readers than pinned")
    check(rep["score_mismatches"] == 0,
          f"{rep['score_mismatches']} pinned scores changed under decode")
    return launches


def main() -> int:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kernels = phase_kernels(dev)
    phase_storm(dev)
    launches = phase_serve(dev)
    torch.cuda.empty_cache()
    model_launches = phase_model(dev)
    table = []
    for name, (source, replaces) in KERNELS.items():
        row = kernels[name]
        # the count from the main path that runs the kernel: phase 5 for
        # K1-K4 (paged serving), phase 6 for flash prefill (the model)
        table.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=(model_launches if name == "flash_prefill"
                      else launches)[name],
            launches_model=model_launches[name],
            max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    print(smi, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
