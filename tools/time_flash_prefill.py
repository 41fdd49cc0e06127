#!/usr/bin/env python3
"""Time K6's float32 route (``flash_attention`` on float32 tensors) of one
checkout of the port on the GPU, so that two checkouts can be compared on
one card in one run (parent, change, change, parent), and read how far
that route and its float32 plain version are from a float64 evaluation.

    python3 tools/time_flash_prefill.py [--root DIR] [--label NAME]
                                        [--cases NAME ...]

``--root`` is the checkout whose ``src/repro_torch`` is imported and built
(default: the one holding this script).  The timed cases are
``chip_smoke.py``'s phase-3 float32 K6 shapes (:data:`CASES`, the same
names): each call's result is first held against the checkout's plain
version (``attention_ref``) within float32's ``DECODE_TOL`` (atol and rtol
1e-5), then one JSON line per case with the route the checkout ran and
``time_search_needed.time_call``'s keys (medians of 25 calls).

Then one JSON line per :data:`ACCURACY` case with three ratios, each the
largest ``|a - b| / (atol + rtol |b|)`` at that tolerance (at most 1 is
within it): ``kernel_vs_plain``, ``kernel_vs_f64`` and ``plain_vs_f64``
(b the float64 evaluation); and beside the last two, the largest ``|a -
b|`` over the limit derived from float32's rounding
(``ref.fwd_f32_rounding`` of this script's checkout, whichever checkout
is timed): ``kernel_vs_f64_limit_ratio`` (what
``tests/test_torch_gpu.py``'s
``test_flash_prefill_softcap_bends_the_logits`` checks in float32) and
``plain_vs_f64_limit_ratio``.  The cases: that test's inputs (gemma2-2b's
layer at T 512 with q scaled by 12, so that the logits, about N(0,
12^2), reach the softcap of 50; windows 0 and 200) and
``gemma2_train_f32`` as timed here.  ``--cases`` with no names times
nothing and prints only these lines.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from time_search_needed import time_call  # noqa: E402

# chip_smoke.py's FLASH float32 cases: B, Hq, Hkv, T, S, D, causal,
# window, softcap
CASES = {
    "f32": (4, 24, 8, 2048, 2048, 128, True, 0, 0.0),
    "gemma2_train_f32": (1, 8, 4, 4096, 4096, 256, True, 4096, 50.0),
    "gemma2_ring_f32": (1, 8, 4, 6144, 6144, 256, True, 4096, 50.0),
    "whisper_encoder_f32": (16, 6, 6, 1500, 1500, 64, False, 0, 0.0),
    "whisper_cross_prefill_f32": (16, 6, 6, 64, 1500, 64, False, 0, 0.0),
    "whisper_cross_decode_f32": (16, 6, 6, 1, 1500, 64, False, 0, 0.0),
    "recurrentgemma_local_f32": (16, 16, 1, 1984, 1984, 256, True, 2048,
                                 0.0),
    "granite_placed_train_f32": (1, 8, 4, 2048, 2048, 64, True, 0, 0.0),
}
# causal cases against float64: (B, Hq, Hkv, T, D, window, softcap, q
# scale, seed)
ACCURACY = {
    "softcap_bends_w0": (1, 8, 4, 512, 256, 0, 50.0, 12.0, 3),
    "softcap_bends_w200": (1, 8, 4, 512, 256, 200, 50.0, 12.0, 3),
    "gemma2_train_f32": (1, 8, 4, 4096, 256, 4096, 50.0, 1.0, 6),
}
ATOL = RTOL = 1e-5


def inputs(dev, seed, *shapes):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev) for shape in shapes]


def attention_f64(q, k, v, window, softcap):
    """Causal attention with GQA, a window and a softcap, in float64."""
    T, D = q.shape[2], q.shape[3]
    G = q.shape[1] // k.shape[1]
    logits = torch.einsum("bhtd,bhsd->bhts", q.double(),
                          k.double().repeat_interleave(G, 1)) / math.sqrt(D)
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    i = torch.arange(T, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    seen = j <= i
    if window > 0:
        seen &= j > i - window
    p = torch.softmax(logits.masked_fill(~seen, -math.inf), -1)
    return torch.einsum("bhts,bhsd->bhtd", p,
                        v.double().repeat_interleave(G, 1))


def ratio(a, b) -> float:
    return float(((a.double() - b.double()).abs()
                  / (ATOL + RTOL * b.double().abs())).max())


def derived_limit():
    """``fwd_f32_rounding`` of the checkout that holds this script, loaded
    from its file (it imports only ``math`` and ``torch``), so that every
    checkout timed is held to the same limit."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "_f32_limit", os.path.join(here, "src", "repro_torch", "kernels",
                                   "flash_prefill", "ref.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.fwd_f32_rounding


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--label", default="")
    ap.add_argument("--cases", nargs="*", default=list(CASES))
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    if not torch.cuda.is_available():
        raise SystemExit("time_flash_prefill: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_prefill import ops as flash_ops
    from repro_torch.kernels.flash_prefill.ref import attention_ref
    _build.build()   # or reuse a library newer than every source
    fwd_f32_rounding = derived_limit()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    head = dict(label=args.label or os.path.abspath(args.root), card=smi,
                route=flash_ops.ROUTES[torch.float32])
    for case in args.cases:
        B, Hq, Hkv, T, S, D, causal, window, cap = CASES[case]
        q, k, v = inputs(dev, 6, (B, Hq, T, D), (B, Hkv, S, D),
                         (B, Hkv, S, D))
        kw = dict(causal=causal, window=window, softcap=cap)
        got = flash_ops.flash_attention(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=ATOL, rtol=RTOL):
            raise SystemExit(f"time_flash_prefill {case}: max error {err} "
                             f"off the plain version ({head['label']})")
        del want
        print(json.dumps(dict(
            head, case=case,
            shape=f"B={B} Hq={Hq} Hkv={Hkv} T={T} S={S} D={D} "
                  f"causal={causal} window={window} softcap={cap}",
            max_abs_err=err,
            **time_call(lambda: flash_ops.flash_attention(q, k, v, **kw)))),
            flush=True)
        del q, k, v, got
        torch.cuda.empty_cache()
    for case, (B, Hq, Hkv, T, D, window, cap, q_scale, seed) in \
            ACCURACY.items():
        q, k, v = inputs(dev, seed, (B, Hq, T, D), (B, Hkv, T, D),
                         (B, Hkv, T, D))
        q = q * q_scale
        kw = dict(causal=True, window=window, softcap=cap)
        got = flash_ops.flash_attention(q, k, v, **kw)
        plain = attention_ref(q, k, v, **kw)
        exact = attention_f64(q, k, v, window, cap)
        limit = fwd_f32_rounding(q, k, v, **kw)
        print(json.dumps(dict(
            head, case=case, accuracy=True,
            kernel_vs_plain=ratio(got, plain),
            kernel_vs_f64=ratio(got, exact),
            plain_vs_f64=ratio(plain, exact),
            kernel_vs_f64_limit_ratio=float(
                ((got.double() - exact).abs() / limit).max()),
            plain_vs_f64_limit_ratio=float(
                ((plain.double() - exact).abs() / limit).max()))),
            flush=True)
        del q, k, v, got, plain, exact, limit
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
