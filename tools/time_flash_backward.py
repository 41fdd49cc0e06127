#!/usr/bin/env python3
"""Time K6b (``flash_attention_backward``) of one checkout of the port on
the GPU in both routes, so that two checkouts can be compared on one card
in one run (parent, change, change, parent).

    python3 tools/time_flash_backward.py [--root DIR] [--label NAME]

``--root`` is the checkout whose ``src/repro_torch`` is imported and built
(default: the one holding this script).  The cases are ``chip_smoke.py``'s
phase-3 K6b shapes (:data:`CASES`, its ``FLASH_BWD``, the same names).
For each case and dtype the inputs are drawn on the card from the case's
seed (100 plus its place in :data:`CASES`), K6 (``_launch`` with the row
LSE, the forward the backward reads) gives ``o`` and ``lse``, and K6b's
(dq, dk, dv) are held to the checkout's plain version
(``attention_bwd_ref``): float32 within ``chip_smoke.py``'s
``FLASH_BWD_TOL`` (atol and rtol 1e-4), bf16 within
``ref.bwd_bf16_margin`` of this script's checkout (``margin``, at most 1),
whichever checkout is timed.  One JSON line per case and dtype: the card
(``nvidia-smi``'s name and power limit), the route the checkout ran,
``time_search_needed.time_call``'s keys for K6b (medians of 25) and for K6
with its LSE (``k6_call_ms``, ``k6_device_ms``, ``k6_kernels``), and a
digest of the bytes of each output (``digest_dq``, ``digest_dk``,
``digest_dv``; K6's ``digest_o``, ``digest_lse``): equal digests in two
checkouts mean bit-equal outputs.  Exits 1 if a case is off its limit.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from time_search_needed import time_call  # noqa: E402

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# chip_smoke.py's FLASH_BWD (tests/test_torch_roofline.py holds the two
# equal): B, Hq, Hkv, T, D, window, softcap and, where not T and causal,
# S and causal
CASES = {
    "gemma2_train": dict(B=1, Hq=8, Hkv=4, T=4096, D=256, window=4096,
                         softcap=50.0),
    "gemma2_window512": dict(B=1, Hq=8, Hkv=4, T=4096, D=256, window=512,
                             softcap=50.0),
    "minitron": dict(B=4, Hq=24, Hkv=8, T=2048, D=128, window=0,
                     softcap=0.0),
    "whisper_cross": dict(B=16, Hq=6, Hkv=6, T=64, S=1500, D=64, window=0,
                          softcap=0.0, causal=False),
    "granite_placed_train": dict(B=1, Hq=8, Hkv=4, T=2048, D=64, window=0,
                                 softcap=0.0),
    "whisper_encoder_placed_train": dict(B=1, Hq=3, Hkv=3, T=1500, S=1500,
                                         D=64, window=0, softcap=0.0,
                                         causal=False),
    "whisper_cross_placed_train": dict(B=1, Hq=3, Hkv=3, T=448, S=1500,
                                       D=64, window=0, softcap=0.0,
                                       causal=False),
    "recurrentgemma_placed_train": dict(B=1, Hq=8, Hkv=1, T=1024, D=256,
                                        window=2048, softcap=0.0),
}
TOL_F32 = dict(atol=1e-4, rtol=1e-4)   # chip_smoke.py's FLASH_BWD_TOL
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def digest(t: torch.Tensor) -> str:
    """The first 16 hex digits of the SHA-256 of ``t``'s bytes."""
    raw = t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def own_margin():
    """``bwd_bf16_margin`` of the checkout that holds this script, loaded
    from its file (it imports only ``math`` and ``torch``), so that every
    checkout timed is held to the same limit."""
    spec = importlib.util.spec_from_file_location(
        "_bf16_limit", os.path.join(HERE, "src", "repro_torch", "kernels",
                                    "flash_prefill", "ref.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.bwd_bf16_margin


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    if not torch.cuda.is_available():
        raise SystemExit("time_flash_backward: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_prefill import ops as flash_ops
    from repro_torch.kernels.flash_prefill.ref import attention_bwd_ref
    _build.build()   # or reuse a library newer than every source
    margin_of = own_margin()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    label = args.label or os.path.abspath(args.root)
    failed = []
    for seed, (case, c) in enumerate(CASES.items(), 100):
        B, Hq, Hkv, T, D = c["B"], c["Hq"], c["Hkv"], c["T"], c["D"]
        S, causal = c.get("S", T), c.get("causal", True)
        window, cap = c["window"], c["softcap"]
        kw = dict(causal=causal, window=window, softcap=cap)
        for name, dtype in DTYPES.items():
            gen = torch.Generator(device=dev).manual_seed(seed)
            q, k, v, do = (torch.randn(shape, generator=gen, device=dev
                                       ).to(dtype)
                           for shape in ((B, Hq, T, D), (B, Hkv, S, D),
                                         (B, Hkv, S, D), (B, Hq, T, D)))
            o, lse = flash_ops._launch(q, k, v, causal, window, cap,
                                       lse=True)
            k6 = time_call(lambda: flash_ops._launch(q, k, v, causal, window,
                                                     cap, lse=True))

            def kernel():
                return flash_ops.flash_attention_backward(q, k, v, o, do,
                                                          lse, **kw)

            got = kernel()
            want = attention_bwd_ref(q, k, v, o, do, lse, **kw)
            err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, want))
            row = dict(label=label, card=smi, case=case, dtype=name,
                       route=flash_ops.BWD_ROUTES[dtype],
                       shape=f"B={B} Hq={Hq} Hkv={Hkv} T={T} S={S} D={D} "
                             f"causal={causal} window={window} "
                             f"softcap={cap}",
                       max_abs_err=err)
            if dtype == torch.float32:
                ok = all(torch.allclose(g, w, **TOL_F32)
                         for g, w in zip(got, want))
            else:
                row["margin"] = margin_of(got, want, q, k, v, o, do, lse,
                                          **kw)
                ok = row["margin"] <= 1.0
            del want
            row.update({f"digest_{x}": digest(t) for x, t in
                        zip(("dq", "dk", "dv", "o", "lse"),
                            (*got, o, lse))})
            row.update(time_call(kernel))
            row.update({f"k6_{key}": val for key, val in k6.items()})
            row["ok"] = ok
            if not ok:
                failed.append(f"{case} {name}")
            print(json.dumps(row), flush=True)
            del q, k, v, do, o, lse, got
            torch.cuda.empty_cache()
    if failed:
        print(f"time_flash_backward: off the limit ({label}): "
              + ", ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
