#!/usr/bin/env python3
"""How far float32 rounding alone moves a phase 10e case's updates.

    python3 tools/update_sensitivity.py CASE [--layers N] [--perturb REL]
                                        [--device cpu|cuda]

Runs ``chip_smoke.py``'s one-rank step of a ``TRAIN_SHARDED`` case (at
``--layers`` where given) twice from the same seed and batches: once as
10e's reference runs it, and once with the sums in another order, either
the batch as two microbatches (the default: the same function, each
weight gradient summed in two parts) or, with ``--perturb``, every
forward product (``@`` and ``einsum``) times ``1 + REL * N(0, 1)`` (REL
2^-23 is about one float32 rounding).  Holds the second run's
``SHARDED_LEAVES`` to the first by ``check_train_sharded``'s update rule
(each held entry's change within ``SHARDED_UPDATE_RTOL`` of the first
run's; every entry within twice the rates' sum) and prints, one JSON
object a line, each leaf's held entries, how many exceed the rule, the
largest relative error among them and the largest absolute error.  On the
CPU the runs take one thread each; ``--device cuda`` runs them on the
card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as c  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.dist.sharding import _paths  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.step import init_state, train_step  # noqa: E402


def _leaves(tree, names) -> dict:
    return {"/".join(p): x.detach().float().cpu().numpy().copy()
            for p, x in _paths(tree) if "/".join(p) in names}


def one_rank(case: str, dev, microbatches: int = 1, perturb: float = 0.0
             ) -> dict:
    """The case's one-rank run: its held leaves at the start and after the
    run, the second moments, the rates' sum and the losses."""
    p = c.TRAIN_SHARDED[case]
    cfg = c._sharded_config(case)
    run = dataclasses.replace(c._sharded_run(case, cfg),
                              microbatches=microbatches)
    names = c.SHARDED_LEAVES[case]
    real = torch.Tensor.__matmul__, torch.einsum
    if perturb:
        gen = torch.Generator(device=dev).manual_seed(1)

        def noisy(y):
            return y * (1 + perturb * torch.randn(
                y.shape, generator=gen, device=y.device, dtype=y.dtype))
        torch.Tensor.__matmul__ = lambda a, b: noisy(real[0](a, b))
        torch.einsum = lambda *a, **k: noisy(real[1](*a, **k))
    try:
        state = init_state(cfg, torch.Generator(device=dev).manual_seed(
            p["seed"]))
        p0 = _leaves(state.params, names)
        data = SyntheticLM(DataConfig(cfg.vocab_size, p["seq_len"],
                                      p["batch"]))
        rates, losses = 0.0, []
        for i in range(p["steps"]):
            rates += float(adamw.cosine_schedule(state.opt.step,
                                                 base_lr=run.lr))
            state, m = train_step(state, c._sharded_batch(
                data, dev, case, cfg, i), cfg, run)
            losses.append(float(m["loss"]))
    finally:
        torch.Tensor.__matmul__, torch.einsum = real
    return {"p0": p0, "param": _leaves(state.params, names),
            "nu": _leaves(state.opt.nu, names), "rates": rates,
            "losses": losses}


def compare(a: dict, b: dict) -> list:
    """Each held leaf of ``b`` against ``a`` by 10e's update rule."""
    out = []
    for name, p0 in a["p0"].items():
        dw, dg = a["param"][name] - p0, b["param"][name] - p0
        nu = a["nu"][name]
        err = np.abs(dg - dw)
        spacing = 4 * np.finfo(np.float32).eps * np.abs(p0)
        big = ((np.abs(dw) >= 0.5 * a["rates"])
               & (np.sqrt(nu) >= c.SHARDED_GRAD_SHARE * np.sqrt(nu.max())))
        over = big & (err > c.SHARDED_UPDATE_RTOL * np.abs(dw) + spacing)
        out.append({"leaf": name, "held": int(big.sum()),
                    "over_rtol": int(over.sum()),
                    "max_rel": float((err[big] / np.abs(dw[big])).max())
                    if big.any() else 0.0,
                    "max_abs": float(err.max()),
                    "twice_rates": 2 * a["rates"],
                    "over_twice_rates": int(
                        (err > 2 * a["rates"] + spacing).sum())})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("case", choices=sorted(c.TRAIN_SHARDED))
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--perturb", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        c._build.lib()
    else:
        torch.set_num_threads(1)
    if args.layers is not None:
        c.TRAIN_SHARDED[args.case] = dict(c.TRAIN_SHARDED[args.case],
                                          layers=args.layers)
    a = one_rank(args.case, dev)
    b = one_rank(args.case, dev, microbatches=1 if args.perturb else 2,
                 perturb=args.perturb)
    print(json.dumps({"case": args.case,
                      "layers": c.TRAIN_SHARDED[args.case]["layers"],
                      "second_run": (f"perturb {args.perturb}"
                                     if args.perturb else "2 microbatches"),
                      "device": (torch.cuda.get_device_name(0)
                                 if dev.type == "cuda" else "cpu"),
                      "losses": a["losses"], "second_losses": b["losses"]}))
    for row in compare(a, b):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
