"""Training driver (port of ``repro.launch.train``): data -> train_step ->
checkpoints, with the fault-tolerance loop (watchdog, heartbeat,
restart from the latest checkpoint, MVGC checkpoint retention).

    CK=$(mktemp -d)
    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b \\
        --reduced --device cpu --steps 12 --ckpt-dir $CK \\
        --ckpt-every 5 --simulate-crash-at 7
    # exits 42 after step 7; the same command without --simulate-crash-at
    # prints "[restore] resumed from step 5" and continues from there

The flags are the JAX driver's, plus ``--device`` (``cuda`` by default;
there is no CPU fallback).  ``--ckpt-dir`` has no default: the launcher
resumes from the latest checkpoint it finds there, so each fresh run
names a fresh directory.  A logged loss carries 9 significant digits,
which name a float32 exactly.  The weights
are random from a generator seeded 0 on the device, in float32 as JAX's
``init_state`` makes them; the data is ``SyntheticLM``.  whisper-tiny is
refused: its forward needs frame embeddings, which ``SyntheticLM`` does
not make (the JAX driver fails there too).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch._tensor import resolve_device
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import SHAPES, RunConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist.straggler import HeartbeatFile, StepWatchdog
from repro_torch.train.step import TrainState, init_state, train_step

SEED = 0   # of the random weights, as JAX's PRNGKey(0)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", required=True,
                    help="checkpoints and heartbeat.json; a run resumes "
                         "from the latest checkpoint found here")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--simulate-crash-at", type=int, default=-1,
                    help="abort at this step (fault-tolerance demo)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.arch == "whisper-tiny":
        ap.error("whisper-tiny is an encoder-decoder: its forward needs frame "
                 "embeddings, and SyntheticLM makes tokens only (the JAX "
                 "driver fails here too)")
    return args


def build(args: argparse.Namespace):
    """(cfg, run, data, state, device) for ``args``: the initial state from
    the seeded generator on the device."""
    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], lr=args.lr,
                    microbatches=args.microbatches,
                    grad_compression=args.grad_compression)
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq_len, args.batch))
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       compression=args.grad_compression)
    return cfg, run, data, state, dev


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    cfg, run, data, state, dev = build(args)
    mgr = CheckpointManager(args.ckpt_dir)
    watchdog = StepWatchdog()
    hb = HeartbeatFile(os.path.join(args.ckpt_dir, "heartbeat.json"),
                       host_id=dist.get_rank() if dist.is_initialized()
                       else 0)
    start = 0
    latest = mgr.latest_step()
    if latest is not None:
        state_raw, extra = mgr.restore(latest, like=state, device=dev)
        state = TrainState(*state_raw)
        data.load_state_dict(extra)
        start = latest
        print(f"[restore] resumed from step {latest}", flush=True)

    for i in range(start, args.steps):
        watchdog.start()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
        state, metrics = train_step(state, batch, cfg, run)
        loss = float(metrics["loss"])         # the step's one host sync
        dt = watchdog.stop(i)
        hb.beat(i)
        if i % args.log_every == 0 or i == args.steps - 1:
            # 9 significant digits name a float32 exactly, so two runs'
            # lines are equal exactly when their losses are bit-equal
            print(f"step {i:5d}  loss {loss:.9g}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  {dt*1e3:.0f}ms",
                  flush=True)
        if args.simulate_crash_at == i:
            print(f"[crash] simulated failure at step {i}", flush=True)
            raise SystemExit(42)
        if (i + 1) % args.ckpt_every == 0 or i == args.steps - 1:
            path = mgr.save(i + 1, state, extra=data.state_dict())
            deleted = mgr.gc(keep_last=2)
            print(f"[ckpt] saved {path}"
                  + (f"; MVGC reclaimed {deleted}" if deleted else ""),
                  flush=True)
    if watchdog.suspect_steps:
        print(f"[straggler] suspect steps: {watchdog.suspect_steps}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
