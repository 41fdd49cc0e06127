"""Serving driver: MVServeEngine with a batch of requests and snapshot
readers (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b \\
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b \\
        --batch 16 --prompt-len 2048 --max-len 4096 --steps 64 \\
        --dtype bfloat16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
        --reduced --device cpu --prompt-len 8 --steps 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \\
        --reduced --device cpu --steps 1

Every decoder-only family runs: dense (minitron-4b, qwen2.5-32b,
starcoder2-7b), local ring caches (gemma2-2b), mixtures of experts
(granite-moe-1b-a400m, deepseek-moe-16b), the recurrent ones
(recurrentgemma-9b's RG-LRU, xlstm-125m's mLSTM/sLSTM) and internvl2-2b
(without patches, as the JAX launcher runs it).  whisper-tiny is refused:
``MVServeEngine.prefill`` takes no frames, in the JAX package too (trap
C13), so an encoder-decoder is served through ``prefill_step`` and
``decode_one`` only.

The flags are the JAX driver's, plus ``--device`` (``cuda`` by default)
and ``--dtype`` (of the weights and the KV cache).  Weights are random,
drawn from a ``torch.Generator`` on the device seeded with ``SEED``, and so
is the prompt; nothing is downloaded.

After the prefill, every ``--pin-every`` steps a snapshot reader pins the
clock (one per reader lane, up to ``READER_LANES``; the JAX driver stops at
4 of its 8) and scores the batch's next tokens
against its snapshot (``snapshot_score``).  At the end each reader reads its
snapshot lengths (``lengths_at``), scores the same tokens again — the two
results must be bit-identical, since decode never changes what a pinned
snapshot sees — and unpins.  Two JAX faults break that rule, in both
packages alike, and the failure names them: a local ring that wraps under
a pinned reader (trap C10), and any recurrent layer, whose state is not
versioned (trap C12: a pinned reader scores against the newest state).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch._tensor import resolve_device
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ModelConfig, RunConfig, SHAPES
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import MVServeEngine

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SEED = 0   # of the random weights and the prompt, as in the JAX driver
READER_LANES = 8   # as in the JAX driver
VERSIONS_PER_SLOT = 16   # as in the JAX driver
RECURRENT_KINDS = ("rglru", "mlstm", "slstm")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--gc-policy", default="slrt",
                    choices=["slrt", "dlrt", "steam", "ebr", "sweep"])
    ap.add_argument("--pin-every", type=int, default=8,
                    help="start a snapshot reader every N steps")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """(cfg, engine, prompt) for ``args``: random weights and a random
    prompt from ``SEED``."""
    cfg: ModelConfig = (reduced_config(args.arch) if args.reduced
                        else get_config(args.arch))
    if cfg.encoder_layers:
        raise SystemExit(
            f"{cfg.name} is an encoder-decoder: MVServeEngine.prefill takes "
            "no frame embeddings, in the JAX package too (trap C13: JAX's "
            "fails on None), so this launcher cannot serve it; use "
            "prefill_step(frontend_embeds=) and decode_one(enc_out=)")
    dev = resolve_device(args.device)
    run = RunConfig(model=cfg, shape=SHAPES["decode_32k"],
                    gc_policy=args.gc_policy,
                    versions_per_slot=VERSIONS_PER_SLOT,
                    reader_lanes=READER_LANES)
    dtype = DTYPES[args.dtype]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = tf.init_params(cfg, gen, dtype)
    engine = MVServeEngine(cfg, run, params, batch=args.batch,
                           max_len=args.max_len, dtype=dtype, device=dev)
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    ).to(dev)
    return cfg, engine, prompt


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(engine: MVServeEngine, prompt: torch.Tensor, *, steps: int,
          pin_every: int, log: Callable[[str], None] = print) -> dict:
    """Prefill ``prompt``, decode ``steps`` tokens with snapshot readers
    (at most one per reader lane), and report what happened: wall times,
    tokens, the readers' score mismatches (must be 0) and the store's space
    report."""
    dev = engine.device
    B, T = prompt.shape
    _sync(dev)
    t0 = time.perf_counter()
    engine.prefill(prompt)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    log(f"[prefill] {B}x{T} in {prefill_s:.3f}s")

    readers = {}          # lane -> (ts, scored tokens, logits)
    tokens = []
    step_s = 0.0
    stats_sum = {}
    for i in range(steps):
        t0 = time.perf_counter()
        toks = engine.step()   # ends in a host read of the step's stats
        step_s += time.perf_counter() - t0
        tokens.append(toks)
        for k, v in engine.last_stats.items():
            stats_sum[k] = stats_sum.get(k, 0) + v
        if pin_every and i % pin_every == 0 \
                and len(readers) < engine.run.gc.reader_lanes:
            lane = len(readers)
            ts = engine.pin(lane)
            cand = engine.state.last_tokens.clone()
            readers[lane] = (ts, cand, engine.score(cand, ts))
            log(f"[rtx] lane {lane} pinned t={ts}")
        if i % 8 == 0:
            rep = engine.space()
            log(f"step {i:3d}  tokens {toks[:4, 0].tolist()}  "
                f"live_versions {rep['live_versions']}  "
                f"ring {rep['ring_size']}  overflow {rep['overflows']}")
    mismatches = 0
    snapshot_lengths = {}
    for lane, (ts, cand, logits) in readers.items():
        lens = engine.lengths_at(ts)
        snapshot_lengths[lane] = lens.tolist()
        mismatches += not torch.equal(engine.score(cand, ts), logits)
        log(f"[rtx] lane {lane} snapshot@{ts}: lengths {lens.tolist()}")
        engine.unpin(lane)
    space = engine.space()
    log(f"[done] space report: {space}")
    out = torch.cat(tokens, dim=1) if tokens else prompt[:, :0]
    return dict(prefill_s=prefill_s, decode_s=step_s, tokens=out,
                readers=len(readers), snapshot_lengths=snapshot_lengths,
                score_mismatches=mismatches, stats_sum=stats_sum,
                space=space)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    cfg, engine, prompt = build(args)
    print(f"[model] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.param_count() / 1e9:.2f}B parameters, "
          f"{args.dtype} on {engine.device}")
    rep = serve(engine, prompt, steps=args.steps, pin_every=args.pin_every)
    if rep["score_mismatches"]:
        msg = (f"{rep['score_mismatches']} pinned readers' scores changed "
               "while they held their pin")
        ring = min(cfg.local_window, args.max_len)
        if "local" in cfg.layer_pattern \
                and args.prompt_len + args.steps > ring:
            msg += (f" (trap C10: a local ring keeps {ring} "
                    "positions, and once decode wraps it a pinned reader's "
                    "window is overwritten, in the JAX package too; keep "
                    "--prompt-len plus --steps within the window)")
        if set(cfg.layer_pattern) & set(RECURRENT_KINDS):
            msg += (" (trap C12: only the lengths are versioned, so a "
                    "pinned reader scores against a recurrent layer's "
                    "newest state, which every decode step changes, in the "
                    "JAX package too)")
        raise SystemExit(msg)
    return rep


if __name__ == "__main__":
    main()
