#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — requires CUDA; the card's name and power limit (nvidia-smi);
2. build  — builds the CUDA kernels from ``src/repro_torch/csrc``;
3. kernels — each kernel (compact, needed, search, search+gather, paged
   decode, flash prefill) against its plain PyTorch version on the card at
   the serving phases' shapes, timed per call (device time from the
   profiler's kernel records, and CUDA events around the call; medians of
   25), beside its bound; K1's, K2's and K3's main-path ops, the one-launch
   ``sweep`` (the slrt flush's needed-sweep), ``view``
   (``paged.snapshot_view``) and ``value_at`` (``snapshot_lengths``), also
   against the chains of ops they replaced (rebuilt here from the code
   that stays), with the device kernels per call of both; ``value_at``
   also at phase 6's store (16 slots of 16 versions: the shape the model
   launches it at, and the kernel table's K3 row); search (K3)
   also at ``benchmarks/kernel_bench.py``'s largest search shape, by ids
   and over every slot (K3's and K5's inputs and timing come from
   ``tools/time_search_needed.py``, which times any checkout's K3 and K5); paged decode also at 16 sequences of 4096
   tokens (the split KV filling the card); flash prefill also at
   gemma2-2b's shapes (a local layer with window 512; phase 6a's local
   layers, window 4096, and global layers, no window, once more with q
   scaled so that the logits reach the softcap, against a control without
   it; phase 6b's float32 local layer at D 256), at phase 6c's
   deepseek-moe-16b layers (16 query and 16 KV heads), at the shapes of
   phases 6d and 6g in bf16 and float32 (whisper-tiny's encoder, 1500
   frames, bidirectional; its cross-attention over 1500 columns at 64 rows
   and at one decode row; a recurrentgemma-9b local layer, 16 query heads
   over one KV head at D 256, window 2048), with SDPA's time where it
   computes the same function, and in float32 (its CUDA-core route; bf16
   takes the wgmma+TMA kernel); K6b, the gradient kernels, against
   attention_bwd_ref from K6's own output and row LSE at gemma2-2b's
   training layers (T 4096, D 256, softcap 50, window 4096 and 512),
   minitron-4b's heads and whisper-tiny's cross-attention, in both of its
   routes (float32 by split-TF32, and bf16, each bounded in its unit),
   with the backward of SDPA (torch.autograd.grad) in the same dtype as
   its yardstick where SDPA computes the same function; the redesigned
   rows carry their route,
   their share of the bound and their time before the redesign as an earlier run
   recorded it (ms_before_recorded, not measured here); needed (K5, which no
   serving path calls) at compact's shape and at
   ``benchmarks/kernel_bench.py``'s two largest compact shapes;
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
   after; ``value_at`` is then held against its plain version on the
   engine's own store at every timestamp it holds, and ``sweep`` (K1) on
   that store under three boards and three lane sets; then a short profiled
   window of decode steps, whose idle share the phase's line carries;
6a. gemma2 — gemma2-2b at its full published widths and depth (26 layers
   alternating a local ring cache of 4096 slots and global attention,
   head dim 256, softcaps 50 and 30, bf16) through the launcher with
   phase 6's flags and checks; no position reaches 4096, so no ring wraps
   under a pinned reader (trap C10);
6b. gemma2_ring — two layers (one local, one global) at gemma2-2b's full
   widths in float32: a 6144-token prompt, longer than the ring, so the
   prefill keeps only the last 4096 positions (the drop path), then 16
   decode steps that wrap the ring; the same weights and tokens run on
   the CPU through the plain versions, teacher-forced with the card's
   tokens, and the logits, the ring and its positions must agree;
6c. moe — deepseek-moe-16b at its full published widths and depth (28
   layers, 64 routed experts top-6 and 2 shared, bf16; batch 8, 32
   steps) through the launcher with phase 6's checks;
6d. recurrentgemma — recurrentgemma-9b at its full published widths and
   depth (38 layers: RG-LRU, RG-LRU, local attention with one KV head of
   256 and a 2048-slot ring; rnn_width 4096, bf16 with float32 gates and
   states) through the launcher: 16 prompts of 1984 tokens (no position
   reaches the ring's 2048), 64 steps, phase 6's checks, except that each
   reader held across a decode step must see its score change (trap C12:
   a recurrent state is not versioned); in every served phase each
   reader's lengths_at must be exactly the lengths at its pin;
6e. xlstm — xlstm-125m at its full published widths and depth (12 layers
   of mLSTM x 3 and sLSTM, no attention, so no K6) the same way;
6f. vlm — internvl2-2b at full width through prefill_step (256 seeded
   patch embeddings before 1792 tokens: lengths 2048) and 64 decode_one
   steps, a reader every 8 steps held exactly (lengths and scores);
6g. whisper — whisper-tiny at full width: 16 sequences of 1500 frames and
   a 64-token decoder prompt through prefill_step, enc_out from
   _run_encoder, 64 decode_one(enc_out=) steps (K6 bidirectional in the
   encoder and in every cross-attention, one query row per decode step);
   readers' lengths exact (a score ignores the encoder in both packages,
   trap C13, so none is scored);
7. fork_tiers — the four ``benchmarks/fork_bench.py`` tiers (smoke, beam,
   spec, ckpt_churn) for ebr, steam, dlrt and slrt, with their eager-copy
   and no-checkpoint controls, fork replay validation and a leak check
   after every op; the deterministic fields of all 16 rows must equal the
   committed BENCH_fork.json;
8. durability — PagedKVEngine at phase 5's pool geometry (32768 bf16
   pages, K+V 2 GiB, 256 sequences, slrt): a beam search (COW forks
   against an eager-copy engine, every child prefix-checked on every
   step), a checkpoint churn whose checkpoint frees idle sequences' pages
   by sole-survivor eviction (its no-checkpoint control frees none), and a
   checkpoint of the whole engine restored into a fresh one, bit-equal,
   that then decodes on identically; the launch counts are zeroed just
   before this phase and read just after;
9. dist_tiers — the ``benchmarks/dist_bench.py`` tiers (smoke, standard,
   stall) for ebr, steam, dlrt and slrt on the port's
   ``ShardedPagedKVEngine`` (hosts stacked on the card, float32): every
   field of all 12 committed BENCH_dist.json rows but ``wall_s`` must
   come out, with no pin violation and the stalled host aged out; the
   stall/steam row's four C11 fields (``DIST_C11_FIELDS``) come from the
   JAX engine with trap C5 removed;
10. dist_serve — 4 hosts, each at phase 5's pool (32768 bf16 pages, K+V 2
   GiB per host, 256 sequences of up to 4096 tokens, slrt), under
   dist_bench's stall traffic: a reader pins on a rotating host every 16
   steps, holds 4 and decodes its view with K4 at the pin and at release
   (views and outputs bit-identical while held); at step 1024 host 1
   pins, stalls (its rows stop, its announcement ages past the 5 s
   budget) and never unpins: its view must stay bit-identical, the LWM
   must advance and every other host must cross its watermark and
   reclaim; run to 64 steps past the last crossing; the launch counts
   are zeroed just before this phase and read just after, then a
   profiled window;
10b. train — gemma2-2b at its full published widths and depth in float32
   (JAX's training dtype): init_state on the card, then 8 train_step's of
   B 1 x T 4096 from SyntheticLM (train_4k's global batch of 256 cut to 1
   for one card); at every step the loss, the gradient norm and every
   parameter finite, the lr equal to cosine_schedule, the parameters
   unchanged by step 0 (lr 0) and moved by step 1; K6 twice per attention
   layer and step (forward and the checkpoint's recompute) and K6b once,
   both counted from zero over the 8 steps; step seconds, tokens/s, peak
   memory and a profiled step's idle share; K6 on its float32 route and
   K6b on its float32 (split-TF32) route; then the launcher's
   crash/resume at reduced gemma2-2b on the card (exit 42, resume from
   step 5, the losses against the uninterrupted run's, a TrainState saved
   and restored bit-equal) and reduced minitron-4b's 30 steps with and
   without gradient compression (the loss must fall by 0.1 and 0.2);
10c. train_bf16 — the same gemma2-2b run in bf16 (init_state(dtype=
   bfloat16), AdamW's moments float32, as in JAX), 4 steps: the same
   checks, with K6 on its wgmma route and K6b on its bf16 route, counted
   from zero over the 4 steps (C14: the port refused this before);
10d-10f. four rank processes of this script (``--rank``), each on the
   card (cuda:0), joined by gloo through a file store (NCCL refuses two
   ranks of one group on one GPU); only the collectives cross gloo,
   through host memory.  First phase 10e's one-rank reference runs in a
   process of its own, so that its memory is the card's again.  Then
   each rank runs 10e and 10f, then 10d (10e needs the card's memory
   most):
   10d dist_ranks — phase 10's traffic loop unchanged, its engine spread over
   the 4 ranks by the default mesh (one host each, the LWM over the min
   ring), to phase 10's step count: every counter, the LWM after every
   step, the pages reclaimed and the peak per host and a digest of every
   view and K4 output must equal phase 10's run; then phase 9's smoke
   and stall rows at 4 ranks;
   10e train_sharded — gemma2-2b at full widths and depth in float32 on
   a 2 x 2 (data, model) mesh with fsdp=True, each leaf gathered at use,
   B 2 x T 2048, 2 steps: the losses and gradient norms within rtol 1e-4
   of the one-rank step, SHARDED_LEAVES' shards (mu, nu) within their
   stated limits and each parameter's change over the run against the
   one-rank step's (step 0's rate is 0: the update shows only there), K6
   and K6b counted on every rank, each rank's peak memory;
   10f pipeline — minitron-4b's 32 layers in bf16 over 4 stage ranks
   (GPipe, M 8 microbatches of B 2 x T 2048): the output bit-equal to the
   same 32 layers in sequence on the card.
   A rank that fails, or outlives RANKS_TIMEOUT_S, fails the phase; every
   rank is stopped before the script goes on;
   then a "timeline" line: the wall seconds since the start at the end of
   each group of phases;
11. the kernel table as one JSON line, each kernel with the wrapper route
   the main path ran (kernel_route) and only numbers measured in this run
   (bound_ms computed from its inputs) and its launches in each phase
   that drives a path (launches_model, _gemma2, _gemma2_ring, _moe,
   _recurrentgemma, _xlstm, _vlm, _whisper, _durability, _dist, _train,
   _train_bf16, and _dist_ranks, _train_sharded and _pipeline summed over
   the ranks; K6b has a row per route, whose main paths are phase 10b's
   and phase 10c's training); K1's,
   K2's and K3's rows carry
   their main-path op (sweep, view, value_at) beside the chain it
   replaced and the parity op (compact, search_gather, search), each at
   the shape of the phase its launches are counted in;
12. the result line ``{"ok": true, "device": {...}}``.

Any failure raises and exits nonzero; nothing is caught.  Without CUDA, or
without the package beside the script, it exits nonzero before any result.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import math
import os
import random
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch._tensor import drop_set  # noqa: E402
from repro_torch.ckpt.manager import tree_flatten  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core.mvgc import announce, vstore  # noqa: E402
from repro_torch.core.telemetry import GCConfig  # noqa: E402
from repro_torch.dist import ShardedPagedKVEngine  # noqa: E402
from repro_torch.dist.overlap import wire  # noqa: E402
from repro_torch.dist.sharding import (  # noqa: E402
    _paths, param_shardings, place_train_state)
from repro_torch.launch.mesh import make_gc_mesh, make_host_mesh  # noqa: E402
from repro_torch.train.pipeline_parallel import pipeline_forward  # noqa: E402
from repro_torch.models.blocks import block_apply, init_block  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.compact import ops as compact_ops  # noqa: E402
from repro_torch.kernels.compact.ref import (  # noqa: E402
    compact_ref, needed_ref, sweep_ref)
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import paged_decode_ref  # noqa: E402
from repro_torch.kernels.flash_prefill import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_prefill.ref import (  # noqa: E402
    attention_bwd_ref, attention_lse_ref, attention_ref, bwd_bf16_margin)
from repro_torch.kernels.version_search import ops as search_ops  # noqa: E402
from repro_torch.kernels.version_search.ref import (  # noqa: E402
    search_gather_ref, search_ref, value_at_ref, view_ref)
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.step import init_state, train_step  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.serve import forking  # noqa: E402
from repro_torch.serve import engine as serve_engine  # noqa: E402
from repro_torch.serve.engine import PagedKVEngine  # noqa: E402
# phase 3's K3 / K5 shapes, inputs and timing, shared with the A/B script
from time_search_needed import (  # noqa: E402
    NEEDED_SHAPES, SEARCH_BIG, SEARCH_T_ALL, needed_inputs, search_inputs,
    time_call)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
PEAK_OPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12, "int32": 67e12}
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
# heads, bf16, causal), gemma2-2b layers (head dim 256, softcap 50),
# deepseek-moe-16b's layers and float32 cases
FLASH = {
    "serve": dict(B=16, Hq=24, Hkv=8, T=2048, D=128, window=0, softcap=0.0,
                  dtype="bf16"),
    # phase 6c's prefill: deepseek-moe-16b's heads (16 query, 16 KV: no
    # head grouping)
    "moe": dict(B=8, Hq=16, Hkv=16, T=2048, D=128, window=0, softcap=0.0,
                dtype="bf16"),
    "gemma2_local": dict(B=16, Hq=8, Hkv=4, T=2048, D=256, window=512,
                         softcap=50.0, dtype="bf16"),
    # gemma2-2b's two prefill shapes in phase 6a: its local layers (window
    # 4096) and its global layers (no window), softcap 50 in both; held
    # to DECODE_TOL plus the bound of P's bf16 rounding (flash_cases)
    "gemma2_w4096": dict(B=16, Hq=8, Hkv=4, T=2048, D=256, window=4096,
                         softcap=50.0, dtype="bf16", p_rounding=True),
    "gemma2_global": dict(B=16, Hq=8, Hkv=4, T=2048, D=256, window=0,
                          softcap=50.0, dtype="bf16", p_rounding=True),
    # the same layer with q scaled by 12: logits q.k/sqrt(D) of about
    # N(0, 12^2), so the cap of 50 bends them (randn's N(0, 1) logits move
    # by under 0.006 under it); the same inputs with no softcap must fail
    # the row's limit (flash_cases), which shows the check sees the cap
    "gemma2_capped": dict(B=4, Hq=8, Hkv=4, T=2048, D=256, window=0,
                          softcap=50.0, dtype="bf16", p_rounding=True,
                          q_scale=12.0),
    # phase 6b's local layer: float32 (the CUDA-core route) at D 256
    "gemma2_ring_f32": dict(B=1, Hq=8, Hkv=4, T=6144, D=256, window=4096,
                            softcap=50.0, dtype="f32"),
    "f32": dict(B=4, Hq=24, Hkv=8, T=2048, D=128, window=0, softcap=0.0,
                dtype="f32"),
}
# K6 at the shapes of phases 6d and 6g, each in bf16 (the served dtype) and
# float32: whisper-tiny's encoder (1500 frames, 6 heads of 64,
# bidirectional), its cross-attention over the 1500 encoder outputs at the
# prefill's 64 tokens and at a decode step's one row (one valid row of the
# bf16 route's 128-row tile; S = 1500 ends inside a KV tile), and a
# recurrentgemma-9b local layer (16 query heads over one KV head, D 256,
# window 2048 over the 1984-token prompt); bf16 held like the gemma2 rows
FAMILY_FLASH = {
    "whisper_encoder": dict(B=16, Hq=6, Hkv=6, T=1500, S=1500, D=64,
                            window=0, causal=False),
    "whisper_cross_prefill": dict(B=16, Hq=6, Hkv=6, T=64, S=1500, D=64,
                                  window=0, causal=False),
    "whisper_cross_decode": dict(B=16, Hq=6, Hkv=6, T=1, S=1500, D=64,
                                 window=0, causal=False),
    "recurrentgemma_local": dict(B=16, Hq=16, Hkv=1, T=1984, D=256,
                                 window=2048),
}
FLASH.update({f"{name}{sfx}": dict(c, softcap=0.0, **kw)
              for name, c in FAMILY_FLASH.items()
              for sfx, kw in (("", dict(dtype="bf16", p_rounding=True)),
                              ("_f32", dict(dtype="f32")))})
# phase 3's K6b cases, each in both routes (float32: split-TF32; bf16):
# gemma2-2b's training layers at phase 10b's shape (B 1, T 4096, D 256,
# softcap 50; its local layers' window 4096 covers the sequence, so they
# and its global layers compute the same function and one row stands for
# both) and a window of 512, minitron-4b's heads, whisper-tiny's
# cross-attention (64 rows over 1500 frames, bidirectional).
# "gemma2_train" is the kernel table's row of each route
FLASH_BWD = {
    "gemma2_train": dict(B=1, Hq=8, Hkv=4, T=4096, D=256, window=4096,
                         softcap=50.0),
    "gemma2_window512": dict(B=1, Hq=8, Hkv=4, T=4096, D=256, window=512,
                             softcap=50.0),
    "minitron": dict(B=4, Hq=24, Hkv=8, T=2048, D=128, window=0,
                     softcap=0.0),
    "whisper_cross": dict(B=16, Hq=6, Hkv=6, T=64, S=1500, D=64, window=0,
                          softcap=0.0, causal=False),
}
# K6b's float32 route against attention_bwd_ref: both sum in float32 in
# other orders over up to 4096 columns; the atol is about 4x the largest
# difference the first card run of these kernels measured at gemma2-2b's
# training shape (2.8e-5 on dv, whose entries reach 7).  The bf16 route is
# held to ref.bwd_bf16_margin: ref.BF16_BWD_TOL (one bf16 rounding of each
# gradient) plus what rounding P and dX to bf16 can move a gradient by
# (ref.bwd_bf16_rounding), as flash_cases bounds K6's P
FLASH_BWD_TOL = dict(atol=1e-4, rtol=1e-4)
# phase 10b: gemma2-2b at its full published widths and depth, float32 as
# JAX's init_state makes it, B 1 x T 4096 (train_4k's sequence; its global
# batch of 256 cut to 1 for one card), 8 steps from SyntheticLM at the
# launcher's learning rate; then the launcher's crash/resume at reduced
# widths on the card, and reduced minitron-4b's 30 steps with and without
# gradient compression (JAX's test_compression_path_trains)
TRAIN = dict(arch="gemma2-2b", batch=1, seq_len=4096, steps=8, lr=3e-3,
             seed=0)
# phase 10c: the same in bf16 (init_state(dtype=bfloat16), AdamW's moments
# float32, as in JAX), 4 steps: K6's wgmma route and K6b's bf16 route
TRAIN_BF16 = dict(TRAIN, steps=4)
TRAIN_RESUME = ["--arch", "gemma2-2b", "--reduced", "--device", "cuda",
                "--steps", "12", "--ckpt-every", "5", "--log-every", "1"]
TRAIN_COMPRESSION = dict(arch="minitron-4b", steps=30, seq_len=32, batch=8,
                         copy_period=8, lr=3e-3, fall=0.1, fall_plain=0.2)
# resumed losses against the uninterrupted run's (the same steps from the
# same bits; CUDA's index backward of the embedding may sum with atomics)
RESUME_RTOL = 1e-5
# phases 10d-10f: four rank processes on the one card (cuda:0), joined by
# gloo through a file store: NCCL refuses two ranks of one group on one
# GPU.  Each rank's state lives on the card; only the collectives cross
# gloo, through host memory
RANKS = 4
RANKS_TIMEOUT_S = 900          # each rank's own limit: a deadlock fails
# 10d replays BENCH_dist.json's smoke and stall tiers at 4 ranks (8 rows):
# the three rank phases take more than the 240 s aimed at on top of the
# script (10e's gathers cross gloo), so the standard tier's 4 rows, which
# add no host count or stall the other two lack, are left to phase 9 and
# the CPU tests
RANK_TIERS = ("smoke", "stall")
# 10e: gemma2-2b at its full widths and depth in float32 on a 2 x 2 (data,
# model) mesh with fsdp=True: B 2 (one sequence per data row), 2 steps at
# phase 10b's schedule, against the one-rank train_step on the same
# batches from the same state (run first in a process of its own, so that
# its memory is the card's again before the ranks start)
TRAIN_SHARDED = dict(TRAIN, batch=2, seq_len=2048, steps=2, mesh=(2, 2))
# the leaves held against the one-rank step (replicated norms, attention
# and MLP matrices split over model and data), with their AdamW moments
SHARDED_LEAVES = ("final_norm", "layers/0/ln1", "layers/0/mixer/wq",
                  "layers/0/mixer/wo", "layers/25/ffn/wd")
# loss and gradient norm: JAX's limit for the sharded step's loss
# (tests/launch/test_distributed.py:98); mu and nu within this share of
# each leaf's largest entry (float32 sums in another order).  Step 0's
# rate is 0, so both losses read the initial parameters: the update shows
# only in the parameters, held by their change over the run (p - p0)
# against the one-rank step's change: where that is at least half the
# rates' sum (AdamW's normalized step near 1) and the gradient is not near
# zero (the one-rank step's second moment at least SHARDED_GRAD_SHARE of
# the leaf's largest, in root: a gradient entry near zero carries float32
# rounding of the leaf's large terms, which AdamW's normalization lifts to
# a full step), within SHARDED_UPDATE_RTOL of it (a skipped update is 1,
# one of the wrong sign 2); elsewhere within twice the rates' sum; both
# plus 4 float32 spacings of p0 (tests/_torch_ranks.py's check_update,
# the same limits)
SHARDED_RTOL, SHARDED_MOMENT_SHARE, SHARDED_UPDATE_RTOL = 1e-4, 1e-4, 1e-2
SHARDED_GRAD_SHARE = 1e-3
# 10f: minitron-4b's 32 layers at full widths in bf16 over 4 stage ranks
# (8 layers each), M 8 microbatches of B 2 x T 2048 of seeded activations
PIPELINE = dict(arch="minitron-4b", microbatches=8, batch=2, seq_len=2048,
                seed=0)
# phase 6: the launcher's flags (minitron-4b at full width, no --reduced)
MODEL_ARGS = ["--arch", "minitron-4b", "--batch", "16", "--prompt-len",
              "2048", "--max-len", "4096", "--steps", "64", "--pin-every",
              "8", "--gc-policy", "slrt", "--dtype",
              "bfloat16", "--device", "cuda"]
# phases 6a and 6c: gemma2-2b and deepseek-moe-16b at full width through
# the launcher.  gemma2's ring is W = 4096 slots and no position reaches
# 4096 (2048 + 64), so the readers hold their pins with no wrap and the
# reader check stays strict (trap C10)
GEMMA2_ARGS = ["--arch", "gemma2-2b", "--batch", "16", "--prompt-len",
               "2048", "--max-len", "4096", "--steps", "64", "--pin-every",
               "8", "--gc-policy", "slrt", "--dtype", "bfloat16",
               "--device", "cuda"]
MOE_ARGS = ["--arch", "deepseek-moe-16b", "--batch", "8", "--prompt-len",
            "2048", "--max-len", "4096", "--steps", "32", "--pin-every", "8",
            "--gc-policy", "slrt", "--dtype", "bfloat16", "--device", "cuda"]
# phases 6d and 6e: recurrentgemma-9b and xlstm-125m at full width through
# the launcher.  recurrentgemma's local ring is W = 2048 slots and no
# position reaches 2048 (1984 + 64), so no ring wraps under a reader (C10
# stays out); every reader's score changes all the same (trap C12)
RECURRENT_FLAGS = ["--batch", "16", "--prompt-len", "1984", "--max-len",
                   "4096", "--steps", "64", "--pin-every", "8",
                   "--gc-policy", "slrt", "--dtype", "bfloat16", "--device",
                   "cuda"]
# each served model's phase, flags and the published widths it must have
SERVED = {
    "model": (MODEL_ARGS, dict(num_layers=32, d_model=3072, hd=128)),
    "gemma2": (GEMMA2_ARGS, dict(
        num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4, hd=256,
        layer_pattern=("local", "attn"), local_window=4096,
        attn_softcap=50.0, final_softcap=30.0)),
    "moe": (MOE_ARGS, dict(
        num_layers=28, d_model=2048, num_heads=16, hd=128, num_experts=64,
        top_k=6, num_shared_experts=2, d_ff=1408)),
    "recurrentgemma": (["--arch", "recurrentgemma-9b"] + RECURRENT_FLAGS,
                       dict(num_layers=38, d_model=4096, rnn_width=4096,
                            hd=256, num_heads=16, num_kv_heads=1,
                            local_window=2048, d_ff=12288,
                            layer_pattern=("rglru", "rglru", "local"))),
    "xlstm": (["--arch", "xlstm-125m"] + RECURRENT_FLAGS, dict(
        num_layers=12, d_model=768, num_heads=4, proj_factor=2.0,
        mlstm_chunk=64, layer_pattern=("mlstm", "mlstm", "mlstm",
                                       "slstm"))),
}
# phases 6f and 6g, through prefill_step and decode_one (JAX's engine
# cannot take frames: trap C13): internvl2-2b with 256 patch embeddings
# (scale 0.02, as tests/models/test_archs_smoke.py makes them) before a
# 1792-token prompt, and whisper-tiny over 1500 frames with a 64-token
# decoder prompt (its decoder holds 448 positions); bf16, slrt, a reader
# pinned every 8 steps
FRONTEND = {
    "vlm": dict(arch="internvl2-2b", batch=16, prefix=256, prompt=1792,
                max_len=4096, steps=64, pin_every=8, seed=0, widths=dict(
                    num_layers=24, d_model=2048, num_heads=16,
                    num_kv_heads=8, d_ff=8192, frontend_tokens=256)),
    "whisper": dict(arch="whisper-tiny", batch=16, prefix=1500, prompt=64,
                    max_len=448, steps=64, pin_every=8, seed=0, widths=dict(
                        num_layers=4, encoder_layers=4, d_model=384,
                        num_heads=6, hd=64, encoder_tokens=1500)),
}
# phase 6b: the ring's drop and wrap paths at gemma2-2b's full widths, two
# layers (one local, one global), float32, against the CPU
RING = dict(layers=2, batch=1, prompt=6144, max_len=8192, steps=16, seed=0)
# its tolerances, card against CPU, both float32, which sum in other
# orders (cuBLAS against the CPU's GEMMs, K6's float32 kernel against its
# plain version).  Each atol is about four times the largest difference
# an H100 run measured (the phase's max_logit_err and max_ring_err): the
# last-position logits (final softcap 30) 1.03e-4; the rings' K/V
# 1.55e-3, larger: RoPE turns a key by the angle p * f, which at
# positions p near 6000 carries p times any last-bit difference between
# the two devices' frequencies f (one float32 ulp of f = 1 is 6e-8)
RING_TOL = {"logits": dict(atol=4e-4, rtol=0.0),
            "ring": dict(atol=6e-3, rtol=0.0)}
STORM = dict(num_seqs=8, num_pages=24, page_size=4, max_pages_per_seq=3,
             versions_per_seq=6, steps=160, min_len=4, max_len=12,
             pin_every=5, pin_hold=3, seed=0)
# phase 7: benchmarks/fork_bench.py TIERS, copied (that module imports JAX)
FORK_TIERS = {
    "smoke": dict(kind="beam", num_seqs=6, num_pages=24, page_size=4,
                  max_pages_per_seq=6, versions_per_seq=8, roots=(0,),
                  prefill=6, rounds=2, beam_width=2, child_tokens=2,
                  join_every=2, seed=0),
    "beam": dict(kind="beam", num_seqs=8, num_pages=40, page_size=4,
                 max_pages_per_seq=6, versions_per_seq=8, roots=(0, 1),
                 prefill=6, rounds=6, beam_width=2, child_tokens=2,
                 join_every=2, seed=0),
    "spec": dict(kind="spec", num_seqs=6, num_pages=48, page_size=4,
                 max_pages_per_seq=8, versions_per_seq=10, roots=(0, 1, 2),
                 prefill=5, rounds=8, draft_tokens=3, seed=0),
    "ckpt_churn": dict(kind="ckpt", num_seqs=8, num_pages=20, page_size=4,
                       max_pages_per_seq=6, versions_per_seq=8, idle=5,
                       phase1_steps=8, phase2_steps=16, seed=0),
}
FORK_POLICIES = ("ebr", "steam", "dlrt", "slrt")
# the deterministic fields of a BENCH_fork.json row
FORK_FIELDS = ("forks", "joins", "releases", "pages_shared_peak",
               "peak_pages", "eager_peak_pages", "shared_savings_pages",
               "prefix_checks", "prefix_violations", "ckpt_saves",
               "ckpt_evictions", "ckpt_pages_freed",
               "control_ckpt_pages_freed", "control_end_pages",
               "pressure_events", "reclaims_triggered", "pages_reclaimed",
               "give_ups")
NOW_TS = 2**31 - 2      # "current" snapshot timestamp of the fork views
# phase 8: phase 5's pool (one attention layer of minitron-4b, bf16).
# The fork tiers check leaks and sharing after every op; at this size that
# host check (about 10 ms) runs after every fork, join and release only.
POOL = dict(num_seqs=256, num_pages=32768, page_size=16,
            max_pages_per_seq=256, kv_heads=8, head_dim=128,
            versions_per_seq=8, reader_lanes=16, seed=0, check_appends=False)
# beam: 32 roots grown to 1024 tokens, 8 rounds of 4 children per root,
# 16 tokens per child, one seeded child joins back each round
DURABLE_BEAM = dict(POOL, kind="beam", roots=tuple(range(32)), prefill=1024,
                    rounds=8, beam_width=4, child_tokens=16, join_every=1,
                    best_seed=0)
# churn, fork_bench's sizing rule at this pool: idle + active demand
# (128 x 96 + 128 x 176 pages = 34816) exceeds the 32768 pages, the
# active sequences alone (22528) stay under the watermark; the control
# stops at its first give-up
DURABLE_CHURN = dict(POOL, kind="ckpt", idle=128, phase1_steps=1536,
                     phase2_steps=1280, control_stops_at_give_up=True)
RESTORE_STEPS = 16
# phase 9: benchmarks/dist_bench.py TIERS and constants, copied (that
# module imports JAX)
DIST_TIERS = {
    "smoke": dict(hosts=2, num_seqs=4, num_pages=10, page_size=4,
                  max_pages_per_seq=3, versions_per_seq=6, steps=18,
                  min_len=4, max_len=9, pin_every=5, pin_hold=3,
                  stall_host=None, stall_after=0, seed=0),
    "standard": dict(hosts=4, num_seqs=4, num_pages=10, page_size=4,
                     max_pages_per_seq=3, versions_per_seq=6, steps=48,
                     min_len=4, max_len=10, pin_every=6, pin_hold=3,
                     stall_host=None, stall_after=0, seed=0),
    "stall": dict(hosts=4, num_seqs=4, num_pages=10, page_size=4,
                  max_pages_per_seq=3, versions_per_seq=6, steps=60,
                  min_len=4, max_len=10, pin_every=6, pin_hold=3,
                  stall_host=1, stall_after=20, seed=0),
}
DIST_POLICIES = ("ebr", "steam", "dlrt", "slrt")
DIST_KV_HEADS, DIST_HEAD_DIM, DIST_READER_LANES = 1, 4, 4
STALE_AFTER_S = 5.0          # finite staleness budget (stall tier ages past)
STALLED_AGE_S = 100.0        # injected announcement age of the wedged host
# trap C11 (ROADMAP.md C, an instance of C5): BENCH_dist.json was written
# by the JAX engine, whose hot-slot sweep lets an inert lane clamped onto
# slot 0 write that slot's old row back over its compaction, while the
# killed handles are freed all the same.  In the stall tier under steam
# that moves four counters of the row.  The port keeps the compaction, as
# it does everywhere; it must give the values the JAX engine gives with
# the inert lanes dropped (tests/test_torch_dist.py, -k c11)
DIST_C11_FIELDS = {("stall", "steam"): dict(
    pressure_events=79, reclaims_triggered=79, pages_reclaimed=34,
    stale_lanes_aged=82)}
# the fields phase 9's lines print (every field it sets is compared)
DIST_FIELDS = ("tokens_appended", "pressure_events", "reclaims_triggered",
               "pages_reclaimed", "peak_pages", "lwm", "lwm_advances",
               "stale_lanes_aged", "stalled_hosts", "give_ups",
               "scans_validated", "pin_violations")
# phase 10: dist_bench's stall traffic at phase 5's pool on each of 4
# hosts stacked on the card (K+V 2 GiB per host); host 1 pins and stalls
# at step 1024 and never unpins
DIST_SERVE = dict(SERVE, hosts=4, stall_host=1, stall_after=1024,
                  max_seconds=240.0)
KERNELS = {
    "compact": ("src/repro_torch/csrc/compact.cu",
                "src/repro/kernels/compact/kernel.py:144"),
    "needed": ("src/repro_torch/csrc/compact.cu",
               "src/repro/kernels/compact/kernel.py:52"),
    "search_gather": ("src/repro_torch/csrc/version_search.cu",
                      "src/repro/kernels/version_search/kernel.py:140"),
    "search": ("src/repro_torch/csrc/version_search.cu",
               "src/repro/kernels/version_search/kernel.py:66"),
    "paged_decode": ("src/repro_torch/csrc/paged_decode.cu",
                     "src/repro/kernels/decode_attention/kernel.py:114"),
    "flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_prefill/kernel.py:125"),
    # K6b has no pallas_call: JAX differentiates _xla_flash by autodiff;
    # a row per route (float32 split-TF32, bf16)
    "flash_backward": ("src/repro_torch/csrc/flash_backward.cu",
                       "src/repro/models/attention.py:58"),
    "flash_backward_bf16": ("src/repro_torch/csrc/flash_backward.cu",
                            "src/repro/models/attention.py:58"),
}
# device ms of K3-K6b before their redesign, recorded in earlier runs
# (PERF.md section 6, "NVIDIA H100 80GB HBM3, 700.00 W"), not measured
# here; phase 3's rows carry them as ms_before_recorded
MS_BEFORE_RECORDED = {"paged_decode": 4.358086, "flash_prefill": 19.320105,
                      "flash_prefill_gemma2_local": 5.816902,
                      # K6b: the CUDA-core pair it replaced
                      "flash_backward": 14.693428,
                      "flash_backward_minitron": 17.038807,
                      "flash_backward_gemma2_window512": 3.776279,
                      "flash_backward_whisper_cross": 0.573878,
                      "search": 0.001632, "needed": 0.001632,
                      "needed_65536x8x256": 0.004736,
                      "needed_32768x16x1024": 0.007776}
# K1's, K2's and K3's main-path ops: the kernel table's rows of K1-K3 carry
# these ops' phase-3 numbers, each at the shape of the phase that counts
# its launches (K3's: phase 6's store, value_at_model); compact,
# search_gather and search stay as parity ops
MAIN_OPS = {"compact": "sweep", "search_gather": "view",
            "search": "value_at_model"}
# launch counters; compact's counts K1 (sweep + compact), search_gather's
# K2 (view + search_gather), search's K3 (value_at + search); sweep, view
# and value_at count their own launches too
WRAPPERS = {"compact": compact_ops.compact,
            "sweep": compact_ops.sweep,
            "needed": compact_ops.needed,
            "search_gather": search_ops.search_gather,
            "view": search_ops.view,
            "search": search_ops.search,
            "value_at": search_ops.value_at,
            "paged_decode": decode_ops.paged_decode,
            "flash_prefill": flash_ops.flash_attention,
            "flash_backward": flash_ops.flash_attention_backward}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def zero_counts() -> None:
    """Every wrapper's launch count, and K6's and K6b's per route, set to
    0."""
    for w in WRAPPERS.values():
        w.launches = 0
    wire.copies = 0
    for routes in (flash_ops.flash_attention.route_launches,
                   flash_ops.flash_attention_backward.route_launches):
        for r in routes:
            routes[r] = 0


def launch_counts() -> dict:
    """Launches since zero_counts, by kernel-table row: K6b's float32
    route as ``flash_backward`` and its bf16 route as
    ``flash_backward_bf16``."""
    out = {name: w.launches for name, w in WRAPPERS.items()}
    routes = flash_ops.flash_attention_backward.route_launches
    out["flash_backward"] = routes[flash_ops.BWD_ROUTES[torch.float32]]
    out["flash_backward_bf16"] = routes[flash_ops.BWD_ROUTES[torch.bfloat16]]
    return out


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _is_device(event) -> bool:
    return str(event.device_type).endswith("CUDA")


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

    out["sweep"] = sweep_case(dev)
    out.update(needed_cases(dev))

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
    out["view"] = view_case(ts, pay, tables.to(dev), lens.to(dev), ids, 2000)
    out["search"] = search_case(ts, pay, ids, t, "search")
    out["value_at"] = value_at_case(ts, pay, 2000)
    out["value_at_model"] = value_at_model_case(dev)
    out.update(search_big_cases(dev))

    out.update(decode_cases(dev, g, gd))
    out.update(flash_cases(dev))
    out.update(flash_backward_cases(dev))
    for name, row in out.items():
        emit({"phase": "kernels", "kernel": name, **row})
    return out


def decode_table(g, B: int, full: bool):
    """A snapshot-view-shaped table at phase 5's geometry: -1 past each
    length, distinct pages; lengths uniform in [0, MP * PS] with 8 rows of
    length 0, or every length MP * PS (``full``)."""
    MP, PS, N = (SERVE["max_pages_per_seq"], SERVE["page_size"],
                 SERVE["num_pages"])
    if full:
        lengths = torch.full((B,), MP * PS, dtype=torch.int32)
    else:
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
    return table, lengths


def decode_cases(dev, g, gd) -> dict:
    """K4 against its plain version at phase 5's geometry: 256 sequences of
    random length (float32, and bf16: the kernel table's row), and 16
    sequences of 4096 tokens in bf16, where the split KV fills the card.
    Checks: DECODE_TOL, length-0 rows 0, finite, same bits twice."""
    p = SERVE
    MP, PS, N = p["max_pages_per_seq"], p["page_size"], p["num_pages"]
    Hkv, D, Hq = p["kv_heads"], p["head_dim"], p["q_heads"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for name, B, full, kinds in (("paged_decode", p["num_seqs"], False,
                                  ("f32", "bf16")),
                                 ("paged_decode_b16_full", 16, True,
                                  ("bf16",))):
        table, lengths = decode_table(g, B, full)
        table, lengths = table.to(dev), lengths.to(dev)
        visible = int(lengths.sum())
        for kind in kinds:
            dtype, tol = DTYPES[kind], DECODE_TOL[kind]
            kp = torch.randn((N, PS, Hkv, D), generator=gd, device=dev,
                             dtype=dtype)
            vp = torch.randn((N, PS, Hkv, D), generator=gd, device=dev,
                             dtype=dtype)
            q = torch.randn((B, Hq, D), generator=gd, device=dev,
                            dtype=dtype)
            got = decode_ops.paged_decode(q, kp, vp, table, lengths)
            want = paged_decode_ref(q, kp, vp, table, lengths)
            torch.cuda.synchronize()
            err = max_err([got], [want])
            check(bool(torch.isfinite(got.float()).all()),
                  f"{name} {kind} not finite")
            check(torch.allclose(got.float(), want.float(), **tol),
                  f"{name} {kind} differs from plain version (max {err})")
            check(bool((got[lengths == 0] == 0).all()),
                  "length-0 rows not 0")
            again = decode_ops.paged_decode(q, kp, vp, table, lengths)
            check(torch.equal(got, again), f"{name} not deterministic")
            if kind != "bf16":
                emit({"phase": "kernels", "check": f"{name}_f32",
                      "max_abs_err": err, **tol})
                del kp, vp
                torch.cuda.empty_cache()
                continue
            elt = 2
            nbytes = (2 * B * Hq * D * elt + B * 4
                      + int((table >= 0).sum()) * 4
                      + visible * Hkv * D * elt * 2)
            b_ms, b_by = bound(nbytes, 4.0 * visible * Hq * D, "bf16")
            # yardstick: SDPA over K/V gathered densely beforehand (the
            # gather is not timed), one query token, GQA, length mask
            kd = kp[table.long()].reshape(B, MP * PS, Hkv, D).transpose(1, 2)
            vd = vp[table.long()].reshape(B, MP * PS, Hkv, D).transpose(1, 2)
            amask = (torch.arange(MP * PS, device=dev)[None, :]
                     < lengths[:, None])[:, None, None, :]
            qd = q[:, :, None, :]
            row = dict(
                shape=f"B={B} Hq={Hq} Hkv={Hkv} D={D} PS={PS} MP={MP} bf16"
                      + (" all lengths MP*PS" if full else ""),
                route="cuda-core split-KV", max_abs_err=err, **tol,
                bound_ms=b_ms, bound_by=b_by,
                **timed(lambda: decode_ops.paged_decode(q, kp, vp, table,
                                                        lengths),
                        lambda: paged_decode_ref(q, kp, vp, table, lengths),
                        lambda: sdpa(qd, kd, vd, attn_mask=amask,
                                     enable_gqa=True)))
            rows[name] = dict(row, share_of_bound=b_ms / row["ms"],
                              ms_before_recorded=MS_BEFORE_RECORDED.get(name))
            del kp, vp, kd, vd
            torch.cuda.empty_cache()
    return rows


def needed_cases(dev) -> dict:
    """K5 against its plain version at NEEDED_SHAPES on
    ``needed_inputs``' slabs; the mask must be exactly equal.  The first
    shape is the kernel table's row; its ``launches`` are this phase's (no
    serving path calls ``needed``)."""
    rows = {}
    compact_ops.needed.launches = 0
    for i, ((R, V, P), args) in enumerate(zip(NEEDED_SHAPES,
                                              needed_inputs(dev))):
        got = compact_ops.needed(*args)
        want = needed_ref(*args)
        torch.cuda.synchronize()
        check(got.dtype == torch.bool and torch.equal(got, want),
              f"needed kernel != plain version at R={R} V={V} P={P}")
        check(bool(got.any()) and not bool(got.all()),
              f"needed check at R={R} is all one value: weak check")
        nbytes = R * V * (4 * 2 + 1) + P * 4 + 4
        b_ms, b_by = bound(nbytes, R * V * math.log2(max(P, 2)), "int32")
        name = "needed" if i == 0 else f"needed_{R}x{V}x{P}"
        row = dict(shape=f"S={R} V={V} P={P}",
                   max_abs_err=max_err([got], [want]), bound_ms=b_ms,
                   bound_by=b_by, **timed(lambda: compact_ops.needed(*args),
                                          lambda: needed_ref(*args)))
        rows[name] = dict(row, share_of_bound=b_ms / row["ms"],
                          ms_before_recorded=MS_BEFORE_RECORDED.get(name))
    rows["needed"]["launches_phase3"] = compact_ops.needed.launches
    return rows


def search_case(ts, pay, ids, t, name: str) -> dict:
    """K3's parity op (``search``, ``search_pallas``'s contract) against
    its plain version: ids (``None``: every slot) and one ``t`` per
    query."""
    got = search_ops.search(ts, pay, ids, t)
    want = search_ref(ts, pay, ids, t)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want, strict=True)),
          f"search kernel != plain version ({name})")
    check(bool(got[1].any()) and not bool(got[1].all()),
          f"search check ({name}) lacks found or not-found queries")
    B, V = got[0].shape[0], ts.shape[1]
    # ids, t, slab rows, payloads and flags
    nbytes = B * 4 * 2 + B * V * 4 * 2 + B * 5
    b_ms, b_by = bound(nbytes, B * V * 2, "int32")
    row = dict(shape=f"B={B} V={V} S={ts.shape[0]}", op="search_ops.search",
               max_abs_err=max_err(got, want), bound_ms=b_ms, bound_by=b_by,
               **timed(lambda: search_ops.search(ts, pay, ids, t),
                       lambda: search_ref(ts, pay, ids, t)))
    return dict(row, share_of_bound=b_ms / row["ms"],
                ms_before_recorded=MS_BEFORE_RECORDED.get(name))


def value_at_chain(ts, pay, t: int):
    """``snapshot_lengths`` as it ran before ``value_at``: ``arange`` ids,
    the search op (payloads and flags), then the lengths masked to 0."""
    ids = torch.arange(ts.shape[0], dtype=torch.int32, device=ts.device)
    got, found = search_ops.search(ts, pay, ids, t)
    return torch.where(found, got, 0)


def value_at_case(ts, pay, t: int, what: str = "") -> dict:
    """K3's main-path op as ``snapshot_lengths`` calls it: every slot (no
    id array), ``t`` a Python int.  The op, the chain it replaced and the
    plain version must agree exactly."""
    got = search_ops.value_at(ts, pay, None, t)
    want = value_at_ref(ts, pay, None, t)
    old = value_at_chain(ts, pay, t)
    torch.cuda.synchronize()
    S, V = ts.shape
    where = f"at S={S} V={V}{what}"
    check(torch.equal(got, want), f"value_at kernel != plain version {where}")
    check(torch.equal(got, old),
          f"value_at kernel != the chain it replaced {where}")
    check(bool((got == 0).any()) and bool((got != 0).any()),
          f"value_at check {where} lacks found or not-found slots")
    nbytes = S * V * 4 * 2 + S * 4            # slab rows, values
    b_ms, b_by = bound(nbytes, S * V * 2, "int32")
    return dict(shape=f"B={S} V={V} every slot{what}",
                op="search_ops.value_at",
                max_abs_err=max_err([got], [want]), bound_ms=b_ms,
                bound_by=b_by,
                **chain_row(time_call(lambda: search_ops.value_at(
                                ts, pay, None, t)),
                            time_call(lambda: value_at_chain(ts, pay, t)),
                            time_call(lambda: value_at_ref(ts, pay, None, t)),
                            b_ms))


def model_store_shape() -> tuple[int, int]:
    """(slots, versions per slot) of phase 6's store: one slot per
    sequence of the launcher's batch."""
    return launcher.parse_args(MODEL_ARGS).batch, launcher.VERSIONS_PER_SLOT


def value_at_model_case(dev) -> dict:
    """K3's main-path op at the shape phase 6 launches it: the model
    engine's ``lengths_at`` over every one of its 16 slots of 16 versions
    (the kernel's 16-lane query groups), ``t`` by value; the kernel
    table's K3 row."""
    ts, _, pay = _store(torch.Generator().manual_seed(6),
                        *model_store_shape(), dev)
    return value_at_case(ts, pay, 1000, " (phase 6's store)")


def check_value_at_on_store(store) -> int:
    """``value_at`` on a store's own slabs against its plain version, at
    0, every timestamp the store holds and one past the last: every
    snapshot a reader can take of it.  Returns the number of times
    checked."""
    stamps = torch.unique(store.ts[store.ts != EMPTY]).tolist()
    times = [0] + stamps + [stamps[-1] + 1 if stamps else 1]
    for t in times:
        got = search_ops.value_at(store.ts, store.payload, None, t)
        want = value_at_ref(store.ts, store.payload, None, t)
        check(torch.equal(got, want),
              f"value_at != plain version on the store at t={t}")
    return len(times)


def check_sweep_on_store(mv, pins: dict | None = None,
                         must_kill: bool = True) -> dict:
    """``sweep`` on an engine's own store against its plain version,
    exactly: every slot, the lanes an slrt flush would give it now (the
    retire ring's slots, holes masked off) and every slot as a lane, each
    under the board the engine's ops sort (``vstore._ann_scan``: the local
    board, plus each extra pin of ``pins`` as a sharded engine's shard ops
    append the global LWM), under no pin and under a pin at every
    timestamp the store holds.  An extra pin of ``TS_MAX`` must sweep as
    no extra pin does.  The sweep of every slot under no pin must kill a
    version when ``must_kill``.  Returns the number of sweeps checked and
    the versions that sweep killed."""
    st, now = mv.store, mv.now
    S, V = st.ts.shape
    dev = st.ts.device
    occ = mv.ring.idx != EMPTY
    ring_slots = torch.where(occ, torch.div(mv.ring.idx, V,
                                            rounding_mode="floor"), 0)
    lanes = {"every slot": (None, None),
             "ring": (ring_slots.to(torch.int32).contiguous(), occ),
             "slots as lanes": (torch.arange(S, dtype=torch.int32,
                                             device=dev),
                                torch.ones((S,), dtype=torch.bool,
                                           device=dev))}
    own = announce.scan(mv.board)
    boards = {"engine": own}
    for pname, pin in (pins or {}).items():
        boards[f"engine + {pname}"] = vstore._ann_scan(mv, pin)
    boards.update({"no pin": torch.full_like(own, TS_MAX),
                   "every stamp": torch.unique(st.ts[st.ts != EMPTY]).to(
                       torch.int32)})
    killed, swept = None, {}
    for bname, board in boards.items():
        for lname, (ids, mask) in lanes.items():
            args = (st.ts, st.succ, st.payload, ids, mask, board, now)
            got = compact_ops.sweep(*args)
            want = sweep_ref(*args)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"sweep != plain version on the store ({lname}, board "
                  f"{bname} of {board.numel()})")
            swept[bname, lname] = got
            if bname == "no pin" and ids is None:
                killed = int(((st.ts != EMPTY) & (got[0] == EMPTY)).sum())
    for pname, pin in (pins or {}).items():
        if int(torch.as_tensor(pin).min()) == TS_MAX:
            check(all(torch.equal(a, b) for lname in lanes for a, b in
                      zip(swept[f"engine + {pname}", lname],
                          swept["engine", lname])),
                  f"sweep under the extra pin {pname} != no extra pin")
    check(not must_kill or killed > 0,
          "the store held no version for the sweep to kill")
    return dict(sweeps_checked=len(boards) * len(lanes),
                sweep_killed_unpinned=killed)


def search_big_cases(dev) -> dict:
    """K3 at ``benchmarks/kernel_bench.py``'s largest search shape, with
    its data: ``search`` over B = 8192 ids with one t each, and
    ``value_at`` over every one of the S = 65536 slots."""
    S, V, B = SEARCH_BIG
    ts, pay, ids, t = search_inputs(S, V, B, dev)
    rows = {f"search_{S}x{V}x{B}": search_case(ts, pay, ids, t, "search_big")}
    got = search_ops.value_at(ts, pay, None, SEARCH_T_ALL)
    want = value_at_ref(ts, pay, None, SEARCH_T_ALL)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "value_at kernel != plain version at "
          f"S={S}")
    check(bool((got == 0).any()) and bool((got != 0).any()),
          f"value_at check at S={S} lacks found or not-found slots")
    b_ms, b_by = bound(S * V * 4 * 2 + S * 4, S * V * 2, "int32")
    row = dict(shape=f"B={S} V={V} every slot", op="search_ops.value_at",
               max_abs_err=max_err([got], [want]), bound_ms=b_ms,
               bound_by=b_by,
               **timed(lambda: search_ops.value_at(ts, pay, None,
                                                   SEARCH_T_ALL),
                       lambda: value_at_ref(ts, pay, None, SEARCH_T_ALL)))
    rows[f"value_at_{S}x{V}"] = dict(row, share_of_bound=b_ms / row["ms"])
    return rows


def chain_row(new: dict, chain: dict, plain: dict, bound_ms: float) -> dict:
    """Phase 3's timing keys of a main-path op beside the chain of ops it
    replaced; the op must run one device kernel per call and take less
    device time than the chain, in this run."""
    check(new["kernels"] == 1, f"one call ran {new['kernels']} device kernels")
    check(new["device_ms"] < chain["device_ms"],
          f"{new['device_ms']} ms on the card, the chain {chain['device_ms']}")
    return dict(ms=new["device_ms"], call_ms=new["call_ms"],
                kernels_per_call=new["kernels"], plain_ms=plain["device_ms"],
                plain_call_ms=plain["call_ms"], library_ms=None,
                library_call_ms=None, chain_ms=chain["device_ms"],
                chain_call_ms=chain["call_ms"],
                chain_launches=chain["kernels"],
                share_of_bound=bound_ms / new["device_ms"])


def sweep_chain(ts, succ, pay, ids, mask, ann, now):
    """The needed-sweep of the given slots as ``vstore._sweep_slots`` ran
    it before the sweep kernel: three row gathers, the compact op (with
    its count memset) and three masked scatters."""
    sid = ids.long()
    new_ts, new_succ, new_pay, freed, _ = compact_ops.compact(
        ts[sid], succ[sid], pay[sid], mask, ann, now)
    return (drop_set(ts, ids, new_ts, mask),
            drop_set(succ, ids, new_succ, mask),
            drop_set(pay, ids, new_pay, mask), freed.reshape(-1))


def sweep_case(dev) -> dict:
    """K1's main-path op at phase 5's slrt flush: R = 4096 ring lanes over
    the S = 256 x V = 8 slab, lane ids with duplicates and about 20 %
    unmasked lanes clamped onto slot 0 (ring holes), a board of 16.  The
    op, the old chain and the plain version must agree exactly."""
    g = torch.Generator().manual_seed(15)
    p = SERVE
    S, V, P = p["num_seqs"], p["versions_per_slot"], p["reader_lanes"]
    R = 2 * S * V                             # make_paged_kv's ring size
    ts, succ, pay = _store(g, S, V, dev)
    mask = torch.rand((R,), generator=g) < 0.8
    ids = torch.where(mask, torch.randint(0, S, (R,), generator=g,
                                          dtype=torch.int32), 0)
    ann = torch.randint(0, 4000, (P,), generator=g, dtype=torch.int32)
    ann[torch.rand((P,), generator=g) < 0.5] = TS_MAX
    args = (ts, succ, pay, ids.to(dev), mask.to(dev),
            torch.sort(ann).values.to(dev),
            torch.tensor(4000, dtype=torch.int32, device=dev))
    got = compact_ops.sweep(*args)
    want = sweep_ref(*args)
    old = sweep_chain(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want, strict=True)),
          "sweep kernel != plain version")
    check(all(torch.equal(a, b) for a, b in zip(got, old, strict=True)),
          "sweep kernel != the chain it replaced")
    check(bool((got[3] != EMPTY).any()), "sweep freed nothing: weak check")
    # slab read and written, lane ids and mask, freed, board and now
    nbytes = S * V * 12 * 2 + R * 5 + R * V * 4 + P * 4 + 4
    b_ms, b_by = bound(nbytes, (S + R) * V * math.log2(P), "int32")
    return dict(shape=f"S={S} V={V} R={R} P={P}", op="compact_ops.sweep",
                max_abs_err=max_err(got, want), bound_ms=b_ms, bound_by=b_by,
                **chain_row(time_call(lambda: compact_ops.sweep(*args)),
                            time_call(lambda: sweep_chain(*args)),
                            time_call(lambda: sweep_ref(*args)), b_ms))


def view_chain(ts, pay, tables, lengths, ids, t: int):
    """``paged.snapshot_view`` as it ran before the view kernel: the whole
    tables copied beside the lengths, ``t`` filled and expanded per query,
    the search+gather op, the table part sliced out, the lengths masked."""
    MP = tables.shape[1]
    values = torch.cat([tables, lengths[:, None]], dim=1)
    t_b = torch.full((), t, dtype=torch.int32,
                     device=ids.device).expand(ids.shape).contiguous()
    rows, _, found = search_ops.search_gather(ts, pay, values, ids, t_b)
    return rows[:, :MP].contiguous(), torch.where(found, rows[:, MP], 0)


def view_case(ts, pay, tables, lengths, ids, t: int) -> dict:
    """K2's main-path op at phase 5's view: B = 256 sequences over T = 2048
    table versions of MP = 256 pages, -1 padding and not-found rows, ``t``
    a Python int.  The op, the old chain and the plain version must agree
    exactly."""
    got = search_ops.view(ts, pay, tables, lengths, ids, t)
    want = view_ref(ts, pay, tables, lengths, ids, t)
    old = view_chain(ts, pay, tables, lengths, ids, t)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want, strict=True)),
          "view kernel != plain version")
    check(all(torch.equal(a, b) for a, b in zip(got, old, strict=True)),
          "view kernel != the chain it replaced")
    check(bool((got[0] == -1).any()) and bool((got[1] == 0).any()),
          "view check lacks -1 padding or not-found rows")
    (B, MP), T, V = got[0].shape, tables.shape[0], ts.shape[1]
    found = int(search_ops.search(ts, pay, ids, t)[1].sum())
    # ids, t, slab rows, found table rows and lengths, outputs
    nbytes = B * 4 + 4 + B * V * 4 * 2 + found * (MP + 1) * 4 \
        + B * (MP + 1) * 4
    b_ms, b_by = bound(nbytes, B * V * 2, "int32")
    return dict(shape=f"B={B} V={V} T={T} MP={MP}", op="search_ops.view",
                max_abs_err=max_err(got, want), bound_ms=b_ms, bound_by=b_by,
                **chain_row(
                    time_call(lambda: search_ops.view(ts, pay, tables,
                                                      lengths, ids, t)),
                    time_call(lambda: view_chain(ts, pay, tables, lengths,
                                                 ids, t)),
                    time_call(lambda: view_ref(ts, pay, tables, lengths, ids,
                                               t)), b_ms))


def visible_pairs(T: int, window: int, S: int | None = None,
                  causal: bool = True) -> int:
    """(row, column) pairs a prefill of T tokens attends to: causal over
    itself, or every one of S columns."""
    if not causal:
        return T * S
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
        S, causal = c.get("S", T), c.get("causal", True)
        kw = dict(causal=causal, window=c["window"], softcap=c["softcap"])
        q = torch.randn((B, Hq, T, D), generator=gd, device=dev, dtype=dtype)
        if "q_scale" in c:
            q = q * c["q_scale"]
        k = torch.randn((B, Hkv, S, D), generator=gd, device=dev, dtype=dtype)
        v = torch.randn((B, Hkv, S, D), generator=gd, device=dev, dtype=dtype)
        got = flash_ops.flash_attention(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = max_err([got], [want])
        check(bool(torch.isfinite(got.float()).all()), f"flash {case} not "
              "finite")
        # DECODE_TOL's limits: both versions sum in float32 in another
        # order, and the bf16 route rounds P to bf16 for the tensor cores.
        # Its largest differences on an H100 were 0.015625 at both bf16
        # shapes, above the bf16 atol: one bf16 rounding step of an output
        # in [2, 4), which rtol = 2**-7 allows.  The float32 case runs the
        # other kernel (the CUDA-core route), so the wgmma kernel is held
        # here only at the bf16 limits; tests/test_torch_gpu.py's marker
        # tests pin its causal, window and S masks exactly.
        tol = DECODE_TOL[kind]
        limit = tol["atol"] + tol["rtol"] * want.float().abs()
        if c.get("p_rounding"):
            # plus what rounding P to bf16 can move an output by: up to
            # 2**-8 of each term p_j |v_j|, so 2**-8 * sum_j p_j |v_j|,
            # the plain version on |V|.  An H100 run found one element
            # of the gemma2_global row (query row 1: two V values of 3.66
            # that cancel to 0.000575) at 0.00425 from the plain version,
            # above the atol: the design's own value, which the same sum
            # with P rounded to bf16 reproduces to 5e-6
            limit = limit + 2**-8 * attention_ref(q, k, v.abs(),
                                                    **kw).float()
        check(bool(((got.float() - want.float()).abs() <= limit).all()),
              f"flash_prefill {case} differs from plain version (max {err})")
        uncapped_err = None
        if "q_scale" in c:
            # control: the plain version without the cap is outside the
            # limit, so a kernel that ignored the softcap would fail here
            uncapped = attention_ref(q, k, v, **dict(kw, softcap=0.0))
            uncapped_err = max_err([uncapped], [want])
            check(not bool(((uncapped.float() - want.float()).abs()
                            <= limit).all()),
                  f"flash_prefill {case}: the uncapped plain version is "
                  f"within the limit (max {uncapped_err}), so the check "
                  "cannot see the softcap")
            del uncapped
        del limit
        check(torch.equal(got, flash_ops.flash_attention(q, k, v, **kw)),
              f"flash_prefill {case} not deterministic")
        del want
        elt = 2 if dtype == torch.bfloat16 else 4
        nbytes = 2 * (B * Hq * T * D + B * Hkv * S * D) * elt
        ops = 4.0 * B * Hq * D * visible_pairs(T, c["window"], S, causal)
        b_ms, b_by = bound(nbytes, ops, kind)
        # yardstick: SDPA (GQA) where it computes the same function: it has
        # no logit softcap or window flag (a window as long as the prompt
        # changes nothing)
        library = None
        if (c["window"] == 0 or c["window"] >= T) and c["softcap"] == 0:
            def library():
                return sdpa(q, k, v, is_causal=causal, enable_gqa=True)
        name = "flash_prefill" if case == "serve" else f"flash_prefill_{case}"
        row = dict(shape=f"B={B} Hq={Hq} Hkv={Hkv} T={T} S={S} D={D} "
                         f"causal={causal} window={c['window']} "
                         f"softcap={c['softcap']} {kind}",
                   route=flash_ops.ROUTES[dtype], max_abs_err=err,
                   **({} if uncapped_err is None else dict(
                       q_scale=c["q_scale"],
                       uncapped_max_abs_err=uncapped_err)),
                   **DECODE_TOL[kind], bound_ms=b_ms, bound_by=b_by,
                   **timed(lambda: flash_ops.flash_attention(q, k, v, **kw),
                           lambda: attention_ref(q, k, v, **kw), library))
        rows[name] = dict(row, share_of_bound=b_ms / row["ms"],
                          ms_before_recorded=MS_BEFORE_RECORDED.get(name))
        del q, k, v, got
        torch.cuda.empty_cache()
    return rows


def flash_backward_cases(dev) -> dict:
    """K6b against attention_bwd_ref at phase 3's FLASH_BWD shapes in both
    routes, from K6's own output and row LSE (K6's float32 route, or its
    wgmma route in bf16); the "gemma2_train" cases are the kernel table's
    rows.  The yardstick is torch.autograd.grad through SDPA in the same
    dtype (its backward only) where SDPA computes the same function: no
    softcap, and a window that covers the sequence or none.  Each row's
    bound is in its route's unit (split-TF32: three tf32 products for each
    of the backward's; bf16); a float32 row also has the bound of the
    CUDA-core design it replaced (bound_cuda_core_ms).  A bf16 row records
    its limit by name and limit_ratio, the largest |got - want| over that
    limit (at most 1)."""
    gd = torch.Generator(device=dev).manual_seed(7)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for case, c in FLASH_BWD.items():
        for kind in ("f32", "bf16"):
            dtype = DTYPES[kind]
            B, Hq, Hkv, T, D = c["B"], c["Hq"], c["Hkv"], c["T"], c["D"]
            S, causal = c.get("S", T), c.get("causal", True)
            kw = dict(causal=causal, window=c["window"], softcap=c["softcap"])
            q, k, v, do = (torch.randn(shape, generator=gd, device=dev
                                       ).to(dtype)
                           for shape in ((B, Hq, T, D), (B, Hkv, S, D),
                                         (B, Hkv, S, D), (B, Hq, T, D)))
            o, lse = flash_ops._launch(q, k, v, causal, c["window"],
                                       c["softcap"], lse=True)
            o_ref, lse_ref = attention_lse_ref(q, k, v, **kw)
            check(max_err([lse], [lse_ref]) <= 1e-4 and (
                kind == "bf16" or max_err([o], [o_ref]) <= 1e-4),
                f"flash_backward {case} {kind}: K6's output or LSE off the "
                "plain version")
            del o_ref, lse_ref

            def kernel():
                return flash_ops.flash_attention_backward(q, k, v, o, do, lse,
                                                          **kw)

            def plain():
                return attention_bwd_ref(q, k, v, o, do, lse, **kw)

            route = flash_ops.BWD_ROUTES[dtype]
            before = flash_ops.flash_attention_backward.route_launches[route]
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            check(flash_ops.flash_attention_backward.route_launches[route]
                  == before + 1, f"flash_backward {case}: not route {route}")
            err = max_err(got, want)
            check(all(bool(torch.isfinite(g).all()) for g in got),
                  f"flash_backward {case} {kind} not finite")
            if kind == "f32":
                tol = FLASH_BWD_TOL
                ok = all(torch.allclose(g, w, **tol)
                         for g, w in zip(got, want))
            else:
                # the largest |got - want| over its limit (at most 1)
                tol = dict(tolerance="BF16_BWD_TOL + bwd_bf16_rounding",
                           limit_ratio=bwd_bf16_margin(got, want, q, k, v, o,
                                                       do, lse, **kw))
                ok = tol["limit_ratio"] <= 1.0
            check(ok, f"flash_backward {case} {kind} differs from plain "
                  f"version (max {err})")
            check(all(torch.equal(a, b) for a, b in zip(got, kernel())),
                  f"flash_backward {case} {kind} not deterministic")
            del got, want
            library = None
            if (c["window"] == 0 or c["window"] >= T) and c["softcap"] == 0:
                leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
                out_lib = sdpa(*leaves, is_causal=causal, enable_gqa=True)

                def library():
                    return torch.autograd.grad(out_lib, leaves, do,
                                               retain_graph=True)
            # read q, k, v, o, dO and the LSE once, write dq, dk, dv once;
            # five T x S x D products per query head over the visible pairs
            elt = 2 if kind == "bf16" else 4
            nbytes = (elt * (3 * B * Hq * T * D + 2 * B * Hkv * S * D
                             + B * Hq * T * D + 2 * B * Hkv * S * D)
                      + 4 * B * Hq * T)
            ops = 10.0 * B * Hq * D * visible_pairs(T, c["window"], S, causal)
            b_ms, b_by = (bound(nbytes, 3 * ops, "tf32") if kind == "f32"
                          else bound(nbytes, ops, "bf16"))
            name = "flash_backward" + ("_bf16" if kind == "bf16" else "") + (
                "" if case == "gemma2_train" else f"_{case}")
            row = dict(shape=f"B={B} Hq={Hq} Hkv={Hkv} T={T} S={S} D={D} "
                             f"causal={causal} window={c['window']} "
                             f"softcap={c['softcap']} {kind}",
                       route=route, max_abs_err=err, **tol, bound_ms=b_ms,
                       bound_by=b_by,
                       bound_unit="tf32 x 3" if kind == "f32" else "bf16",
                       # the CUDA-core design this route replaced (float32)
                       **({} if kind == "bf16" else dict(
                           bound_cuda_core_ms=bound(nbytes, ops, "f32")[0])),
                       library_what=None if library is None else
                       "torch.autograd.grad through SDPA (its backward), "
                       + kind,
                       **timed(kernel, plain, library))
            rows[name] = dict(row, share_of_bound=b_ms / row["ms"],
                              ms_before_recorded=MS_BEFORE_RECORDED.get(name))
            del q, k, v, do, o, lse, library
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
# phases 7-8: fork_bench's workloads (benchmarks/fork_bench.py:109-353)
# ---------------------------------------------------------------------------
class ForkRun:
    """One engine run's host-side accounting: the COW main run, the eager
    control or the no-checkpoint control.  K/V rows are seeded normal
    draws, distinct per (step, sequence) in float32 and bfloat16 alike, so
    a wrongly recycled page shows in a prefix check."""

    def __init__(self, p: dict, policy: str, eager: bool, dev,
                 dtype=torch.float32):
        self.p, self.dev, self.dtype = p, dev, dtype
        self.B = p["num_seqs"]
        self.heads = (p.get("kv_heads", 1), p.get("head_dim", 4))
        self.eng = PagedKVEngine(
            self.B, p["num_pages"], p["page_size"], p["max_pages_per_seq"],
            *self.heads,
            gc=GCConfig(policy=policy,
                        versions_per_slot=p["versions_per_seq"],
                        reader_lanes=p.get("reader_lanes", 4),
                        hot_k=p["num_seqs"]),
            eager_fork=eager, dtype=dtype, device=dev)
        self.validator = forking.ForkValidator()
        self.gen = torch.Generator(device=dev).manual_seed(p["seed"])
        self.ids = torch.arange(self.B, dtype=torch.int32, device=dev)
        self.check_appends = p.get("check_appends", True)
        self.tokens = self.step_no = self.shared_peak = self.leaks = 0
        self.ckpt_saves = 0
        self.ckpt_seconds = 0.0

    def _sample(self) -> None:
        self.shared_peak = max(self.shared_peak,
                               forking.shared_page_count(self.eng.st))
        self.leaks += not forking.check_no_leak(self.eng.st)[0]

    def views(self):
        tbl, ln = self.eng.view_at(NOW_TS)
        return tbl.cpu().numpy(), ln.cpu().numpy()

    def _mask(self, n: int) -> torch.Tensor:
        return torch.ones((n,), dtype=torch.bool, device=self.dev)

    def _pairs(self, pairs):
        return (torch.tensor([s for s, _ in pairs], dtype=torch.int32,
                             device=self.dev),
                torch.tensor([d for _, d in pairs], dtype=torch.int32,
                             device=self.dev))

    def append(self, mask: np.ndarray) -> np.ndarray:
        """One decode step over ``mask``."""
        self.step_no += 1
        kv = torch.randn((self.B, *self.heads), generator=self.gen,
                         device=self.dev, dtype=self.dtype)
        failed = self.eng.step(self.ids, kv, kv,
                               torch.as_tensor(mask, device=self.dev))
        failed = failed.cpu().numpy()
        self.tokens += int((mask & ~failed).sum())
        if self.check_appends:
            self._sample()
        return failed

    def fork(self, pairs) -> None:
        """Fork (src, dst) pairs and register each child's prefix."""
        failed = self.eng.fork(*self._pairs(pairs), self._mask(len(pairs)))
        self._sample()
        tbl, ln = self.views()
        for (_, d), bad in zip(pairs, failed.cpu().numpy()):
            if not bad:
                self.validator.note_fork(self.eng.st, d, tbl[d], int(ln[d]))

    def check_children(self, children) -> None:
        tbl, ln = self.views()
        for c in children:
            self.validator.check(self.eng.st, c, tbl[c], int(ln[c]))

    def join(self, pairs) -> None:
        self.eng.join(*self._pairs(pairs), self._mask(len(pairs)))
        for s, _ in pairs:
            self.validator.drop(s)
        self._sample()

    def release(self, slots) -> None:
        self.eng.release(torch.tensor(slots, dtype=torch.int32,
                                      device=self.dev),
                         self._mask(len(slots)))
        for s in slots:
            self.validator.drop(s)
        self._sample()


def _beam_workload(run: ForkRun) -> None:
    """Each root forks ``beam_width`` children, children decode
    ``child_tokens`` steps (prefix-checked each step), the root advances
    one token, then one child per root joins back (every ``join_every``-th
    round; the first child, or a seeded one with ``best_seed``) and the
    rest release."""
    p = run.p
    roots = list(p["roots"])
    child_slots = [s for s in range(run.B) if s not in roots]
    best = random.Random(p["best_seed"]) if "best_seed" in p else None
    mask0 = np.zeros((run.B,), bool)
    mask0[roots] = True
    for _ in range(p["prefill"]):
        run.append(mask0)
    for rnd in range(p["rounds"]):
        pairs, by_root = [], {}
        free = list(child_slots)
        for r in roots:
            kids = [free.pop(0) for _ in range(p["beam_width"])]
            by_root[r] = kids
            pairs.extend((r, k) for k in kids)
        run.fork(pairs)
        kids_mask = np.zeros((run.B,), bool)
        kids_mask[[k for _, k in pairs]] = True
        for _ in range(p["child_tokens"]):
            run.append(kids_mask)
            run.check_children([k for _, k in pairs])
        run.append(mask0)     # the root advances: parent and child tails differ
        run.check_children([k for _, k in pairs])
        if (rnd + 1) % p["join_every"] == 0:
            win = {r: by_root[r][best.randrange(p["beam_width"])
                                 if best else 0] for r in roots}
            run.join([(win[r], r) for r in roots])
            run.release([k for r in roots for k in by_root[r]
                         if k != win[r]])
        else:
            run.release([k for r in roots for k in by_root[r]])


def _spec_workload(run: ForkRun) -> None:
    """Each root forks a draft that runs ``draft_tokens`` ahead; even
    rounds accept (join), odd rounds reject (release)."""
    p = run.p
    roots = list(p["roots"])
    drafts = [s for s in range(run.B) if s not in roots][:len(roots)]
    mask0 = np.zeros((run.B,), bool)
    mask0[roots] = True
    for _ in range(p["prefill"]):
        run.append(mask0)
    draft_mask = np.zeros((run.B,), bool)
    draft_mask[drafts] = True
    for rnd in range(p["rounds"]):
        pairs = list(zip(roots, drafts))
        run.fork(pairs)
        for _ in range(p["draft_tokens"]):
            run.append(draft_mask)
            run.check_children(drafts)
        if rnd % 2 == 0:
            run.join([(d, r) for r, d in pairs])
        else:
            run.release(drafts)


def _ckpt_workload(run: ForkRun, with_ckpt: bool) -> None:
    """All sequences decode ``phase1_steps``, then the first ``idle`` go
    quiet while the rest decode on.  With ``with_ckpt`` the engine
    checkpoints at the boundary; one active step moves the active current
    versions past ``ckpt_max``, and a forced reclaim evicts the idle sole
    survivors.  The control runs the same schedule without the
    checkpoint (and, with ``control_stops_at_give_up``, stops at its first
    give-up)."""
    p = run.p
    all_mask = np.ones((run.B,), bool)
    active_mask = np.zeros((run.B,), bool)
    active_mask[p["idle"]:] = True
    for _ in range(p["phase1_steps"]):
        run.append(all_mask)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        if with_ckpt:
            t0 = time.perf_counter()
            run.eng.checkpoint(d)
            run.ckpt_seconds += time.perf_counter() - t0
            run.ckpt_saves += 1
        run.append(active_mask)
        run.eng.reclaim(p["num_seqs"] * p["versions_per_seq"])
        for _ in range(p["phase2_steps"] - 1):
            failed = run.append(active_mask)
            if failed.any() and not with_ckpt \
                    and p.get("control_stops_at_give_up"):
                break


def fork_cell(p: dict, policy: str, dev, dtype=torch.float32):
    """``fork_bench.run_cell`` on ``dev``: the main run, then its eager-copy
    or no-checkpoint control.  Returns (row of FORK_FIELDS plus leak
    checks and seconds, the main run)."""
    t0 = time.perf_counter()
    main = ForkRun(p, policy, False, dev, dtype)
    eager = control = None
    if p["kind"] == "ckpt":
        _ckpt_workload(main, with_ckpt=True)
        control = ForkRun(p, policy, False, dev, dtype)
        _ckpt_workload(control, with_ckpt=False)
    else:
        work = _beam_workload if p["kind"] == "beam" else _spec_workload
        work(main)
        eager = ForkRun(p, policy, True, dev, dtype)
        work(eager)
    eng, v = main.eng, main.validator
    eager_peak = eager.eng.peak_pages if eager is not None else 0
    row = dict(
        forks=eng.forks, joins=eng.joins, releases=eng.releases,
        pages_shared_peak=main.shared_peak, peak_pages=eng.peak_pages,
        eager_peak_pages=eager_peak,
        shared_savings_pages=(max(0, eager_peak - eng.peak_pages)
                              if eager is not None else 0),
        prefix_checks=v.checked, prefix_violations=v.violations,
        ckpt_saves=main.ckpt_saves,
        ckpt_evictions=eng.stats.ckpt_evictions,
        ckpt_pages_freed=eng.stats.ckpt_freed,
        control_ckpt_pages_freed=(control.eng.stats.ckpt_freed
                                  if control is not None else 0),
        control_end_pages=(int(control.eng.space()["live_pages"])
                           if control is not None else 0),
        pressure_events=eng.pressure_events,
        reclaims_triggered=eng.reclaims_triggered,
        pages_reclaimed=eng.pages_reclaimed, give_ups=eng.give_ups)
    row.update(leak_checks_failed=main.leaks,
               control_leak_checks_failed=(eager or control).leaks,
               decode_steps=main.step_no, tokens_appended=main.tokens,
               seconds=time.perf_counter() - t0)
    if control is not None:
        row.update(control_give_ups=control.eng.give_ups,
                   control_steps=control.step_no)
    return row, main


def bench_fork_rows() -> dict:
    """BENCH_fork.json's rows keyed by (tier, policy)."""
    with open(os.path.join(ROOT, "BENCH_fork.json")) as f:
        return {(r["figure"].split("/")[1], r["scheme"]): r
                for r in json.load(f)["rows"]}


def phase_fork_tiers(dev) -> None:
    bench = bench_fork_rows()
    rows = {(tier, policy): fork_cell(FORK_TIERS[tier], policy, dev)[0]
            for tier in FORK_TIERS for policy in FORK_POLICIES}
    check(set(rows) == set(bench), "fork tiers differ from BENCH_fork.json")
    for key, got in rows.items():
        want = {f: bench[key][f] for f in FORK_FIELDS}
        same = {f: got[f] for f in FORK_FIELDS} == want
        emit({"phase": "fork_tiers", "tier": key[0], "policy": key[1], **got,
              "matches_bench_fork": same})
        check(same, f"fork tier {key} differs from BENCH_fork.json: "
              f"{ {f: (got[f], want[f]) for f in FORK_FIELDS if got[f] != want[f]} }")
        check(got["prefix_violations"] == 0 and got["leak_checks_failed"] == 0
              and got["control_leak_checks_failed"] == 0,
              f"fork tier {key}: prefix or leak violations")


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def restore_check(eng: PagedKVEngine, dev) -> dict:
    """Checkpoint ``eng`` whole, restore it into a fresh engine on ``dev``:
    every leaf bit-equal, the host-side state equal; then both decode
    RESTORE_STEPS identical steps and must stay equal, down to a paged
    decode over their current views.  Returns the phase's numbers."""
    st = eng.st
    B, ps, Hkv, D = (st.mv.store.ts.shape[0], st.page_size,
                     st.k_pages.shape[2], st.k_pages.shape[3])
    fresh = PagedKVEngine(B, st.free.shape[0], ps, st.max_pages, Hkv, D,
                          gc=eng.gc, eager_fork=eng.eager_fork,
                          dtype=st.k_pages.dtype, device=dev)

    def same_state(a: PagedKVEngine, b: PagedKVEngine) -> bool:
        return all(torch.equal(x, y) for x, y in
                   zip(tree_flatten(a.st), tree_flatten(b.st), strict=True)) \
            and a.stats == b.stats and a.dag == b.dag \
            and a._freed_pages == b._freed_pages and a.ckpt_max == b.ckpt_max

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = eng.checkpoint(d)
        save_s = time.perf_counter() - t0
        nbytes = _dir_bytes(d)
        t0 = time.perf_counter()
        fresh.restore(d)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    restored_equal = same_state(eng, fresh)
    check(restored_equal, "restored engine differs from the saved one")
    gen = torch.Generator(device=dev).manual_seed(13)
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    ones = torch.ones((B,), dtype=torch.bool, device=dev)
    for _ in range(RESTORE_STEPS):
        kv = torch.randn((B, Hkv, D), generator=gen, device=dev,
                         dtype=st.k_pages.dtype)
        fa, fb = eng.step(ids, kv, kv, ones), fresh.step(ids, kv, kv, ones)
        check(torch.equal(fa, fb), "restored engine failed other lanes")
        check(eng.freed_pages() == fresh.freed_pages(),
              "restored engine freed other pages")
    check(same_state(eng, fresh), "restored engine diverged in decode")
    q = torch.randn((B, 3 * Hkv, D), generator=gen, device=dev,
                    dtype=st.k_pages.dtype)
    outs = [decode_ops.paged_decode(q, e.st.k_pages, e.st.v_pages,
                                    *e.view_at(NOW_TS)) for e in (eng, fresh)]
    check(torch.equal(*outs), "paged decode differs after restore")
    check(bool(torch.isfinite(outs[0].float()).all()), "decode not finite")
    return dict(step=step, bytes_written=nbytes, save_s=save_s,
                restore_s=restore_s, save_gb_s=nbytes / save_s / 1e9,
                restore_gb_s=nbytes / restore_s / 1e9,
                restored_bit_equal=restored_equal,
                steps_after_restore=RESTORE_STEPS)


def phase_durability(dev) -> dict:
    """The slice's main path at phase 5's pool size: fork validation
    (beam), checkpoint-armed eviction (churn) and save/restore."""
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    beam, run = fork_cell(DURABLE_BEAM, "slrt", dev, torch.bfloat16)
    del run
    torch.cuda.empty_cache()
    emit({"phase": "durability", "part": "beam", **beam})
    check(beam["shared_savings_pages"] > 0, "COW forks saved no pages")
    check(beam["prefix_violations"] == 0 and beam["prefix_checks"] > 0,
          "fork prefix violations (or no checks)")
    check(beam["leak_checks_failed"] == 0
          and beam["control_leak_checks_failed"] == 0, "page leak in beam")
    churn, run = fork_cell(DURABLE_CHURN, "slrt", dev, torch.bfloat16)
    emit({"phase": "durability", "part": "churn",
          "ckpt_save_s": run.ckpt_seconds, **churn})
    check(churn["ckpt_pages_freed"] > 0, "checkpoint eviction freed nothing")
    check(churn["give_ups"] == 0, "checkpointed churn gave up")
    check(churn["control_ckpt_pages_freed"] == 0, "control evicted pages")
    check(churn["control_give_ups"] > 0, "control never ran out of pages: "
          "the churn is not sized past the pool")
    restore = restore_check(run.eng, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    emit({"phase": "durability", "part": "restore", **restore,
          "seconds": wall,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
          "launches": launches})
    for name in ("compact", "search_gather", "paged_decode"):
        check(launches[name] > 0, f"{name} kernel never launched in "
              "durability")
    del run
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 9-10: the multi-host layer (benchmarks/dist_bench.py:124-252)
# ---------------------------------------------------------------------------
def _view_checksum(local_st, tbl, ln, page_size: int) -> tuple:
    """The exact K values of every token a host's snapshot view covers (a
    wrongly recycled page changes them even when the table is unchanged)."""
    k = local_st.k_pages[:, :, 0, 0].cpu().numpy()
    tbl, ln = tbl.cpu().numpy(), ln.cpu().numpy()
    return tuple((int(ln[s]), tuple(float(k[tbl[s, j // page_size],
                                              j % page_size])
                                     for j in range(int(ln[s]))))
                 for s in range(tbl.shape[0]))


def dist_cell(tier: str, policy: str, dev) -> dict:
    """``dist_bench.run_cell`` on the port's engine: every field of the
    BENCH_dist.json row that the run sets, but ``wall_s``."""
    p = DIST_TIERS[tier]
    H, B, ps = p["hosts"], p["num_seqs"], p["page_size"]
    eng = ShardedPagedKVEngine(
        H, B, p["num_pages"], ps, p["max_pages_per_seq"], DIST_KV_HEADS,
        DIST_HEAD_DIM,
        gc=GCConfig(policy=policy, versions_per_slot=p["versions_per_seq"],
                    reader_lanes=DIST_READER_LANES,
                    stale_after_s=STALE_AFTER_S),
        dtype=torch.float32, device=dev)
    rng = random.Random(p["seed"])
    targets = [[rng.randrange(p["min_len"], p["max_len"] + 1)
                for _ in range(B)] for _ in range(H)]
    cur_len = [[0] * B for _ in range(H)]
    seq_ids = torch.arange(B, dtype=torch.int32, device=dev).expand(H, B)
    live_mask = np.ones((H, B), bool)      # stalled host rows drop out
    tokens = completed = pins = validated = violations = 0
    live_pins = {}       # (host, lane) -> [ts, reference checksum, hold]
    next_pin = 0

    def checksum(host, ts):
        return _view_checksum(eng.host_state(host), *eng.view_at(host, ts),
                              ps)

    def check_pins() -> None:
        nonlocal validated, violations
        for (host, lane), (ts, ref, _) in live_pins.items():
            validated += 1
            violations += checksum(host, ts) != ref

    for step in range(p["steps"]):
        if p["stall_host"] is not None and step == p["stall_after"]:
            ages = np.zeros((H,), np.float32)
            ages[p["stall_host"]] = STALLED_AGE_S
            eng.virtual_ages_s = ages
            live_mask[p["stall_host"], :] = False
        base = (np.arange(H * B, dtype=np.float32).reshape(H, B)
                + H * B * (step + 1))
        kv = torch.as_tensor(base, device=dev)[:, :, None, None].expand(
            H, B, DIST_KV_HEADS, DIST_HEAD_DIM)
        failed = eng.step(seq_ids, kv, kv,
                          torch.as_tensor(live_mask, device=dev))
        failed = failed.cpu().numpy()
        for h in range(H):
            for s in range(B):
                if live_mask[h, s] and not failed[h, s]:
                    tokens += 1
                    cur_len[h][s] += 1
        done = np.array([[cur_len[h][s] >= targets[h][s] for s in range(B)]
                         for h in range(H)]) & live_mask
        if done.any():
            eng.reset(seq_ids, torch.as_tensor(done, device=dev))
            for h, s in zip(*np.nonzero(done)):
                completed += 1
                cur_len[h][s] = 0
                targets[h][s] = rng.randrange(p["min_len"], p["max_len"] + 1)
        if step % p["pin_every"] == 0 and len(live_pins) < H:
            host = next_pin % H
            lane = (next_pin // H) % DIST_READER_LANES
            next_pin += 1
            if (host, lane) not in live_pins:
                ts = eng.pin(host, lane)
                live_pins[(host, lane)] = [ts, checksum(host, ts),
                                           p["pin_hold"]]
                pins += 1
        check_pins()
        for key in list(live_pins):
            live_pins[key][2] -= 1
            # the stalled host never unpins: only aging moves the LWM past it
            if live_pins[key][2] <= 0 and key[0] != p["stall_host"]:
                eng.unpin(*key)
                del live_pins[key]
    check_pins()
    for key in list(live_pins):
        eng.unpin(*key)

    space = eng.space()
    stalled = int((eng.ages_s() > eng.budget_s()).sum())
    ts_arr = eng.stacked().mv.store.ts.cpu().numpy()
    occ = (ts_arr != EMPTY).sum(axis=-1)
    steps_n = p["steps"]
    work = tokens + validated
    return dict(
        bench="dist", figure=f"dist_kv/{tier}", ds="paged_kv",
        scheme=policy, mix=tier, scan_size=0, zipf=0.0,
        n_keys=space["page_pool"], num_procs=H * B, ops_per_proc=steps_n,
        seed=p["seed"], updates=tokens, lookups=0, scans=pins,
        scan_keys=validated, total_work=work,
        ops_per_mwork=round((tokens + pins) / max(1, work) * 1e6, 3),
        updates_per_mwork=round(tokens / max(1, work) * 1e6, 3),
        scan_keys_per_mwork=round(validated / max(1, work) * 1e6, 3),
        peak_space_words=space["peak_pages"],
        peak_versions=int(occ.max()),
        avg_space_words=0,
        end_space_words=space["live_pages"],
        end_versions_per_list=round(int((ts_arr != EMPTY).sum()) / (H * B),
                                    4),
        scans_validated=validated, scan_violations=violations,
        reclaims_triggered=space["reclaims_triggered"],
        peak_space_post_reclaim=space["peak_pages_post_reclaim"],
        pressure_events=space["pressure_events"],
        pages_reclaimed=space["pages_reclaimed"],
        peak_pages=space["peak_pages"],
        peak_pages_post_reclaim=space["peak_pages_post_reclaim"],
        page_pool=space["page_pool"], page_size=ps,
        decode_steps=steps_n, tokens_appended=tokens,
        sequences_completed=completed, forks=0,
        give_ups=space["give_ups"], snapshot_pins=pins,
        overflow_count=space["overflows"],
        dropped_retires=space["dropped_retires"],
        hosts=H, lwm=space["lwm"], lwm_advances=space["lwm_advances"],
        stale_lanes_aged=space["stale_lanes_aged"], stalled_hosts=stalled,
        under_pressure_hosts=space["under_pressure_hosts"],
        pin_violations=violations)


def bench_dist_rows() -> dict:
    """BENCH_dist.json's rows keyed by (tier, policy), as committed."""
    with open(os.path.join(ROOT, "BENCH_dist.json")) as f:
        return {(r["figure"].split("/")[1], r["scheme"]): r
                for r in json.load(f)["rows"]}


def expected_dist_rows() -> dict:
    """The rows the port must give: BENCH_dist.json's, with the fields
    trap C11 moves taken from ``DIST_C11_FIELDS``."""
    return {key: {**row, **DIST_C11_FIELDS.get(key, {})}
            for key, row in bench_dist_rows().items()}


def phase_dist_tiers(dev, tiers=tuple(DIST_TIERS)) -> None:
    """BENCH_dist.json's rows of ``tiers`` (phase 9: every tier) through
    ``dist_cell``, each against the committed row."""
    bench = expected_dist_rows()
    keys = [(t, p) for t in tiers for p in DIST_POLICIES]
    check(set(keys) <= set(bench) and (
        tiers != tuple(DIST_TIERS) or set(keys) == set(bench)),
        "dist tiers differ from BENCH_dist.json")
    for key in keys:
        t0 = time.perf_counter()
        got = dist_cell(*key, dev)
        diff = {f: (v, bench[key][f]) for f, v in got.items()
                if v != bench[key][f]}
        emit({"phase": "dist_tiers", "tier": key[0], "policy": key[1],
              **{f: got[f] for f in DIST_FIELDS},
              "matches_bench_dist": not diff,
              "c11_fields": sorted(DIST_C11_FIELDS.get(key, {})),
              "seconds": time.perf_counter() - t0})
        check(not diff, f"dist tier {key} differs from BENCH_dist.json: "
              f"{diff}")
        check(got["pin_violations"] == 0, f"dist tier {key}: pin violations")
        check(not got["stalled_hosts"] or got["stale_lanes_aged"] > 0,
              f"dist tier {key}: the stalled host was never aged out")


def _digest(*tensors) -> str:
    """A digest of tensors' exact bytes (a view's tables and lengths, a
    decode's output)."""
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def phase_dist_serve(dev, p: dict = DIST_SERVE, name: str = "dist"
                     ) -> dict:
    """4 hosts, each at phase 5's pool, under dist_bench's stall traffic:
    rotating pinned readers whose views and K4 outputs must stay
    bit-identical while held, and host 1 wedged with a pin from step 1024
    on (aged out of the LWM; its own view must stay bit-identical).  Runs
    until every live host has crossed its watermark, plus 64 steps.  The
    same loop runs on every rank of phase 10d, the engine spread over
    them by its default mesh: each host's reads (views, K4, the final K1
    check) run where its shard is (``host_apply``).  Returns the phase's
    line, with the LWM after every step and a digest of every view and
    decode output."""
    H, B, N = p["hosts"], p["num_seqs"], p["num_pages"]
    Hkv, D, Hq = p["kv_heads"], p["head_dim"], p["q_heads"]
    lanes, stall_host = p["reader_lanes"], p["stall_host"]
    eng = ShardedPagedKVEngine(
        H, B, N, p["page_size"], p["max_pages_per_seq"], Hkv, D,
        gc=GCConfig(policy="slrt", versions_per_slot=p["versions_per_slot"],
                    reader_lanes=lanes, stale_after_s=STALE_AFTER_S),
        dtype=torch.bfloat16, device=dev)
    lo = max(1, int(eng.gc.page_watermark * N))
    rngs = [random.Random(p["seed"] + h) for h in range(H)]
    gen = torch.Generator(device=dev).manual_seed(p["seed"])
    targets = np.array([[rngs[h].randrange(p["min_len"], p["max_len"] + 1)
                         for _ in range(B)] for h in range(H)])
    cur = np.zeros((H, B), np.int64)
    ids = torch.arange(B, dtype=torch.int32, device=dev).expand(H, B)
    live = np.ones((H, B), bool)
    live_t = torch.ones((H, B), dtype=torch.bool, device=dev)
    tokens = completed = pins = views_checked = violations = decodes = 0
    readers = {}            # (host, lane) -> [ts, view, q, out, hold]
    crossed = [None] * H    # step at which each host crossed its watermark
    stall = None

    lwm_trace, digests = [], []

    def decode(host, view, q):
        out = eng.host_apply(host, lambda st: decode_ops.paged_decode(
            q, st.k_pages, st.v_pages, *view))
        digests.append(_digest(out))
        return out

    def held(host, ts, view) -> bool:
        return all(torch.equal(a, b)
                   for a, b in zip(eng.view_at(host, ts), view))

    def decode_step():
        """One token for every live sequence on every host; finished ones
        reset, with each host's own target draws."""
        k = torch.randn((H, B, Hkv, D), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        v = torch.randn((H, B, Hkv, D), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        failed = eng.step(ids, k, v, live_t).cpu().numpy()
        ok = live & ~failed
        cur[:] += ok
        done = (cur >= targets) & live
        if done.any():
            eng.reset(ids, torch.as_tensor(done, device=dev))
            cur[done] = 0
            for h, s in zip(*np.nonzero(done)):
                targets[h, s] = rngs[h].randrange(p["min_len"],
                                                  p["max_len"] + 1)
        return int(ok.sum()), int(done.sum())

    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step = 0
    while step < p["max_steps"]:
        if step == p["stall_after"]:
            # host 1 pins, then wedges: its rows stop, its announcement
            # ages past the budget, and it never unpins
            ts = eng.pin(stall_host, lanes - 1)
            view = eng.view_at(stall_host, ts)
            digests.append(_digest(*view))
            q = torch.randn((B, Hq, D), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            stall = [ts, view, q, decode(stall_host, view, q)]
            decodes += 1
            ages = np.zeros((H,), np.float32)
            ages[stall_host] = STALLED_AGE_S
            eng.virtual_ages_s = ages
            live[stall_host] = False
            live_t = torch.as_tensor(live, device=dev)
        appended, finished = decode_step()
        lwm_trace.append(eng._last_lwm)
        tokens += appended
        completed += finished
        for h in range(H):
            if crossed[h] is None and eng.peak_pages_by_host[h] > N - lo:
                crossed[h] = step
        if step % p["pin_every"] == 0:
            host = pins % H
            if stall is not None and host == stall_host:
                pins += 1
                host = pins % H
            lane = (pins // H) % lanes
            ts = eng.pin(host, lane)
            view = eng.view_at(host, ts)
            digests.append(_digest(*view))
            q = torch.randn((B, Hq, D), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            readers[(host, lane)] = [ts, view, q, decode(host, view, q),
                                     p["pin_hold"]]
            pins += 1
            decodes += 1
        for key in list(readers):
            ts, view, q, out, hold = readers[key]
            same = held(key[0], ts, view)
            views_checked += 1
            readers[key][4] = hold - 1
            if hold - 1 <= 0:
                again = decode(key[0], view, q)
                decodes += 1
                same = same and torch.equal(again, out)
                check(bool(torch.isfinite(again.float()).all()),
                      "decode output not finite")
                eng.unpin(*key)
                del readers[key]
            violations += not same
        step += 1
        live_hosts = [h for h in range(H) if stall is None or h != stall_host]
        if stall is not None and all(crossed[h] is not None
                                     for h in live_hosts) \
                and step > max(crossed[h] for h in live_hosts) \
                + p["steps_after_pressure"]:
            break
        # ranks must take the same branch: over ranks (phase 10d) the step
        # count is phase 10's and max_seconds is inf, as a clock read on
        # each rank could stop one rank a step before the others
        if time.perf_counter() - t0 > p["max_seconds"]:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    stall_same = stall is not None and held(stall_host, stall[0], stall[1]) \
        and torch.equal(decode(stall_host, stall[1], stall[2]), stall[3])
    space = eng.space()
    res = dict(phase=f"{name}_serve", hosts=H, steps=step, seconds=wall,
               tokens_appended=tokens, tokens_per_s=tokens / wall,
               ms_per_step=wall / step * 1e3,
               sequences_completed=completed, snapshot_pins=pins,
               views_checked=views_checked, decodes=decodes,
               violations=violations, stalled_view_bit_identical=stall_same,
               watermark_crossed_at_step=crossed,
               pages_reclaimed_by_host=eng.pages_reclaimed_by_host,
               peak_pages_by_host=eng.peak_pages_by_host,
               lwm_refreshes=eng.lwm_refreshes,
               lwm_refreshes_per_step=eng.lwm_refreshes / step,
               space=space,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches)
    check(stall is not None, f"the stall step never came in {step} steps")
    # K1 on every shard's own store under the board its shard ops sort:
    # the local board plus the global LWM as one extra pin (17 entries),
    # with the LWM a refresh gives now, the TS_MAX sentinel and the
    # stalled host's pin as a real timestamp.  A pin on every live host
    # and two more steps first, so that every live store holds superseded
    # versions that only the pins keep
    held_now = [(h, next(ln for ln in range(lanes) if (h, ln) not in readers))
                for h in live_hosts]
    for h, lane in held_now:
        eng.pin(h, lane)
    decode_step()
    decode_step()
    lwm = eng.lwm_pins()
    res["sweep_lwm_pin"] = int(lwm[0, 0])
    sweeps = [eng.host_apply(h, lambda st, h=h: check_sweep_on_store(
        st.mv, must_kill=h != stall_host,
        pins={"LWM now": lwm[h], "TS_MAX": TS_MAX, "stall pin": stall[0]}))
        for h in range(H)]
    res["sweeps_checked"] = sum(c["sweeps_checked"] for c in sweeps)
    res["sweep_killed_unpinned_by_host"] = [c["sweep_killed_unpinned"]
                                            for c in sweeps]
    for key in list(readers) + held_now:
        eng.unpin(*key)
    res.update(lwm_trace=lwm_trace, digests=digests,
               wire_copies=wire.copies)
    emit({k: v for k, v in res.items()
          if k not in ("lwm_trace", "digests")})
    check(violations == 0, f"{violations} pinned-view violations")
    check(stall_same, "the stalled host's pinned view changed")
    check(space["stale_lanes_aged"] > 0, "the stalled host was never aged")
    check(space["lwm_advances"] > 0, "the global LWM never advanced")
    for h in live_hosts:
        check(crossed[h] is not None,
              f"host {h} never crossed its watermark in {step} steps")
        check(eng.pages_reclaimed_by_host[h] > 0,
              f"host {h} reclaimed no page")
    for name in ("sweep", "view", "paged_decode"):
        check(launches[name] > 0, f"{name} kernel never launched in "
              "dist_serve")
    check(launches["flash_prefill"] == 0, "flash prefill ran in dist_serve")
    check(launches["needed"] == 0, "needed ran in dist_serve")
    res["profile"] = profile_window(decode_step, name=name)
    return res


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

    zero_counts()
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
            # the descriptor read (search, K3, every slot) must name the
            # table versions whose rows and lengths the fused view read
            pay, found = vstore.snapshot_read(eng.st.mv, None, ts)
            tbl = pay.clamp(min=0).long()
            check(torch.equal(torch.where(found[:, None], eng.st.tables[tbl],
                                          -1), view[0])
                  and torch.equal(torch.where(found, eng.st.lengths[tbl], 0),
                                  view[1]),
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
    launches = launch_counts()
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
    for name in ("compact", "sweep", "search_gather", "view", "search",
                 "paged_decode"):
        check(launches[name] > 0, f"{name} kernel never launched in serve")
    check(launches["flash_prefill"] == 0, "flash prefill ran in paged serve")
    check(launches["needed"] == 0, "needed ran in paged serve")
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
            if any(f in k for f in ("sweep_kernel", "compact_kernel",
                                    "needed_kernel", "search_kernel",
                                    "search_gather_kernel",
                                    "view_kernel", "paged_decode_kernel",
                                    "flash_prefill_kernel", "flash_bwd_"))}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", f"{name}_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                          row_limit=40))
    res = {"phase": f"{name}_profile", "steps": steps, "wall_ms": wall * 1e3,
           "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1 - busy_us / 1e3 / (wall * 1e3),
           "kernel_launches": sum(n for n, _ in per_kernel.values()),
           "kernel_launches_per_step":
               sum(n for n, _ in per_kernel.values()) / steps,
           "host_syncs": syncs,
           "port_kernels_ms": ours,
           "top_device_ms": [[k, n, t / 1e3] for k, (n, t) in top]}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phases 6, 6a and 6c: a model served at full width through the launcher
# ---------------------------------------------------------------------------
def _prefill_bits(c, T: int) -> list:
    """What one prefill writes into a layer's cache: a global cache's
    first ``T`` columns; a local ring (k, v and pos) or a recurrent state
    whole."""
    if isinstance(c, KVCache):
        return [c.k[:, :T].clone(), c.v[:, :T].clone()]
    return [x.clone() for x in c]


def attention_layers(cfg) -> int:
    """Layers that run K6 at a prefill: the ``attn`` and ``local`` ones."""
    return sum(k in ("attn", "local") for k in tf._kinds(cfg))


def pin_steps(steps: int, pin_every: int) -> list:
    """The decode steps after which the launcher pins a reader."""
    return [i for i in range(steps) if i % pin_every == 0][
        :launcher.READER_LANES]


def expected_mismatches(cfg, steps: int, pin_every: int) -> int:
    """Pinned readers whose score must change: none in an attention-only
    model whose rings do not wrap; under a recurrent layer every reader
    held across a decode step (trap C12: the state is not versioned)."""
    if not set(tf._kinds(cfg)) & set(launcher.RECURRENT_KINDS):
        return 0
    return sum(i < steps - 1 for i in pin_steps(steps, pin_every))


def phase_served(dev, name: str) -> tuple[dict, dict]:
    """Serve ``SERVED[name]``'s model through the launcher: two prefills
    of the same prompt must give the same bits; the launch counts are
    zeroed just before the launcher's run and read just after; flash
    prefill runs once per attention layer on the bf16 route, compact and
    value_at run, every pinned reader's ``lengths_at`` is exactly the
    lengths at its pin, its score is bit-identical (under a recurrent
    layer it changes, exactly for the readers held across a step: trap
    C12), every token is in the vocabulary; value_at and sweep equal their
    plain versions on the engine's own store; then a short profiled decode
    window.  Returns the launches and flash prefill's launches by route."""
    argv, widths = SERVED[name]
    args = launcher.parse_args(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, engine, prompt = launcher.build(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    B, T = prompt.shape
    got = {k: getattr(cfg, k) for k in widths}
    check(got == widths, f"{cfg.name} is not at its published widths: {got}")

    # two prefills of the same prompt give the same bits (and warm up)
    st = engine.state
    outs = []
    for _ in range(2):
        logits, cache, _ = tf.prefill(st.params, cfg, prompt, st.cache,
                                      inplace=True)
        outs.append([logits.clone()] + _prefill_bits(cache[0], T)
                    + _prefill_bits(cache[-1], T))
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    check(same, f"{name}: two prefills of the same prompt gave different "
          "bits")
    del outs, logits, cache

    zero_counts()
    routes = flash_ops.flash_attention.route_launches
    rep = launcher.serve(engine, prompt, steps=args.steps,
                         pin_every=args.pin_every, log=lambda line: None)
    torch.cuda.synchronize()
    launches = launch_counts()
    flash_routes = dict(routes)
    pins = pin_steps(args.steps, args.pin_every)
    want_lengths = {lane: [T + i + 1] * B for lane, i in enumerate(pins)}
    want_mismatches = expected_mismatches(cfg, args.steps, args.pin_every)
    store = engine.state.mv.store
    if name == "model":
        check(tuple(store.ts.shape) == model_store_shape(),
              f"the store is {tuple(store.ts.shape)}, phase 3's "
              f"value_at_model row {model_store_shape()}")
    value_at_times = check_value_at_on_store(store)
    sweeps = check_sweep_on_store(engine.state.mv)
    prof = profile_window(engine.step, steps=8, name=name)
    toks = rep["tokens"]
    res = dict(
        phase=name, arch=cfg.name, layers=cfg.num_layers,
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
        profile_kernel_launches_per_step=prof["kernel_launches_per_step"],
        launches=launches, flash_launches_per_prefill=launches[
            "flash_prefill"], flash_route_launches=flash_routes,
        readers=rep["readers"],
        score_mismatches=rep["score_mismatches"],
        score_mismatches_expected=want_mismatches,
        reader_lengths_exact=rep["snapshot_lengths"] == want_lengths,
        value_at_times_checked=value_at_times, **sweeps,
        prefill_bits_equal=same, stats_sum=rep["stats_sum"],
        space=rep["space"], tokens_head=toks[:2, :8].tolist())
    emit(res)
    check(tuple(toks.shape) == (B, args.steps), "wrong token shape")
    check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          "a token outside [0, vocab)")
    n_attn = attention_layers(cfg)
    check(launches["flash_prefill"] == n_attn,
          f"flash prefill launched {launches['flash_prefill']} times in one "
          f"prefill of {n_attn} attention layers")
    check(flash_routes[flash_ops.ROUTES[torch.bfloat16]] == n_attn,
          f"the bf16 prefill did not run the wgmma kernel: {flash_routes}")
    for k in ("compact", "search", "value_at"):
        check(launches[k] > 0, f"{k} kernel never launched in {name}")
    check(rep["readers"] == len(pins), "fewer readers than pinned")
    check(rep["snapshot_lengths"] == want_lengths,
          f"a reader's lengths_at is not the lengths at its pin: "
          f"{rep['snapshot_lengths']}")
    check(rep["score_mismatches"] == want_mismatches,
          f"{rep['score_mismatches']} pinned scores changed under decode, "
          f"{want_mismatches} expected")
    del engine, st
    return launches, flash_routes


# ---------------------------------------------------------------------------
# phases 6f and 6g: a frontend (patches, frames) through prefill_step and
# decode_one
# ---------------------------------------------------------------------------
def phase_frontend(dev, name: str) -> dict:
    """Serve ``FRONTEND[name]``'s model at full width through the pure
    serving steps, as JAX can serve it (its ``MVServeEngine`` takes no
    frames: trap C13): ``prefill_step`` with the patch or frame embeddings
    (seeded on the card, scale 0.02), for whisper ``enc_out`` once by
    ``_run_encoder`` as JAX's caller computes it, then ``decode_one``
    steps, the stats read each step as ``MVServeEngine.step`` reads them,
    a reader pinned every ``pin_every`` steps.  Two prefills of the same
    inputs give the same bits; the launch counts are zeroed just before
    the served run and read just after: K6 in every attention layer of
    the prefill (whisper: its encoder's, and cross-attention in every
    layer, at prefill and at every decode step), compact and value_at;
    every reader's lengths exactly the lengths at its pin, and (the VLM,
    attention only) its score bit-identical at release; lengths
    ``prompt + prefix + steps`` (a VLM's patches are a prefix) or
    ``prompt + steps``; value_at and sweep equal their plain versions on
    the state's own store; then a short profiled decode window."""
    c = FRONTEND[name]
    cfg = get_config(c["arch"])
    got = {k: getattr(cfg, k) for k in c["widths"]}
    check(got == c["widths"], f"{cfg.name} is not at its published widths: "
          f"{got}")
    B, T, Nf, steps = c["batch"], c["prompt"], c["prefix"], c["steps"]
    encdec = cfg.encoder_layers > 0
    dtype = torch.bfloat16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(c["seed"])
    params = tf.init_params(cfg, gen, dtype)
    run = RunConfig(model=cfg, shape=SHAPES["decode_32k"], gc_policy="slrt",
                    versions_per_slot=launcher.VERSIONS_PER_SLOT,
                    reader_lanes=launcher.READER_LANES)
    tokens = torch.from_numpy(np.random.default_rng(c["seed"]).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)).to(dev)
    fe = (torch.randn((B, Nf, cfg.d_model), generator=gen, device=dev)
          * 0.02).to(dtype)
    state = serve_engine.make_serve_state(cfg, run, params, B, c["max_len"],
                                          dtype, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    # two prefills of the same inputs give the same bits (and warm up)
    outs = []
    for _ in range(2):
        logits, cache, lens = tf.prefill(params, cfg, tokens, state.cache,
                                         frontend_embeds=fe, inplace=True)
        span = int(lens[0])
        outs.append([logits.clone(), lens.clone()]
                    + _prefill_bits(cache[0], span)
                    + _prefill_bits(cache[-1], span))
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    check(same, f"{name}: two prefills of the same inputs gave different "
          "bits")
    del outs, logits, cache

    zero_counts()
    routes = flash_ops.flash_attention.route_launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = serve_engine.prefill_step(state, cfg, run, tokens, fe)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    enc_out, encoder_s = None, 0.0
    if encdec:
        t0 = time.perf_counter()
        enc_out = tf._run_encoder(params, cfg, fe)
        torch.cuda.synchronize()
        encoder_s = time.perf_counter() - t0

    def step(st):
        st, toks, _, stats = serve_engine.decode_one(st, cfg, run,
                                                     enc_out=enc_out)
        values = torch.stack([v.reshape(()) for v in stats.values()])
        return st, toks, dict(zip(stats, values.tolist()))

    readers, tokens_out, stats_sum = {}, [], {}
    decode_s = 0.0
    for i in range(steps):
        t0 = time.perf_counter()
        state, toks, stats = step(state)
        decode_s += time.perf_counter() - t0
        tokens_out.append(toks)
        for k, v in stats.items():
            stats_sum[k] = stats_sum.get(k, 0) + v
        if i % c["pin_every"] == 0 and len(readers) < launcher.READER_LANES:
            lane = len(readers)
            state, ts = serve_engine.begin_snapshot(state, lane)
            ts = int(ts)
            cand = state.last_tokens.clone()
            score = (None if encdec else
                     serve_engine.snapshot_score(state, cfg, cand, ts))
            readers[lane] = (i, ts, cand, score)
    mismatches, lengths_exact = 0, True
    prompt_len = T + (0 if encdec else Nf)
    for lane, (i, ts, cand, score) in readers.items():
        lens = serve_engine.snapshot_lengths(state, ts)
        lengths_exact &= lens.tolist() == [prompt_len + i + 1] * B
        if score is not None:
            mismatches += not torch.equal(
                serve_engine.snapshot_score(state, cfg, cand, ts), score)
        state = serve_engine.end_snapshot(state, lane)
    torch.cuda.synchronize()
    launches = launch_counts()
    flash_routes = dict(routes)
    lengths = state.cache_len.tolist()
    value_at_times = check_value_at_on_store(state.mv.store)
    sweeps = check_sweep_on_store(state.mv)
    box = [state]

    def profiled_step():
        box[0] = step(box[0])[0]

    prof = profile_window(profiled_step, steps=8, name=name)
    toks = torch.cat(tokens_out, dim=1)
    n_attn = attention_layers(cfg)
    # whisper: prefill = encoder + self-attention + cross-attention in every
    # layer; the caller's encoder pass; cross-attention per decode step
    want_flash = (n_attn if not encdec else
                  2 * cfg.encoder_layers + 2 * n_attn + steps * n_attn)
    res = dict(
        phase=name, arch=cfg.name, layers=cfg.num_layers,
        encoder_layers=cfg.encoder_layers, d_model=cfg.d_model,
        parameters=cfg.param_count(), dtype="bfloat16", batch=B,
        prompt_len=T, prefix=Nf, max_len=c["max_len"], steps=steps,
        policy="slrt", build_s=build_s, prefill_ms=prefill_s * 1e3,
        encoder_ms=encoder_s * 1e3,
        prefill_tokens_per_s=B * (T + Nf) / prefill_s,
        decode_ms_per_step=decode_s / steps * 1e3,
        decode_tokens_per_s=B * steps / decode_s,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        profile_device_idle_share=prof["device_idle_share"],
        profile_device_busy_ms_per_step=prof["device_busy_ms"] / prof["steps"],
        profile_host_syncs_per_step=prof["host_syncs"] / prof["steps"],
        profile_kernel_launches_per_step=prof["kernel_launches_per_step"],
        launches=launches, flash_launches_expected=want_flash,
        flash_route_launches=flash_routes, readers=len(readers),
        reader_lengths_exact=lengths_exact, score_mismatches=mismatches,
        lengths=sorted(set(lengths)), value_at_times_checked=value_at_times,
        **sweeps, prefill_bits_equal=same, stats_sum=stats_sum,
        space=vstore.space_report(state.mv),
        tokens_head=toks[:2, :8].tolist())
    emit(res)
    check(tuple(toks.shape) == (B, steps), "wrong token shape")
    check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          "a token outside [0, vocab)")
    check(lengths == [prompt_len + steps] * B,
          f"{name}: lengths {sorted(set(lengths))}, not "
          f"{prompt_len + steps}")
    check(launches["flash_prefill"] == want_flash
          and flash_routes[flash_ops.ROUTES[dtype]] == want_flash,
          f"{name}: flash prefill launched {flash_routes}, {want_flash} "
          "expected on the bf16 route")
    for k in ("compact", "search", "value_at"):
        check(launches[k] > 0, f"{k} kernel never launched in {name}")
    check(len(readers) == len(pin_steps(steps, c["pin_every"])),
          "fewer readers than pinned")
    check(lengths_exact, f"{name}: a reader's lengths are not the lengths "
          "at its pin")
    check(mismatches == 0, f"{mismatches} pinned scores changed under "
          "decode")
    del state, box, params
    return launches


# ---------------------------------------------------------------------------
# phase 6b: gemma2-2b's ring drop and wrap paths against the CPU
# ---------------------------------------------------------------------------
def _ring_pass(params, cfg, prompt, dev, steps: int, feed=None):
    """Prefill ``prompt`` and decode ``steps`` tokens on ``dev`` through
    the model's passes (in place), greedily or teacher-forced with
    ``feed``.  Returns the last-position logits of the prefill and of
    every step (on the CPU), the tokens fed, and the local ring after the
    prefill and at the end."""
    B, T = prompt.shape
    cache = tf.init_cache(cfg, B, RING["max_len"], torch.float32, dev)
    logits, cache, lens = tf.prefill(params, cfg, prompt.to(dev), cache,
                                     inplace=True)
    out, toks = [logits[:, -1].cpu()], []
    after_prefill = [x.to('cpu', copy=True) for x in cache[0]]
    for i in range(steps):
        tok = (feed[i].to(dev) if feed is not None
               else logits[:, -1].argmax(-1).to(torch.int32)[:, None])
        toks.append(tok.cpu())
        logits, cache = tf.decode_step(params, cfg, tok, cache, lens,
                                       inplace=True, span=T + i + 1)
        lens = lens + 1
        out.append(logits[:, -1].cpu())
    return out, toks, after_prefill, [x.to('cpu', copy=True)
                                      for x in cache[0]]


def phase_gemma2_ring(dev) -> dict:
    """gemma2-2b's local ring at its full widths where the serving phase
    cannot reach: two layers (one local, one global), float32, a prompt
    of 6144 tokens (longer than the 4096-slot ring, so the prefill keeps
    only the last 4096 positions: the drop path) and 16 decode steps that
    go on overwriting it (the wrap), no reader.  The same weights and
    tokens then run on the CPU through the plain versions, teacher-forced
    with the card's tokens: the last-position logits of the prefill and
    of every step, and the ring's K/V after the prefill and at the end,
    must agree within RING_TOL, and the ring's positions exactly."""
    base = get_config("gemma2-2b")
    cfg = dataclasses.replace(base, num_layers=RING["layers"])
    check(cfg.layer_pattern == ("local", "attn") and cfg.hd == 256
          and cfg.local_window == 4096 and cfg.d_model == 2304,
          "gemma2-2b is not at its published widths")
    B, T, steps, W = RING["batch"], RING["prompt"], RING["steps"], \
        cfg.local_window
    gen = torch.Generator(device=dev).manual_seed(RING["seed"])
    params = tf.init_params(cfg, gen, torch.float32)
    prompt = torch.from_numpy(np.random.default_rng(RING["seed"]).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32))
    zero_counts()
    routes = flash_ops.flash_attention.route_launches
    t0 = time.perf_counter()
    card, toks, ring0, ring = _ring_pass(params, cfg, prompt, dev, steps)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = launch_counts()
    flash_routes = dict(routes)

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    params_cpu = _to(params, cpu)
    del params
    torch.cuda.empty_cache()
    plain, _, plain_ring0, plain_ring = _ring_pass(params_cpu, cfg, prompt,
                                                   cpu, steps, feed=toks)
    cpu_s = time.perf_counter() - t0
    logit_err = max_err(card, plain)
    ring_err = max_err(ring[:2] + ring0[:2], plain_ring[:2] + plain_ring0[:2])
    held = sorted(int(p) for p in ring0[2][0] if p >= 0)
    held_end = sorted(int(p) for p in ring[2][0] if p >= 0)
    res = dict(phase="gemma2_ring", arch=cfg.name, layers=cfg.num_layers,
               d_model=cfg.d_model, dtype="float32", batch=B, prompt_len=T,
               max_len=RING["max_len"], steps=steps, ring_slots=W,
               card_s=card_s, cpu_s=cpu_s, max_logit_err=logit_err,
               max_ring_err=ring_err, tolerance=RING_TOL, launches=launches,
               flash_route_launches=flash_routes,
               ring_held_after_prefill=[held[0], held[-1], len(held)],
               ring_held_at_end=[held_end[0], held_end[-1], len(held_end)])
    emit(res)
    check(held == list(range(T - W, T)), "the prefill's ring does not hold "
          "the last W positions")
    check(held_end == list(range(T + steps - W, T + steps)),
          "the decoded ring does not hold the last W positions")
    check(torch.equal(ring0[2], plain_ring0[2])
          and torch.equal(ring[2], plain_ring[2]),
          "the ring's positions differ between the card and the CPU")
    for i, (a, b) in enumerate(zip(card, plain)):
        check(bool(torch.isfinite(a).all()), f"gemma2_ring: logits of pass "
              f"{i} not finite")
        check(torch.allclose(a, b, **RING_TOL["logits"]),
              f"gemma2_ring: logits of pass "
              f"{i} differ from the CPU's (max {float((a - b).abs().max())})")
    for a, b in zip(ring[:2] + ring0[:2], plain_ring[:2] + plain_ring0[:2]):
        check(torch.allclose(a, b, **RING_TOL["ring"]),
              "gemma2_ring: the ring's K/V differ from the CPU's")
    check(launches["flash_prefill"] == cfg.num_layers
          and flash_routes[flash_ops.ROUTES[torch.float32]] == cfg.num_layers,
          f"the float32 prefill did not run K6's CUDA-core route once per "
          f"layer: {flash_routes}")
    return launches


# ---------------------------------------------------------------------------
# phase 10b: training on the card
# ---------------------------------------------------------------------------
def _batch(data: SyntheticLM, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}


def _all_finite(tensors) -> bool:
    return bool(torch.stack([torch.isfinite(x).all() for x in tensors]).all())


def train_full_width(dev, dtype=torch.float32) -> dict:
    """gemma2-2b at full width: init_state on the card in ``dtype``
    (float32: TRAIN, phase 10b; bf16: TRAIN_BF16, phase 10c), then its
    steps from SyntheticLM; every step's loss, gradient norm and
    parameters finite, its lr equal to cosine_schedule's, the parameters
    unchanged by step 0 (lr 0) and moved by step 1, AdamW's moments
    float32; K6 twice per attention layer and step (forward and the
    checkpoint's recompute) on the dtype's route, K6b once on its route."""
    bf16 = dtype == torch.bfloat16
    p = TRAIN_BF16 if bf16 else TRAIN
    cfg = get_config(p["arch"])
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], lr=p["lr"])
    torch.cuda.reset_peak_memory_stats()
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(
        p["seed"]), dtype=dtype)
    check({x.dtype for x in tree_flatten(state.params)} <= {dtype,
                                                            torch.float32}
          and {x.dtype for x in tree_flatten(state.opt.mu)
               + tree_flatten(state.opt.nu)} == {torch.float32},
          f"train {dtype}: parameter or moment dtypes")
    n_params = tf.param_count(state.params)
    data = SyntheticLM(DataConfig(cfg.vocab_size, p["seq_len"], p["batch"]))
    n_attn = attention_layers(cfg)
    probe = state.params["layers"][0]["mixer"]["wq"]
    check(probe.dtype == dtype, f"train: wq is {probe.dtype}")
    zero_counts()
    step_s, losses, gnorms = [], [], []
    for i in range(p["steps"]):
        before = probe.detach().clone()
        batch = _batch(data, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lr_want = adamw.cosine_schedule(state.opt.step, base_lr=run.lr)
        state, m = train_step(state, batch, cfg, run)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        losses.append(loss)
        gnorms.append(gnorm)
        check(math.isfinite(loss) and math.isfinite(gnorm),
              f"train step {i}: loss {loss} or grad norm {gnorm} not finite")
        check(torch.equal(m["lr"], lr_want),
              f"train step {i}: lr {float(m['lr'])} != cosine_schedule")
        check(_all_finite(tree_flatten(state.params)),
              f"train step {i}: a parameter is not finite")
        moved = not torch.equal(before, probe)
        check(moved == (i > 0), f"train step {i}: parameters "
              f"{'moved' if moved else 'did not move'} (lr "
              f"{float(m['lr'])})")
        del batch, m
    launches = launch_counts()
    steps = p["steps"]
    k6_route = flash_ops.ROUTES[dtype]
    k6 = dict(flash_ops.flash_attention.route_launches)
    check(k6 == {r: 2 * n_attn * steps if r == k6_route else 0 for r in k6},
          f"train {dtype}: K6 launches by route {k6}, want "
          f"{2 * n_attn * steps} on {k6_route} (forward and recompute per "
          "layer)")
    k6b = {flash_ops.BWD_ROUTES[torch.float32]: launches["flash_backward"],
           flash_ops.BWD_ROUTES[torch.bfloat16]:
               launches["flash_backward_bf16"]}
    k6b_route = flash_ops.BWD_ROUTES[dtype]
    check(k6b == {r: n_attn * steps if r == k6b_route else 0 for r in k6b},
          f"train {dtype}: K6b calls by route {k6b}, want {n_attn * steps} "
          f"on {k6b_route}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = profile_window(lambda: train_step(state, _batch(data, dev), cfg,
                                             run), steps=1,
                          name="train_bf16" if bf16 else "train")
    med = sorted(step_s[1:])[len(step_s[1:]) // 2]
    res = {"phase": "train_bf16" if bf16 else "train", "arch": cfg.name,
           "dtype": str(dtype), "params": n_params,
           "batch": p["batch"], "seq_len": p["seq_len"], "steps": steps,
           "reduced": ["train_4k's global batch 256 cut to 1 (one card)"],
           "step_s": step_s, "median_step_s": med,
           "tokens_per_s": p["batch"] * p["seq_len"] / med,
           "losses": losses, "grad_norms": gnorms,
           "peak_gib": peak, "device_idle_share": prof["device_idle_share"],
           "k6_routes": k6, "k6b_routes": k6b,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "launches": launches}
    emit(res)
    del state, data, probe
    torch.cuda.empty_cache()
    return launches


def _launch_train(ckpt: str, *flags: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_RESUME,
         "--ckpt-dir", ckpt, *flags], capture_output=True, text=True,
        env=env, timeout=600, cwd=ROOT)


def train_resume(dev) -> dict:
    """The launcher's crash/resume recipe on the card at reduced gemma2-2b
    (a full-width checkpoint of params, mu and nu is 29 GiB a save): the
    crash exits 42, the rerun resumes from step 5, and its losses equal
    the uninterrupted run's within RESUME_RTOL (bit-equal or not is
    recorded); and a TrainState saved and restored in this process is
    bit-equal to the one saved."""
    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        full = _launch_train(os.path.join(tmp, "full"))
        check(full.returncode == 0, f"train launcher failed: {full.stderr}")
        crash = _launch_train(os.path.join(tmp, "ft"),
                              "--simulate-crash-at", "7")
        check(crash.returncode == 42, f"crash run exited {crash.returncode}"
              f", not 42: {crash.stderr[-2000:]}")
        resume = _launch_train(os.path.join(tmp, "ft"))
        check(resume.returncode == 0, f"resume failed: {resume.stderr}")
        check("[restore] resumed from step 5" in resume.stdout,
              "the rerun did not resume from step 5")
        want = dict(re.findall(r"step\s+(\d+)\s+loss (\S+)", full.stdout))
        got = dict(re.findall(r"step\s+(\d+)\s+loss (\S+)", resume.stdout))
        check(sorted(got, key=int) == [str(i) for i in range(5, 12)],
              f"resumed steps {sorted(got, key=int)}")
        rel = max(abs(float(got[k]) / float(want[k]) - 1) for k in got)
        check(rel <= RESUME_RTOL, f"resumed losses off by {rel} relative")
        with open(os.path.join(tmp, "ft", "heartbeat.json")) as f:
            hb = json.load(f)
        check(hb["host_id"] == 0 and hb["step"] == 11, f"heartbeat {hb}")
        out.update(resumed_bit_equal=all(got[k] == want[k] for k in got),
                   resumed_max_rel=rel, resumed_losses=got,
                   uninterrupted_losses={k: want[k] for k in got})

        cfg = reduced_config("gemma2-2b")
        run = RunConfig(model=cfg, shape=SHAPES["train_4k"], lr=3e-3)
        data = SyntheticLM(DataConfig(cfg.vocab_size, 64, 8))
        state = init_state(cfg, torch.Generator(device=dev).manual_seed(0))
        for _ in range(5):
            state, _ = train_step(state, _batch(data, dev), cfg, run)
        mgr = CheckpointManager(os.path.join(tmp, "inproc"))
        mgr.save(5, state, extra=data.state_dict())
        restored, extra = mgr.restore(5, like=state, device=dev)
        pairs = list(zip(tree_flatten(state), tree_flatten(restored)))
        check(extra == {"step": 5}, f"restored data state {extra}")
        check(all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs),
              "the restored TrainState differs from the saved one")
        out["restored_leaves_bit_equal"] = len(pairs)
    return out


def train_compression(dev) -> dict:
    """Reduced minitron-4b on the card, TRAIN_COMPRESSION's steps with the
    int8 error-feedback round trip and without: the loss must fall by more
    than ``fall`` and ``fall_plain``."""
    p = TRAIN_COMPRESSION
    cfg = reduced_config(p["arch"])
    out = {}
    for comp, fall in ((True, p["fall"]), (False, p["fall_plain"])):
        run = RunConfig(model=cfg, shape=SHAPES["train_4k"], lr=p["lr"],
                        grad_compression=comp)
        data = SyntheticLM(DataConfig(cfg.vocab_size, p["seq_len"],
                                      p["batch"],
                                      copy_period=p["copy_period"]))
        state = init_state(cfg, torch.Generator(device=dev).manual_seed(0),
                           compression=comp)
        losses = []
        for _ in range(p["steps"]):
            state, m = train_step(state, _batch(data, dev), cfg, run)
            losses.append(float(m["loss"]))
        key = "compression" if comp else "plain"
        check(losses[-1] < losses[0] - fall,
              f"train {key}: loss {losses[0]} -> {losses[-1]}, not down by "
              f"{fall}")
        out[key] = dict(first=losses[0], last=losses[-1])
    return out


def phase_train(dev) -> tuple[dict, dict]:
    """Phase 10b: full-width training in float32, then the launcher's
    crash/resume and gradient compression at reduced widths; phase 10c:
    full-width training in bf16.  Returns the two full-width runs' launch
    counts."""
    launches = train_full_width(dev)
    res = {"phase": "train_resume", **train_resume(dev)}
    res["compression"] = train_compression(dev)
    emit(res)
    torch.cuda.empty_cache()
    return launches, train_full_width(dev, torch.bfloat16)


# ---------------------------------------------------------------------------
# phases 10d-10f: placement over four rank processes on the card
# ---------------------------------------------------------------------------
def _sharded_run(cfg) -> RunConfig:
    return RunConfig(model=cfg, shape=SHAPES["train_4k"],
                     lr=TRAIN_SHARDED["lr"])


def _mesh_stand_in() -> object:
    """The 2 x 2 mesh as the sharding rules read it (axis sizes only)."""
    return type("Mesh", (), {"shape": dict(zip(
        ("data", "model"), TRAIN_SHARDED["mesh"]))})()


def train_sharded_reference(dev, io: str) -> int:
    """Phase 10e's one-rank run, in a process of its own (``chip_smoke.py
    --train-reference IO``), so that its 52 GiB are the card's again when
    it exits: TRAIN_SHARDED's steps of the plain ``train_step`` from the
    seed's state on the same batches.  Writes the losses, gradient norms,
    step seconds, peak memory and each SHARDED_LEAVES' spec on the 2 x 2
    mesh to ``IO/reference.json`` and the leaves (params, mu, nu, and the
    initial params as p0) as ``.npy`` beside it."""
    p = TRAIN_SHARDED
    cfg = get_config(p["arch"])
    run = _sharded_run(cfg)
    torch.cuda.reset_peak_memory_stats()
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(
        p["seed"]))
    for path, x in _paths(state.params):
        name = "/".join(path)
        if name in SHARDED_LEAVES:
            np.save(os.path.join(io, "reference_p0_" + name.replace("/", ".")
                                 + ".npy"), x.detach().float().cpu().numpy())
    data = SyntheticLM(DataConfig(cfg.vocab_size, p["seq_len"], p["batch"]))
    losses, norms, step_s, rates = [], [], [], 0.0
    for _ in range(p["steps"]):
        batch = _batch(data, dev)
        rates += float(adamw.cosine_schedule(state.opt.step,
                                             base_lr=run.lr))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, batch, cfg, run)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    specs = dict(_paths(param_shardings(state.params, _mesh_stand_in(),
                                        fsdp=True)))
    for kind, tree in (("param", state.params), ("mu", state.opt.mu),
                       ("nu", state.opt.nu)):
        for path, x in _paths(tree):
            name = "/".join(path)
            if name in SHARDED_LEAVES:
                np.save(os.path.join(io, f"reference_{kind}_"
                                     + name.replace("/", ".") + ".npy"),
                        x.detach().float().cpu().numpy())
    with open(os.path.join(io, "reference.json"), "w") as f:
        json.dump({"losses": losses, "grad_norms": norms, "step_s": step_s,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "specs": {n: list(specs[tuple(n.split("/"))])
                             for n in SHARDED_LEAVES},
                   "rates": rates},
                  f)
    return 0


def _on_card(tree) -> bool:
    return all(x.is_cuda for x in tree_flatten(tree))


def rank_dist(dev, rank: int, steps: int) -> dict:
    """Phase 10d on one rank: phase 10's traffic loop, unchanged, on the engine
    that its default mesh spreads over the ranks (one host each), to
    phase 10's step count (a time limit per rank would let the ranks stop
    apart); then phase 9's rows of RANK_TIERS at 4 ranks."""
    p = dict(DIST_SERVE, max_steps=steps, max_seconds=math.inf)
    res = phase_dist_serve(dev, p, name=f"dist_rank{rank}")
    t0 = time.perf_counter()
    phase_dist_tiers(dev, RANK_TIERS)
    res["tiers_seconds"] = time.perf_counter() - t0
    return res


def rank_train_sharded(dev, rank: int, world: int, io: str) -> dict:
    """Phase 10e on one rank: the seed's state placed over the 2 x 2 mesh
    (each rank builds it whole in turn, keeps its shards and frees it: a
    float32 state is 31 GiB), then the sharded train_step; this rank's
    shards of SHARDED_LEAVES go to ``io``."""
    p = TRAIN_SHARDED
    cfg = get_config(p["arch"])
    run = _sharded_run(cfg)
    mesh = make_host_mesh(*p["mesh"], device=dev)
    torch.cuda.reset_peak_memory_stats()
    for r in range(world):
        if r == rank:
            full = init_state(cfg, torch.Generator(device=dev).manual_seed(
                p["seed"]))
            state, pl = place_train_state(full, mesh, fsdp=True)
            del full
            torch.cuda.empty_cache()
        dist.barrier()
    check(_on_card(state.params) and _on_card(state.opt.mu)
          and _on_card(state.opt.nu), f"rank {rank}: a shard is off the card")
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    state_gib = torch.cuda.memory_allocated() / 2**30
    for path, x in _paths(state.params):
        name = "/".join(path)
        if name in SHARDED_LEAVES:
            np.save(os.path.join(io, f"sharded_{rank}_p0_"
                                 + name.replace("/", ".") + ".npy"),
                    x.detach().float().cpu().numpy())
    emit({"phase": "train_sharded_rank", "rank": rank,
          "state_gib": state_gib, "init_peak_gib": init_peak})
    data = SyntheticLM(DataConfig(cfg.vocab_size, p["seq_len"], p["batch"]))
    n_attn = attention_layers(cfg)
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_s = [], [], []
    for i in range(p["steps"]):
        batch = _batch(data, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            state, m = train_step(state, batch, cfg, run, placement=pl)
        except torch.OutOfMemoryError:
            print(torch.cuda.memory_summary(abbreviated=True), flush=True)
            raise
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        emit({"phase": "train_sharded_rank", "rank": rank, "step": i,
              "seconds": step_s[-1],
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        check(math.isfinite(losses[-1]) and math.isfinite(norms[-1]),
              f"rank {rank} step {i}: loss or grad norm not finite")
    launches = launch_counts()
    copies = wire.copies
    k6 = dict(flash_ops.flash_attention.route_launches)
    k6_route = flash_ops.ROUTES[torch.float32]
    check(k6 == {r: 2 * n_attn * p["steps"] if r == k6_route else 0
                 for r in k6}, f"rank {rank}: K6 launches {k6}")
    check(launches["flash_backward"] == n_attn * p["steps"],
          f"rank {rank}: K6b launches {launches['flash_backward']}")
    for kind, tree in (("param", state.params), ("mu", state.opt.mu),
                       ("nu", state.opt.nu)):
        for path, x in _paths(tree):
            name = "/".join(path)
            if name in SHARDED_LEAVES:
                np.save(os.path.join(io, f"sharded_{rank}_{kind}_"
                                     + name.replace("/", ".") + ".npy"),
                        x.detach().float().cpu().numpy())
    coord = dict(zip(("data", "model"), mesh.get_coordinate()))
    out = {"coord": coord, "losses": losses, "grad_norms": norms,
           "step_s": step_s, "init_peak_gib": init_peak,
           "state_gib": state_gib,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches, "wire_copies": copies,
           "local_params": sum(x.numel() for x in tree_flatten(
               state.params))}
    del state, data
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def rank_pipeline(dev, rank: int, world: int) -> dict:
    """Phase 10f on one rank: its stage's 8 of minitron-4b's 32 layers
    (each layer's weights from its own seed), ``pipeline_forward`` over
    the 4 stage ranks; then stage 0 runs the same 32 layers in sequence
    on each microbatch, and the two must give the same bits."""
    p = PIPELINE
    cfg = get_config(p["arch"])
    kinds = tf._kinds(cfg)
    L, M, B, T = cfg.num_layers, p["microbatches"], p["batch"], p["seq_len"]
    mesh = make_gc_mesh(world, axis="stage", device=dev)
    sid, per = mesh.get_local_rank("stage"), cfg.num_layers // world

    def layer(i):
        gen = torch.Generator(device=dev).manual_seed(p["seed"] + 1 + i)
        return init_block(gen, cfg, kinds[i], torch.bfloat16), kinds[i]

    positions = torch.arange(T, dtype=torch.int32, device=dev)[None] \
        .expand(B, T)

    def apply(stage, h):
        for bp, kind in stage:
            h, _ = block_apply(bp, cfg, kind, h, positions, mode="train")
        return h

    stage = [layer(i) for i in range(sid * per, (sid + 1) * per)]
    x = torch.randn((M, B, T, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(p["seed"]), device=dev, dtype=torch.bfloat16)
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        y = pipeline_forward(apply, stage, x, mesh=mesh, axis="stage")
    torch.cuda.synchronize()
    out = {"stage": sid, "layers": [sid * per, (sid + 1) * per],
           "seconds": time.perf_counter() - t0,
           "launches": launch_counts(), "wire_copies": wire.copies,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "finite": bool(torch.isfinite(y.float()).all())}
    if sid == 0:
        del stage
        t0 = time.perf_counter()
        with torch.no_grad():
            h = x.clone()
            for i in range(L):
                one = [layer(i)]
                for m in range(M):
                    h[m] = apply(one, h[m])
                del one
        torch.cuda.synchronize()
        out.update(sequential_seconds=time.perf_counter() - t0,
                   bit_equal=torch.equal(y, h),
                   max_abs_err=float((y.float() - h.float()).abs().max()))
    dist.barrier()
    return out


def rank_main(rank: int, world: int, io: str) -> int:
    """One rank of phases 10d-10f (``chip_smoke.py --rank R WORLD IO``):
    joins the gloo group through ``IO/store``, runs the three phases
    (10e, 10f, then 10d) and writes ``IO/rank{R}.json``."""
    from datetime import timedelta
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(io, "store"),
        rank=rank, world_size=world, timeout=timedelta(seconds=300))
    dev = torch.device("cuda", 0)
    _build.lib()
    with open(os.path.join(io, "ref.json")) as f:
        ref = json.load(f)
    try:
        # 10e first: its gemma2-2b state is the phase that needs the card's
        # memory most
        out = {"train": rank_train_sharded(dev, rank, world, io)}
        out["pipeline"] = rank_pipeline(dev, rank, world)
        torch.cuda.empty_cache()
        out["dist"] = rank_dist(dev, rank, ref["dist_steps"])
    finally:
        dist.destroy_process_group()
    with open(os.path.join(io, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _spawn(io: str, argvs: list) -> None:
    """Start a process of this script for each argument list and wait for
    them; the first that fails or outlives RANKS_TIMEOUT_S fails the
    phase, and every process is stopped before this returns."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    logs = [open(os.path.join(io, f"proc{r}.log"), "w")
            for r in range(len(argvs))]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *argv], env=env,
        cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT)
        for r, argv in enumerate(argvs)]
    t0 = time.monotonic()
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.monotonic() - t0 > RANKS_TIMEOUT_S:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(io, f"proc{r}.log")) as f:
                tail = f.read()[-12000:]
            check(False, f"{' '.join(argvs[r])} exited {p.returncode}:\n"
                  f"{tail}")


#: the fields of phase 10's line that phase 10d's ranks must equal
DIST_RANK_FIELDS = ("steps", "tokens_appended", "sequences_completed",
                    "snapshot_pins", "views_checked", "decodes",
                    "violations", "stalled_view_bit_identical",
                    "watermark_crossed_at_step", "pages_reclaimed_by_host",
                    "peak_pages_by_host", "lwm_refreshes", "space",
                    "sweep_lwm_pin", "sweeps_checked",
                    "sweep_killed_unpinned_by_host", "lwm_trace", "digests")


def _ref_shard(full: torch.Tensor, spec, coord: dict) -> np.ndarray:
    x = full
    for d, axis in enumerate(spec):
        if axis is not None:
            x = x.chunk(TRAIN_SHARDED["mesh"][("data", "model").index(axis)],
                        dim=d)[coord[axis]]
    return x.numpy()


def check_train_sharded(io: str, ref: dict, trains: list) -> tuple:
    """Phase 10e's checks: each rank's losses and gradient norms against
    the one-rank reference's, and its shards of SHARDED_LEAVES (mu and nu
    within their limits, each parameter's change over the run against the
    reference's).  Returns (the largest |error| of each leaf and kind, the
    update check's worst errors and counts)."""
    worst, update = {}, {"rel": 0.0, "abs": 0.0, "big": 0, "n": 0}
    for r, res in enumerate(trains):
        np.testing.assert_allclose(res["losses"], ref["losses"],
                                   rtol=SHARDED_RTOL)
        np.testing.assert_allclose(res["grad_norms"], ref["grad_norms"],
                                   rtol=SHARDED_RTOL)
        for name, kind in itertools.product(
                SHARDED_LEAVES, ("param", "mu", "nu")):
            leaf = name.replace("/", ".")
            got = np.load(os.path.join(
                io, f"sharded_{r}_{kind}_{leaf}.npy"))
            spec, coord = ref["specs"][name], res["coord"]
            want = _ref_shard(torch.from_numpy(np.load(os.path.join(
                io, f"reference_{kind}_{leaf}.npy"))), spec, coord)
            check(got.shape == want.shape,
                  f"train_sharded: rank {r} {name} shard {got.shape}")
            worst[f"{name}:{kind}"] = max(
                worst.get(f"{name}:{kind}", 0.0),
                float(np.abs(got - want).max()))
            if kind != "param":
                np.testing.assert_allclose(got, want, rtol=0, atol=(
                    SHARDED_MOMENT_SHARE * float(np.abs(want).max())))
                continue
            p0, nu = (_ref_shard(torch.from_numpy(np.load(os.path.join(
                io, f"reference_{k}_{leaf}.npy"))), spec, coord)
                for k in ("p0", "nu"))
            # every rank starts from the reference's state, bit for bit
            check(np.array_equal(np.load(os.path.join(
                io, f"sharded_{r}_p0_{leaf}.npy")), p0),
                f"train_sharded: rank {r} {name} starts elsewhere")
            dg, dw = got - p0, want - p0
            err = np.abs(dg - dw)
            spacing = 4 * np.finfo(np.float32).eps * np.abs(p0)
            scale = np.sqrt(np.load(os.path.join(
                io, f"reference_nu_{leaf}.npy")).max())
            big = ((np.abs(dw) >= 0.5 * ref["rates"])
                   & (np.sqrt(nu) >= SHARDED_GRAD_SHARE * scale))
            check(np.all(err[big] <= SHARDED_UPDATE_RTOL
                         * np.abs(dw[big]) + spacing[big])
                  and np.all(err <= 2 * ref["rates"] + spacing),
                  f"train_sharded: rank {r} {name}'s update differs "
                  "from the one-rank step's")
            if big.any():
                update["rel"] = max(update["rel"], float(
                    (err[big] / np.abs(dw[big])).max()))
            update["abs"] = max(update["abs"], float(err.max()))
            update["big"] += int(big.sum())
            update["n"] += big.size
    check(update["big"] > 0, "train_sharded: no parameter of "
          f"{SHARDED_LEAVES} was updated")
    return worst, update


def phase_ranks(dev, dist_ref: dict) -> dict:
    """Phases 10d-10f over RANKS rank processes on the card: the one-rank
    reference of 10e first (freed before the ranks start), then the ranks,
    then each phase's checks against phase 10's run and the reference.
    Returns each phase's launches, summed over the ranks."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as io:
        with open(os.path.join(io, "ref.json"), "w") as f:
            json.dump({"dist_steps": dist_ref["steps"]}, f)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _spawn(io, [["--train-reference", io]])
        with open(os.path.join(io, "reference.json")) as f:
            ref = json.load(f)
        ref_wall = time.perf_counter() - t0
        parent_gib = torch.cuda.memory_reserved() / 2**30
        free_gib = torch.cuda.mem_get_info()[0] / 2**30
        t0 = time.perf_counter()
        _spawn(io, [["--rank", str(r), str(RANKS), io]
                    for r in range(RANKS)])
        wall = time.perf_counter() - t0
        outs = []
        for r in range(RANKS):
            with open(os.path.join(io, f"rank{r}.json")) as f:
                outs.append(json.load(f))
        # 10d: every rank ran phase 10's traffic to phase 10's result
        dist_runs = [o["dist"] for o in outs]
        for r, res in enumerate(dist_runs):
            diff = [k for k in DIST_RANK_FIELDS if res[k] != dist_ref[k]]
            check(not diff, f"dist_ranks: rank {r} differs from phase 10 "
                  f"in {diff}")
            for name in ("sweep", "view", "paged_decode"):
                check(res["launches"][name] > 0,
                      f"dist_ranks: rank {r} never launched {name}")
        summed = {k: sum(res["launches"][k] for res in dist_runs)
                  for k in dist_runs[0]["launches"]}
        emit({"phase": "dist_ranks", "ranks": RANKS,
              "hosts_per_rank": DIST_SERVE["hosts"] // RANKS,
              "steps": dist_ref["steps"], "matches_phase_10": True,
              "lwm_trace_len": len(dist_ref["lwm_trace"]),
              "digests": len(dist_ref["digests"]),
              "seconds_by_rank": [x["seconds"] for x in dist_runs],
              "ms_per_step_by_rank": [x["ms_per_step"] for x in dist_runs],
              "tokens_per_s_by_rank": [x["tokens_per_s"] for x in dist_runs],
              "wire_copies_per_step_by_rank": [
                  x["wire_copies"] / x["steps"] for x in dist_runs],
              "idle_share_by_rank": [x["profile"]["device_idle_share"]
                                     for x in dist_runs],
              "peak_memory_gib_by_rank": [x["peak_memory_gib"]
                                          for x in dist_runs],
              "tiers_seconds_by_rank": [x["tiers_seconds"]
                                        for x in dist_runs],
              "one_process_ms_per_step": dist_ref["ms_per_step"],
              "launches_by_rank": [x["launches"] for x in dist_runs],
              "launches": summed})
        # 10e: the sharded step against the one-rank step
        trains = [o["train"] for o in outs]
        worst, update = check_train_sharded(io, ref, trains)
        emit({"phase": "train_sharded", "arch": TRAIN_SHARDED["arch"],
              "mesh": TRAIN_SHARDED["mesh"], "fsdp": True,
              "batch": TRAIN_SHARDED["batch"],
              "seq_len": TRAIN_SHARDED["seq_len"],
              "steps": TRAIN_SHARDED["steps"],
              "losses": trains[0]["losses"], "ref_losses": ref["losses"],
              "grad_norms": trains[0]["grad_norms"],
              "ref_grad_norms": ref["grad_norms"],
              "max_abs_err": worst, "rates": ref["rates"],
              "update_max_rel_err": update["rel"],
              "update_max_abs_err": update["abs"],
              "update_share_held_relative": update["big"] / update["n"],
              "update_rtol": SHARDED_UPDATE_RTOL,
              "step_s_by_rank": [x["step_s"] for x in trains],
              "ref_step_s": ref["step_s"], "ref_peak_gib": ref["peak_gib"],
              "ref_wall_s": ref_wall, "parent_reserved_gib": parent_gib,
              "free_gib_at_spawn": free_gib,
              "init_peak_gib_by_rank": [x["init_peak_gib"] for x in trains],
              "peak_gib_by_rank": [x["peak_gib"] for x in trains],
              "peak_gib_sum": sum(x["peak_gib"] for x in trains),
              "local_params_by_rank": [x["local_params"] for x in trains],
              "wire_copies_by_rank": [x["wire_copies"] for x in trains],
              "launches_by_rank": [x["launches"] for x in trains]})
        # 10f: the stages' output against the sequential forward
        pipes = [o["pipeline"] for o in outs]
        first = next(x for x in pipes if x["stage"] == 0)
        check(all(x["finite"] for x in pipes), "pipeline: output not finite")
        check(first["bit_equal"], "pipeline: the stages' output differs "
              f"from the sequential forward by {first['max_abs_err']}")
        for r, x in enumerate(pipes):
            check(x["launches"]["flash_prefill"] == (
                PIPELINE["microbatches"] * attention_layers(get_config(
                    PIPELINE["arch"])) // RANKS),
                  f"pipeline: rank {r} K6 launches "
                  f"{x['launches']['flash_prefill']}")
        emit({"phase": "pipeline", "arch": PIPELINE["arch"],
              "stages": RANKS, **{k: PIPELINE[k] for k in (
                  "microbatches", "batch", "seq_len")},
              "bit_equal": first["bit_equal"],
              "max_abs_err": first["max_abs_err"],
              "seconds_by_rank": [x["seconds"] for x in pipes],
              "sequential_seconds": first["sequential_seconds"],
              "peak_gib_by_rank": [x["peak_gib"] for x in pipes],
              "wire_copies_by_rank": [x["wire_copies"] for x in pipes],
              "launches_by_rank": [x["launches"] for x in pipes],
              "ranks_wall_s": wall})

    def total(key):
        return {k: sum(o[key]["launches"][k] for o in outs)
                for k in outs[0][key]["launches"]}
    return {"dist_ranks": summed, "train_sharded": total("train"),
            "pipeline": total("pipeline")}


def _to(x, dev):
    """Parameters (tensors in nested dicts and lists) on ``dev``."""
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    if isinstance(x, list):
        return [_to(v, dev) for v in x]
    return x.to(dev)


def main() -> int:
    t0 = time.perf_counter()
    seconds = {}

    def lap(name: str) -> None:
        """Wall seconds since the script started, at the end of a phase."""
        seconds[name] = time.perf_counter() - t0

    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    lap("build")
    kernels = phase_kernels(dev)
    lap("kernels")
    phase_storm(dev)
    launches = phase_serve(dev)
    torch.cuda.empty_cache()
    lap("serve")
    model_launches, flash_routes = phase_served(dev, "model")
    torch.cuda.empty_cache()
    lap("model")
    served = {}
    served["gemma2"], _ = phase_served(dev, "gemma2")
    torch.cuda.empty_cache()
    served["gemma2_ring"] = phase_gemma2_ring(dev)
    torch.cuda.empty_cache()
    served["moe"], _ = phase_served(dev, "moe")
    torch.cuda.empty_cache()
    for name in ("recurrentgemma", "xlstm"):
        served[name], _ = phase_served(dev, name)
        torch.cuda.empty_cache()
    for name in FRONTEND:
        served[name] = phase_frontend(dev, name)
        torch.cuda.empty_cache()
    lap("served")
    phase_fork_tiers(dev)
    durable_launches = phase_durability(dev)
    torch.cuda.empty_cache()
    lap("durability")
    phase_dist_tiers(dev)
    dist_ref = phase_dist_serve(dev)
    dist_launches = dist_ref["launches"]
    torch.cuda.empty_cache()
    lap("dist")
    train_launches, bf16_launches = phase_train(dev)
    lap("train")
    rank_launches = phase_ranks(dev, dist_ref)
    del dist_ref
    lap("ranks")
    emit({"phase": "timeline", "seconds_at_end_of": seconds})
    table = []
    for name, (source, replaces) in KERNELS.items():
        row = kernels[MAIN_OPS.get(name, name)]
        # the count from the main path that runs the kernel: phase 5 for
        # K1, K2 and K4 (paged serving), phase 6 for K3 (the model
        # engine's snapshot lengths) and flash prefill; no serving path
        # calls needed (K5), as in the JAX package, so its count is
        # phase 3's
        launches_from, count = {
            "flash_prefill": ("model", model_launches[name]),
            "flash_backward": ("train", train_launches[name]),
            "flash_backward_bf16": ("train_bf16", bf16_launches[name]),
            "search": ("model", model_launches[name]),
            "needed": ("kernels (phase 3): no serving path calls needed",
                       row.get("launches_phase3", 0)),
        }.get(name, ("serve", launches[name]))
        # kernel_route: which of the wrapper's routes the main path ran
        # (flash prefill counts each route's launches; the rest have one)
        kernel_route = (", ".join(r for r, n in flash_routes.items() if n)
                        if name == "flash_prefill" else
                        flash_ops.BWD_ROUTES[torch.float32]
                        if name == "flash_backward" else
                        flash_ops.BWD_ROUTES[torch.bfloat16]
                        if name == "flash_backward_bf16" else "cuda-core")
        table.append(dict(
            name=name, route="cuda", kernel_route=kernel_route, source=source,
            replaces=replaces,
            launches=count, launches_from=launches_from,
            launches_model=model_launches[name],
            **{f"launches_{k}": v[name] for k, v in served.items()},
            launches_durability=durable_launches[name],
            launches_dist=dist_launches[name],
            launches_train=train_launches[name],
            launches_train_bf16=bf16_launches[name],
            **{f"launches_{k}": v[name] for k, v in rank_launches.items()},
            max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            share_of_bound=row["bound_ms"] / row["ms"],
            **({"bound_unit": row["bound_unit"]}
               if name.startswith("flash_backward") else {})))
        if name in MAIN_OPS:
            # K1-K3: the main path's one-launch op, beside the chain of
            # ops it replaced and the parity op that stays
            parity = kernels[name]
            table[-1].update(
                op=row["op"], call_ms=row["call_ms"],
                kernels_per_call=row["kernels_per_call"],
                chain_ms=row["chain_ms"], chain_call_ms=row["chain_call_ms"],
                chain_launches=row["chain_launches"],
                parity_op=dict(op=name, ms=parity["ms"],
                               call_ms=parity["call_ms"],
                               bound_ms=parity["bound_ms"]))
    print(smi, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--train-reference"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.lib()
        sys.exit(train_sharded_reference(torch.device("cuda", 0),
                                         sys.argv[2]))
    sys.exit(main())
