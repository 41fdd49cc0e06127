"""Pipeline parallelism, GPipe order, over a ``stage`` mesh axis (port of
``repro.train.pipeline_parallel``).

Each stage holds a contiguous slice of the model; microbatches stream
through with a send to the next stage and a receive from the previous one
per tick, in place of JAX's ``ppermute``.  ``M + S - 1`` ticks realise the
GPipe schedule (bubble ``(S - 1) / (M + S - 1)``); the activation in
flight is the only state crossing a tick.

Where JAX runs one function over a mesh under ``shard_map``, this is a
per-rank function: every rank of the stage group calls it with its own
stage's parameters and the same microbatched input, and gets the full
output back.  It pipelines any per-stage ``apply_fn(stage_params, x) ->
x``.  Sends and receives cross gloo through host memory
(:func:`repro_torch.dist.overlap.exchange`).

**Forward only.**  JAX's version is differentiable (``ppermute`` and
``psum`` have transposes); here a hop copies its activation to host
memory and back, which autograd does not follow, so a stage whose output
crossed a hop would silently get no gradient.  :func:`pipeline_forward`
therefore refuses to run where autograd would record it: call it under
``torch.no_grad()`` or on tensors that do not require grad.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.ckpt.manager import tree_flatten
from repro_torch.dist.overlap import broadcast_, exchange


def pipeline_forward(apply_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stage_params: Any, x: torch.Tensor, *, mesh,
                     axis: str = "stage") -> torch.Tensor:
    """Returns y [M, mb, ...]: ``x`` [M, mb, ...] (the same on every rank)
    pushed through all S stages of ``mesh``'s ``axis`` in GPipe order;
    ``stage_params`` are this rank's stage's.  Forward only: raises
    ``RuntimeError`` when grad is enabled and ``x`` or a tensor of
    ``stage_params`` requires grad."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad
            for t in [x, *tree_flatten(stage_params)]):
        raise RuntimeError("pipeline_forward is forward only: its hops "
                           "cross host memory outside autograd; run it "
                           "under torch.no_grad()")
    group = mesh.get_group(axis)
    S = dist.get_world_size(group)
    sid = dist.get_rank(group)
    M = x.shape[0]
    buf = torch.zeros_like(x)                  # outputs (stage S - 1)
    carry = torch.zeros_like(x[0])             # inbound activation
    for t in range(M + S - 1):
        m = t - sid                            # microbatch index here
        # stage 0 ingests fresh microbatches; the others take the carry
        inp = x[min(max(t, 0), M - 1)] if sid == 0 else carry
        active = 0 <= m < M
        # an inactive stage passes its input on, as JAX's mask does
        out = apply_fn(stage_params, inp) if active else inp
        if sid == S - 1 and active:
            buf[m] = out                       # the last stage banks it
        carry = exchange(out, (sid + 1) % S, (sid - 1) % S, group) \
            if S > 1 else out
    # only stage S - 1's buffer holds outputs: JAX sums the masked buffers
    # (zeros elsewhere) to every stage, which is the last stage's buffer
    return broadcast_(buf, S - 1, group)
