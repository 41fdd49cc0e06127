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

**Gradients.**  JAX's version is differentiable: ``ppermute``,
``fori_loop`` and ``psum`` have transposes.  Here the whole schedule is
one ``torch.autograd.Function`` (:class:`_Pipeline`), since a hop's host
copy is outside autograd, and a graph per hop would deadlock: stage 0
never uses the carry of the ring's wrap hop (S - 1 -> 0), so its backward
would never post that hop's reverse.  The forward saves each active tick's
stage input; the backward walks the ticks in reverse, every rank posting
the reverse hop of each (the gradient of the carry it received to
``sid - 1``, the gradient of its output from ``sid + 1``; the wrap hop
carries zeros, as ``ppermute``'s transpose does), and at an active tick
recomputes ``apply_fn`` on the saved input and differentiates it.  As in
JAX's transpose, the replicated output is one output with one cotangent:
stage S - 1's own.  Each leaf's gradient is summed in its dtype, last
microbatch first, and stage 0's input gradients are broadcast to every
rank's ``x``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from repro_torch.ckpt.manager import tree_flatten, tree_unflatten
from repro_torch.dist.overlap import broadcast_, exchange


def pipeline_forward(apply_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stage_params: Any, x: torch.Tensor, *, mesh,
                     axis: str = "stage") -> torch.Tensor:
    """Returns y [M, mb, ...]: ``x`` [M, mb, ...] (the same on every rank)
    pushed through all S stages of ``mesh``'s ``axis`` in GPipe order;
    ``stage_params`` are this rank's stage's.

    Differentiable with respect to ``x`` and every tensor of
    ``stage_params`` that requires grad, as JAX's is.  When autograd
    records the call, its contract is:

    * ``apply_fn`` is deterministic, as a JAX function is: the backward
      recomputes each microbatch's stage from its saved input and must
      reproduce the forward;
    * every stage rank records the call (``x`` requires grad on every
      rank or on none; where on none, each rank's stage has a tensor that
      requires grad) and backpropagates through the output, since the
      backward's hops are collectives; only stage S - 1's cotangent of
      the output is used;
    * it holds the M saved stage inputs (one microbatch's activation
      each) until the backward, and during the backward one microbatch's
      graph of one stage.

    Under ``torch.no_grad()``, or where nothing requires grad, it saves
    nothing and runs the forward alone."""
    group = mesh.get_group(axis)
    leaves = tree_flatten(stage_params)
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in [x, *leaves]):
        return _Pipeline.apply(apply_fn, stage_params, group, x, *leaves)
    return _schedule(apply_fn, stage_params, x, group)


def _schedule(apply_fn, stage_params, x: torch.Tensor, group,
              inputs: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The forward's ``M + S - 1`` ticks; each active tick's stage input
    appended to ``inputs`` when given."""
    S, sid = dist.get_world_size(group), dist.get_rank(group)
    M = x.shape[0]
    buf = torch.zeros_like(x)                  # outputs (stage S - 1)
    carry = torch.zeros_like(x[0])             # inbound activation
    for t in range(M + S - 1):
        m = t - sid                            # microbatch index here
        # stage 0 ingests fresh microbatches; the others take the carry
        inp = x[min(max(t, 0), M - 1)] if sid == 0 else carry
        active = 0 <= m < M
        if active and inputs is not None:
            inputs.append(inp)
        # an inactive stage passes its input on, as JAX's mask does
        out = apply_fn(stage_params, inp) if active else inp
        if sid == S - 1 and active:
            buf[m] = out                       # the last stage banks it
        carry = exchange(out, (sid + 1) % S, (sid - 1) % S, group) \
            if S > 1 else out
    # only stage S - 1's buffer holds outputs: JAX sums the masked buffers
    # (zeros elsewhere) to every stage, which is the last stage's buffer
    return broadcast_(buf, S - 1, group)


def _stage_dy(gy: torch.Tensor, group) -> torch.Tensor:
    """The output's cotangent as stage S - 1 uses it: its own, not summed
    over the ranks (the replicated output is one output)."""
    return gy


def _reverse_hop(g: torch.Tensor, sid: int, S: int, group) -> torch.Tensor:
    """The transpose of a forward hop: ``g`` (the gradient of the carry
    this rank received) goes back to ``sid - 1``; returns the gradient of
    this rank's output, from ``sid + 1``."""
    return exchange(g, (sid - 1) % S, (sid + 1) % S, group)


def _accumulate(acc: Optional[torch.Tensor], g: torch.Tensor
                ) -> torch.Tensor:
    """One microbatch's leaf gradient added to the sum so far (in the
    leaf's dtype)."""
    return g if acc is None else acc + g


class _Pipeline(torch.autograd.Function):
    """:func:`_schedule` with GPipe's reverse schedule as its backward."""

    @staticmethod
    def forward(ctx, apply_fn, stage_params, group, x, *leaves):
        inputs: List[torch.Tensor] = []
        y = _schedule(apply_fn, stage_params, x, group, inputs)
        tensors = [t for t in leaves if torch.is_tensor(t)]
        ctx.save_for_backward(*inputs, *tensors)
        ctx.fn, ctx.like, ctx.group, ctx.M = (apply_fn, stage_params, group,
                                              len(inputs))
        ctx.leaves = [None if torch.is_tensor(t) else t for t in leaves]
        return y

    @staticmethod
    def backward(ctx, gy):
        group, M = ctx.group, ctx.M
        S, sid = dist.get_world_size(group), dist.get_rank(group)
        saved = ctx.saved_tensors
        inputs, tensors = saved[:M], iter(saved[M:])
        want = ctx.needs_input_grad[4:]
        # the stage's leaves, those that want a gradient as fresh leaves
        leaves = [next(tensors) if t is None else t for t in ctx.leaves]
        leaves = [t.detach().requires_grad_() if w else t
                  for t, w in zip(leaves, want)]
        params = tree_unflatten(ctx.like, leaves)
        wrt = [t for t, w in zip(leaves, want) if w]
        need_in = sid > 0 or ctx.needs_input_grad[3]
        acc: List[Optional[torch.Tensor]] = [None] * len(wrt)
        dy = _stage_dy(gy, group)
        dx = torch.zeros_like(gy) if ctx.needs_input_grad[3] else None
        zeros = torch.zeros_like(gy[0])
        g_carry = zeros           # the last tick's carry feeds no tick
        for t in range(M + S - 2, -1, -1):
            g_out = _reverse_hop(g_carry, sid, S, group) if S > 1 \
                else zeros
            m = t - sid
            if not 0 <= m < M:
                g_in = g_out      # the forward passed its input on
            else:
                if sid == S - 1:
                    g_out = dy[m]
                with torch.enable_grad():
                    h = inputs[m].detach().requires_grad_(need_in)
                    out = ctx.fn(params, h)
                    grads = torch.autograd.grad(
                        out, ([h] if need_in else []) + wrt, g_out,
                        materialize_grads=True)
                g_in = grads[0] if need_in else None
                for i, g in enumerate(grads[int(need_in):]):
                    acc[i] = _accumulate(acc[i], g)
                del out, grads, h
            if sid > 0:
                g_carry = g_in
            elif dx is not None and 0 <= m < M:
                dx[m] = g_in      # stage 0's input is x[m]
        if dx is not None:
            dx = broadcast_(dx, 0, group)
        it = iter(acc)
        return (None, None, None, dx,
                *(next(it) if w else None for w in want))
