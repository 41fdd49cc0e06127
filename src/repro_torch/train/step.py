"""Training step (port of ``repro.train.step``): loss -> gradients ->
AdamW, with microbatch accumulation, optional int8 error-feedback
compression before the gradient reduction, and the reduction hook.

The state is a :class:`TrainState` of tensors: the parameters (the port's
tree, one dict per layer), the AdamW state, the error-feedback carry and
the step.  A state placed over a ``(data, model)`` mesh
(:func:`repro_torch.dist.sharding.place_train_state`) holds this rank's
shards, and :func:`train_step` takes its ``Placement``: one design, each
leaf gathered at use, layer by layer (over ``data`` only where the layer
computes on its shards over ``model``: attention heads, the MLP's hidden
dim, the vocabulary), its gradient sent back to its placement, AdamW on
the local shards.  :func:`train_step` updates the
parameters and the moments in place and returns them (see
:mod:`repro_torch.optim.adamw`), as the JAX step's donated buffers would
be reused; a caller that needs the state before the step keeps a copy.
Gradients come from ``torch.autograd.grad`` through the model, whose
attention layers run K6 forward and K6b backward on the card.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch._tensor import DeviceLike, resolve_device
from repro_torch.ckpt.manager import tree_flatten, tree_unflatten
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.dist.overlap import ring_all_reduce
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.optim.compress import (compress_tree, decompress_tree,
                                        init_error)


def make_grad_reduce(group: Optional[dist.ProcessGroup] = None,
                     reduce: str = "mean") -> Callable[[Any], Any]:
    """The ``grad_reduce`` hook of a data-parallel loop: the ring
    all-reduce of :mod:`repro_torch.dist.overlap` leaf by leaf over
    ``group`` (the default group when None).  ``reduce="mean"`` is the
    data-parallel gradient's reduction (JAX's ``pmean``).  Like the ring, it
    is a per-rank function: every rank of the group calls it with its own
    gradients."""
    def reduce_tree(grads):
        return tree_unflatten(grads, [ring_all_reduce(g, reduce, group)
                                      for g in tree_flatten(grads)])
    return reduce_tree


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    err: Any             # error-feedback carry (1-element zeros when unused)
    step: torch.Tensor   # int32 scalar


def init_state(cfg: ModelConfig, gen: Optional[torch.Generator] = None,
               dtype: torch.dtype = torch.float32, compression: bool = False,
               *, device: DeviceLike = None) -> TrainState:
    """Random parameters from ``gen`` (on its device; without one, a
    generator seeded 0 on ``device``, the GPU unless the caller names
    another), zero moments, and the error carry: zeros like the parameters
    with ``compression``, else a 1-element float32 zero per leaf, as in
    JAX."""
    if gen is None:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(0)
    params = tf.init_params(cfg, gen, dtype=dtype)
    dev = gen.device
    if compression:
        err = init_error(params)
    else:
        err = tree_unflatten(params, [
            torch.zeros((1,), dtype=torch.float32, device=dev)
            for _ in tree_flatten(params)])
    return TrainState(params=params, opt=adamw.init(params), err=err,
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def _value_and_grad(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                    placement=None) -> Tuple[torch.Tensor, list]:
    """(loss, float32 gradient of every parameter leaf, in
    ``tree_flatten`` order), each layer checkpointed.  With a
    ``placement`` the leaves are this rank's shards, which the model
    gathers at use and computes on over ``model`` (:func:`repro_torch.
    models.transformer.loss_fn`), ``batch`` is the global batch, of which
    this rank takes its rows, and the gradients are the shards'
    (averaged over the batch axes)."""
    leaves = tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    group = None
    if placement is not None:
        batch, group = placement.split(batch)
    with torch.enable_grad():
        loss, _ = tf.loss_fn(params, cfg, batch, remat=True,
                             placement=placement, group=group)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), [g.float() for g in grads]


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, run: RunConfig,
               grad_reduce: Optional[Callable[[Any], Any]] = None,
               placement=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step on ``batch`` (tokens [global_batch, seq] on the
    state's device).  With ``run.microbatches`` > 1 the batch is cut into
    that many chunks along its rows, the float32 gradients summed and
    divided by their number (the loss too).  Then, with
    ``run.grad_compression``, the int8 round trip with error feedback; then
    ``grad_reduce`` (the values crossing the reduction are the quantized
    ones); then AdamW at the cosine schedule's rate for the step before
    it.  Returns (state', {"loss", "lr", "grad_norm"}).

    ``placement`` (a :class:`repro_torch.dist.sharding.Placement`) says
    that ``state`` holds this rank's shards: every rank passes the same
    global batch and takes its rows of each microbatch by ``batch_spec``;
    each leaf is gathered just before its layer runs (and again in the
    checkpoint's recompute) and freed after, over ``data`` only where the
    layer computes on its shards over ``model`` (attention heads, the
    MLP's hidden dim, the vocabulary: the activations cross the ``model``
    ranks instead); its gradient goes back to its placement, averaged
    over ``data``, and a leaf gathered whole taken once over ``model``
    (whose ranks compute the same thing); the loss is the mean over
    ``data`` and the clip's norm is taken over the distinct shards of
    every rank.  The statistics of the whole batch cross the ranks that
    split it (the loss mask's sum, an MoE layer's expert counts: see
    :func:`repro_torch.models.transformer.loss_fn`), so the result is the
    one-rank step's, as JAX's GSPMD step's is.  With
    ``run.grad_compression`` each leaf's int8 scale is that of the whole
    leaf (the max of ``|g + e|`` over the ranks that hold its distinct
    shards), and ``state.err`` holds this rank's shards, placed by the
    parameters' specs (as JAX's ``launch/specs.py`` places it).
    ``grad_reduce`` is refused there: the placement already reduces the
    gradients over the batch axes, and a second reduction would be the
    data-parallel loop's, not this one's."""
    mb = run.microbatches
    params = state.params
    if placement is not None and grad_reduce is not None:
        raise ValueError("a placed state takes no grad_reduce: the "
                         "placement reduces its gradients")
    if mb > 1:
        B = batch["tokens"].shape[0]
        grads, loss = None, torch.zeros((), dtype=torch.float32,
                                        device=batch["tokens"].device)
        for i in range(mb):
            chunk = {k: v.reshape(mb, B // mb, *v.shape[1:])[i]
                     for k, v in batch.items()}
            l, g = _value_and_grad(params, cfg, chunk, placement)
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            loss = loss + l
        grads = [g / mb for g in grads]
        loss = loss / mb
    else:
        loss, grads = _value_and_grad(params, cfg, batch, placement)
    grads = tree_unflatten(params, grads)

    err = state.err
    if run.grad_compression:
        q, scales, err = compress_tree(grads, state.err, placement)
        grads = decompress_tree(q, scales)
    if grad_reduce is not None:
        grads = grad_reduce(grads)
    gnorm = None
    if placement is not None:
        loss = placement.batch_mean(loss)
        gnorm = placement.global_norm(grads)

    lr = adamw.cosine_schedule(state.opt.step, base_lr=run.lr)
    params, opt, om = adamw.apply(params, grads, state.opt, lr=lr,
                                  gnorm=gnorm)
    return (TrainState(params, opt, err, state.step + 1),
            {"loss": loss, "lr": lr, **om})
