"""AdamW with global-norm clipping (port of ``repro.optim.adamw``).

Parameters, gradients and the moments are trees of tensors (nested dicts
and lists, as the port's model parameters are); the moments are float32
whatever the parameters' dtype.  Every step quantity (the clip scale, the
bias corrections, the learning rate) is a float32 tensor computed as JAX
computes it, not a Python float, so the update rounds as JAX's does.

:func:`apply` updates ``params``, ``state.mu`` and ``state.nu`` in place
(under ``torch.no_grad``) and returns them: at gemma2-2b's full width the
three are 29 GiB in float32, and a functional update would hold a second
copy of them.  This stands in for the buffer donation the JAX training
step is written for; each element is computed with JAX's operations in
JAX's order.
"""
from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.ckpt.manager import tree_flatten, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    mu: Any              # first moment (a tree like the parameters)
    nu: Any              # second moment


def _zeros_like_tree(params) -> Any:
    return tree_unflatten(params, [torch.zeros_like(p, dtype=torch.float32)
                                   for p in tree_flatten(params)])


def init(params) -> AdamWState:
    dev = tree_flatten(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=_zeros_like_tree(params),
                      nu=_zeros_like_tree(params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in ``jax.tree.leaves`` order) of each
    leaf's float32 sum of squares."""
    total = 0
    for x in tree_flatten(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def apply(params, grads, state: AdamWState, *, lr, b1: float = 0.9,
          b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
          grad_clip: float = 1.0, gnorm: Optional[torch.Tensor] = None
          ) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step with the gradients clipped to global norm
    ``grad_clip`` (0 = no clipping).  ``gnorm`` is that norm when the
    caller holds shards of the gradients and took it over the ranks
    (``Placement.global_norm``); else :func:`global_norm` of ``grads``.
    Returns (params, state, {"grad_norm"}), the parameters and moments
    updated in place."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = (torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
             if grad_clip else 1.0)
    step = state.step + 1
    stepf = step.float()
    b1c = 1 - b1 ** stepf
    b2c = 1 - b2 ** stepf
    ps: List[torch.Tensor] = tree_flatten(params)
    with torch.no_grad():
        for p, g, m, v in zip(ps, tree_flatten(grads),
                              tree_flatten(state.mu), tree_flatten(state.nu)):
            g = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)        # b1 m + (1 - b1) g
            v.mul_(b2).add_((1 - b2) * g * g)    # b2 v + (1 - b2) g g
            mh = m / b1c
            vh = v / b2c
            delta = mh / (torch.sqrt(vh) + eps) \
                + weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm}


def cosine_schedule(step: torch.Tensor, *, base_lr: float, warmup: int = 100,
                    total: int = 10_000, min_frac: float = 0.1
                    ) -> torch.Tensor:
    """Linear warmup from 0 over ``warmup`` steps, then a cosine from
    ``base_lr`` down to ``min_frac * base_lr`` at ``total``; float32."""
    stepf = step.float()
    warm = stepf / max(1, warmup)
    prog = torch.clamp((stepf - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(stepf < warmup, warm, cos)
