"""Int8 error-feedback gradient compression (port of
``repro.optim.compress``).

Gradients are quantized to int8 with a per-tensor scale before the
reduction across data-parallel replicas, and the quantization error is fed
back into the next step's gradient (error feedback keeps convergence;
Karimireddy et al.).  ``torch.round`` rounds half to even, as
``jnp.round`` does, so the int8 values and the scales equal JAX's bit for
bit on the same float32 input.

On a placed state (a :class:`repro_torch.dist.sharding.Placement`) each
rank holds shards of the gradients and of the error carry, and a leaf's
scale is still that of the whole leaf: the max of ``|g + e|`` over the
ranks that hold its distinct shards (one float32 all-reduce a leaf), as
JAX's GSPMD step computes it on a sharded state.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.ckpt.manager import tree_flatten, tree_unflatten


def quantize(g: torch.Tensor, top=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale ``max|g| / 127``, the max floored at
    1e-12).  ``top(max|g|)`` gives the whole leaf's max where ``g`` is a
    shard of it."""
    gf = g.float()
    amax = torch.max(torch.abs(gf))
    if top is not None:
        amax = top(amax)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: Any, error: Any, placement=None
                  ) -> Tuple[Any, Any, Any]:
    """(quantized, scales, new_error) of ``grads + error``, each a tree like
    ``grads``; ``error`` is the carried state (zeros at first).  With a
    ``placement`` both are this rank's shards, and each scale is the
    whole leaf's (see the module docstring)."""
    from repro_torch.dist.sharding import _paths
    qs, scales, errs = [], [], []
    paths = [p for p, _ in _paths(grads)]
    for path, g, e in zip(paths, tree_flatten(grads), tree_flatten(error)):
        corrected = g.float() + e
        top = None
        if placement is not None:
            def top(x, path=path):
                return placement.leaf_max(x.reshape(1), path).reshape(())
        q, s = quantize(corrected, top)
        qs.append(q)
        scales.append(s)
        errs.append(corrected - dequantize(q, s))
    return (tree_unflatten(grads, qs), tree_unflatten(grads, scales),
            tree_unflatten(grads, errs))


def decompress_tree(qs: Any, scales: Any) -> Any:
    return tree_unflatten(qs, [dequantize(q, s) for q, s in
                               zip(tree_flatten(qs), tree_flatten(scales))])


def init_error(params) -> Any:
    return tree_unflatten(params, [torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device)
                                   for p in tree_flatten(params)])
