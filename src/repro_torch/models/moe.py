"""Mixture-of-experts feed-forward: a top-k router and capacity-bucketed
dispatch, with optional shared experts (port of ``repro.models.moe``).

Tokens are sorted by the expert they are routed to, scattered into
per-expert buckets of capacity ``C`` (``[E, C, d]``; a token past an
expert's capacity is dropped, GShard-style), run through the experts as
batched matmuls, and combined back with the router's weights.  JAX computes
the expert products with ``einsum`` outside any Pallas kernel, so plain
``torch.bmm`` is their counterpart here.

Where torch and JAX differ (each named where it arises):

* ``lax.top_k`` puts the lower expert first among equal probabilities;
  a stable descending ``torch.sort`` does the same (trap C2).
* ``jnp.argsort`` is stable; so is ``torch.sort(..., stable=True)``.
* The bucket scatter's drop slot ``E * C`` is a pad row, cut off after
  the scatter (``mode="drop"`` has no torch counterpart).
* JAX combines with ``out.at[tok].add(contrib)``.  ``index_add_`` on CUDA
  adds with atomics, whose order (and so whose bits) varies from call to
  call.  The ``N * k`` slots are a permutation of (token, choice), so
  each (token, choice) finds its slot, and a token's ``k`` contributions
  are added one at a time in a fixed order, that of its slots (by
  expert), as JAX's scatter adds them.

**A batch split over ranks** (``group``, a
:class:`repro_torch.dist.sharding.BatchGroup`; training on a placed state
only).  JAX's GSPMD step routes the global batch, and this layer reads two
statistics of every token in it: the expert counts of the load-balance
loss, and, in the global dispatch, the capacity (from the global token
count) and each assignment's rank within its expert (after every token of
the rows before it).  So each rank takes the counts of every rank of the
group (:meth:`~repro_torch.dist.sharding.BatchGroup.rows`, the same call
on every rank of the group: trap "ranks must take the same branch"), sums
them for the loss, offsets its ranks by the counts of the ranks before it
and sizes the buckets from ``n`` times its tokens.  Its load-balance loss
is then ``n`` times its share of the global one (its own tokens' mean
probabilities against the global counts), as the placement expects.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init
from repro_torch.models.mlp import _act, init_mlp, mlp


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype = torch.float32) -> dict:
    """The router is float32 whatever ``dtype`` is, as in JAX."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": dense_init(gen, (d, E), dtype=torch.float32),
        "wg": dense_init(gen, (E, d, f), in_axis=1, dtype=dtype),
        "wu": dense_init(gen, (E, d, f), in_axis=1, dtype=dtype),
        "wd": dense_init(gen, (E, f, d), in_axis=1, dtype=dtype),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, cfg, dtype=dtype,
                               d_ff=cfg.d_ff * cfg.num_shared_experts)
    return p


def moe(params: dict, cfg: ModelConfig, x: torch.Tensor, group=None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``group``: the ranks that split the batch's rows, None when ``x``
    is the whole batch (see the module docstring)."""
    if cfg.moe_dispatch == "grouped":
        return moe_grouped(params, cfg, x, group)
    return moe_global(params, cfg, x, group)


def capacity(cfg: ModelConfig, n: int) -> int:
    """Slots per expert for a pool of ``n`` tokens: the capacity-factor
    term (a Python ``int()`` of a float, as in JAX), with a dropless floor
    of ``min(n * k, 128)`` for small pools such as decode steps."""
    k, E = cfg.top_k, cfg.num_experts
    return max(1, int(cfg.moe_capacity_factor * n * k / E), min(n * k, 128))


def _route(params: dict, cfg: ModelConfig, x: torch.Tensor, group=None):
    """The top-k gate weights (renormalised, from float32 router
    probabilities) and expert ids [..., k], the Switch load-balance loss,
    and each expert's assignments on the ranks of ``group`` before this
    one (None without a group)."""
    E, k = cfg.num_experts, cfg.top_k
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)  # trap C2
    gate_vals, gate_idx = top.values[..., :k], top.indices[..., :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    me = probs.reshape(-1, E).mean(0)
    # counts by a scatter-add of ones, as JAX's .at[].add(1.0): exact in
    # any order, and with no host sync (bincount reads its input's range)
    flat = gate_idx.reshape(-1)
    counts = probs.new_zeros((E,)).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=probs.dtype))
    before, n = None, 1
    if group is not None:
        every = group.rows(counts)                              # [n, E]
        counts, before = every.sum(0), every[:group.index].sum(0)
        n = group.n
    ce = counts / (flat.numel() * n)
    return gate_vals, gate_idx, E * torch.sum(me * ce), before


def _experts(params: dict, cfg: ModelConfig, be: torch.Tensor
             ) -> torch.Tensor:
    """Every expert on its bucket rows: ``be`` [E, R, d] -> [E, R, d]."""
    g = _act(cfg.act, torch.bmm(be, params["wg"]))
    u = torch.bmm(be, params["wu"])
    return torch.bmm(g * u, params["wd"])


def _dispatch_combine(params: dict, cfg: ModelConfig, x: torch.Tensor,
                      C: int, group=None, offset: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route, sort and bucket the tokens of each group (row) of ``x``
    [G, n, d] on their own with capacity ``C``, run the experts, combine:
    -> ([G, n, d], aux).  ``offset``: ``x`` is one group that continues
    the rows of the ranks of ``group`` before this one, so each rank
    within an expert starts after their assignments to it."""
    G, n, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    gate_vals, gate_idx, aux, before = _route(params, cfg, x, group)
    sorted_e, order = torch.sort(gate_idx.reshape(G, n * k), dim=-1,
                                 stable=True)
    # rank within its expert = position - first position of that expert
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(n * k, device=x.device) - first
    if offset and before is not None:
        rank = rank + before.long()[sorted_e]
    dest = torch.where(rank < C, sorted_e * C + rank, E * C)    # E*C = drop
    gidx = torch.arange(G, device=x.device)[:, None]
    buckets = x.new_zeros((G, E * C + 1, d))
    buckets[gidx, dest] = x[gidx, order // k]   # row E*C is cut off below
    be = buckets[:, :E * C].reshape(G, E, C, d).transpose(0, 1)
    eo = _experts(params, cfg, be.reshape(E, G * C, d))
    eo = eo.view(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)

    # slot j holds (token, choice) order[j]: each (token, choice)'s bucket
    # row, a token's choices ordered by it (by expert, the order of the
    # slots, dropped ones last)
    row = torch.empty_like(dest).scatter_(1, order, dest).view(G, n, k)
    row, turn = torch.sort(row, dim=-1)
    w = torch.gather(gate_vals, -1, turn)
    gathered = eo[gidx[..., None], row.clamp_max(E * C - 1)]   # [G, n, k, d]
    contrib = torch.where((row < E * C)[..., None],
                          gathered * w[..., None].to(x.dtype), 0)
    out = torch.zeros_like(contrib[:, :, 0])
    for c in range(k):
        out = out + contrib[:, :, c]
    return out, aux


def moe_global(params: dict, cfg: ModelConfig, x: torch.Tensor,
               group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` [B, T, d] -> (out [B, T, d], load-balance aux loss): one sort
    over all ``B * T * k`` assignments, capacity from ``B * T`` tokens
    (over ``group``: the global batch's)."""
    B, T, d = x.shape
    n = group.n if group is not None else 1
    out, aux = _dispatch_combine(params, cfg, x.reshape(1, B * T, d),
                                 capacity(cfg, B * T * n), group,
                                 offset=True)
    out = out.view(B, T, d)
    if cfg.num_shared_experts:
        out = out + mlp(params["shared"], cfg, x)
    return out, aux


def moe_grouped(params: dict, cfg: ModelConfig, x: torch.Tensor,
                group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sequence dispatch: routing, sort, rank and capacity (from ``T``
    tokens) independently per batch row; over ``group`` only the
    load-balance counts cross the ranks."""
    out, aux = _dispatch_combine(params, cfg, x, capacity(cfg, x.shape[1]),
                                 group)
    if cfg.num_shared_experts:
        out = out + mlp(params["shared"], cfg, x)
    return out, aux
