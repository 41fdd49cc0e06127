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

**Experts split over ``model``** (``tp``, a
:class:`repro_torch.dist.sharding.ModelAxis` whose ``local`` holds
``wg``/``wu``/``wd``: expert parallelism, as JAX's GSPMD cells put the
expert dim on ``model``).  The ``model`` ranks of a data row hold the same
rows and the whole float32 router, so each routes every token as the
others do: the top-k, the load-balance loss, the capacity and each
assignment's rank within its expert, and so the dropped tokens, are the
same on all of them.  Rank ``r`` of ``n`` runs its block of ``E / n``
experts on their bucket rows alone, adds the slots of its experts in slot
order (the others are zeros), adds its shared expert's partial sum (split
on its hidden dim, as the dense MLP is) and one ``tp.g`` sums the ranks'
``[B, T, d]``: the bucket outputs never cross the ranks.

Where the experts also came split over the batch's ranks (FSDP:
``tp.rows``; a training step's global dispatch over ``group``), JAX's
GSPMD step divides each expert's bucket rows over those ranks as well (a
quarter of one device's expert work on a 2 x 2 mesh, where the split
above alone leaves half).  So there every rank gathers the whole batch's
tokens and routing (:meth:`~repro_torch.dist.sharding.BatchGroup.gather`,
the routing of the global batch is the one-rank step's), computes its
block of ``C / group.n`` rows of each of its experts, and the partial sums
of every token are summed over the batch's ranks, each keeping its own
rows (:meth:`~repro_torch.dist.sharding.BatchGroup.sum_rows`), before the
one ``tp.g``.  The serve cells (no FSDP) keep each rank's own rows.

Trap, training: ``tp.f`` goes on what enters the expert path only, the
tokens the buckets (and the shared expert) read and the gate weights
that scale this rank's slots.  It never goes on the router's input:
every rank computes the router's path in full, so an ``f`` there would
sum its gradient ``n`` times.  And without ``f`` on the gate weights a
rank's router gradient would hold its own experts' terms only, which the
placement, taking a whole leaf's gradient once over ``model``, would
silently keep.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init
from repro_torch.models.mlp import _act, init_mlp, mlp, mlp_product


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


def moe(params: dict, cfg: ModelConfig, x: torch.Tensor, group=None,
        tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``group``: the ranks that split the batch's rows, None when ``x``
    is the whole batch; ``tp``: the model axis when the experts (or the
    shared expert) came split over ``model`` (see the module
    docstring)."""
    if cfg.moe_dispatch == "grouped":
        return moe_grouped(params, cfg, x, group, tp)
    return moe_global(params, cfg, x, group, tp)


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


def _axes(tp):
    """(the model axis of the experts when this rank holds its block of
    them, that of the shared expert when its hidden dim came split)."""
    if tp is None:
        return None, None
    ep = tp if {"wg", "wu", "wd"} <= tp.local else None
    shared = frozenset(k[len("shared/"):] for k in tp.local
                       if k.startswith("shared/"))
    return ep, (tp.holding(shared) if shared else None)


def _dispatch_combine(params: dict, cfg: ModelConfig, src: torch.Tensor,
                      gate_vals: torch.Tensor, gate_idx: torch.Tensor,
                      C: int, before=None, block=None) -> torch.Tensor:
    """Sort and bucket the tokens ``src`` [G, n, d] of each group (row)
    on their own by their expert ids ``gate_idx`` [G, n, k] with capacity
    ``C``, run the experts, and combine with the gate weights ``gate_vals``
    [G, n, k]: -> [G, n, d].  ``before`` (a group continuing the rows of
    the ranks before this one): each expert's assignments on them, after
    which each rank within that expert starts.  ``block`` = (first expert,
    experts, first row, rows): the bucket rows this rank computes of each
    of its experts' ``C`` (all of every expert by default); the result
    is then this rank's partial sum, the slots of its rows alone."""
    G, n, d = src.shape
    E, k = cfg.num_experts, cfg.top_k
    e0, El, c0, Cb = block if block is not None else (0, E, 0, C)
    sorted_e, order = torch.sort(gate_idx.reshape(G, n * k), dim=-1,
                                 stable=True)
    # rank within its expert = position - first position of that expert
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(n * k, device=src.device) - first
    if before is not None:
        rank = rank + before.long()[sorted_e]
    dest = torch.where(rank < C, sorted_e * C + rank, E * C)    # E*C = drop
    # this rank's bucket row of each slot; R (a pad row, cut off below)
    # for a slot dropped or not in its block
    R = El * Cb
    mine = ((rank < C) & (sorted_e >= e0) & (sorted_e < e0 + El)
            & (rank >= c0) & (rank < c0 + Cb))
    here = torch.where(mine, (sorted_e - e0) * Cb + rank - c0, R)
    gidx = torch.arange(G, device=src.device)[:, None]
    buckets = src.new_zeros((G, R + 1, d))
    buckets[gidx, here] = src[gidx, order // k]
    be = buckets[:, :R].reshape(G, El, Cb, d).transpose(0, 1)
    eo = _experts(params, cfg, be.reshape(El, G * Cb, d))
    eo = eo.view(El, G, Cb, d).transpose(0, 1).reshape(G, R, d)

    # slot j holds (token, choice) order[j]: each (token, choice)'s bucket
    # row, a token's choices ordered by it (by expert, the order of the
    # slots, dropped ones last), and its row here
    row, turn = torch.sort(torch.empty_like(dest).scatter_(1, order, dest)
                           .view(G, n, k), dim=-1)
    row = torch.empty_like(here).scatter_(1, order, here).view(
        G, n, k).gather(-1, turn)
    w = torch.gather(gate_vals, -1, turn)
    gathered = eo[gidx[..., None], row.clamp_max(R - 1)]      # [G, n, k, d]
    contrib = torch.where((row < R)[..., None],
                          gathered * w[..., None].to(src.dtype), 0)
    out = torch.zeros_like(contrib[:, :, 0])
    for c in range(k):
        out = out + contrib[:, :, c]
    return out


def _with_shared(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 xe: torch.Tensor, out: torch.Tensor, ep, sh
                 ) -> torch.Tensor:
    """The experts' output ``out`` plus the shared expert's.  Where the
    experts came split, ``out`` is this rank's partial sum: a shared
    expert split on its hidden dim adds its partial sum (of ``xe``, which
    already passed ``ep.f``) before the one ``ep.g``; one that came whole
    adds its output after it."""
    shared = None
    if cfg.num_shared_experts:
        if ep is not None and sh is not None:
            out = out + mlp_product(params["shared"], cfg, xe)
        else:
            shared = mlp(params["shared"], cfg, x, sh)
    if ep is not None:
        out = ep.g(out)
    return out if shared is None else out + shared


def _expert_block(cfg: ModelConfig, ep, C: int, group=None):
    """The ``block`` of :func:`_dispatch_combine` this rank computes: its
    ``E / n`` experts (all without ``ep``), and with ``group`` (the rows
    split over the batch's ranks too) its ``index``-th of ``group.n``
    blocks of each expert's ``C`` rows."""
    E = cfg.num_experts
    if ep is None:
        return None
    El = E // ep.n
    if group is None:
        return ep.index * El, El, 0, C
    c0 = C * group.index // group.n
    return ep.index * El, El, c0, C * (group.index + 1) // group.n - c0


def moe_global(params: dict, cfg: ModelConfig, x: torch.Tensor,
               group=None, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` [B, T, d] -> (out [B, T, d], load-balance aux loss): one sort
    over all ``B * T * k`` assignments, capacity from ``B * T`` tokens
    (over ``group``: the global batch's); ``tp``: :func:`moe`'s."""
    B, T, d = x.shape
    N, k = B * T, cfg.top_k
    n = group.n if group is not None else 1
    C = capacity(cfg, N * n)
    ep, sh = _axes(tp)
    gate_vals, gate_idx, aux, before = _route(params, cfg, x, group)
    # f on the expert path's inputs only (the tokens, the gate weights),
    # never on the router's (trap: see the module docstring)
    xe = ep.f(x) if ep is not None else x
    gv = ep.f(gate_vals) if ep is not None else gate_vals
    if ep is not None and ep.rows and group is not None:
        # each expert's rows split over the batch's ranks too: the whole
        # batch's tokens and routing here, this rank's block of rows, the
        # partial sums of every token summed over the batch's ranks
        src = group.gather(xe.reshape(N, d))[None]
        gv = group.gather(gv.reshape(N, k))[None]
        gi = group.rows(gate_idx.reshape(N, k)).reshape(1, N * n, k)
        part = _dispatch_combine(params, cfg, src, gv, gi, C,
                                 block=_expert_block(cfg, ep, C, group))
        out = group.sum_rows(part[0]).view(B, T, d)
    else:
        out = _dispatch_combine(
            params, cfg, xe.reshape(1, N, d), gv.reshape(1, N, k),
            gate_idx.reshape(1, N, k), C, before,
            _expert_block(cfg, ep, C)).view(B, T, d)
    return _with_shared(params, cfg, x, xe, out, ep, sh), aux


def moe_grouped(params: dict, cfg: ModelConfig, x: torch.Tensor,
                group=None, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sequence dispatch: routing, sort, rank and capacity (from ``T``
    tokens) independently per batch row; over ``group`` only the
    load-balance counts cross the ranks; ``tp``: :func:`moe`'s."""
    ep, sh = _axes(tp)
    C = capacity(cfg, x.shape[1])
    gate_vals, gate_idx, aux, _ = _route(params, cfg, x, group)
    xe = ep.f(x) if ep is not None else x
    gv = ep.f(gate_vals) if ep is not None else gate_vals
    out = _dispatch_combine(params, cfg, xe, gv, gate_idx, C,
                            block=_expert_block(cfg, ep, C))
    return _with_shared(params, cfg, x, xe, out, ep, sh), aux
