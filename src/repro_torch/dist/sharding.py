"""Sharding of the parameter, optimizer and batch trees over a mesh (port
of ``repro.dist.sharding``).

Policy (megatron-style tensor parallelism + optional ZeRO-3), JAX's rules
exactly:

* **TP over ``model``**: attention head dims, MLP hidden dims, MoE expert
  dims, vocab rows of the (un)embedding tables.
* **FSDP over ``data``**: with ``fsdp=True`` the first TP-free dim of every
  matrix also shards over the data axis (params and both Adam moments).
* **Safety**: an axis that does not divide its dim falls back to
  replicated on that dim, so one rule set serves the 512-chip production
  mesh and a 2 x 2 test mesh.

**Specs.**  A spec is JAX's ``PartitionSpec`` as a tuple: one entry per
dim, an axis name, a tuple of axis names or ``None`` (a scalar's is
``()``).  The rules read only the mesh's axis sizes, so a mesh is a
``DeviceMesh`` or any object whose ``shape`` maps axis names to sizes (as
a JAX mesh's does).  The port's parameter tree is per layer
(``layers[i]``); JAX's is stacked over superblocks (``sb/l{j}``) with a
leading ``[R]`` dim that always stays ``None``.  So a port leaf's spec is
JAX's spec of its stacked leaf with that leading ``None`` dropped: the
rules below see the core shape in both packages.

**Placement.**  :class:`Placement` holds one rank's view of a parameter
tree over a ``DeviceMesh``: each leaf's spec (:func:`placements` gives
its DTensor placements).  It cuts this rank's shards out of a full tree
(:meth:`Placement.shard_tree`), places a ``TrainState``
(:func:`place_train_state`, the counterpart of
``jax.device_put(state, shardings)``), gathers a leaf at use and sends its
gradient back to the leaf's placement (:meth:`Placement.gather`), takes
this rank's rows of a batch (:meth:`Placement.split`) and the gradients'
global norm over the ranks (:meth:`Placement.global_norm`).  Every
collective goes through :mod:`repro_torch.dist.overlap` (gloo, CUDA
tensors staged through host memory).

**Statistics of the whole batch.**  JAX's GSPMD step computes the loss of
the global batch, and some of it is not a mean of per-row terms: the
cross-entropy divides by the mask's sum over the batch, and an MoE layer's
load-balance loss and its capacity buckets read the expert counts of every
token.  A rank sees only its rows, so those statistics cross the ranks
that split the batch (:class:`BatchGroup`): the model computes each
rank's loss as ``n`` times its share of the global loss (``n`` ranks),
whose mean over the ranks, and the mean of whose gradients, are the
global ones.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro_torch.ckpt.manager import tree_flatten, tree_unflatten
from repro_torch.dist.overlap import all_gather_cat, all_reduce_, wire


class Spec(tuple):
    """JAX's ``PartitionSpec`` as a tuple: one entry per dim (an axis name,
    a tuple of axis names or ``None``; a tuple of one name is that name,
    as ``PartitionSpec`` keeps it).  A leaf of a spec tree."""

    def __new__(cls, entries=()):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))


# ---------------------------------------------------------------------------
# mesh sizes and keypaths
# ---------------------------------------------------------------------------
def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or of anything whose
    ``shape`` is such a mapping (a JAX mesh, a test's stand-in)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def _axis_size(sizes: Mapping[str, int], axes) -> int:
    total = 1
    for a in axes if isinstance(axes, tuple) else (axes,):
        total *= sizes.get(a, 1)
    return total


def _fits(dim: int, sizes: Mapping[str, int], axes) -> bool:
    n = _axis_size(sizes, axes)
    return n > 1 and dim % n == 0 and dim >= n


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def _paths(tree: Any, prefix: Tuple[str, ...] = ()
           ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(keypath parts, leaf) in :func:`tree_flatten` order; list indices
    are parts as strings, as JAX's keypaths print them."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, prefix + (str(i),))]
    return [(prefix, tree)]


# ---------------------------------------------------------------------------
# batch and host-stacked specs
# ---------------------------------------------------------------------------
def batch_spec(leaf, mesh, batch_size: Optional[int] = None) -> Spec:
    """Spec of one batch leaf: the leading dim over (pod, data) when it
    divides, everything else replicated."""
    shape = getattr(leaf, "shape", None)
    if not shape:
        return Spec()
    B = batch_size if batch_size is not None else shape[0]
    baxes = batch_axes(mesh)
    lead = baxes if _fits(B, axis_sizes(mesh), baxes) else None
    return Spec([lead] + [None] * (len(shape) - 1))


def batch_sharding(batch, mesh, batch_size: Optional[int] = None):
    """The spec tree of an input batch (tokens, masks, frontend)."""
    return tree_unflatten(batch, [batch_spec(x, mesh, batch_size)
                                  for x in tree_flatten(batch)])


def host_spec(leaf, axis: str = "gc_hosts") -> Spec:
    """Spec of one leaf of a host-stacked state: the leading ``[H]`` host
    dim over ``axis``, everything else replicated; a scalar replicated."""
    shape = getattr(leaf, "shape", None)
    if not shape:
        return Spec()
    return Spec([axis] + [None] * (len(shape) - 1))


def host_stacked_sharding(tree, axis: str = "gc_hosts"):
    """The spec tree of a host-stacked MVGC state (every leaf ``[H, ...]``,
    ``repro_torch.dist.mvgc.stack_states``): each host's slice on its own
    position of ``axis``.  ``ShardedPagedKVEngine`` keeps hosts
    ``[r H/n, (r+1) H/n)`` on rank ``r`` by this spec."""
    return tree_unflatten(tree, [host_spec(x, axis)
                                 for x in tree_flatten(tree)])


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------
def _tp_axes(parts: Sequence[str], shape: Tuple[int, ...], *,
             attn_hd_shard: bool, moe_replicate: bool) -> List[Optional[str]]:
    """Tensor-parallel axis per core dim (before divisibility sanitation)."""
    name = parts[-1]
    rank = len(shape)
    axes: List[Optional[str]] = [None] * rank

    if name in ("embed", "unembed") and rank == 2:        # [V, d]
        axes[0] = "model"
    elif name in ("wq", "wk", "wv") and rank == 3:        # [d, H, hd]
        axes[2 if attn_hd_shard else 1] = "model"
    elif name == "wo" and rank == 3:                      # [H, hd, d]
        axes[1 if attn_hd_shard else 0] = "model"
    elif name in ("bq", "bk", "bv") and rank == 2:        # [H, hd]
        axes[1 if attn_hd_shard else 0] = "model"
    elif name in ("wg", "wu") and rank == 2:              # mlp [d, f]
        axes[1] = "model"
    elif name == "wd" and rank == 2:                      # mlp [f, d]
        axes[0] = "model"
    elif name in ("wg", "wu", "wd") and rank == 3:        # moe [E, d|f, f|d]
        if not moe_replicate:
            axes[0] = "model"                              # expert parallelism
    elif name in ("w_up", "w_gate", "w_in") and rank == 2:  # [d, di|w]
        axes[1] = "model"
    elif name in ("w_down", "w_out") and rank == 2:       # [di|w, d]
        axes[0] = "model"
    elif name == "wx_s" and rank == 3:                    # slstm [d, H, 4hd]
        axes[1] = "model"
    elif name == "wr" and rank == 3:                      # slstm [H, hd, 4hd]
        axes[0] = "model"
    elif name == "w_if" and rank == 3:                    # mlstm [di, H, 2]
        axes[1] = "model"
    # norms, biases, lambda, conv weights, routers, shared experts:
    # replicated (tiny), or sharded by the generic FSDP rule
    return axes


def _leaf_spec(parts: Sequence[str], leaf, mesh, *, fsdp: bool,
               attn_hd_shard: bool, moe_replicate: bool,
               fsdp_axis: str = "data") -> Spec:
    """JAX's ``_leaf_spec`` for a leaf of the port's per-layer tree (no
    leading ``[R]`` dim, so nothing is stacked)."""
    shape = tuple(getattr(leaf, "shape", ()))
    if not shape:
        return Spec()
    sizes = axis_sizes(mesh)
    axes = _tp_axes(parts, shape, attn_hd_shard=attn_hd_shard,
                    moe_replicate=moe_replicate)
    # sanitize TP assignments against the mesh
    axes = [a if a and _fits(shape[i], sizes, a) else None
            for i, a in enumerate(axes)]
    if fsdp and len(shape) >= 2:
        # ZeRO-3: first TP-free dim that the data axis divides
        for i, a in enumerate(axes):
            if a is None and _fits(shape[i], sizes, fsdp_axis):
                axes[i] = fsdp_axis
                break
    return Spec(axes)


def param_shardings(params, mesh, *, fsdp: bool = False,
                    attn_hd_shard: bool = False,
                    moe_replicate: bool = False):
    """The spec tree mirroring ``params`` (tensors or anything with a
    ``shape``).  ``attn_hd_shard`` moves attention TP from the head dim to
    the head-size dim; ``moe_replicate`` keeps expert weights replicated
    instead of expert-parallel."""
    return tree_unflatten(params, [
        _leaf_spec(parts, x, mesh, fsdp=fsdp, attn_hd_shard=attn_hd_shard,
                   moe_replicate=moe_replicate)
        for parts, x in _paths(params)])


def placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` that names the axis, else
    ``Replicate()``.  Several axes on one dim shard it in the spec's order
    (major first), as JAX does."""
    out = []
    for name in axis_sizes(mesh):
        dims = [d for d, a in enumerate(spec)
                if a == name or (isinstance(a, tuple) and name in a)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


# ---------------------------------------------------------------------------
# one rank's placement of a parameter tree
# ---------------------------------------------------------------------------
def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class _Gather(torch.autograd.Function):
    """Forward: the full leaf from this rank's shard.  Backward: the full
    leaf's gradient on this rank back to the shard's placement."""

    @staticmethod
    def forward(ctx, local, placement, path):
        ctx.placement, ctx.path = placement, path
        return placement._gather(local, path)

    @staticmethod
    def backward(ctx, grad):
        return ctx.placement._reduce_grad(grad, ctx.path), None, None


class Placement:
    """One rank's placement of a parameter-shaped tree over ``mesh`` (a
    ``DeviceMesh`` whose axes name the spec's axes): each leaf's spec
    (``specs``, :func:`param_shardings`' tree, at most one axis per dim).
    Batch rows split over :func:`batch_axes`; ranks that differ only on
    the other axes (``model``) hold the same rows and compute the same
    full gradients."""

    def __init__(self, mesh, specs):
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not on the mesh")
        self.mesh = mesh
        self.sizes = axis_sizes(mesh)
        self.coord = dict(zip(self.sizes, coord))
        self.specs = dict(_paths(specs))
        if any(isinstance(e, tuple) for s in self.specs.values() for e in s):
            raise ValueError("a parameter dim sharded over several axes")
        self.batch_axes = batch_axes(mesh)

    def _index(self, axes: Tuple[str, ...]) -> Tuple[int, int]:
        """(this rank's index, count) over ``axes``, major first."""
        idx, n = 0, 1
        for a in axes:
            idx = idx * self.sizes[a] + self.coord[a]
            n *= self.sizes[a]
        return idx, n

    def _cut(self, x: torch.Tensor, path, axes) -> torch.Tensor:
        """``x``'s piece at this rank along each dim that one of ``axes``
        shards (a view)."""
        for d, a in enumerate(self.specs[path]):
            if a in axes:
                x = x.chunk(self.sizes[a], dim=d)[self.coord[a]]
        return x

    def shard_tree(self, tree):
        """This rank's shard of every leaf of ``tree`` (contiguous
        copies: the full tree can be freed)."""
        return tree_unflatten(tree, [
            self._cut(x, p, self.sizes).clone(
                memory_format=torch.contiguous_format)
            for p, x in _paths(tree)])

    # -- gather at use --------------------------------------------------
    def _group(self, axis: str) -> dist.ProcessGroup:
        return self.mesh.get_group(axis)

    def _split(self, path) -> bool:
        return any(a and self.sizes[a] > 1 for a in self.specs[path])

    def _gather(self, local: torch.Tensor, path) -> torch.Tensor:
        """The full leaf from this rank's shard.  The pieces meet in host
        memory, where gloo moves them, and only the full leaf goes to the
        shard's device."""
        if not self._split(path):
            return local.clone()
        x = wire(local)
        for d, a in enumerate(self.specs[path]):
            if a:
                x = all_gather_cat(x, self._group(a), dim=d)
        return x.to(local.device)

    def _reduce_grad(self, grad: torch.Tensor, path) -> torch.Tensor:
        """The full leaf's gradient on this rank -> the gradient of this
        rank's shard: averaged over the batch axes (each row of them took
        its own rows of the batch), taken once over the other axes (whose
        ranks computed the same thing).  This rank's slice crosses to host
        memory once, is reduced and cut there, and only the shard's
        gradient comes back."""
        batch = [a for a in self.batch_axes if self.sizes.get(a, 1) > 1]
        if not batch and not self._split(path):
            return grad
        others = [a for a in self.sizes if a not in self.batch_axes]
        g = self._cut(grad, path, others)
        g = wire(g) if g.is_cuda else g.clone(
            memory_format=torch.contiguous_format)
        for a in batch:
            all_reduce_(g, self._group(a))
        n_batch = math.prod(self.sizes[a] for a in batch)
        if n_batch > 1:
            g /= n_batch
        return self._cut(g, path, batch).contiguous().to(grad.device)

    def gather(self, tree, *path: str):
        """The full leaves of ``tree`` (this rank's shards of the subtree
        at ``path``), each gathered over the axes that shard it just
        now; autograd sends each full leaf's gradient back to its shard
        (:meth:`_reduce_grad`).  Called inside a checkpointed layer, the
        recompute gathers again."""
        prefix = tuple(str(p) for p in path)
        return tree_unflatten(tree, [
            _Gather.apply(x, self, prefix + p) for p, x in _paths(tree)])

    # -- batch, loss and norm -------------------------------------------
    def split(self, batch: Dict[str, torch.Tensor]
              ) -> Tuple[Dict[str, torch.Tensor], Optional["BatchGroup"]]:
        """This rank's rows of a global batch, by :func:`batch_spec`, and
        the :class:`BatchGroup` that split them (None when the rows do not
        divide over the batch axes: then every rank takes the whole
        batch, as JAX replicates it)."""
        spec = batch_spec(batch["tokens"], self.mesh)
        if spec[0] is None:
            return dict(batch), None
        group = BatchGroup(self, _axes_of(spec[0]))
        return {k: v.chunk(group.n, dim=0)[group.index]
                for k, v in batch.items()}, group

    def batch_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the batch axes of a per-rank scalar: the global
        loss, from each rank's ``n`` times its share of it (or from the
        whole batch's loss on every rank, when the rows were not split)."""
        x = x.detach().clone().reshape(1).float()
        n = 1
        for a in self.batch_axes:
            if self.sizes.get(a, 1) > 1:
                all_reduce_(x, self._group(a))
                n *= self.sizes[a]
        return (x / n).reshape(())

    def global_norm(self, grads) -> torch.Tensor:
        """The gradients' global norm over the ranks: the squares of the
        distinct shards only, a leaf replicated over an axis counted on
        that axis's first position alone, summed over all ranks."""
        total = torch.zeros((1,), dtype=torch.float32,
                            device=tree_flatten(grads)[0].device)
        for p, g in _paths(grads):
            used = {a for e in self.specs[p] for a in _axes_of(e)}
            if all(self.coord[a] == 0 for a in self.sizes if a not in used):
                total = total + torch.sum(torch.square(g.float()))
        for a in self.sizes:
            all_reduce_(total, self._group(a))
        return torch.sqrt(total).reshape(())


class BatchGroup:
    """The ranks over which one batch's rows are split (the batch axes of a
    :class:`Placement`, major first), as a layer sees them: ``n`` ranks,
    this one at ``index``, each with as many rows.  Every rank of the
    group calls :meth:`rows` at the same point of the same layer."""

    def __init__(self, placement: "Placement", axes: Tuple[str, ...]):
        self._pl, self.axes = placement, axes
        self.index, self.n = placement._index(axes)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (one shape on all ranks), stacked in
        ``index`` order: ``[n, *x.shape]``; a statistic, so detached."""
        y = x.detach()[None]
        for a in reversed(self.axes):          # minor axis first
            y = all_gather_cat(y, self._pl._group(a), dim=0)
        return y


def place_train_state(state, mesh, *, fsdp: bool = False,
                      attn_hd_shard: bool = False,
                      moe_replicate: bool = False):
    """Place a ``TrainState`` over ``mesh`` on this rank, the counterpart of
    ``jax.device_put(state, shardings)`` in JAX's test: the params, and
    AdamW's ``mu`` and ``nu`` by the same specs, cut to this rank's
    shards; ``err`` and ``step`` replicated.  Every rank passes the same
    full state (built from one seed).  Returns ``(state of shards,
    Placement)``; the full state can be freed."""
    specs = param_shardings(state.params, mesh, fsdp=fsdp,
                            attn_hd_shard=attn_hd_shard,
                            moe_replicate=moe_replicate)
    pl = Placement(mesh, specs)
    opt = state.opt._replace(mu=pl.shard_tree(state.opt.mu),
                             nu=pl.shard_tree(state.opt.nu))
    return state._replace(params=pl.shard_tree(state.params), opt=opt), pl
