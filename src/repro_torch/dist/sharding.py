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
global norm over the ranks (:meth:`Placement.global_norm`).  A part that
computes on its shards over ``model`` (:meth:`Placement.gather_local`)
takes each leaf split over ``model`` as this rank's piece, gathered over
the other axes only: attention heads (an encoder's and cross-attention's
too), the hidden slice of an MLP or of a shared expert, a mixture's block
of ``E / n`` experts (expert parallelism), an RG-LRU's channels, an
xLSTM mixer's heads, the vocabulary's rows.  Every
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

import copy
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro_torch.ckpt.manager import tree_flatten, tree_unflatten
from repro_torch.dist.overlap import (all_gather_cat, all_reduce,
                                     all_reduce_, unwire, wire)


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
    ``shape`` is such a mapping (a JAX mesh, a test's stand-in), or of
    such a mapping itself."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
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


def _local_dim(parts: Sequence[str], ndim: int) -> Optional[int]:
    """The dim of a leaf that a layer computing over ``model`` keeps
    split (the same names and ranks as :func:`_tp_axes`' rules): the
    heads of ``wq``/``wk``/``wv``/``wo`` and their biases (an mLSTM's
    ``wq``/``wk``/``wv`` and ``w_if``, an sLSTM's ``wx_s`` and ``wr``
    too), the hidden dim of a dense MLP's (or a shared expert's)
    ``wg``/``wu``/``wd``, the experts of a mixture's ``[E, ., .]``
    ``wg``/``wu``/``wd`` (expert parallelism), the width of an RG-LRU's
    ``w_in``/``w_gate``/``w_out`` and the inner width of an mLSTM's
    ``w_up``/``w_gate``/``w_down`` (an sLSTM's ``w_down`` on its input
    dim), the vocab rows of ``embed`` and ``unembed``; None for any other
    leaf (a router among them)."""
    name = parts[-1]
    if name in ("embed", "unembed") and ndim == 2:
        return 0
    if name in ("wq", "wk", "wv", "w_if", "wx_s") and ndim == 3:
        return 1
    if (name in ("wo", "wg", "wu", "wd", "wr") and ndim == 3) or (
            name in ("bq", "bk", "bv") and ndim == 2):
        return 0
    if name in ("wg", "wu", "w_in", "w_gate", "w_up") and ndim == 2:
        return 1
    if name in ("wd", "w_out", "w_down") and ndim == 2:
        return 0
    return None


#: the leaves of a recurrent mixer that compute on their shards together,
#: by the leaf that names the kind (RG-LRU, mLSTM, sLSTM): where the specs
#: split only some of them over ``model`` (a dim that does not divide), the
#: mixer computes whole, as JAX's GSPMD step then computes it
_UNITS = {"w_in": frozenset(("w_in", "w_gate", "w_out")),
          "w_up": frozenset(("w_up", "w_gate", "wq", "wk", "wv", "w_if",
                             "w_down")),
          "wx_s": frozenset(("wx_s", "wr", "w_down"))}

#: the leaves that a part computing on its shards takes whole and slices
#: to this rank's channels or heads (replicated over ``model`` by the
#: specs): an RG-LRU's per-channel leaves and its gate matrices' columns,
#: an xLSTM mixer's ``ln_out`` and the sLSTM's bias.  Each ``model`` rank
#: computes the gradient of its slice only: the placement sums their
#: gradients over ``model`` (:meth:`Placement._reduce_grad`)
_SLICED = frozenset(("conv_w", "conv_b", "wa", "ba", "wx", "bx", "lambda",
                     "ln_out", "b"))


def _computes_whole(names, local: frozenset) -> bool:
    """Whether a part whose leaves are ``names`` computes whole although
    the leaves ``local`` came split: a recurrent mixer with only some of
    its :data:`_UNITS` split."""
    return any(mark in names and not unit <= local
               for mark, unit in _UNITS.items())


def _piece_names(prefix: Tuple[str, ...], paths) -> frozenset:
    """The names by which a part gathered at ``prefix`` knows its leaves
    at ``paths`` (relative to the part): each path joined by "/" (a
    mixture's ``wg`` and its shared expert's ``shared/wg`` stay apart),
    the part's own name for a part that is one leaf (``embed``)."""
    return frozenset("/".join(p) if p else prefix[-1] for p in paths)


class _Gather(torch.autograd.Function):
    """Forward: the leaf from this rank's shard (whole, or this rank's
    piece over ``model`` when ``local``).  Backward: that tensor's
    gradient on this rank back to the shard's placement (summed over
    ``model`` first when ``partial``: a :data:`_SLICED` leaf)."""

    @staticmethod
    def forward(ctx, shard, placement, path, local, partial):
        ctx.placement, ctx.path = placement, path
        ctx.local, ctx.partial = local, partial
        return placement._gather(shard, path, local)

    @staticmethod
    def backward(ctx, grad):
        return (ctx.placement._reduce_grad(grad, ctx.path, ctx.local,
                                           ctx.partial),
                None, None, None, None)


class _CopyToModel(torch.autograd.Function):
    """Megatron-LM's ``f``: the identity forward; backward, the gradient
    summed over the ``model`` ranks (each rank's column-split product saw
    only its slice)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron-LM's ``g``: forward, the ``model`` ranks' partial sums of
    a row-split product summed; the identity backward (every rank's
    cotangent of the sum is the same)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _JoinOverModel(torch.autograd.Function):
    """Every ``model`` rank's piece of an activation joined along ``dim``;
    backward, the whole's gradient summed over the ranks (each rank's
    product read all of it) and cut to this rank's piece (a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather_cat(x, axis.group, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        a = ctx.axis
        return (all_reduce(grad, a.group).chunk(a.n, dim=ctx.dim)[a.index]
                .contiguous(), None, None)


class _SumOverModel(torch.autograd.Function):
    """A statistic's partial sums summed over the ``model`` ranks; each
    rank's outputs read the sum, so the backward sums the gradient over
    the ranks too (Megatron's ``g`` keeps it: wrong here)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class ModelAxis:
    """The ``model`` ranks of one data row, as a layer that computes on
    its shards sees them: ``n`` ranks, this one at ``index``; rank ``r``
    holds the ``r``-th of ``n`` equal blocks of each split dim.  ``local``
    names the leaves of the layer that came as this rank's pieces, by
    their paths in the part (:meth:`Placement.gather_local`: ``wq``, or a
    mixture's ``wg`` and its shared expert's ``shared/wg``); the layer
    reads it, not the leaves' shapes."""

    #: a mixture's experts (``local`` holding them) that came split over
    #: the batch axes too (FSDP): each expert's bucket rows are split over
    #: the ranks of the batch as well (:func:`repro_torch.models.moe.moe`)
    rows: bool = False

    def __init__(self, placement: "Placement",
                 local: frozenset = frozenset()):
        self.group = placement._group("model")
        self.n, self.index = placement.sizes["model"], placement.coord["model"]
        self.local = local

    def holding(self, local: frozenset, **attrs) -> "ModelAxis":
        """This axis for a layer whose leaves ``local`` came as pieces
        (and ``attrs`` set on it)."""
        out = copy.copy(self)
        out.local = local
        for k, v in attrs.items():
            setattr(out, k, v)
        return out

    def f(self, x: torch.Tensor) -> torch.Tensor:
        """Where a replicated activation enters a column-split product:
        the identity forward, its gradient summed over the ranks."""
        return _CopyToModel.apply(x, self.group)

    def g(self, x: torch.Tensor) -> torch.Tensor:
        """After a row-split product: the partial sums summed over the
        ranks; the identity backward."""
        return _ReduceFromModel.apply(x, self.group)

    def reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
        """A statistic (no gradient) reduced over the ranks, as a new
        tensor."""
        return all_reduce(x.detach(), self.group, op)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's piece of an activation split over the ranks (no
        gradient), joined along ``dim`` in rank order."""
        return all_gather_cat(x.detach(), self.group, dim=dim)

    def join(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """:meth:`gather`, differentiable: where every rank's product reads
        the whole of an activation split over the ranks (its gradient
        summed over them and cut back to this rank's piece)."""
        return _JoinOverModel.apply(x, self, dim)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """A statistic's partial sums (a norm's sum of squares over a
        width split over the ranks) summed over the ranks; its gradient
        summed over them too."""
        return _SumOverModel.apply(x, self.group)


class ServeAxis(ModelAxis):
    """:class:`ModelAxis` at serve time, where nothing is differentiated:
    ``f`` is the identity, ``g`` and ``psum`` a plain all-reduce and
    ``join`` the plain all-gather ``gather``.  A layer's mixer
    that computes on its shards also learns how its cache is split
    (:meth:`ServePlacement.gather_local` decides): ``kv`` is ``"heads"``
    when the K/V cache holds this rank's KV heads, ``"seq"`` when it holds
    this rank's block of positions (or ring slots) of every KV head, and
    ``kept`` names the cache fields that the layer reads and writes on
    their shards (the others come whole, :meth:`ServePlacement.cache_in`),
    ``joined`` the fields that it reads whole and returns as this rank's
    heads (dim 1), which :meth:`ServePlacement.cache_out` makes whole
    again (an xLSTM state, whole over ``model`` as JAX keeps it)."""

    kv: Optional[str] = None
    kept: frozenset = frozenset()
    joined: frozenset = frozenset()

    def f(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def g(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x, self.group)

    def join(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return self.gather(x, dim)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x, self.group)


class Placement:
    """One rank's placement of a parameter-shaped tree over ``mesh`` (a
    ``DeviceMesh`` whose axes name the spec's axes): each leaf's spec
    (``specs``, :func:`param_shardings`' tree, at most one axis per dim).
    Batch rows split over :func:`batch_axes`; ranks that differ only on
    the other axes (``model``) hold the same rows: a leaf gathered whole
    gets the same full gradient on each of them, a leaf gathered as its
    piece (:meth:`gather_local`) that piece's."""

    #: the mixer kinds whose layers compute on their shards over ``model``
    #: (``models.transformer._block_params``)
    local_mixers = ("attn", "local", "rglru", "mlstm", "slstm")

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
        #: the model axis of a layer computing on its shards (None when
        #: the mesh has no ``model`` axis larger than 1)
        self.tp = ModelAxis(self) if self.sizes.get("model", 1) > 1 \
            else None

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

    def is_local(self, path) -> bool:
        """Whether a layer that gathers ``path`` by :meth:`gather_local`
        gets this rank's piece over ``model``: the specs split the leaf
        over ``model`` on its :func:`_local_dim`."""
        spec = self.specs[path]
        d = _local_dim(path, len(spec))
        return self.tp is not None and d is not None and spec[d] == "model"

    def _gather(self, shard: torch.Tensor, path, local: bool = False
                ) -> torch.Tensor:
        """The leaf from this rank's shard: whole, or with ``local`` (a
        leaf :meth:`is_local`) gathered over every axis but ``model``.
        The pieces meet in host memory, where gloo moves them, and only
        the result goes to the shard's device.  Every tensor the
        placement makes of a leaf is made here."""
        axes = [a for a in self.specs[path] if a and self.sizes[a] > 1
                and not (local and a == "model")]
        if not axes:
            x = shard.clone()
        else:
            x = wire(shard)
            for d, a in enumerate(self.specs[path]):
                if a in axes:
                    x = all_gather_cat(x, self._group(a), dim=d)
            x = unwire(x, shard.device)
        return x

    def _reduce_grad(self, grad: torch.Tensor, path, local: bool = False,
                     partial: bool = False) -> torch.Tensor:
        """The gathered leaf's gradient on this rank -> the gradient of
        this rank's shard: averaged over the batch axes (each row of them
        took its own rows of the batch), taken once over the other axes
        (whose ranks computed the same thing; a ``local`` leaf's gradient
        is already this rank's piece over ``model``), except that a
        ``partial`` leaf's (a :data:`_SLICED` leaf of a part computing on
        its shards: each ``model`` rank's gradient is its slice's) is
        summed over ``model`` too.  This rank's slice crosses to host
        memory once, is reduced and cut there, and only the shard's
        gradient comes back."""
        batch = [a for a in self.batch_axes if self.sizes.get(a, 1) > 1]
        sums = batch + (["model"] if partial else [])
        if not sums and not self._split(path):
            return grad
        others = [a for a in self.sizes if a not in self.batch_axes
                  and not (local and a == "model")]
        g = self._cut(grad, path, others)
        g = wire(g) if g.is_cuda else g.clone(
            memory_format=torch.contiguous_format)
        for a in sums:
            all_reduce_(g, self._group(a))
        n_batch = math.prod(self.sizes[a] for a in batch)
        if n_batch > 1:
            g /= n_batch
        return unwire(self._cut(g, path, batch).contiguous(), grad.device)

    def gather(self, tree, *path: str):
        """The whole leaves of ``tree`` (this rank's shards of the subtree
        at ``path``), each gathered just now over the axes that shard it;
        autograd sends each whole leaf's gradient back to its shard
        (:meth:`_reduce_grad`).  Called inside a checkpointed layer, the
        recompute gathers again.  With grad disabled (serving) a leaf
        that no axis splits is the shard itself, not a copy."""
        return self._gather_tree(tree, tuple(str(p) for p in path), False)

    def gather_local(self, tree, *path: str):
        """For a layer that computes on its shards over ``model``: the
        leaves of ``tree`` as :meth:`gather` gives them, except that a
        leaf :meth:`is_local` is gathered over every axis but ``model``
        (this rank's piece of it), and its gradient stays that piece's.
        Returns ``(leaves, tp)``: ``tp`` is :attr:`tp` holding the names
        of the leaves that came as pieces (:func:`_piece_names`), or None
        when none did (no ``model`` axis, or no leaf split over it), or
        when the part computes whole all the same (:func:`_computes_whole`:
        then every leaf comes whole)."""
        prefix = tuple(str(p) for p in path)
        paths = [p for p, _ in _paths(tree)]
        local = _piece_names(prefix, [p for p in paths
                                      if self.is_local(prefix + p)])
        if local and _computes_whole({p[-1] for p in paths if p}, local):
            local = frozenset()
        if not local:
            return self._gather_tree(tree, prefix, False), None
        out = self._gather_tree(tree, prefix, True, sliced=True)
        # experts split over the batch axes too (FSDP): their bucket rows
        # are split over the batch's ranks, as JAX's GSPMD step divides
        # them
        batch = {a for a in self.batch_axes if self.sizes.get(a, 1) > 1}
        spec = self.specs.get(prefix + ("wg",), ())
        rows = len(spec) == 3 and bool(batch) and batch <= set(spec)
        return out, self.tp.holding(local, rows=rows)

    def _gather_tree(self, tree, prefix, local: bool, sliced: bool = False):
        """:meth:`gather` (``local``: :meth:`gather_local`'s pieces;
        ``sliced``: the part computes on its shards, so its
        :data:`_SLICED` leaves' gradients are partial)."""
        paths = _paths(tree)
        flags = [local and self.is_local(prefix + p) for p, _ in paths]
        if not torch.is_grad_enabled():
            return tree_unflatten(tree, [
                self._gather(x, prefix + p, loc)
                if self._split(prefix + p) else x
                for (p, x), loc in zip(paths, flags)])
        return tree_unflatten(tree, [
            _Gather.apply(x, self, prefix + p, loc,
                          sliced and bool(p) and p[-1] in _SLICED)
            for (p, x), loc in zip(paths, flags)])

    def leaf_max(self, x: torch.Tensor, path) -> torch.Tensor:
        """The max of a per-shard statistic of leaf ``path`` over the
        ranks that hold its distinct shards (every axis that splits it),
        written into ``x`` and returned."""
        for a in self.specs[path]:
            if a and self.sizes[a] > 1:
                all_reduce_(x, self._group(a), op=dist.ReduceOp.MAX)
        return x

    # -- batch, loss and norm -------------------------------------------
    def split(self, batch: Dict[str, torch.Tensor]
              ) -> Tuple[Dict[str, torch.Tensor], Optional["BatchGroup"]]:
        """This rank's rows of a global batch, by :func:`batch_spec`, and
        the :class:`BatchGroup` that split them (None when the rows do not
        divide over the batch axes: then every rank takes the whole
        batch, as JAX replicates it)."""
        spec = batch_spec(batch["tokens"], self.sizes)
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

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        for a in self.axes:
            x = all_reduce(x, self._pl._group(a))
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` joined along dim 0 in ``index`` order,
        differentiable: the backward sums the gradient over the ranks and
        keeps this rank's rows (each rank's gradient of its rows from every
        rank's use of them)."""
        return _GatherRows.apply(x, self)

    def sum_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (dim 0: every rank's rows in ``index`` order, each rank a
        partial sum of them) summed over the ranks, this rank's rows kept,
        differentiable: the backward joins the ranks' gradients of their
        rows (:meth:`gather`'s transpose)."""
        return _SumRows.apply(x, self)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.rows(x).reshape(-1, *x.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        g = ctx.group
        return g._sum(grad).chunk(g.n, dim=0)[g.index], None


class _SumRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group._sum(x).chunk(group.n, dim=0)[group.index].clone()

    @staticmethod
    def backward(ctx, grad):
        g = ctx.group
        return g.rows(grad).reshape(-1, *grad.shape[1:]), None


class ServePlacement:
    """One rank's placement of a serve state over ``mesh``: what JAX's
    decode and prefill cells compile (``launch/specs.py``'s
    ``build_serve_cell``), run by this rank on its shards over ``model``,
    as GSPMD computes those cells.

    * The parameters by ``param_specs`` (:func:`param_shardings` with
      ``fsdp=False``: no leaf is split over the batch axes).  A part that
      computes on its shards (:meth:`gather_local`: the attention,
      RG-LRU, mLSTM and sLSTM mixers, a dense MLP, a mixture of experts
      on this rank's block of experts and its shared expert's slice of the
      hidden dim, an encoder's layers and cross-attention, the
      (un)embedding) takes its leaves split over ``model`` as they are;
      every other leaf is gathered whole at use (:meth:`param`): a
      router, and a mixer whose leaves are split on a dim it does not
      compute on (``attn_hd_shard``) or only some of whose leaves divide
      over ``model`` (:func:`_computes_whole`).
    * The cache by ``cache_specs`` (``specs.cache_shardings``: per layer,
      the layer's cache type holding a spec per leaf).  Dim 0 of every
      leaf is the batch: when it is split, this rank computes its rows of
      the batch (:attr:`group`, :meth:`rows`) and its leaves hold those
      rows.  A mixer that computes on its shards reads and writes the
      leaves it keeps (``ServeAxis.kept``: K/V split on KV heads, or on
      positions or ring slots, with a ring's ``pos``; an RG-LRU's ``h``
      and ``conv`` split on width) in place (trap T1); an xLSTM mixer
      reads its heads of its state (whole over ``model``) and its new
      state is gathered over ``model`` (``ServeAxis.joined``).  Any other leaf is
      gathered before the layer over the axes of its dims but the batch's
      (:meth:`cache_in`: a ring's ``pos`` where its K/V go on heads, and
      every leaf of a layer computed whole), and after the layer cut back
      to this rank's shard (:meth:`cache_out`).
    * What the whole batch reads (new lengths for the store, tokens) is
      gathered over the batch axes (:meth:`whole`), and the greedy pick
      reads the vocabulary's split (:attr:`vocab`)."""

    #: the mixer kinds whose layers compute on their shards over ``model``
    #: (``models.transformer._block_params``)
    local_mixers = ("attn", "local", "rglru", "mlstm", "slstm")

    def __init__(self, mesh, param_specs, cache_specs):
        self.params = Placement(mesh, param_specs)
        self.cache_specs = cache_specs
        lead = _axes_of(tuple(cache_specs[0])[0][0])
        self.group = (BatchGroup(self.params, lead)
                      if _axis_size(self.params.sizes, lead) > 1 else None)
        #: the model axis of a part computing on its shards (None when the
        #: mesh has no ``model`` axis larger than 1)
        self.tp = (ServeAxis(self.params) if self.params.tp is not None
                   else None)

    def _leaf(self, x: torch.Tensor, path, local: bool) -> torch.Tensor:
        """A leaf as its layer uses it: the shard itself where no axis the
        layer needs gathered splits it (``model`` is not needed for a
        ``local`` leaf), else gathered (:meth:`Placement._gather`, where
        every tensor the placement makes of a leaf is made)."""
        pl = self.params
        if any(a and pl.sizes[a] > 1 and not (local and a == "model")
               for a in pl.specs[path]):
            return pl._gather(x, path, local)
        return x

    def param(self, tree, *path):
        """The whole leaves of ``tree`` (this rank's shards of the subtree
        at ``path``): a leaf no axis splits is the shard itself."""
        prefix = tuple(str(p) for p in path)
        return tree_unflatten(tree, [self._leaf(x, prefix + p, False)
                                     for p, x in _paths(tree)])

    gather = param

    def gather_local(self, tree, *path):
        """For a part that computes on its shards over ``model``: the
        leaves of ``tree``, each split over ``model`` on the dim the part
        computes on (:meth:`Placement.is_local`) as this rank's shard, the
        others whole.  Returns ``(leaves, tp)``: ``tp`` is :attr:`tp`
        holding the names of the leaves that came as pieces, and for a
        layer's mixer how its cache is split (:meth:`_mixer_cache`); or
        ``(whole leaves, None)`` when the part computes whole."""
        prefix = tuple(str(p) for p in path)
        paths = [(prefix + p, x) for p, x in _paths(tree)]
        local = _piece_names(prefix, [p[len(prefix):] for p, _ in paths
                                      if self.params.is_local(p)])
        attrs = {}
        if prefix[0] == "layers" and prefix[-1] == "mixer":
            attrs = self._mixer_cache(int(prefix[1]), local, paths)
        if not local or attrs is None or _computes_whole(
                {p[-1] for p, _ in paths}, local):
            return self.param(tree, *path), None
        return (tree_unflatten(tree, [
            self._leaf(x, p, self.params.is_local(p)) for p, x in paths]),
            self.tp.holding(local, **attrs))

    def _mixer_cache(self, i: int, local: frozenset, paths):
        """How layer ``i``'s mixer computes on its shards, from the specs
        of its leaves and of its cache: the :class:`ServeAxis` attributes
        ``kv`` and ``kept``, or None when it computes whole (a leaf split
        over ``model`` on a dim the mixer does not compute on, as with
        ``attn_hd_shard``; a cache split otherwise than the mixer reads
        it).

        * RG-LRU: ``w_in``/``w_gate``/``w_out`` split on the width, and
          ``h`` and ``conv`` split on it over ``model`` alone.
        * mLSTM and sLSTM: their :data:`_UNITS` split on heads or the
          inner width, and the state whole over ``model`` (split on the
          batch alone, as ``cache_shardings`` keeps it): the mixer reads
          its heads' slice of it and returns its heads' new state, made
          whole again over ``model`` (``joined``).
        * Attention, ``kv = "heads"``: ``wq``/``wk``/``wv``/``wo`` split on
          heads and the K/V cache on its KV heads (``cache_shardings``'
          first branch); a ring's ``pos`` comes whole.
        * Attention, ``kv = "seq"``: ``wq``/``wo`` split on heads,
          ``wk``/``wv`` whole, and the K/V cache (with a ring's ``pos``)
          split on positions or slots over ``model`` alone (the second
          branch: sequence-parallel decode)."""
        pl = self.params
        if any("model" in pl.specs[p] and not pl.is_local(p)
               for p, _ in paths):
            return None
        spec = self.cache_specs[i]._asdict()
        names = {p[-1] for p, _ in paths}
        if "w_up" in names or "wx_s" in names:
            if any(a is not None for f in spec for a in spec[f][1:]):
                return None
            return {"joined": frozenset(spec)}
        if "w_in" in names:
            if ({"w_in", "w_gate", "w_out"} <= local
                    and tuple(spec["h"][1:]) == ("model",)
                    and tuple(spec["conv"][1:]) == (None, "model")):
                return {"kept": frozenset(("h", "conv"))}
            return None
        kv = tuple(spec["k"][1:])
        if kv == (None, "model", None) and {"wq", "wk", "wv", "wo"} <= local:
            return {"kv": "heads", "kept": frozenset(("k", "v"))}
        ring = "pos" in spec
        if (kv == ("model", None, None) and {"wq", "wo"} <= local
                and "wk" not in local
                and (not ring or tuple(spec["pos"][1:]) == ("model",))):
            return {"kv": "seq",
                    "kept": frozenset(("k", "v", "pos") if ring
                                      else ("k", "v"))}
        return None

    @property
    def vocab(self) -> Optional[ServeAxis]:
        """The model axis of the unembedding when each rank holds its
        block of the vocabulary (the logits are then this rank's
        columns), else None."""
        name = ("unembed",) if ("unembed",) in self.params.specs \
            else ("embed",)
        return self.tp if self.params.is_local(name) else None

    def rows(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's rows of a batch-major tensor."""
        if x is None or self.group is None:
            return x
        return x.chunk(self.group.n, dim=0)[self.group.index]

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The whole batch's rows from every rank's ``x``, on every rank."""
        if self.group is None:
            return x
        return self.group.rows(x).reshape(-1, *x.shape[1:])

    def _dims(self, spec, first: int):
        """(dim, its axes of size > 1, major first) of each dim from
        ``first`` on that an axis splits."""
        out = []
        for d, e in enumerate(spec):
            axes = [a for a in _axes_of(e) if self.params.sizes[a] > 1]
            if d >= first and axes:
                out.append((d, tuple(axes)))
        return out

    def _gather_leaf(self, x, spec, first: int):
        for d, axes in self._dims(spec, first):
            for a in reversed(axes):               # minor axis first
                x = all_gather_cat(x, self.params._group(a), dim=d)
        return x

    def _cut_leaf(self, x, spec, first: int):
        for d, axes in self._dims(spec, first):
            idx, k = self.params._index(axes)
            x = x.chunk(k, dim=d)[idx]
        return x

    def cache_in(self, c, i: int, tp=None):
        """Layer ``i``'s cache leaves as its mixer reads them: those it
        keeps on their shards (``tp.kept``, ``tp`` the mixer's
        :class:`ServeAxis`) as they are, every other leaf gathered over
        the axes of its dims but the batch's (the shard itself when none
        splits it)."""
        kept = tp.kept if tp is not None else frozenset()
        return type(c)(*(x if f in kept else self._gather_leaf(x, s, 1)
                         for f, x, s in zip(c._fields, c,
                                            self.cache_specs[i])))

    def cache_out(self, new, old, i: int, tp=None):
        """Layer ``i``'s new cache on this rank's shard: a kept leaf is the
        layer's own (written in place, or a new recurrent state); a joined
        leaf (``tp.joined``: this rank's heads of it) is gathered over
        ``model`` on its heads; any other split leaf's piece is cut and
        written into the old shard, in place; a leaf no axis splits is
        the layer's own."""
        kept = tp.kept if tp is not None else frozenset()
        joined = tp.joined if tp is not None else frozenset()
        out = []
        for f, n, o, spec in zip(new._fields, new, old, self.cache_specs[i]):
            if f in joined:
                n = tp.join(n, 1)
            if f not in kept and self._dims(spec, 1):
                with torch.no_grad():
                    o.copy_(self._cut_leaf(n, spec, 1))
                n = o
            out.append(n)
        return type(new)(*out)

    def shard_cache(self, cache):
        """This rank's shard of a whole cache (the same on every rank):
        each leaf cut along every dim its spec splits, batch included
        (contiguous copies)."""
        return [type(c)(*(self._cut_leaf(x, s, 0).clone(
            memory_format=torch.contiguous_format)
            for x, s in zip(c, specs)))
            for c, specs in zip(cache, self.cache_specs)]

    def gather_cache(self, cache):
        """The whole cache from every rank's shards, on every rank."""
        return [type(c)(*(self._gather_leaf(x, s, 0)
                          for x, s in zip(c, specs)))
                for c, specs in zip(cache, self.cache_specs)]


def place_train_state(state, mesh, *, fsdp: bool = False,
                      attn_hd_shard: bool = False,
                      moe_replicate: bool = False,
                      grad_compression: bool = False):
    """Place a ``TrainState`` over ``mesh`` on this rank, the counterpart of
    ``jax.device_put(state, shardings)`` in JAX's test: the params, and
    AdamW's ``mu`` and ``nu`` by the same specs, cut to this rank's
    shards; ``step`` replicated; ``err`` by the same specs with
    ``grad_compression`` (the run's: its carry is a leaf like each
    parameter, as :func:`repro_torch.launch.specs.train_state_specs`
    and JAX's ``launch/specs.py`` place it), else replicated.  Every rank passes the same full state (built from one
    seed).  Returns ``(state of shards, Placement)``; the full state can
    be freed."""
    specs = param_shardings(state.params, mesh, fsdp=fsdp,
                            attn_hd_shard=attn_hd_shard,
                            moe_replicate=moe_replicate)
    pl = Placement(mesh, specs)
    opt = state.opt._replace(mu=pl.shard_tree(state.opt.mu),
                             nu=pl.shard_tree(state.opt.nu))
    err = pl.shard_tree(state.err) if grad_compression else state.err
    return state._replace(params=pl.shard_tree(state.params), opt=opt,
                          err=err), pl
