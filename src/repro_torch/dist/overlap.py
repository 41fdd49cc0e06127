"""Ring all-reduce over a ``torch.distributed`` group (port of
``repro.dist.overlap.make_ring_all_reduce``).

A ring all-reduce decomposed into 2(n-1) point-to-point hops —
reduce-scatter, then all-gather, one chunk in flight per hop — in JAX's
chunking and hop order exactly: the flat input is zero-padded to ``n * c``
elements (``c = ceil(size / n)``), rank ``r`` sends to ``r + 1`` and
receives from ``r - 1``, hop ``s`` of the reduce-scatter combines the
received chunk into chunk ``(r - s - 1) % n`` (local value first, as JAX's
``.at[].add``), and hop ``s`` of the all-gather overwrites chunk
``(r - s) % n``.  So a float32 ``sum`` is bit-equal to JAX's ring, not
only to a sum.  ``reduce="mean"`` divides the ring sum by ``n``
(``pmean``); ``reduce="min"`` takes the elementwise minimum (``pmin``), the
reduction of the sharded MVGC stack's global low-water mark, where a
pin-free host contributes the ``TS_MAX`` identity.  Pad positions only
ever combine with pad positions and are sliced off.

Where JAX builds the function over a mesh axis and shards the input over
it, this is a per-rank function: every rank of ``group`` calls it with its
own shard and gets the reduced tensor back.

**Gloo and CUDA tensors.**  The port's groups are gloo: NCCL refuses two
ranks of one group on one card, and the card is one H100.  Gloo's
point-to-point and ``reduce_scatter`` do not take CUDA tensors, and its
collectives that do stage them through host memory themselves.  So every
collective of the port goes through :func:`wire`: a CUDA tensor is copied
to host memory in plain sight (one host sync, counted in
``wire.copies``), crosses gloo there, and the result is copied back to
the caller's device (:func:`unwire`; the bytes of both copies in
``wire.bytes``).  State stays on the card; only the collectives' operands
cross.  The helpers below (:func:`exchange`, :func:`all_gather_cat`,
:func:`all_reduce_`, :func:`broadcast_`, :func:`broadcast_tree`) are the
port's collectives built on it; each is a per-rank function that every
rank of ``group`` calls in the same order.  Under an op counter
(:mod:`repro_torch.launch.op_cost`; the hook is
:func:`repro_torch.kernels.cost.collective`) each charges one collective by
``hlo_cost``'s byte model, and the host copies and gloo ops inside it are
not counted.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.kernels.cost import collective

REDUCES = ("sum", "mean", "min")


def wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as gloo takes it: a contiguous host tensor.  A CUDA tensor is
    copied to host memory, which waits for the card: one host sync,
    counted in ``wire.copies``."""
    if x.is_cuda:
        wire.copies += 1
        wire.bytes += _nbytes(x)
        return x.detach().to("cpu").contiguous()
    return x.detach().contiguous()


wire.copies = 0
wire.bytes = 0


def unwire(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor that crossed gloo, on ``device``: a copy back to the
    card is counted in ``wire.bytes`` (the bytes that cross between the
    card and host memory, both ways)."""
    if torch.device(device).type == "cuda":
        wire.bytes += _nbytes(x)
    return x.to(device)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _write_back(x: torch.Tensor, buf: torch.Tensor) -> None:
    """``buf``'s values into ``x`` where :func:`wire` made ``buf`` a copy
    (a CUDA tensor or a strided one; else they share memory)."""
    if x.is_cuda or not x.is_contiguous():
        if x.is_cuda:
            wire.bytes += _nbytes(buf)
        with torch.no_grad():
            x.copy_(buf)


def _raw(x: torch.Tensor) -> torch.Tensor:
    """A contiguous host tensor's bytes (gloo moves any dtype, bool and
    bfloat16 included, as bytes)."""
    return x.reshape(-1).view(torch.uint8)


def world(group: Optional[dist.ProcessGroup] = None) -> int:
    """The size of ``group`` (the default group when None); a process
    without an initialised default group is a group of one."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _global(group: Optional[dist.ProcessGroup], r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def exchange(send: torch.Tensor, dst: int, src: int,
             group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Send ``send`` to group rank ``dst`` and receive a tensor of its
    shape and dtype from group rank ``src``, in one batch (every rank of a
    ring posts both, so no order of blocking calls can deadlock).  Returns
    the received tensor on ``send``'s device."""
    with collective("collective-permute", _nbytes(send)):
        out = wire(send)
        recv = torch.empty_like(out)
        ops = [dist.P2POp(dist.isend, _raw(out), _global(group, dst), group),
               dist.P2POp(dist.irecv, _raw(recv), _global(group, src),
                          group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return unwire(recv, send.device)


def all_gather_cat(x: torch.Tensor, group: Optional[dist.ProcessGroup],
                   dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all ranks) concatenated along
    ``dim`` in group rank order, on every rank, on ``x``'s device.  One
    broadcast per rank, all in flight at once: gloo runs them over its
    pairs side by side, where its ``all_gather`` walks a ring one hop at a
    time."""
    n = world(group)
    if n == 1:
        return x
    with collective("all-gather", n * _nbytes(x)):
        mine = wire(x)
        parts = [mine if r == dist.get_rank(group)
                 else torch.empty_like(mine) for r in range(n)]
        works = [dist.broadcast(_raw(parts[r]), _global(group, r),
                                group=group, async_op=True)
                 for r in range(n)]
        for w in works:
            w.wait()
        return unwire(torch.cat(parts, dim=dim), x.device)


def all_reduce_(x: torch.Tensor, group: Optional[dist.ProcessGroup],
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """gloo's all-reduce of ``x`` over ``group``, written back into ``x``
    (every rank gets the same bits) and returned."""
    if world(group) == 1:
        return x
    with collective("all-reduce", _nbytes(x)):
        buf = wire(x)
        dist.all_reduce(buf, op=op, group=group)
        _write_back(x, buf)
    return x


def all_reduce(x: torch.Tensor, group: Optional[dist.ProcessGroup],
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """gloo's all-reduce of ``x`` over ``group`` as a new tensor on ``x``'s
    device (every rank gets the same bits); ``x`` is left as it is."""
    if world(group) == 1:
        return x
    with collective("all-reduce", _nbytes(x)):
        buf = wire(x) if x.is_cuda else x.detach().clone(
            memory_format=torch.contiguous_format)
        dist.all_reduce(buf, op=op, group=group)
        return unwire(buf, x.device)


def broadcast_(x: torch.Tensor, src: int,
               group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Group rank ``src``'s ``x`` written into ``x`` on every rank (one
    shape and dtype on all of them) and returned."""
    if world(group) == 1:
        return x
    with collective("broadcast", _nbytes(x)):
        buf = wire(x)
        dist.broadcast(_raw(buf), _global(group, src), group=group)
        _write_back(x, buf)
    return x


def _map(tree: Any, fn) -> Any:
    """``fn`` of every tensor of ``tree`` (NamedTuples, tuples, lists and
    dicts; other values as they are)."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return tree


def broadcast_tree(tree: Any, src: int, group: Optional[dist.ProcessGroup],
                   device: torch.device) -> Any:
    """Group rank ``src``'s ``tree`` (tensors in NamedTuples, tuples,
    lists and dicts, or plain values; the other ranks pass anything) on
    every rank, its tensors on ``device``.  The tree crosses pickled, so
    only the port's own ranks may be its peers."""
    if world(group) == 1:
        return tree
    box = [_map(tree, wire) if dist.get_rank(group) == src else None]
    dist.broadcast_object_list(box, src=_global(group, src), group=group)
    return _map(box[0], lambda x: unwire(x, device))


def ring_all_reduce(x: torch.Tensor, reduce: str = "sum",
                    group: Optional[dist.ProcessGroup] = None
                    ) -> torch.Tensor:
    """All-reduce this rank's ``x`` over ``group`` (the default group when
    None) by the ring; a process without an initialised default group is a
    group of one.  Returns a new tensor of ``x``'s shape; an unknown
    ``reduce`` raises ``ValueError``."""
    if reduce not in REDUCES:
        raise ValueError(
            f"reduce must be 'sum', 'mean' or 'min', got {reduce!r}")
    n = world(group)
    if n == 1:
        return x / 1.0 if reduce == "mean" else x.clone()
    with collective("all-reduce", _nbytes(x)):
        return _ring(x, reduce, group, n)


def _ring(x: torch.Tensor, reduce: str, group, n: int) -> torch.Tensor:
    r = dist.get_rank(group)
    nxt, prv = (r + 1) % n, (r - 1) % n
    flat = wire(x).reshape(-1)           # the hops run in host memory
    c = -(-flat.numel() // n)                        # chunk elements (ceil)
    buf = torch.zeros((n * c,), dtype=flat.dtype, device=flat.device)
    buf[:flat.numel()] = flat
    buf = buf.view(n, c)

    def hop(send_chunk: int) -> torch.Tensor:
        return exchange(buf[send_chunk], nxt, prv, group)

    # reduce-scatter: after n-1 hops rank r owns chunk (r + 1) % n complete
    for s in range(n - 1):
        recv = hop((r - s) % n)
        dst = (r - s - 1) % n
        buf[dst] = (torch.minimum(buf[dst], recv) if reduce == "min"
                    else buf[dst] + recv)
    # all-gather: circulate the completed chunks around the same ring
    for s in range(n - 1):
        buf[(r - s) % n] = hop((r + 1 - s) % n)
    out = buf.reshape(-1)[:flat.numel()].reshape(x.shape)
    return unwire(out / n if reduce == "mean" else out, x.device)
