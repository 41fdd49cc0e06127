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
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

REDUCES = ("sum", "mean", "min")


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
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    if n == 1:
        return x / 1.0 if reduce == "mean" else x.clone()
    r = dist.get_rank(group)
    nxt, prv = ((r + 1) % n, (r - 1) % n)
    if group is not None:
        nxt, prv = (dist.get_global_rank(group, nxt),
                    dist.get_global_rank(group, prv))
    flat = x.reshape(-1)
    c = -(-flat.numel() // n)                        # chunk elements (ceil)
    buf = torch.zeros((n * c,), dtype=flat.dtype, device=flat.device)
    buf[:flat.numel()] = flat
    buf = buf.view(n, c)
    recv = torch.empty((c,), dtype=flat.dtype, device=flat.device)

    def hop(send_chunk: int) -> None:
        ops = [dist.P2POp(dist.isend, buf[send_chunk].contiguous(), nxt,
                          group),
               dist.P2POp(dist.irecv, recv, prv, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    # reduce-scatter: after n-1 hops rank r owns chunk (r + 1) % n complete
    for s in range(n - 1):
        hop((r - s) % n)
        dst = (r - s - 1) % n
        buf[dst] = (torch.minimum(buf[dst], recv) if reduce == "min"
                    else buf[dst] + recv)
    # all-gather: circulate the completed chunks around the same ring
    for s in range(n - 1):
        hop((r + 1 - s) % n)
        buf[(r - s) % n] = recv
    out = buf.reshape(-1)[:flat.numel()].reshape(x.shape)
    return out / n if reduce == "mean" else out
