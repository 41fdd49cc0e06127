"""Carry state between the JAX package and the port as numpy arrays.

:func:`mvstate_from_numpy` and :func:`paged_kv_from_numpy` take an
``MVState`` / ``PagedKV`` of the JAX package — or any object with the same
field names whose leaves convert with ``numpy.asarray`` — and build the
port's tensors on ``device``.  :func:`to_numpy` goes back: the same
``NamedTuple`` type with numpy leaves (bfloat16 tensors widen to float32,
which is exact).  Nothing here imports JAX: a JAX array is read through
``numpy.asarray``, and a bfloat16 numpy array through its 16-bit pattern.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch._tensor import DeviceLike, resolve_device
from repro_torch.core.mvgc import announce, pool, rangetracker, vstore
from repro_torch.mvkv import paged


def tensor_from_numpy(x: Any, device: DeviceLike = None) -> torch.Tensor:
    """One leaf: numpy (or array-like) -> tensor, dtype kept, bf16 too."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(resolve_device(device))
    return torch.from_numpy(np.array(arr)).to(resolve_device(device))


def mvstate_from_numpy(mv: Any, device: DeviceLike = None) -> vstore.MVState:
    dev = resolve_device(device)

    def t(x):
        return tensor_from_numpy(x, dev)

    return vstore.MVState(
        store=pool.VersionStore(t(mv.store.ts), t(mv.store.succ),
                                t(mv.store.payload)),
        board=announce.AnnounceBoard(t(mv.board.slots)),
        ring=rangetracker.RetireRing(t(mv.ring.idx), t(mv.ring.low),
                                     t(mv.ring.high)),
        now=t(mv.now), overflow_count=t(mv.overflow_count),
        dropped_retires=t(mv.dropped_retires),
    )


def paged_kv_from_numpy(st: Any, device: DeviceLike = None) -> paged.PagedKV:
    dev = resolve_device(device)
    return paged.PagedKV(
        *(tensor_from_numpy(getattr(st, f), dev)
          for f in paged.PagedKV._fields[:-1]),
        mv=mvstate_from_numpy(st.mv, dev))


def to_numpy(x: Any) -> Any:
    """Tensors (nested in NamedTuples) -> numpy arrays, structure kept."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    return x
