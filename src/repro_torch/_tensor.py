"""Small tensor helpers that stand in for JAX idioms torch lacks.

* :func:`resolve_device` — the port's device rule: ``cuda`` unless the
  caller names another device, and an error (never a silent CPU fallback)
  when no GPU is present.
* :func:`gather_index`, :func:`drop_rows`, :func:`put_rows` and
  :func:`drop_set` — JAX's index rules for a caller's slot, sequence or lane
  ids: an index in ``[-n, 0)`` means ``index + n``; a gather clamps what is
  still out of range, a masked ``.at[].set(v, mode="drop")`` drops it.
  torch wraps ``[-n, 0)`` itself but raises on anything else and has no
  drop mode, so dropped lanes are routed to a pad row that is sliced off.
  :func:`masked_rows` and :func:`masked_set` do the same for indices the
  port built itself, valid wherever masked.  No host sync.
* :func:`i32_or_int` — a scalar argument as the kernels take it: a Python
  int by value, anything else as an int32 tensor on the device.
"""
from __future__ import annotations

import numbers
from typing import Optional, Union

import torch

I32 = torch.int32
DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the GPU; raise if it is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def gather_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` as JAX gathers rows ``x[idx]`` of ``n``: ``[-n, 0)`` wraps to
    ``idx + n`` (torch's indexing does that) and anything still outside
    ``[0, n)`` is clamped into it, so the result (int64) indexes any ``n``
    rows."""
    return idx.long().clamp(-n, n - 1)


def drop_rows(idx: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    """Destination row of each lane of a masked ``.at[idx].set(v,
    mode="drop")`` over ``n`` rows, for :func:`put_rows`: ``idx`` in
    ``[-n, 0)`` wraps to ``idx + n``; lanes with ``mask`` False or an index
    still outside ``[0, n)`` go to the pad row ``n``."""
    idx = idx.long()
    keep = mask & (idx >= -n) & (idx < n)
    return torch.where(keep, idx % max(n, 1), n)


def masked_rows(idx: torch.Tensor, mask: torch.Tensor, n: int
                ) -> torch.Tensor:
    """:func:`drop_rows` for indices the caller built itself, already in
    ``[0, n)`` wherever ``mask`` is True (allocated slots, ring holes,
    page ids): lanes with ``mask`` False go to the pad row ``n``, and no
    wrap or range check is spent on the rest (two launches, not seven, on
    the serving loop's host-bound path)."""
    return torch.where(mask, idx.long(), n)


def put_rows(base: torch.Tensor, dest: torch.Tensor, values) -> torch.Tensor:
    """A copy of ``base`` with ``base[dest[i]] = values[i]``, where ``dest``
    comes from :func:`drop_rows` or :func:`masked_rows` (row ``n`` is
    dropped).  Lanes that share a row must carry identical values: which
    one lands is unspecified on a GPU.  ``values`` may be a scalar or
    broadcast against ``dest``."""
    n = base.shape[0]
    out = torch.cat([base, base.new_empty((1,) + tuple(base.shape[1:]))])
    if not torch.is_tensor(values):   # a scalar, filled on the device
        values = torch.full((), values, dtype=base.dtype, device=base.device)
    out[dest] = values.to(base.dtype)
    return out[:n]


def drop_set(base: torch.Tensor, idx: torch.Tensor, values,
             mask: torch.Tensor) -> torch.Tensor:
    """Functional masked row scatter, JAX's
    ``base.at[where(mask, idx, n)].set(values, mode="drop")``: a copy of
    ``base`` with ``base[idx[i]] = values[i]`` for every lane ``i`` where
    ``mask[i]`` and ``idx[i]`` lies in ``[-n, n)`` (negative indices wrap).
    Callers that scatter several arrays by one index compute
    :func:`drop_rows` once and call :func:`put_rows` for each."""
    return put_rows(base, drop_rows(idx, mask, base.shape[0]), values)


def masked_set(base: torch.Tensor, idx: torch.Tensor, values,
               mask: torch.Tensor) -> torch.Tensor:
    """:func:`drop_set` for indices the caller built itself (allocated
    slots, pages and table versions), in ``[0, n)`` wherever ``mask``
    holds: the scatter through :func:`masked_rows`."""
    return put_rows(base, masked_rows(idx, mask, base.shape[0]), values)


def i32(x, device: Optional[torch.device] = None) -> torch.Tensor:
    """An int32 tensor from a Python int, array or tensor.  A Python int is
    filled on the device: copying it from the host would be a host sync."""
    if isinstance(x, int):
        return torch.full((), x, dtype=I32, device=device)
    return torch.as_tensor(x, dtype=I32, device=device)


def i32_or_int(x, device: Optional[torch.device] = None):
    """A Python (or numpy) integer stays an int, which a kernel takes by
    value, so no fill is launched for it; a tensor or array becomes a
    contiguous int32 tensor on ``device`` (no copy if it already is one)."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=I32).contiguous()
    if isinstance(x, numbers.Integral):
        return int(x)
    return torch.as_tensor(x, dtype=I32, device=device).contiguous()
