"""Small tensor helpers that stand in for JAX idioms torch lacks.

* :func:`resolve_device` — the port's device rule: ``cuda`` unless the
  caller names another device, and an error (never a silent CPU fallback)
  when no GPU is present.
* :func:`drop_set` — ``x.at[where(mask, idx, n)].set(v, mode="drop")``:
  torch has no drop mode and raises on an out-of-range index, so inert lanes
  are routed to a pad row that is sliced off.  No host sync.
"""
from __future__ import annotations

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


def drop_set(base: torch.Tensor, idx: torch.Tensor, values,
             mask: torch.Tensor) -> torch.Tensor:
    """Functional masked row scatter: a copy of ``base`` with
    ``base[idx[i]] = values[i]`` for every lane ``i`` where ``mask[i]``.

    Lanes with ``mask`` False write nothing, whatever their index (JAX's
    ``mode="drop"`` with an out-of-range sentinel).  Masked lanes that share
    an index must carry identical rows: which one lands is unspecified on a
    GPU.  ``values`` may be a scalar or broadcast against ``idx``."""
    n = base.shape[0]
    out = torch.cat([base, base.new_empty((1,) + tuple(base.shape[1:]))])
    dest = torch.where(mask, idx.to(torch.long), n)
    if not torch.is_tensor(values):   # a scalar, filled on the device
        values = torch.full((), values, dtype=base.dtype, device=base.device)
    out[dest] = values.to(base.dtype)
    return out[:n]


def i32(x, device: Optional[torch.device] = None) -> torch.Tensor:
    """An int32 tensor from a Python int, array or tensor.  A Python int is
    filled on the device: copying it from the host would be a host sync."""
    if isinstance(x, int):
        return torch.full((), x, dtype=I32, device=device)
    return torch.as_tensor(x, dtype=I32, device=device)
