"""Carry state between the JAX package and the port as numpy arrays.

:func:`mvstate_from_numpy` and :func:`paged_kv_from_numpy` take an
``MVState`` / ``PagedKV`` of the JAX package — or any object with the same
field names whose leaves convert with ``numpy.asarray`` — and build the
port's tensors on ``device``.  :func:`params_from_numpy` maps a JAX
model's parameter pytree (layers stacked over superblocks) onto the port's
per-layer dicts, and :func:`serve_state_from_numpy` a JAX ``ServeState``
onto the port's, so both packages compute from the same weights.
:func:`to_numpy` goes back: the same ``NamedTuple`` types, lists and
dicts with numpy leaves (bfloat16 tensors widen to float32, which is
exact).  Nothing here imports JAX: a JAX array is read through
``numpy.asarray``, and a bfloat16 numpy array through its 16-bit pattern.
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch._tensor import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.mvgc import announce, pool, rangetracker, vstore
from repro_torch.models.attention import KVCache, LocalKVCache
from repro_torch.mvkv import paged
from repro_torch.serve.engine import ServeState


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


def _cast(x: Any, dev: torch.device, dtype: Optional[torch.dtype]
          ) -> torch.Tensor:
    out = tensor_from_numpy(x, dev)
    return out if dtype is None else out.to(dtype)


def _map_tree(tree: Any, fn) -> Any:
    """Apply ``fn`` to every leaf of nested dicts, lists and NamedTuples."""
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def _per_layer(cfg: ModelConfig, tree: Any) -> List[Any]:
    """Unstack ``{"sb": {"l{j}": stacked [R, ...]}, "tail": [...]}`` into
    one entry per layer in depth order (layer ``r * p + j`` is superblock
    ``r``'s ``l{j}``; the tail follows)."""
    p, R = len(cfg.layer_pattern), cfg.pattern_repeats
    layers = [_map_tree(tree["sb"][f"l{j}"], lambda x, r=r: np.asarray(x)[r])
              for r in range(R) for j in range(p)]
    return layers + list(tree.get("tail", []))


def params_from_numpy(cfg: ModelConfig, params: Any, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> dict:
    """A JAX parameter pytree (``embed``, ``sb/l{j}/{ln1, mixer/{wq, wk, wv,
    wo}, ln2, ffn/...}`` stacked over superblocks, ``final_norm``,
    ``unembed`` when untied) -> the port's parameters on ``device``, cast to
    ``dtype`` when given.  A mixture of experts' router stays float32, as
    ``init_moe`` makes it in both packages."""
    dev = resolve_device(device)

    def t(x):
        return _cast(x, dev, dtype)

    def layer(tree):
        out = _map_tree(tree, t)
        if isinstance(tree.get("ffn"), dict) and "router" in tree["ffn"]:
            out["ffn"]["router"] = _cast(tree["ffn"]["router"], dev,
                                         torch.float32)
        return out

    out = {"embed": t(params["embed"]),
           "layers": [layer(x) for x in _per_layer(cfg, params)],
           "final_norm": t(params["final_norm"])}
    if "unembed" in params:
        out["unembed"] = t(params["unembed"])
    return out


def _cache_from_numpy(c: Any, dev: torch.device,
                      dtype: Optional[torch.dtype]):
    """One layer's cache; a local ring's ``pos`` stays int32."""
    k, v = _cast(c.k, dev, dtype), _cast(c.v, dev, dtype)
    if hasattr(c, "pos"):
        return LocalKVCache(k, v, tensor_from_numpy(c.pos, dev))
    return KVCache(k, v)


def serve_state_from_numpy(cfg: ModelConfig, state: Any,
                           device: DeviceLike = None,
                           dtype: Optional[torch.dtype] = None):
    """A JAX ``ServeState`` -> the port's, on ``device``; ``dtype`` casts the
    parameters (not a router) and the KV caches (not a ring's ``pos``) when
    given."""
    dev = resolve_device(device)
    return ServeState(
        params=params_from_numpy(cfg, state.params, dev, dtype),
        cache=[_cache_from_numpy(c, dev, dtype)
               for c in _per_layer(cfg, state.cache)],
        cache_len=tensor_from_numpy(state.cache_len, dev),
        mv=mvstate_from_numpy(state.mv, dev),
        last_tokens=tensor_from_numpy(state.last_tokens, dev),
        longest=int(np.max(state.cache_len)))


def to_numpy(x: Any) -> Any:
    """Tensors (nested in NamedTuples, lists and dicts) -> numpy arrays,
    structure kept."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, list):
        return [to_numpy(v) for v in x]
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    return x
