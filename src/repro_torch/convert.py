"""Carry state between the JAX package and the port as numpy arrays.

:func:`mvstate_from_numpy` and :func:`paged_kv_from_numpy` take an
``MVState`` / ``PagedKV`` of the JAX package — or any object with the same
field names whose leaves convert with ``numpy.asarray`` — and build the
port's tensors on ``device``.  :func:`params_from_numpy` maps a JAX
model's parameter pytree (layers stacked over superblocks, an encoder's
too) onto the port's per-layer dicts, and :func:`serve_state_from_numpy` a
JAX ``ServeState`` onto the port's (KV caches, rings and recurrent
states), so both packages compute from the same weights.
:func:`train_state_from_numpy` maps a JAX ``TrainState`` onto the port's,
and :func:`params_to_numpy` a parameter-shaped tree (parameters,
gradients, moments) back onto JAX's stacked layout.
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
from repro_torch.ckpt.manager import tree_flatten, tree_unflatten
from repro_torch.configs.base import ModelConfig
from repro_torch.core.mvgc import announce, pool, rangetracker, vstore
from repro_torch.models.attention import KVCache, LocalKVCache
from repro_torch.models.blocks import RECURRENT_STATES
from repro_torch.models.transformer import _kinds
from repro_torch.mvkv import paged
from repro_torch.optim.adamw import AdamWState
from repro_torch.serve.engine import ServeState
from repro_torch.train.step import TrainState


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


#: mixer leaves that are float32 by construction in both packages, whatever
#: the block's dtype: a ``dtype`` cast keeps them float32
F32_MIXER_LEAVES = {"rglru": ("wa", "ba", "wx", "bx", "lambda"),
                    "mlstm": ("w_if",), "slstm": ("b",)}


def params_from_numpy(cfg: ModelConfig, params: Any, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> dict:
    """A JAX parameter pytree (``embed``, ``sb/l{j}/{ln1, mixer/..., ln2,
    ffn/..., cross_ln, cross/...}`` stacked over superblocks, ``tail``,
    ``final_norm``, ``unembed`` when untied, ``encoder/{sb/l0 stacked over
    the encoder's layers, final_norm}`` for an encoder-decoder) -> the
    port's parameters on ``device``, cast to ``dtype`` when given.  A
    mixture of experts' router and the recurrent mixers' gate leaves
    (``F32_MIXER_LEAVES``) stay float32, as both packages' inits make
    them."""
    dev = resolve_device(device)

    def t(x):
        return _cast(x, dev, dtype)

    def layer(tree, kind):
        out = _map_tree(tree, t)
        for name in F32_MIXER_LEAVES.get(kind, ()):
            out["mixer"][name] = _cast(tree["mixer"][name], dev,
                                       torch.float32)
        if isinstance(tree.get("ffn"), dict) and "router" in tree["ffn"]:
            out["ffn"]["router"] = _cast(tree["ffn"]["router"], dev,
                                         torch.float32)
        return out

    out = {"embed": t(params["embed"]),
           "layers": [layer(x, kind) for x, kind in
                      zip(_per_layer(cfg, params), _kinds(cfg))],
           "final_norm": t(params["final_norm"])}
    if "unembed" in params:
        out["unembed"] = t(params["unembed"])
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {
            "layers": [layer(_map_tree(enc["sb"]["l0"],
                                       lambda x, r=r: np.asarray(x)[r]),
                             "attn")
                       for r in range(cfg.encoder_layers)],
            "final_norm": t(enc["final_norm"])}
    return out


#: the port's recurrent state of each JAX state's fields
_STATES = {s._fields: s for s in RECURRENT_STATES}


def _cache_from_numpy(c: Any, dev: torch.device,
                      dtype: Optional[torch.dtype]):
    """One layer's cache; a local ring's ``pos`` stays int32, a recurrent
    state float32."""
    fields = getattr(c, "_fields", ())
    if fields in _STATES:
        return _STATES[fields](*(tensor_from_numpy(x, dev) for x in c))
    k, v = _cast(c.k, dev, dtype), _cast(c.v, dev, dtype)
    if hasattr(c, "pos"):
        return LocalKVCache(k, v, tensor_from_numpy(c.pos, dev))
    return KVCache(k, v)


def serve_state_from_numpy(cfg: ModelConfig, state: Any,
                           device: DeviceLike = None,
                           dtype: Optional[torch.dtype] = None):
    """A JAX ``ServeState`` -> the port's, on ``device``; ``dtype`` casts the
    parameters (not the float32 leaves) and the KV caches (not a ring's
    ``pos``, not a recurrent state) when given."""
    dev = resolve_device(device)
    return ServeState(
        params=params_from_numpy(cfg, state.params, dev, dtype),
        cache=[_cache_from_numpy(c, dev, dtype)
               for c in _per_layer(cfg, state.cache)],
        cache_len=tensor_from_numpy(state.cache_len, dev),
        mv=mvstate_from_numpy(state.mv, dev),
        last_tokens=tensor_from_numpy(state.last_tokens, dev),
        longest=int(np.max(state.cache_len)))


def params_to_numpy(cfg: ModelConfig, params: Any) -> dict:
    """The port's parameter tree (or a tree like it: gradients, moments)
    -> the JAX layout as numpy arrays: each layer's leaves stacked over
    superblocks under ``sb/l{j}``, the remainder under ``tail``, an
    encoder's under ``encoder/sb/l0``; the reverse of
    :func:`params_from_numpy`."""
    p, R = len(cfg.layer_pattern), cfg.pattern_repeats
    layers = to_numpy(params["layers"])

    out = {"embed": to_numpy(params["embed"]),
           "sb": {f"l{j}": _stack([layers[r * p + j] for r in range(R)])
                  for j in range(p)},
           "final_norm": to_numpy(params["final_norm"])}
    if len(layers) > R * p:
        out["tail"] = layers[R * p:]
    if "unembed" in params:
        out["unembed"] = to_numpy(params["unembed"])
    if "encoder" in params:
        enc = to_numpy(params["encoder"])
        out["encoder"] = {"sb": {"l0": _stack(enc["layers"])},
                          "final_norm": enc["final_norm"]}
    return out


def _stack(trees: List[Any]) -> Any:
    """Stack numpy leaves of like trees along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def train_state_from_numpy(cfg: ModelConfig, state: Any,
                           device: DeviceLike = None):
    """A JAX ``TrainState`` (params, ``AdamWState(step, mu, nu)``, err,
    step) -> the port's :class:`repro_torch.train.step.TrainState` on
    ``device``: params, mu, nu and (with compression) err through
    :func:`params_from_numpy`'s layer mapping.  JAX's error carry without
    compression is a ``(1,)`` zero per leaf, stacked or not, so the port's
    is a ``(1,)`` zero per leaf of its own tree."""
    dev = resolve_device(device)
    params = params_from_numpy(cfg, state.params, dev)
    mu = params_from_numpy(cfg, state.opt.mu, dev)
    nu = params_from_numpy(cfg, state.opt.nu, dev)
    leaves = tree_flatten(params)
    err_leaves = [np.asarray(x) for x in tree_flatten(state.err)]
    if all(e.shape == (1,) for e in err_leaves) and any(
            p.shape != (1,) for p in leaves):
        err = tree_unflatten(params, [
            torch.zeros((1,), dtype=torch.float32, device=dev)
            for _ in leaves])
    else:
        err = params_from_numpy(cfg, state.err, dev)
    return TrainState(params=params,
                      opt=AdamWState(tensor_from_numpy(state.opt.step, dev),
                                     mu, nu),
                      err=err, step=tensor_from_numpy(state.step, dev))


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
