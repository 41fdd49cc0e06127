"""Input shapes and sharding specs of every (arch x shape x mesh) cell, and
the cell builders the dry run runs (port of ``repro.launch.specs``).

Shapes first: :func:`input_specs` and :func:`shapes_of` give
:class:`Shaped` leaves (shape and dtype, JAX's ``ShapeDtypeStruct``), and
no tensor of a cell is made here.  The dry run
(:func:`repro_torch.launch.dryrun.trace`) makes this rank's shards as
fake tensors from them inside its ``FakeTensorMode``.

Specs are the port's :class:`repro_torch.dist.sharding.Spec` tuples.  The
port's parameter tree and cache are per layer, where JAX's are stacked
over superblocks with a leading ``[R]`` dim that always stays ``None``, so
a port leaf's spec is JAX's spec of its stacked leaf with that entry
dropped (the rule ``param_shardings`` follows): :func:`cache_shardings`
reads the core shape, as JAX's does.

A cell builder returns ``(step, args, placement)``: ``step(*args)`` is
what one rank runs, ``args`` the rank's arguments (:class:`Shaped` leaves
of its shards, built by the dry run) and ``placement`` its placement.  It
takes a shape name, as JAX's does, or a :class:`ShapeConfig` for a shape
that is not in ``SHAPES``.  JAX's ``attn_gather_qkv`` is a GSPMD sharding
hint with no counterpart in the port, whose placed steps gather at use
only what does not compute on its shards over ``model``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import (ModelConfig, RunConfig, SHAPES,
                                      ShapeConfig)
from repro_torch.dist.sharding import (ServePlacement, Spec, axis_sizes,
                                       batch_axes, param_shardings)

COMPUTE_DTYPE = torch.bfloat16

ShapeLike = Union[str, ShapeConfig]


@dataclasses.dataclass(frozen=True)
class Shaped:
    """A leaf's shape and dtype: JAX's ``ShapeDtypeStruct`` (a leaf, not a
    container, for every tree walk)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _shape(shape: ShapeLike) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def run_config(arch: str, shape: ShapeLike, gc_policy: str = "slrt"
               ) -> RunConfig:
    cfg = get_config(arch)
    sh = _shape(shape)
    big = cfg.param_count() * 2 > 8e9   # >= ~4B params: shard params over data
    return RunConfig(model=cfg, shape=sh, fsdp=big and sh.name == "train_4k",
                     gc_policy=gc_policy, microbatches=1)


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------
def input_specs(arch: str, shape: ShapeLike) -> Dict[str, Shaped]:
    """Shapes and dtypes of every model input of this cell."""
    cfg = get_config(arch)
    sh = _shape(shape)
    B = sh.global_batch
    if sh.kind == "decode":      # one new token against a cache of seq_len
        return {"tokens": Shaped((B, 1), torch.int32)}
    T_text = sh.seq_len
    out: Dict[str, Shaped] = {}
    if cfg.encoder_layers:                      # whisper: frames go to enc
        out["frontend"] = Shaped((B, cfg.encoder_tokens, cfg.d_model),
                                 COMPUTE_DTYPE)
    elif cfg.frontend != "none":                # vlm: patch prefix
        T_text = sh.seq_len - cfg.frontend_tokens
        out["frontend"] = Shaped((B, cfg.frontend_tokens, cfg.d_model),
                                 COMPUTE_DTYPE)
    out["tokens"] = Shaped((B, T_text), torch.int32)
    if sh.kind == "train":
        out["loss_mask"] = Shaped((B, T_text), torch.float32)
    return out


def map_leaves(tree, fn):
    """``fn`` of every tensor or :class:`Shaped` leaf of ``tree``
    (NamedTuples, tuples, lists and dicts), the structure kept."""
    if isinstance(tree, (torch.Tensor, Shaped)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(v, fn) for v in tree)
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn) for k, v in tree.items()}
    return tree


def shapes_of(build) -> Any:
    """The :class:`Shaped` tree of what ``build(device)`` builds, built on
    fake CPU tensors (no data, no RNG drawn): the counterpart of
    ``jax.eval_shape``.  Trap "random init on a fake cuda tensor": a
    torch without CUDA refuses it, so shapes come first, on the CPU, and
    the dry run makes its fake tensors from them with ``torch.empty``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = build(torch.device("cpu"))
    return map_leaves(tree, lambda t: Shaped(tuple(t.shape), t.dtype))


# ---------------------------------------------------------------------------
# sharding rules for non-param state
# ---------------------------------------------------------------------------
def _dim_shardable(n: int, mesh, axes) -> bool:
    total = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        total *= axis_sizes(mesh).get(a, 1)
    return n % total == 0 and n >= total


def cache_shardings(cache_shapes, mesh, cfg: ModelConfig, B: int):
    """Spec of every leaf of the decode cache (per layer: a KV cache,
    ring or recurrent state; each layer's type holding a spec per field).

    Policy: batch over (pod, data) when divisible; KV sequence dim over
    'model' (sequence-parallel decode) unless kv-heads divide the model
    axis, in which case heads go on 'model'.  When the batch can't cover
    the data axes (long_500k B=1) the sequence dim takes BOTH (data,
    model)."""
    sizes = axis_sizes(mesh)
    baxes = batch_axes(mesh)
    b_ok = _dim_shardable(B, mesh, baxes)
    m = sizes.get("model", 1)
    heads_on_model = cfg.num_kv_heads % m == 0 and cfg.num_kv_heads >= m
    bspec = baxes if b_ok else None

    def leaf_spec(name: str, core) -> Spec:
        if name in ("k", "v") and len(core) == 4:        # [B, L, H, D]
            if heads_on_model:
                return Spec((bspec, None, "model", None))
            seq_ax = ("data", "model") if not b_ok and _dim_shardable(
                core[1], mesh, ("data", "model")) else "model"
            if not _dim_shardable(core[1], mesh, seq_ax):
                seq_ax = None
            return Spec((bspec, seq_ax, None, None))
        if name == "pos" and len(core) == 2:             # local ring positions
            seq_ax = "model" if _dim_shardable(core[1], mesh, "model") \
                else None
            return Spec((bspec, seq_ax))
        if name == "h" and len(core) == 2:               # rglru [B, w]
            w_ax = "model" if _dim_shardable(core[1], mesh, "model") else None
            return Spec((bspec, w_ax))
        if name == "conv" and len(core) == 3:            # rglru [B, W-1, w]
            w_ax = "model" if _dim_shardable(core[2], mesh, "model") else None
            return Spec((bspec, None, w_ax))
        # mlstm C [B,H,dk,dv], n [B,H,dk]; slstm c, n, m, h [B,H,hd]: batch
        return Spec([bspec] + [None] * (len(core) - 1)) if len(core) \
            else Spec()

    return [type(c)(*(leaf_spec(name, tuple(x.shape))
                      for name, x in zip(c._fields, c)))
            for c in cache_shapes]


def mv_shardings(mv_shapes, mesh, B: int):
    """Descriptor store: slots follow the batch sharding; board/ring/scalars
    replicated (they are tiny and read by every shard's GC pass)."""
    baxes = batch_axes(mesh)
    b_ok = _dim_shardable(B, mesh, baxes)

    def walk(tree, top: str):
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(walk(v, top or f)
                                for f, v in zip(tree._fields, tree)))
        shp = tuple(tree.shape)
        if len(shp) >= 1 and shp[0] == B and b_ok and top == "store":
            return Spec([baxes] + [None] * (len(shp) - 1))
        return Spec()

    return walk(mv_shapes, "")


def batch_shardings(batch_specs, mesh, B: int):
    baxes = batch_axes(mesh)
    bspec = baxes if _dim_shardable(B, mesh, baxes) else None
    return {k: Spec([bspec] + [None] * (len(x.shape) - 1))
            for k, x in batch_specs.items()}


def replicate(tree):
    return map_leaves(tree, lambda _: Spec())


def _pad_heads_cfg(cfg: ModelConfig, mesh) -> ModelConfig:
    """Round head counts up to the model-axis multiple (zero-padded heads in
    deployment): keeps the softmax shard-local where 40-head models would
    otherwise replicate attention 16x."""
    m = axis_sizes(mesh).get("model", 1)

    def pad(h):
        return ((h + m - 1) // m) * m

    return dataclasses.replace(cfg, num_heads=pad(cfg.num_heads),
                               num_kv_heads=pad(cfg.num_kv_heads),
                               head_dim=cfg.hd)


def shard_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of this rank's shard of a leaf of ``shape`` under
    ``spec``: each dim divided by the sizes of the axes that shard it."""
    sizes = axis_sizes(mesh)
    out = []
    for d, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = 1
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            n *= sizes.get(a, 1)
        out.append(d // n)
    return tuple(out)


# ---------------------------------------------------------------------------
# cell builders: (step, args, placement)
# ---------------------------------------------------------------------------
def _cell_cfg(arch: str, mesh, pad_heads: bool, moe_dispatch: Optional[str]
              ) -> ModelConfig:
    cfg = get_config(arch)
    if pad_heads:
        cfg = _pad_heads_cfg(cfg, mesh)
    if moe_dispatch:
        cfg = dataclasses.replace(cfg, moe_dispatch=moe_dispatch)
    return cfg


def zip_map(tree, specs, fn: Callable):
    """``fn(leaf, spec)`` of every tensor or :class:`Shaped` leaf of
    ``tree`` with the :class:`Spec` at its place in ``specs`` (a tree of
    the same structure), the structure kept."""
    if isinstance(tree, (torch.Tensor, Shaped)):
        return fn(tree, specs)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(zip_map(v, s, fn) for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(zip_map(v, s, fn) for v, s in zip(tree, specs))
    if isinstance(tree, dict):
        return {k: zip_map(v, specs[k], fn) for k, v in tree.items()}
    return tree


def _placed(shapes, specs, mesh):
    """This rank's piece of each leaf of ``shapes`` under its spec."""
    return zip_map(shapes, specs, lambda x, s: Shaped(
        shard_shape(x.shape, s, mesh), x.dtype))


def train_state_specs(state, mesh, run: RunConfig, *,
                      attn_hd_shard: bool = False,
                      moe_replicate: bool = False):
    """The spec tree of a ``TrainState`` (JAX's ``build_train_cell``'s
    ``state_shard``): the params by :func:`param_shardings`, AdamW's
    moments by the same specs, its step and the state's step replicated,
    and ``err`` by the params' specs under ``run.grad_compression`` (its
    carry is a leaf like each parameter), else replicated."""
    from repro_torch.train import step as train_mod
    pspecs = param_shardings(state.params, mesh, fsdp=run.fsdp,
                             attn_hd_shard=attn_hd_shard,
                             moe_replicate=moe_replicate)
    return train_mod.TrainState(
        params=pspecs, opt=state.opt._replace(step=Spec(), mu=pspecs,
                                              nu=pspecs),
        err=pspecs if run.grad_compression else replicate(state.err),
        step=Spec())


def build_train_cell(arch: str, mesh, shape: ShapeLike = "train_4k",
                     fsdp: Optional[bool] = None, microbatches: int = 1,
                     attn_hd_shard: bool = False,
                     moe_dispatch: Optional[str] = None,
                     moe_replicate: bool = False, pad_heads: bool = False):
    """One rank's training step: ``train_step(state, batch, placement=)``
    on its shards of the state (:func:`train_state_specs`) and the global
    batch, of which it takes its rows."""
    from repro_torch.train import step as train_mod
    from repro_torch.dist.sharding import Placement
    cfg = _cell_cfg(arch, mesh, pad_heads, moe_dispatch)
    run = run_config(arch, shape)
    if fsdp is not None:
        run = dataclasses.replace(run, fsdp=fsdp)
    if microbatches != 1:
        run = dataclasses.replace(run, microbatches=microbatches)
    state = shapes_of(lambda dev: train_mod.init_state(
        cfg, torch.Generator(device=dev), dtype=COMPUTE_DTYPE,
        compression=run.grad_compression))
    specs = train_state_specs(state, mesh, run,
                              attn_hd_shard=attn_hd_shard,
                              moe_replicate=moe_replicate)
    batch = input_specs(arch, shape)
    placement = Placement(mesh, specs.params)

    def step(state, batch):
        return train_mod.train_step(state, batch, cfg, run,
                                    placement=placement)

    return step, (_placed(state, specs, mesh), batch), placement


def build_serve_cell(arch: str, mesh, shape: ShapeLike,
                     gc_policy: str = "slrt", attn_hd_shard: bool = False,
                     moe_dispatch: Optional[str] = None,
                     moe_replicate: bool = False, pad_heads: bool = False):
    """One rank's prefill (``prefill``, the model's, as JAX's cell) or
    decode step (the placed ``decode_one``: model decode, descriptor
    write and GC) on its shards, by :class:`ServePlacement`: attention on
    its KV heads or its block of positions, the MLP and the RG-LRU on
    their slices, the vocabulary on its block, as GSPMD computes JAX's
    cell."""
    from repro_torch.models import transformer as tf
    from repro_torch.serve import engine as eng
    cfg = _cell_cfg(arch, mesh, pad_heads, moe_dispatch)
    sh = _shape(shape)
    run = run_config(arch, sh, gc_policy)
    B, L = sh.global_batch, sh.seq_len
    params = shapes_of(lambda dev: tf.init_params(
        cfg, torch.Generator(device=dev), dtype=COMPUTE_DTYPE))
    pspecs = param_shardings(params, mesh, fsdp=False,
                             attn_hd_shard=attn_hd_shard,
                             moe_replicate=moe_replicate)
    cache = shapes_of(lambda dev: tf.init_cache(cfg, B, L, COMPUTE_DTYPE,
                                                dev))
    cspecs = cache_shardings(cache, mesh, cfg, B)
    placement = ServePlacement(mesh, pspecs, cspecs)
    pl_params = _placed(params, pspecs, mesh)
    pl_cache = _placed(cache, cspecs, mesh)

    if sh.kind == "prefill":
        batch = input_specs(arch, sh)

        def step(params, cache, batch):
            return tf.prefill(params, cfg, placement.rows(batch["tokens"]),
                              cache,
                              frontend_embeds=placement.rows(
                                  batch.get("frontend")),
                              inplace=True, placement=placement)

        return step, (pl_params, pl_cache, batch), placement

    # decode: the full MV-Serve step (model decode + descriptor write + GC)
    state = shapes_of(lambda dev: eng.make_serve_state(
        cfg, run, None, B, 1, COMPUTE_DTYPE, dev))
    bspec = Spec((batch_axes(mesh) if _dim_shardable(
        B, mesh, batch_axes(mesh)) else None,))
    state = state._replace(
        params=pl_params, cache=pl_cache,
        cache_len=_placed(state.cache_len, bspec, mesh),
        last_tokens=_placed(state.last_tokens, Spec(tuple(bspec) + (None,)),
                            mesh),
        longest=L - 1)

    def step(state):
        new_state, toks, _, _ = eng.decode_one(state, cfg, run,
                                               placement=placement)
        return new_state, toks

    return step, (state,), placement


__all__ = ["COMPUTE_DTYPE", "Shaped", "batch_shardings",
           "build_serve_cell", "build_train_cell", "cache_shardings",
           "train_state_specs",
           "input_specs", "mv_shardings", "replicate", "run_config",
           "map_leaves", "shard_shape", "shapes_of", "zip_map"]
