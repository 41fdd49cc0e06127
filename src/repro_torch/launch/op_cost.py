"""Per-device cost of one step, counted op by op as it is dispatched (the
port's counterpart of ``repro.launch.hlo_cost``).

JAX compiles a step into one optimized per-device HLO module, and
``hlo_cost`` parses that text, because XLA's own ``cost_analysis()`` counts
a while loop's body once.  The port compiles nothing: eager PyTorch
dispatches each aten op as the rank runs it, so the cost is counted there,
by a ``TorchDispatchMode`` (:class:`OpCounter`) around the step, with
``hlo_cost``'s rules (``src/repro/launch/hlo_cost.py:1-22``):

* **FLOPs**: a dot (``mm``, ``bmm``, ``addmm``, ``baddbmm``; ``matmul``,
  ``linear`` and ``einsum`` as they lower to them) costs ``2 |result|
  |contracted|`` (plus ``|result|`` for the add of ``addmm``); a
  reduction ``|input|``; transcendentals 1 flop an element, also counted
  apart (``TRANSCENDENTAL``, hlo_cost's list); data movement
  (``MOVES``, ``GATHERS``, ``UPDATES``, ``CREATION``) none; every other
  op, elementwise arithmetic first, 1 flop an element of its result
  (hlo_cost's elementwise rule and its default).
* **Traffic**: every op reads its operands and writes its results (eager
  ops are unfused, so this is what crosses HBM, and there are no
  ``fused_*`` keys); a gather reads and writes its result only (the rows
  read, not the table), an in-place update its update twice; views,
  ``empty`` and metadata cost nothing (``NO_COST``).
* **Loops**: eager code has none to multiply: the counter sees every
  iteration, every layer, the backward and the checkpoint's recompute,
  as hlo_cost multiplies trip counts and XLA recomputes remat.
* **Kernels**: a wrapper of the port's kernels (``kernels/*/ops.py``)
  charges its kernel's analytic cost (:mod:`repro_torch.kernels.cost`,
  through which a counter is found while it counts) once a call, under
  the kernel's name, whether it launches the kernel, runs the plain
  version on the CPU or only makes its outputs' shapes (fake tensors);
  the ops inside are not counted.  The census keeps launches, flops and bytes per kernel.
* **Collectives**: the port's collectives (``dist/overlap.py``) charge
  hlo_cost's byte model (that of ``dryrun.collective_census``):
  all-reduce 2x its result, all-gather, all-to-all and permute 1x the
  result, reduce-scatter 1x the operand (broadcast 1x the result); the
  gloo ops and host copies inside are not counted.
* **Branches**: a host read of a fake tensor (``bool(t)``, ``.tolist()``)
  has no value.  :meth:`OpCounter.explore` runs a function once for each
  path through its boolean host reads and keeps the path with the most
  FLOPs, as hlo_cost charges a ``conditional`` its larger branch; a read
  of any other dtype raises.

Every op is kept as a record (op, shapes and dtypes in and out; or the
kernel's or collective's charge) with its count, so that
:mod:`repro_torch.launch.reanalyze` can re-cost a saved trace with the
rules as they are now.  The counter also follows the live bytes of the
storages it sees made on its device (``memory``): the peak above the
bytes alive when :meth:`OpCounter.mark_entry` was called is the step's
``temp_bytes``.
"""
from __future__ import annotations

import collections
import contextlib
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.cost import ACTIVE

DOTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot"}
TRANSCENDENTAL = {"exp", "exp2", "log", "log2", "log10", "tanh", "rsqrt",
                  "sqrt", "sigmoid", "sin", "cos", "expm1", "log1p", "erf",
                  "erfc", "erfinv", "silu", "gelu", "softplus",
                  "silu_backward", "gelu_backward", "_softmax",
                  "_log_softmax", "logsumexp"}
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmax",
              "argmin", "prod", "var", "std", "var_mean", "norm",
              "linalg_vector_norm", "cumsum", "cumprod", "all", "any",
              "count_nonzero", "nansum", "logsumexp", "_softmax_backward_data",
              "_log_softmax_backward_data"}
GATHERS = {"index", "embedding", "index_select", "gather", "take",
           "_unsafe_index"}
# in place: the update (the last tensor operand) read and written
UPDATES = {"copy_", "index_put_", "_index_put_impl_"}
CREATION = {"zeros", "ones", "full", "arange", "scalar_tensor", "eye",
            "linspace", "zeros_like", "ones_like", "full_like", "new_zeros",
            "new_ones", "new_full", "fill", "zero"}
MOVES = {"clone", "_to_copy", "cat", "stack", "constant_pad_nd", "flip",
         "roll", "repeat", "scatter", "scatter_add", "scatter_reduce",
         "index_add", "index_copy", "sort", "topk", "masked_scatter",
         "index_fill", "index_put", "embedding_dense_backward",
         "slice_scatter", "select_scatter", "diagonal_scatter",
         "as_strided_scatter", "_copy_from", "_copy_from_and_resize"}
NO_COST = {"view", "_unsafe_view", "_reshape_alias", "reshape", "expand",
           "permute", "transpose", "t", "squeeze", "unsqueeze", "slice",
           "select", "as_strided", "alias", "detach", "split",
           "split_with_sizes", "chunk", "unbind", "narrow", "diagonal",
           "unfold", "view_as_real", "view_as_complex", "expand_as",
           "lift_fresh", "empty", "empty_like", "empty_strided",
           "new_empty", "new_empty_strided", "_local_scalar_dense",
           "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
           "is_same_size", "_has_compatible_shallow_copy_type", "set_",
           "resize_", "device", "item", "_to_dense", "record_stream",
           "is_nonzero"}
# not recorded: the c10d ops are gloo's (the port's collective functions
# charge them), prim's are metadata
NO_COST_NAMESPACES = {"c10d", "_c10d_functional", "prim"}
COLLECTIVE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0,
                     "all-to-all": 1.0, "collective-permute": 1.0,
                     "broadcast": 1.0, "reduce-scatter": 0.0}

# (shape, dtype name) of one tensor of a record
TensorSpec = Tuple[Tuple[int, ...], str]
Record = Tuple[Any, ...]


def _itemsize(dtype: str) -> int:
    return getattr(torch, dtype).itemsize


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _bytes(specs) -> int:
    return sum(_numel(s) * _itemsize(d) for s, d in specs)


def _elems(specs) -> int:
    return sum(_numel(s) for s, _ in specs)


def _tensors(x, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors of an op's arguments or results, in order (an op's
    arguments nest only in lists, tuples and dicts)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


_DTYPE_NAMES: Dict[torch.dtype, str] = {}


def _specs(values) -> Tuple[TensorSpec, ...]:
    out = []
    for t in _tensors(values, []):
        name = _DTYPE_NAMES.get(t.dtype)
        if name is None:
            name = _DTYPE_NAMES[t.dtype] = str(t.dtype).replace("torch.", "")
        out.append((tuple(t.shape), name))
    return tuple(out)


def op_record(func, args, kwargs, out) -> Record:
    """The record of one dispatched op: (namespace, name, operands,
    results)."""
    ns, name = func._schema.name.split("::")
    return ("op", ns, name, _specs((args, kwargs)), _specs(out))


def cost(record: Record) -> Dict[str, float]:
    """flops, traffic_bytes and transcendentals of one record, by the rules
    of the module docstring."""
    out = {"flops": 0.0, "traffic_bytes": 0.0, "transcendentals": 0.0}
    if record[0] == "kernel":
        _, _, nbytes, flops, _ = record
        out.update(flops=flops, traffic_bytes=nbytes)
        return out
    if record[0] == "collective":
        _, _, res_b, opd_b = record
        out["traffic_bytes"] = res_b + opd_b
        return out
    _, ns, name, ins, outs = record
    if ns in NO_COST_NAMESPACES or name in NO_COST:
        return out
    base = name[:-1] if name.endswith("_") and name not in UPDATES else name
    res_e, res_b = _elems(outs), _bytes(outs)
    traffic = _bytes(ins) + res_b
    flops = trans = 0.0
    if base in DOTS:
        lhs = ins[1] if base.startswith("add") or base == "baddbmm" else ins[0]
        k = lhs[0][-1] if lhs[0] else 1
        flops = 2.0 * res_e * k + (res_e if base.startswith(("add", "badd"))
                                   else 0)
    elif name in UPDATES:
        traffic = 2.0 * _bytes(ins[-1:])
    elif base in GATHERS:
        traffic = 2.0 * res_b
    elif base in CREATION:
        traffic = res_b
    elif base in MOVES:
        pass
    elif base in TRANSCENDENTAL:
        flops = trans = float(res_e)
        if base in REDUCTIONS:               # logsumexp
            flops = trans = float(_elems(ins[:1]))
    elif base in REDUCTIONS:
        flops = float(_elems(ins[:1]))
    else:                                    # elementwise, and the default
        flops = float(res_e)
    out.update(flops=flops, traffic_bytes=traffic, transcendentals=trans)
    return out


def analyze(trace: Dict[Record, int]) -> Dict[str, Any]:
    """``analyze_hlo``'s keys that mean something in the port (``flops``,
    ``traffic_bytes``, ``transcendentals``, ``collectives``,
    ``collective_bytes``) and ``kernels``, the census kernel -> launches,
    flops and bytes, from a trace of record -> count."""
    tot = {"flops": 0.0, "traffic_bytes": 0.0, "transcendentals": 0.0}
    coll: Dict[str, Dict[str, float]] = {}
    kern: Dict[str, Dict[str, float]] = {}
    for rec, n in trace.items():
        c = cost(rec)
        for k in tot:
            tot[k] += n * c[k]
        if rec[0] == "collective":
            _, kind, res_b, opd_b = rec
            d = coll.setdefault(kind, {"count": 0, "bytes": 0.0})
            d["count"] += n
            d["bytes"] += n * (COLLECTIVE_FACTOR[kind] * res_b
                               + (opd_b if kind == "reduce-scatter" else 0.0))
        elif rec[0] == "kernel":
            d = kern.setdefault(rec[1], {"launches": 0, "flops": 0.0,
                                         "bytes": 0.0})
            d["launches"] += n
            d["flops"] += n * rec[3]
            d["bytes"] += n * rec[2]
    return {**tot, "collectives": coll, "kernels": kern,
            "collective_bytes": sum(v["bytes"] for v in coll.values())}


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------
# op -> (index, name) of the arguments its schema writes in place
_WRITES: Dict[Any, List[Tuple[int, str]]] = {}


def active() -> Optional["OpCounter"]:
    """The innermost counter counting now, if any."""
    return ACTIVE[-1] if ACTIVE else None


class DataDependentRead(RuntimeError):
    """A host read of a fake tensor that is not a boolean: no path to
    explore."""


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is entered (see the module
    docstring).  ``device`` names the device type whose storages count
    toward ``memory`` (the card's, ``"cuda"``, in a dry run on the card).
    The boolean host reads of fake tensors are answered inside
    :meth:`explore` only, which walks every answer."""

    def __init__(self, device: str = "cuda"):
        super().__init__()
        self.device = device
        self.script: List[bool] = []
        self.made: List[bool] = []
        self.trace: Dict[Record, int] = collections.Counter()
        self._depth = 0
        self._exploring = False
        # live storages: key -> bytes; the finalizers drop them
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.entry_bytes = 0
        self._entry: Dict[int, int] = {}
        self._written: set = set()

    # -- entering -------------------------------------------------------
    def __enter__(self):
        ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            ACTIVE.remove(self)

    @contextlib.contextmanager
    def _scope(self, record: Record):
        if self._depth == 0:
            self.trace[record] += 1
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1

    # -- memory ---------------------------------------------------------
    def _free(self, key: int, n: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live_bytes -= n

    def _track(self, out) -> None:
        for t in _tensors(out, []):
            if t.device.type != self.device:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key, n)

    def mark_entry(self, args: Dict[int, int]) -> None:
        """The step starts with ``args`` (storage key -> bytes) alive: the
        trace restarts empty (what made the arguments is not the step's),
        the peak restarts from the bytes alive now, and the writes into
        ``args`` are followed from now (:attr:`written_entry_bytes`)."""
        self.trace = collections.Counter()
        self.entry_bytes = self.peak_bytes = self.live_bytes
        self._entry = dict(args)
        self._written = set()

    @property
    def written_entry_bytes(self) -> int:
        """The bytes of the step's arguments it wrote in place."""
        return sum(self._entry[k] for k in self._written)

    def _note_writes(self, func, args, kwargs) -> None:
        if func not in _WRITES:
            _WRITES[func] = [(i, a.name) for i, a in enumerate(
                func._schema.arguments)
                if a.alias_info is not None and a.alias_info.is_write]
        for i, name in _WRITES[func]:
            v = args[i] if i < len(args) else kwargs.get(name)
            for t in _tensors(v, []):
                key = t.untyped_storage()._cdata
                if key in self._entry:
                    self._written.add(key)

    @property
    def temp_bytes(self) -> int:
        """The peak of live bytes since :meth:`mark_entry`, above the
        bytes alive then."""
        return self.peak_bytes - self.entry_bytes

    # -- dispatch -------------------------------------------------------
    def _decide(self, t) -> bool:
        if not self._exploring:
            raise DataDependentRead(
                f"a host read of a fake tensor {tuple(t.shape)} outside "
                "OpCounter.explore")
        if t.dtype != torch.bool:
            raise DataDependentRead(
                f"a host read of a fake {t.dtype} tensor {tuple(t.shape)}: "
                "the dry run explores boolean reads only")
        i = len(self.made)
        v = bool(self.script[i]) if i < len(self.script) else False
        self.made.append(v)
        return v

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func is torch.ops.aten._local_scalar_dense.default
                and _is_fake(args[0])
                and getattr(args[0], "constant", None) is None):
            return self._decide(args[0])
        out = func(*args, **kwargs)
        if self._depth == 0 and func.namespace not in NO_COST_NAMESPACES:
            self.trace[op_record(func, args, kwargs, out)] += 1
        if self._entry:
            self._note_writes(func, args, kwargs)
        self._track(out)
        return out

    # -- paths through host reads ---------------------------------------
    def explore(self, fn: Callable[[], Any]) -> Any:
        """Inside this counter: run ``fn()`` once for each path through its
        boolean host reads of fake tensors (all False first, then depth
        first), and keep the trace of the path with the most FLOPs, whose
        result is returned.  Real tensors are read and take one path."""
        saved, self._exploring = (self.trace, self.script, self.made), True
        best, script = None, []
        try:
            while True:
                self.trace, self.script, self.made = (
                    collections.Counter(), script, [])
                out = fn()
                flops = analyze(self.trace)["flops"]
                if best is None or flops > best[0]:
                    best = (flops, self.trace, out)
                script = list(self.made)
                while script and script[-1]:
                    script.pop()
                if not script:
                    break
                script[-1] = True
        finally:
            self.trace, self.script, self.made = saved
            self._exploring = False
        for rec, n in best[1].items():
            self.trace[rec] += n
        return best[2]

    def result(self) -> Dict[str, Any]:
        """:func:`analyze` of the trace so far."""
        return analyze(self.trace)
