"""Each hand-written kernel's analytic cost from its shapes, and the hooks
through which a kernel wrapper or a collective charges it to an op counter.

A cost is ``(bytes, operations, operation type)``: the bytes the kernel's
function must move (each input read once, each output written once) and
the operations it does, of the type whose peak rate bounds them.
:func:`repro_torch.launch.roofline.bound` turns a cost into the least time
on the H100; ``chip_smoke.py`` phase 3 prints it as ``bound_ms``.  Where
the work depends on the data (found rows, visible tokens), the caller
passes what its inputs need; a dry run, which has no data, passes the most
they could need.

An op counter (:class:`repro_torch.launch.op_cost.OpCounter`) is in
:data:`ACTIVE` while it counts.  A wrapper decorated with :func:`charged`
is then charged its kernel's cost once a call, under the kernel's name,
whatever route it takes (a launch, the plain version on the CPU, or the
empty results of fake tensors), and none of the ops inside it are
counted; with no counter, the decorated call costs one check of
:data:`ACTIVE`.  :func:`collective` does the same for one of the port's
collectives (``dist/overlap.py``).
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import math
from typing import Any, Callable, List, Optional, Tuple, Union

Cost = Tuple[float, float, str]      # (bytes, operations, operation type)

#: the op counters counting now, innermost last
ACTIVE: List[Any] = []

_NULL = contextlib.nullcontext()


def kernel_record(name: str, nbytes: float, flops: float, kind: str
                  ) -> Tuple[Any, ...]:
    return ("kernel", name, float(nbytes), float(flops), kind)


def collective_record(kind: str, result_bytes: float, operand_bytes: float
                      ) -> Tuple[Any, ...]:
    return ("collective", kind, float(result_bytes), float(operand_bytes))


def charged(name: Union[str, Callable[..., str]],
            cost_of: Callable[..., Cost]):
    """Decorate a kernel wrapper: under a counter, each call is charged
    ``cost_of(**arguments)`` once as kernel ``name`` (a string, or a
    function of the arguments), the call's arguments passed by name with
    their defaults; with no counter, the wrapper is called as it is."""
    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not ACTIVE:
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            a = bound.arguments
            label = name if isinstance(name, str) else name(**a)
            with ACTIVE[-1]._scope(kernel_record(label, *cost_of(**a))):
                return fn(*args, **kwargs)
        return call
    return wrap


def collective(kind: str, result_bytes: float, operand_bytes: float = 0.0):
    """Context of one collective of the port: under a counter, charges
    hlo_cost's byte model for ``kind`` once and counts none of the ops
    inside (gloo's, the host copies); otherwise nothing."""
    if not ACTIVE:
        return _NULL
    return ACTIVE[-1]._scope(collective_record(kind, result_bytes,
                                               operand_bytes))


# ---------------------------------------------------------------------------
# the kernels' costs
# ---------------------------------------------------------------------------
def board_bytes(P: int, searches: int) -> int:
    """The bytes of a sorted board of ``P`` entries that ``searches``
    lower-bound searches must read: every entry, or, on a board larger
    than the searches can reach, the ``ceil(log2(P + 1))`` probes of
    each."""
    return 4 * min(P, searches * math.ceil(math.log2(P + 1)))


def sweep_cost(S: int, V: int, R: int, P: int, lanes: bool = True) -> Cost:
    """K1's ``sweep``: the [S, V] slab read and written (ts, succ,
    payload), ``R`` lane ids and masks (``lanes``; every slot without
    them, ``R = S``), freed handles, the board of ``P`` as far as the
    searches reach it (:func:`board_bytes`) and ``now``; ``log2(P)``
    compares per entry swept."""
    swept = (S + (R if lanes else 0)) * V
    nbytes = (S * V * 12 * 2 + (R * 5 if lanes else 0) + R * V * 4
              + board_bytes(P, swept) + 4)
    return nbytes, swept * math.log2(max(P, 1)), "int32"


def compact_cost(R: int, V: int, P: int) -> Cost:
    """K1's parity op ``compact`` over ``R`` rows: 12 bytes an entry read,
    16 written, the mask, the board as far as the searches reach it,
    ``now`` and count."""
    nbytes = (R * V * 4 * 3 + R + board_bytes(P, R * V) + 4
              + R * V * 4 * 4 + 4)
    return nbytes, R * V * (math.log2(max(P, 1)) + 8), "int32"


def needed_cost(S: int, V: int, P: int) -> Cost:
    """K5: ts and succ read, one bool written per entry, the board as far
    as the searches reach it."""
    return (S * V * (4 * 2 + 1) + board_bytes(P, S * V) + 4,
            S * V * math.log2(max(P, 2)), "int32")


def search_cost(B: int, V: int) -> Cost:
    """K3's parity op ``search``: ids and t, one slab row (ts, payload)
    per query, payloads and flags written."""
    return B * 4 * 2 + B * V * 4 * 2 + B * 5, B * V * 2, "int32"


def value_at_cost(B: int, V: int, ids: bool = False) -> Cost:
    """K3's ``value_at`` over ``B`` slots (every slot: no id array, the
    main path), one slab row per query, one value written."""
    return (B * V * 4 * 2 + B * 4 + (B * 4 if ids else 0), B * V * 2,
            "int32")


def search_gather_cost(B: int, V: int, M: int, found: int) -> Cost:
    """K2's parity op: ids and t, slab rows, the ``found`` value rows of
    ``M`` read, rows, payloads and flags written."""
    return (B * 4 * 2 + B * V * 4 * 2 + found * M * 4 + B * (M * 4 + 5),
            B * V * 2, "int32")


def view_cost(B: int, V: int, MP: int, found: int) -> Cost:
    """K2's ``view``: ids, t, slab rows, the ``found`` table rows and
    lengths read, the view's tables and lengths written."""
    return (B * 4 + 4 + B * V * 4 * 2 + found * (MP + 1) * 4
            + B * (MP + 1) * 4, B * V * 2, "int32")


def paged_decode_cost(B: int, Hq: int, Hkv: int, D: int, elt: int,
                      pages: int, visible: int) -> Cost:
    """K4: q read and the output written, lengths, the ``pages`` table
    entries in use, and K and V of the ``visible`` tokens once; two
    multiply-adds a visible token, head dim and query head."""
    nbytes = (2 * B * Hq * D * elt + B * 4 + pages * 4
              + visible * Hkv * D * elt * 2)
    return nbytes, 4.0 * visible * Hq * D, "bf16"


def visible_pairs(T: int, window: int, S: Optional[int] = None,
                  causal: bool = True) -> int:
    """(row, column) pairs a prefill of T tokens attends to: causal over
    itself, or every one of S columns."""
    if not causal:
        return T * S
    if window <= 0:
        return T * (T + 1) // 2
    w = min(window, T)
    return w * (w + 1) // 2 + (T - w) * w


def _kind(elt: int) -> str:
    return "bf16" if elt == 2 else "f32"


def flash_prefill_cost(B: int, Hq: int, Hkv: int, T: int, S: int, D: int,
                       elt: int, window: int = 0, causal: bool = True
                       ) -> Cost:
    """K6: q and the output, k and v read once; two products of a head dim
    over each visible pair and query head, in the inputs' type: for
    float32, ``bound(*cost)`` is the CUDA-core bound of the float32 design
    that the split-TF32 route replaced, and the route's own bound (three
    tf32 products for each of the two) is
    :func:`repro_torch.launch.roofline.flash_prefill_bound` of the cost."""
    nbytes = 2 * (B * Hq * T * D + B * Hkv * S * D) * elt
    ops = 4.0 * B * Hq * D * visible_pairs(T, window, S, causal)
    return nbytes, ops, _kind(elt)


def flash_backward_cost(B: int, Hq: int, Hkv: int, T: int, S: int, D: int,
                        elt: int, window: int = 0, causal: bool = True
                        ) -> Cost:
    """K6b: q, k, v, o, dO and the LSE read once, dq, dk, dv written once;
    five products over the visible pairs.  The operations are the
    function's five products, in the inputs' type: for float32,
    ``bound(*cost)`` is the CUDA-core bound of the float32 design that the
    split-TF32 route replaced, and the route's own bound (three tf32
    products for each of the five) is
    :func:`repro_torch.launch.roofline.flash_backward_bound` of the cost."""
    nbytes = (elt * (3 * B * Hq * T * D + 2 * B * Hkv * S * D
                     + B * Hq * T * D + 2 * B * Hkv * S * D)
              + 4 * B * Hq * T)
    ops = 10.0 * B * Hq * D * visible_pairs(T, window, S, causal)
    return nbytes, ops, _kind(elt)
