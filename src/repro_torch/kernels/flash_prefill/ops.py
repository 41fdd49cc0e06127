"""Blockwise causal flash attention for prefill (K6).

Replaces the Pallas kernel ``flash_attention_pallas`` of
``repro/kernels/flash_prefill/kernel.py`` with ``csrc/flash_prefill.cu``:
causal attention with GQA by head index, a sliding window, a tanh logit
softcap, any ``S``, head dims up to 256, 0 for a row that sees no column,
and no atomics (two calls give the same bits).  The wrapper dispatches on
the device of its inputs: CPU tensors take the plain version
(:func:`repro_torch.kernels.flash_prefill.ref.attention_ref`), CUDA tensors
launch a kernel or raise.  It routes by dtype, each route a hand-written
kernel:

* ``"wgmma+tma"`` (bfloat16): the FlashAttention-3 shape for Hopper.  A
  block of three warpgroups owns 128 query rows of one head; a producer
  warpgroup loads Q and a ring of K/V tiles by TMA into swizzled shared
  memory, two consumer warpgroups compute ``Q K^T`` and ``P V`` on the
  bf16 tensor cores with ``wgmma`` (P rounded to bf16 in registers, as
  FlashAttention and SDPA do; the row sum ``l`` sums P in float32 before
  the rounding) and run the online softmax in float32 registers.  TMA
  needs rows of a multiple of 16 bytes, so a head dim that is not a
  multiple of 8 is padded with zero dims here and the output sliced back;
  the scale stays ``1/sqrt(D)`` of the real ``D``.
* ``"wgmma-tf32x3"`` (float32): split-TF32 on the tf32 tensor cores, as
  K6b's float32 route (``csrc/flash_tf32.cuh`` holds what the two share):
  ``x = hi + lo`` with ``hi = tf32(x)`` and each product ``hi hi + hi lo +
  lo hi``, about float32's accuracy.  It replaced the first float32
  kernel, on the CUDA cores, which reached 11-36 % of its bound and took
  1.40x float32 SDPA at whisper-tiny's encoder.  A block of two
  warpgroups owns 64 query rows of one head; the warpgroups take
  alternate 32-column KV steps, each with its own ``(m, l, O)`` and its
  own ring of cp.async units, and warpgroup 0 merges the two at the end
  in a fixed order.  ``S = Q K^T`` reads Q's rows from shared memory into
  split registers and K and its ``lo`` copy as they lie; ``P V`` reads
  ``V^T`` and its ``lo`` (tf32 has no transpose bit), its columns in the
  order that makes P's accumulator registers the product's A operand.
  The tensor cores truncate a product's terms to the largest one's
  exponent, so no long sum stays in them: each KV step's ``P V`` starts
  from zero and is added to ``O alpha`` in float32 (K6b's dV left its
  tolerance without this), ``S``'s ``hi hi`` starts from zero in each
  unit of the head dim, and its two correction products sum apart.  This
  wrapper allocates the pre-pass's copies, ``lo(k)``, ``V^T`` and
  ``lo(V^T)`` (48 MiB at gemma2-2b's training layer), and pads a head dim
  that is not 64, 128 or 256 with zero dims (the kernel loads 128-byte
  slices of it); the scale stays ``1/sqrt(D)`` of the real ``D``.
  Bound: its two products three times over at the tf32 rate (495
  TFLOP/s), ``12 B Hq D pairs`` operations
  (:func:`repro_torch.launch.roofline.flash_prefill_bound`).

``flash_attention.launches`` counts kernel launches and
``flash_attention.route_launches`` the launches of each route.  Fake
tensors (a dry run, :mod:`repro_torch.launch.dryrun`) get empty results of
the kernels' shapes, and each call of K6 or K6b is charged its analytic
cost (:mod:`repro_torch.kernels.cost`) under an op counter
(:mod:`repro_torch.launch.op_cost`), whatever route it takes.

Under autograd (grad enabled and ``q``, ``k`` or ``v`` requiring grad) the
call goes through :class:`FlashAttention`, a ``torch.autograd.Function``:
its forward is K6 storing each row's log-sum-exp of the float32 logits
(either route; one K6 launch, counted as above), its backward is K6b
(:func:`flash_attention_backward`, ``csrc/flash_backward.cu``), which
recomputes the probabilities tile by tile from that LSE.  The K6 launch
writes into a fresh tensor through ``ctypes``, so without the Function a
loss through it would get no gradient for q, k and v.  On CPU tensors both
halves take their plain versions (:func:`~.ref.attention_lse_ref`,
:func:`~.ref.attention_bwd_ref`).  Without grad the call is K6 as before,
with no LSE stored.

K6b runs on the tensor cores by dtype (``BWD_ROUTES``), each route a pair
of hand-written kernels in ``csrc/flash_backward.cu``: one sums dK and dV
over the query heads and tiles that see a KV tile, the other dQ over the
KV tiles a query tile sees, both recomputing the logits (7 products where
the backward needs 5).  A design that saved the two products by writing
each KV tile's share of dQ to float32 partials did not beat it on an H100
(``csrc/flash_backward.cu``'s header, ``PERF.md``).  Each element is
summed in a fixed order with no atomics, so two calls give the same bits.

* ``"wgmma-bf16"``: two launches, the dQ kernel (which also writes each
  query row's ``delta = rowsum(dO o)`` and LSE for the other) and then
  the dK/dV kernel, each a block of two consumer warpgroups over 128 rows
  (at D 256 the dK/dV kernel's two share 64 KV rows and split the head
  dim), the other side streamed by TMA through an mbarrier ring, dO, Q and
  K read transposed by wgmma's descriptor (no transposed copies); bf16
  operands, float32 accumulation; P and dX rounded to bf16 for their
  products, dK, dV and dQ rounded once.  Its workspace is delta and the
  LSE over query rows padded to a multiple of 128.  Bound: ``10 B Hq D
  pairs`` operations at the bf16 rate (989 TFLOP/s).
* ``"wgmma-tf32x3"`` (float32): after a pass for delta and a copy pass
  (``Q^T``, ``dO^T``, ``K^T`` and the tf32 ``lo`` halves), the two kernels
  in split-TF32, ``x = hi + lo`` with ``hi = tf32(x)`` and ``hi hi + hi lo
  + lo hi`` per product on the tf32 tensor cores, about float32's accuracy
  (``hi`` is ``x`` itself, whose top 19 bits the tensor cores read; ``lo``
  a copy); at D 256 dK's and dV's kernel splits the head dim, 9 products.
  Bound: three times those operations at the tf32 rate (495 TFLOP/s).

A head dim that is not 64, 128 or 256 is padded with zero dims to the
next of them here (the kernel loads 128-byte slices of it) and the
gradients are written at the real ``D``; the scale stays ``1/sqrt(D)``.
``flash_attention_backward.launches`` counts calls and ``.route_launches``
the calls of each route.

Bound on the H100: operations.  A causal prefill does about ``T^2 D``
multiply-adds per query head (``T^2 / 2`` visible pairs, two products each)
against ``2 (Hq + Hkv) T D`` elements moved per batch row: about 1000
operations per byte at T 2048, D 128, where the bf16 tensor cores and not
device memory are the limit.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build, cost
from repro_torch.kernels.flash_prefill.ref import (attention_bwd_ref,
                                                   attention_lse_ref,
                                                   attention_ref)

#: the kernel of each input dtype
ROUTES = {torch.bfloat16: "wgmma+tma", torch.float32: "wgmma-tf32x3"}
#: K6b's route of each input dtype
BWD_ROUTES = {torch.bfloat16: "wgmma-bf16", torch.float32: "wgmma-tf32x3"}
#: the kernel's largest head dim (its widest shared-memory tile)
MAX_HEAD_DIM = 256


def _tma_ready(t: torch.Tensor, dp: int) -> torch.Tensor:
    """``t`` with its head dim padded with zeros to ``dp`` and its base
    16-byte aligned, as the TMA tensor maps and the cp.async loads
    require."""
    if t.shape[-1] != dp:
        t = F.pad(t, (0, dp - t.shape[-1]))
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int, softcap: float) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q and k/v must be 4-d [B, H, T, D] "
                         "tensors")
    B, Hq, T, D = q.shape
    Bk, Hkv, S, Dk = k.shape
    if (q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype
            or v.shape != k.shape or Bk != B or Dk != D or Hkv == 0
            or Hq % Hkv or not 0 < D <= MAX_HEAD_DIM
            or not all(t.is_cuda and t.is_contiguous() for t in (q, k, v))
            or not (k.device == q.device and v.device == q.device)):
        raise ValueError(
            f"{name}: q, k and v must be contiguous CUDA tensors of "
            "one dtype (float32 or bfloat16) on one device, with Hq a "
            f"multiple of Hkv and head_dim <= {MAX_HEAD_DIM}; got "
            f"q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} {k.dtype}, "
            f"v {tuple(v.shape)} {v.dtype}")
    if window < 0 or softcap < 0:
        raise ValueError(f"{name}: window and softcap must be >= 0")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, softcap: float, lse: bool = False):
    """One K6 launch on CUDA tensors: the output and, when ``lse``, each
    row's log-sum-exp, float32 [B, Hq, T]."""
    _check("flash_attention", q, k, v, window, softcap)
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    route = ROUTES[q.dtype]
    is_bf16 = q.dtype == torch.bfloat16
    dp = -(-D // 8) * 8 if is_bf16 else _head_dim(D)
    q, k, v = (_tma_ready(t, dp) for t in (q, k, v))
    out = torch.empty((B, Hq, T, dp), dtype=q.dtype, device=q.device)
    row_lse = (torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
               if lse else None)
    if out.numel() == 0:
        return out[..., :D], row_lse
    lib = _build.lib()
    # the float32 route's split copies of k and v (bf16 needs none)
    work = None if is_bf16 else torch.empty(
        lib.mvgc_flash_prefill_workspace(B, Hkv, S, dp, 0),
        dtype=torch.uint8, device=q.device)
    err = lib.mvgc_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        row_lse.data_ptr() if lse else None,
        None if work is None else work.data_ptr(),
        B, Hq, Hkv, T, S, dp, int(causal), int(window), float(softcap),
        1.0 / math.sqrt(D), int(is_bf16), _build.stream())
    _build.check("mvgc_flash_prefill", err)
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    return (out if dp == D else out[..., :D].contiguous()), row_lse


def _shapes(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int
            ) -> dict:
    """The arguments of K6's and K6b's cost functions."""
    B, Hq, T, D = q.shape
    return dict(B=B, Hq=Hq, Hkv=k.shape[1], T=T, S=k.shape[2], D=D,
                elt=q.element_size(), window=window, causal=causal)


@cost.charged("flash_prefill", lambda q, k, causal, window, **_:
              cost.flash_prefill_cost(**_shapes(q, k, causal, window)))
def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: int, softcap: float, lse: bool):
    """K6 on any tensors: the output and, when ``lse``, the row LSE.  Fake
    tensors (a dry run) get empty results of the kernel's shapes, CPU
    tensors the plain version, CUDA tensors a launch; each is charged as
    one launch under an op counter."""
    if is_fake(q):
        return q.new_empty(q.shape), (
            q.new_empty(q.shape[:3], dtype=torch.float32) if lse else None)
    if q.device.type == "cpu":
        kw = dict(causal=causal, window=window, softcap=softcap)
        if lse:
            return attention_lse_ref(q, k, v, **kw)
        return attention_ref(q, k, v, **kw), None
    return _launch(q, k, v, causal, window, softcap, lse=lse)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """``q`` [B, Hq, T, D], ``k``/``v`` [B, Hkv, S, D] -> [B, Hq, T, D] in
    ``q``'s dtype.  Query row ``i`` sees columns ``j <= i`` (causal) with
    ``j > i - window`` (window > 0); a row that sees no column gives 0.
    Differentiable through :class:`FlashAttention` when autograd records
    the call."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, softcap)
    return _forward(q, k, v, causal, window, softcap, lse=False)[0]


flash_attention.launches = 0
flash_attention.route_launches = {r: 0 for r in ROUTES.values()}


def _head_dim(D: int) -> int:
    """K6b's padded head dim: 64, 128 or 256."""
    return 64 if D <= 64 else 128 if D <= 128 else 256


@cost.charged(lambda q, **_: "flash_backward" + (
                  "_bf16" if q.dtype == torch.bfloat16 else ""),
              lambda q, k, causal, window, **_:
              cost.flash_backward_cost(**_shapes(q, k, causal, window)))
def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             softcap: float = 0.0):
    """K6b: (dq, dk, dv) of :func:`flash_attention` at output ``o``, upstream
    gradient ``do`` and the forward's row log-sum-exp ``lse`` [B, Hq, T]
    (float32), under the forward's ``causal``, ``window`` and ``softcap``.
    CPU tensors take :func:`~.ref.attention_bwd_ref`; CUDA tensors (bf16
    or float32) launch the kernels of their route (``BWD_ROUTES``), counted
    as one call in ``flash_attention_backward.launches`` and in its
    route's ``route_launches``.  Fake tensors (a dry run) get empty
    gradients; each call is charged as one launch under an op counter, as
    ``flash_backward`` (float32) or ``flash_backward_bf16``."""
    if is_fake(q):
        return q.new_empty(q.shape), k.new_empty(k.shape), \
            v.new_empty(v.shape)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                 window=window, softcap=softcap)
    _check("flash_attention_backward", q, k, v, window, softcap)
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if (o.shape != q.shape or do.shape != q.shape or lse.shape != (B, Hq, T)
            or o.dtype != q.dtype or do.dtype != q.dtype
            or lse.dtype != torch.float32
            or not all(t.is_cuda and t.is_contiguous() and t.device == q.device
                       for t in (o, do, lse))):
        raise ValueError(
            "flash_attention_backward: o and do must be contiguous CUDA "
            f"tensors of q's shape {tuple(q.shape)} and dtype, and lse "
            f"float32 [B, Hq, T]; got o {tuple(o.shape)} {o.dtype}, do "
            f"{tuple(do.shape)} {do.dtype}, lse {tuple(lse.shape)} "
            f"{lse.dtype}")
    route = BWD_ROUTES[q.dtype]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dp = _head_dim(D)
    q, k, v, o, do = (_tma_ready(t, dp) for t in (q, k, v, o, do))
    is_bf16 = int(q.dtype == torch.bfloat16)
    lib = _build.lib()
    work = torch.empty(lib.mvgc_flash_backward_workspace(
        B, Hq, Hkv, T, S, D, is_bf16), dtype=torch.uint8, device=q.device)
    err = lib.mvgc_flash_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, T, S, D, int(causal),
        int(window), float(softcap), 1.0 / math.sqrt(D), is_bf16,
        _build.stream())
    _build.check("mvgc_flash_backward", err)
    flash_attention_backward.launches += 1
    flash_attention_backward.route_launches[route] += 1
    return dq, dk, dv


flash_attention_backward.launches = 0
flash_attention_backward.route_launches = {r: 0
                                           for r in BWD_ROUTES.values()}


class FlashAttention(torch.autograd.Function):
    """K6 with its row LSE forward, K6b backward; plain versions of both
    on the CPU, empty results on fake tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = _forward(q, k, v, causal, window, softcap, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, do.contiguous(), lse, causal=causal, window=window,
            softcap=softcap)
        return dq, dk, dv, None, None, None
