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
* ``"cuda-core-f32"`` (float32): the first version, in float32 on the CUDA
  cores (the tensor cores would round float32 to TF32).

``flash_attention.launches`` counts kernel launches and
``flash_attention.route_launches`` the launches of each route.

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

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill.ref import attention_ref

#: the kernel of each input dtype
ROUTES = {torch.bfloat16: "wgmma+tma", torch.float32: "cuda-core-f32"}
#: the kernel's largest head dim (its widest shared-memory tile)
MAX_HEAD_DIM = 256


def _tma_ready(t: torch.Tensor, dp: int) -> torch.Tensor:
    """``t`` with its head dim padded with zeros to ``dp`` and its base
    16-byte aligned, as the TMA tensor maps require."""
    if t.shape[-1] != dp:
        t = F.pad(t, (0, dp - t.shape[-1]))
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """``q`` [B, Hq, T, D], ``k``/``v`` [B, Hkv, S, D] -> [B, Hq, T, D] in
    ``q``'s dtype.  Query row ``i`` sees columns ``j <= i`` (causal) with
    ``j > i - window`` (window > 0); a row that sees none gives 0."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: q and k/v must be 4-d "
                         "[B, H, T, D] tensors")
    B, Hq, T, D = q.shape
    Bk, Hkv, S, Dk = k.shape
    if (q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype
            or v.shape != k.shape or Bk != B or Dk != D or Hkv == 0
            or Hq % Hkv or not 0 < D <= MAX_HEAD_DIM
            or not all(t.is_cuda and t.is_contiguous() for t in (q, k, v))
            or not (k.device == q.device and v.device == q.device)):
        raise ValueError(
            "flash_attention: q, k and v must be contiguous CUDA tensors of "
            "one dtype (float32 or bfloat16) on one device, with Hq a "
            f"multiple of Hkv and head_dim <= {MAX_HEAD_DIM}; got "
            f"q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} {k.dtype}, "
            f"v {tuple(v.shape)} {v.dtype}")
    if window < 0 or softcap < 0:
        raise ValueError("flash_attention: window and softcap must be >= 0")
    route = ROUTES[q.dtype]
    dp = D
    if route == "wgmma+tma":
        dp = -(-D // 8) * 8
        q, k, v = (_tma_ready(t, dp) for t in (q, k, v))
    out = torch.empty((B, Hq, T, dp), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out[..., :D]
    err = _build.lib().mvgc_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, T, S, dp, int(causal), int(window), float(softcap),
        1.0 / math.sqrt(D), int(route == "wgmma+tma"), _build.stream())
    _build.check("mvgc_flash_prefill", err)
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    return out if dp == D else out[..., :D].contiguous()


flash_attention.launches = 0
flash_attention.route_launches = {r: 0 for r in ROUTES.values()}
