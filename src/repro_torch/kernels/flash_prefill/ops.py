"""Blockwise causal flash attention for prefill (K6).

Replaces the Pallas kernel ``flash_attention_pallas`` of
``repro/kernels/flash_prefill/kernel.py`` with ``csrc/flash_prefill.cu``:
one block per (batch, query head, 64-row query tile) loops over the 64-column
KV tiles in shared memory that the causal mask and the window leave
visible, with an online softmax in float32 on float32 or bfloat16 inputs,
GQA by head index, a tanh logit softcap, any ``S``, head dims up to 256,
and no atomics (two calls give the same bits).  The wrapper dispatches on
the device of its inputs: CPU tensors take the plain version
(:func:`repro_torch.kernels.flash_prefill.ref.attention_ref`), CUDA tensors
launch the kernel or raise.  ``flash_attention.launches`` counts kernel
launches.

Bound on the H100: operations.  A causal prefill does about ``T^2 D``
multiply-adds per query head (``T^2 / 2`` visible pairs, two products each)
against ``2 (Hq + Hkv) T D`` elements moved per batch row.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill.ref import attention_ref

_DTYPES = (torch.float32, torch.bfloat16)
#: the kernel's largest head dim (its widest shared-memory tile)
MAX_HEAD_DIM = 256


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
    if (q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype
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
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _build.lib().mvgc_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, T, S, D, int(causal), int(window), float(softcap),
        int(q.dtype == torch.bfloat16), _build.stream())
    _build.check("mvgc_flash_prefill", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
