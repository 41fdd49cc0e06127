"""Paged flash-decode over the versioned KV pool (K4).

Replaces the Pallas kernel ``paged_decode_pallas`` of
``repro/kernels/decode_attention/kernel.py`` with ``csrc/paged_decode.cu``:
one block per (sequence, kv head), an online softmax over only the pages
that hold visible tokens, float32 arithmetic on float32 or bfloat16 pages,
and no atomics (the output is bit-for-bit reproducible).  The wrapper
dispatches on the device of its inputs: CPU tensors take the plain version
(:func:`repro_torch.kernels.decode_attention.ref.paged_decode_ref`), CUDA
tensors launch the kernel or raise.  ``paged_decode.launches`` counts
kernel launches.

Bound on the H100: bytes — every visible K and V element is read once and
feeds only 2G multiply-adds (G = Hq / Hkv query heads per kv head).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import paged_decode_ref

_DTYPES = (torch.float32, torch.bfloat16)


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, page_table: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """``q`` [B, Hq, D], ``k/v_pages`` [N, PS, Hkv, D], ``page_table``
    i32[B, MP] (``-1`` allowed past each length), ``lengths`` i32[B] ->
    ``[B, Hq, D]`` in ``q``'s dtype; length 0 gives zeros."""
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pages, v_pages, page_table, lengths)
    _build.require_cuda_i32("paged_decode", page_table, lengths)
    B, Hq, D = q.shape
    N, PS, Hkv, Dk = k_pages.shape
    MP = page_table.shape[1]
    if (q.dtype not in _DTYPES or k_pages.dtype != q.dtype
            or v_pages.dtype != q.dtype or v_pages.shape != k_pages.shape
            or Dk != D or Hq % Hkv or page_table.shape != (B, MP)
            or lengths.shape != (B,)
            or not all(t.is_cuda and t.is_contiguous()
                       for t in (q, k_pages, v_pages))):
        raise ValueError("paged_decode: q, k_pages and v_pages must be "
                         "contiguous CUDA tensors of one dtype (float32 or "
                         "bfloat16) with matching heads and head_dim")
    out = torch.empty_like(q)
    err = _build.lib().mvgc_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, N, Hq, Hkv, D, PS, MP, int(q.dtype == torch.bfloat16),
        _build.stream())
    _build.check("mvgc_paged_decode", err)
    paged_decode.launches += 1
    return out


paged_decode.launches = 0
