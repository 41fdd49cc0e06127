"""Paged flash-decode over the versioned KV pool (K4).

Replaces the Pallas kernel ``paged_decode_pallas`` of
``repro/kernels/decode_attention/kernel.py`` with ``csrc/paged_decode.cu``:
an online softmax over only the pages that hold visible tokens, float32
arithmetic on float32 or bfloat16 pages, NaN for every query head of a
(sequence, kv head) whose visible pages name no page of the pool, zeros
for length 0, and no atomics (the output is bit-for-bit reproducible).  The
wrapper dispatches on the device of its inputs: CPU tensors take the plain
version (:func:`repro_torch.kernels.decode_attention.ref.paged_decode_ref`),
CUDA tensors launch the kernel or raise.

A call runs two kernels (split KV): the split pass streams a fixed chunk of
each sequence's pages per block, one block per (sequence, kv head, split),
and writes partial softmax statistics to scratch that this wrapper
allocates; the combine merges the partials in split order.  The number of
splits comes from :func:`split_plan` on the host (it never reads
``lengths``).  ``paged_decode.launches`` counts wrapper calls, one per call.
Fake tensors (a dry run) get an empty output, and each call is charged
K4's analytic cost (:mod:`repro_torch.kernels.cost`, every page of every
table visible) under an op counter (:mod:`repro_torch.launch.op_cost`).

Bound on the H100: bytes — every visible K and V element is read once and
feeds only 2G multiply-adds (G = Hq / Hkv query heads per kv head), far
under the operations per byte at which the card becomes compute-bound.  So
the kernel stays on the CUDA cores and keeps many bytes in flight: each
lane reads 16-byte vectors and stages its next two steps of K and V in a
``cp.async`` ring in shared memory while it computes on the current one.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build, cost
from repro_torch.kernels.decode_attention.ref import paged_decode_ref

_DTYPES = (torch.float32, torch.bfloat16)
#: the kernel's largest head dim
MAX_HEAD_DIM = 256
#: query heads one block holds in registers (more go to further blocks)
MAX_GROUP = 8
#: tokens of one sequence a split streams at most
MAX_SPLIT_TOKENS = 1024
#: split blocks an SM runs at once (the bf16 kernel at G = 3, D = 128: its
#: registers allow three 128-thread blocks)
RESIDENT_BLOCKS_PER_SM = 3


def split_plan(B: int, Hq: int, Hkv: int, PS: int, MP: int, sms: int) -> int:
    """Splits of each sequence's page table: the number that chunks of
    ``MAX_SPLIT_TOKENS`` tokens ask for, moved to fill a whole number of
    waves (at least one) of ``RESIDENT_BLOCKS_PER_SM`` blocks per SM, since
    a part-filled last wave costs as much as a full one; at most ``MP``,
    and no empty trailing split (chunks are ``ceil(MP / n_split)``
    pages)."""
    if MP <= 0:
        return 1
    blocks = max(1, B * Hkv * -(-(Hq // Hkv) // MAX_GROUP))
    wave = RESIDENT_BLOCKS_PER_SM * sms
    n = -(-MP // max(1, MAX_SPLIT_TOKENS // PS))
    waves = max(1, int(blocks * n / wave + 0.5))
    n = max(1, int(waves * wave / blocks + 0.5))
    chunk = -(-MP // min(n, MP))
    return -(-MP // chunk)


def _paged_decode_cost(q, k_pages, page_table, **_) -> cost.Cost:
    """K4's cost with every page of every table visible."""
    B, Hq, D = q.shape
    MP, PS, Hkv = page_table.shape[1], k_pages.shape[1], k_pages.shape[2]
    return cost.paged_decode_cost(B, Hq, Hkv, D, q.element_size(), B * MP,
                                  B * MP * PS)


@cost.charged("paged_decode", _paged_decode_cost)
def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, page_table: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """``q`` [B, Hq, D], ``k/v_pages`` [N, PS, Hkv, D], ``page_table``
    i32[B, MP] (``-1`` allowed past each length), ``lengths`` i32[B] ->
    ``[B, Hq, D]`` in ``q``'s dtype; length 0 gives zeros."""
    if is_fake(q):
        return q.new_empty(q.shape)
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pages, v_pages, page_table, lengths)
    _build.require_cuda_i32("paged_decode", page_table, lengths)
    B, Hq, D = q.shape
    N, PS, Hkv, Dk = k_pages.shape
    MP = page_table.shape[1]
    if (q.dtype not in _DTYPES or k_pages.dtype != q.dtype
            or v_pages.dtype != q.dtype or v_pages.shape != k_pages.shape
            or Dk != D or not 0 < D <= MAX_HEAD_DIM or Hq % Hkv
            or page_table.shape != (B, MP) or lengths.shape != (B,)
            or not all(t.is_cuda and t.is_contiguous()
                       for t in (q, k_pages, v_pages))):
        raise ValueError("paged_decode: q, k_pages and v_pages must be "
                         "contiguous CUDA tensors of one dtype (float32 or "
                         "bfloat16) with matching heads and head_dim <= "
                         f"{MAX_HEAD_DIM}")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split = split_plan(B, Hq, Hkv, PS, MP, sms)
    out = torch.empty_like(q)
    part_o = torch.empty((B * Hq * n_split * D,), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((B * Hq * n_split * 2,), dtype=torch.float32,
                          device=q.device)
    err = _build.lib().mvgc_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_o.data_ptr(), part_ml.data_ptr(), B, N, Hq, Hkv, D, PS, MP,
        n_split, int(q.dtype == torch.bfloat16), _build.stream())
    _build.check("mvgc_paged_decode", err)
    paged_decode.launches += 1
    return out


paged_decode.launches = 0
