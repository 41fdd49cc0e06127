"""Plain PyTorch version of paged flash-decode (port of
``repro.kernels.decode_attention.ref``).

One query token per sequence attends to its first ``length`` cached tokens,
whose K/V live in the pages its page table names.  Computed in float32 and
cast to ``q``'s dtype.  Table entries past the length (``NO_PAGE = -1``
padding included) are gathered — ``-1`` wraps to the last page, as in the
JAX version — and masked out."""
from __future__ import annotations

import math

import torch


def paged_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, page_table: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """``q`` [B, Hq, D], ``k/v_pages`` [N, PS, Hkv, D], ``page_table``
    i32[B, MP], ``lengths`` i32[B] -> [B, Hq, D]; length 0 gives zeros."""
    B, Hq, D = q.shape
    _, PS, Hkv, _ = k_pages.shape
    MP = page_table.shape[1]
    G = Hq // Hkv
    tbl = page_table.long()
    k = k_pages[tbl].reshape(B, MP * PS, Hkv, D).float()
    v = v_pages[tbl].reshape(B, MP * PS, Hkv, D).float()
    qg = q.reshape(B, Hkv, G, D).float()
    logits = torch.einsum("bjgd,btjd->bjgt", qg, k) * (1.0 / math.sqrt(D))
    pos = torch.arange(MP * PS, device=q.device)
    mask = pos[None, :] < lengths[:, None]                    # [B, T]
    logits = logits.masked_fill(~mask[:, None, None, :], -math.inf)
    p = torch.softmax(logits, dim=-1).nan_to_num(nan=0.0)     # length 0
    out = torch.einsum("bjgt,btjd->bjgd", p, v)
    return out.reshape(B, Hq, D).to(q.dtype)
