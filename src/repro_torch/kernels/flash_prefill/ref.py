"""Plain PyTorch version of flash prefill attention (port of
``repro.kernels.flash_prefill.ref.attention_ref``).

Dense attention with GQA (query head ``h`` reads kv head ``h // G``), a
causal mask, a sliding window and a tanh logit softcap, computed in float32
and cast to ``q``'s dtype.  Trap T6: the logits are scaled in float32
after the product, as in the Pallas kernel and ``attention_ref`` (not in
``q``'s dtype before it, as ``_xla_flash`` does).  Query row ``i`` sees key
column ``j`` when ``j <= i`` (causal) and ``j > i - window`` (window > 0); a row
that sees no column gives 0, as the kernel's ``l == 0`` guard does (with
``T == S`` every row sees at least itself).
"""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """``q`` [B, Hq, T, D], ``k``/``v`` [B, Hkv, S, D] -> [B, Hq, T, D]."""
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    logits = torch.einsum("bhtd,bhsd->bhts", q.float(), kf) \
        * (1.0 / math.sqrt(D))
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    i = torch.arange(T, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window > 0:
        mask &= j > i - window
    logits = logits.masked_fill(~mask, -math.inf)
    p = torch.softmax(logits, dim=-1).nan_to_num(nan=0.0)   # unseen rows
    return torch.einsum("bhts,bhsd->bhtd", p, vf).to(q.dtype)
