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

:func:`attention_lse_ref` also returns each row's log-sum-exp, and
:func:`attention_bwd_ref` is the gradient from it: the plain versions of
the two halves of the autograd function in ``ops.py`` (K6 with its LSE,
and K6b, ``csrc/flash_backward.cu``).
"""
from __future__ import annotations

import math

import torch


def _logits(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int,
            softcap: float):
    """(scaled and capped float32 logits [B, Hq, T, S], ``tanh(x / cap)``
    or None, the visibility mask [T, S])."""
    D, T, S = q.shape[3], q.shape[2], k.shape[2]
    G = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(G, dim=1)
    logits = torch.einsum("bhtd,bhsd->bhts", q.float(), kf) \
        * (1.0 / math.sqrt(D))
    t = None
    if softcap > 0:
        t = torch.tanh(logits / softcap)
        logits = t * softcap
    i = torch.arange(T, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window > 0:
        mask &= j > i - window
    return logits, t, mask


def _masked_logits(q, k, causal, window, softcap):
    logits, _, mask = _logits(q, k, causal, window, softcap)
    return logits.masked_fill(~mask, -math.inf)


def _attend(logits, v, G, dtype):
    """Softmax over the masked logits, then the product with ``v``."""
    p = torch.softmax(logits, dim=-1).nan_to_num(nan=0.0)   # unseen rows
    vf = v.float().repeat_interleave(G, dim=1)
    return torch.einsum("bhts,bhsd->bhtd", p, vf).to(dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """``q`` [B, Hq, T, D], ``k``/``v`` [B, Hkv, S, D] -> [B, Hq, T, D]."""
    logits = _masked_logits(q, k, causal, window, softcap)
    return _attend(logits, v, q.shape[1] // k.shape[1], q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      softcap: float = 0.0):
    """:func:`attention_ref` and each row's log-sum-exp of its visible
    logits, float32 [B, Hq, T] (``+inf`` for a row that sees no column),
    the forward half of the gradient's plain version."""
    logits = _masked_logits(q, k, causal, window, softcap)
    lse = torch.logsumexp(logits, dim=-1)
    lse = torch.where(torch.isneginf(lse), math.inf, lse)
    return _attend(logits, v, q.shape[1] // k.shape[1], q.dtype), lse


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                      *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0):
    """The gradient of :func:`attention_ref` at output ``o`` with upstream
    gradient ``do`` and the forward's row log-sum-exp ``lse``: (dq, dk,
    dv), each in its input's dtype (plain version of K6b).  With ``x =
    q.k / sqrt(D)``, ``s = cap tanh(x / cap)`` and ``P = exp(s - lse)`` on
    the visible columns: ``dV = P^T dO``, ``dS = P (dO V^T -
    rowsum(dO o))``, ``dX = dS (1 - tanh^2)``, ``dQ = dX K / sqrt(D)``,
    ``dK = dX^T Q / sqrt(D)``; dK and dV sum over the query heads of each
    KV head."""
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    s, t, mask = _logits(q, k, causal, window, softcap)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    dof = do.float()
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    dv = torch.einsum("bhts,bhtd->bhsd", p, dof)
    dp = torch.einsum("bhtd,bhsd->bhts", dof, vf)
    delta = (dof * o.float()).sum(-1)
    ds = p * (dp - delta[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kf) * scale
    dk = torch.einsum("bhts,bhtd->bhsd", ds, q.float()) * scale

    def per_kv_head(x):
        return x.view(B, Hkv, G, S, D).sum(2)

    return (dq.to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))
