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
and K6b, ``csrc/flash_backward.cu``).  :func:`bwd_bf16_rounding` bounds
what K6b's bf16 route may differ from :func:`attention_bwd_ref` by, and
:func:`bwd_bf16_margin` holds the route to that limit.
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


def _p_dx(q, k, v, o, do, lse, causal, window, softcap):
    """``P = exp(s - lse)`` on the visible columns (0 elsewhere) and ``dX =
    P (dO V^T - rowsum(dO o)) (1 - tanh^2)``, float32 [B, Hq, T, S]."""
    G = q.shape[1] // k.shape[1]
    s, t, mask = _logits(q, k, causal, window, softcap)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    dof = do.float()
    dp = torch.einsum("bhtd,bhsd->bhts", dof,
                      v.float().repeat_interleave(G, dim=1))
    dx = p * (dp - (dof * o.float()).sum(-1)[..., None])
    if t is not None:
        dx = dx * (1.0 - t * t)
    return p, dx


def _products(p, dx, q, k, do, scale):
    """``(scale dX K, scale dX^T Q, P^T dO)`` of float32 ``q``, ``k``,
    ``do``, the last two summed over the query heads of each KV head."""
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dq = torch.einsum("bhts,bhsd->bhtd", dx,
                      k.repeat_interleave(G, dim=1)) * scale
    dk = torch.einsum("bhts,bhtd->bhsd", dx, q) * scale
    dv = torch.einsum("bhts,bhtd->bhsd", p, do)
    return (dq, dk.view(B, Hkv, G, S, D).sum(2),
            dv.view(B, Hkv, G, S, D).sum(2))


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
    p, dx = _p_dx(q, k, v, o, do, lse, causal, window, softcap)
    dq, dk, dv = _products(p, dx, q.float(), k.float(), do.float(),
                           1.0 / math.sqrt(q.shape[3]))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


#: standard deviations of a sum of rounding errors that
#: :func:`bwd_bf16_rounding` allows: 4 * 2**-8 is about 7 of them
BF16_ROUNDING_SIGMAS = 4.0
#: K6b's bf16 route against :func:`attention_bwd_ref`, besides
#: :func:`bwd_bf16_rounding`: each gradient is rounded to bf16 once (rtol
#: one bf16 step, atol as the bf16 attention kernels are held)
BF16_BWD_TOL = dict(atol=4e-3, rtol=2.0**-7)


def bwd_bf16_rounding(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                      *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0):
    """What rounding P and dX to bf16 for their products (K6b's bf16 route,
    as K6's forward rounds P) can move (dq, dk, dv) by, float32.  Each term
    of a sum, ``scale dX K``, ``scale dX^T Q`` or ``P^T dO``, moves by its
    own rounding error, at most 2**-8 of itself and, rounding to nearest,
    about as often up as down (a standard deviation of 2**-8 / sqrt(3) of
    it), so their sum moves like a random walk:
    ``BF16_ROUNDING_SIGMAS * 2**-8 * sqrt(sum of the squared terms)``,
    about seven standard deviations.  The worst case, 2**-8 times the sum
    of the terms' magnitudes, grows like the number of terms where the sum
    itself grows like its square root, so over thousands of columns it
    would let a tile's share of a gradient go missing unseen."""
    p, dx = _p_dx(q, k, v, o, do, lse, causal, window, softcap)
    squares = _products(p * p, dx * dx, q.float().square(),
                        k.float().square(), do.float().square(),
                        1.0 / q.shape[3])
    return tuple(BF16_ROUNDING_SIGMAS * 2.0**-8 * x.sqrt() for x in squares)


def bwd_bf16_margin(got, want, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
                    lse: torch.Tensor, *, causal: bool = True,
                    window: int = 0, softcap: float = 0.0) -> float:
    """The largest ``|got - want|`` over its limit, across (dq, dk, dv):
    K6b's bf16 route ``got`` is within its limit of the plain gradient
    ``want`` (:func:`attention_bwd_ref` on the same inputs) where this is
    at most 1.  The limit of an entry is ``BF16_BWD_TOL``'s ``atol + rtol
    |want|`` plus its :func:`bwd_bf16_rounding`."""
    bound = bwd_bf16_rounding(q, k, v, o, do, lse, causal=causal,
                              window=window, softcap=softcap)
    tol = BF16_BWD_TOL
    return max(float(((g.float() - w.float()).abs()
                      / (tol["atol"] + tol["rtol"] * w.float().abs() + e)
                      ).max())
               for g, w, e in zip(got, want, bound))
