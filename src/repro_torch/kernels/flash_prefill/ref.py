"""Plain PyTorch version of flash prefill attention (port of
``repro.kernels.flash_prefill.ref.attention_ref``).

Dense attention with GQA (query head ``h`` reads kv head ``h // G``), a
causal mask, a sliding window and a tanh logit softcap, computed in float32
(float64 for float64 inputs: the exact answer the float32 routes are held
to) and cast to ``q``'s dtype.  Trap T6: the logits are scaled in float32
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
:func:`fwd_f32_rounding` bounds what any float32 evaluation of K6 (the
plain version, or K6's split-TF32 route) may differ from the exact,
float64 answer by, and :func:`fwd_f32_margin` holds an output to it.
"""
from __future__ import annotations

import math

import torch


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the dtype the plain versions compute in: float64 stays,
    anything else is float32."""
    return x if x.dtype == torch.float64 else x.float()


def _logits(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int,
            softcap: float):
    """(scaled and capped logits [B, Hq, T, S] in :func:`_wide`'s dtype,
    ``tanh(x / cap)`` or None, the visibility mask [T, S])."""
    D, T, S = q.shape[3], q.shape[2], k.shape[2]
    G = q.shape[1] // k.shape[1]
    kf = _wide(k).repeat_interleave(G, dim=1)
    logits = torch.einsum("bhtd,bhsd->bhts", _wide(q), kf) \
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
    vf = _wide(v).repeat_interleave(G, dim=1)
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
    logits, float32 [B, Hq, T] (float64 for float64 inputs; ``+inf`` for
    a row that sees no column), the forward half of the gradient's plain
    version."""
    logits = _masked_logits(q, k, causal, window, softcap)
    lse = torch.logsumexp(logits, dim=-1)
    lse = torch.where(torch.isneginf(lse), math.inf, lse)
    return _attend(logits, v, q.shape[1] // k.shape[1], q.dtype), lse


def _p_dx(q, k, v, o, do, lse, causal, window, softcap):
    """``P = exp(s - lse)`` on the visible columns (0 elsewhere) and ``dX =
    P (dO V^T - rowsum(dO o)) (1 - tanh^2)``, float32 [B, Hq, T, S]."""
    G = q.shape[1] // k.shape[1]
    s, t, mask = _logits(q.float(), k.float(), causal, window, softcap)
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


#: float32's unit roundoff: a rounding to nearest moves a value by at most
#: this share of it
F32_EPS = 2.0**-24
#: the most the split-TF32 route leaves out of one product ``a b``: with
#: ``a = hi + lo`` (``hi`` a's first 11 significant bits, so ``|lo| <
#: 2**-10 |a|``) it forms ``hi.hi + hi.tf32(lo) + tf32(lo).hi``; the
#: tensor core's truncation of ``lo`` to tf32 drops bits below 2**-21 of
#: ``|a|``, so the error is under ``2**-21 + 2**-21 + 2**-20`` (``lo.lo``)
#: of ``|a b|``, always toward zero (a float32 product: 2**-24)
F32_SPLIT_MAX = 2.0**-19
#: the unit of a logit's products and their sum: the larger of float32's
#: 2**-24 and what the split leaves out of a product on average (about
#: 2**-23 for ``lo.lo`` and 0.6 * 2**-23 for each truncated ``lo``:
#: 2**-21.8)
F32_UNIT = 2.0**-22
#: standard deviations of a sum of independent errors that
#: :func:`fwd_f32_rounding` allows, as :data:`BF16_ROUNDING_SIGMAS`
F32_ROUNDING_SIGMAS = 4.0


def fwd_f32_rounding(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """What a float32 evaluation of :func:`attention_ref` (the float32
    plain version, or K6's split-TF32 route) may differ from the exact
    answer by at these inputs: float64 ``[B, Hq, T, D]``, derived from
    float32's rounding, not read off any measured error.

    Let ``x_j = q.k_j / sqrt(D)``, ``s_j = cap tanh(x_j / cap)``, ``p_j``
    the softmax of the visible ``s`` and ``o = sum_j p_j v_j``.  A logit
    error ``ds_j`` moves ``p_j`` by ``p_j (ds_j - sum_i p_i ds_i)``, so
    ``o`` by ``sum_j p_j ds_j (v_j - o)``; an error in a term ``p_j v_j``
    moves ``o`` by itself.

    * The logit: ``|ds_j| <= e_j = F32_UNIT A_j + 8 F32_EPS |x_j| +
      F32_UNIT`` with ``A_j = sum_d |q_d k_jd| / sqrt(D)``.  The first term
      is the products and their sum: the split shrinks each product by
      about F32_UNIT of it (at most ``F32_UNIT |x_j|`` in all), its
      truncations' spread and float32's roundings of the partial sums
      (at most 2**-24 of each, and the tensor cores' truncation 2**-23,
      adding as a random walk) stay well inside ``F32_UNIT A_j``.  The
      second is the logit's own roundings after the sum, each at most
      F32_EPS of ``|x_j| >= |s_j|``: the scale, ``x / cap``, tanh (2 ulps,
      4), ``* cap`` and the exponent's argument ``s log2(e) - m``; tanh's
      slope is at most 1.  The third is the exponential's own error (2
      ulps of the base-2 exp).
    * The terms of P V: each ``p_j v_j`` is off by at most F32_SPLIT_MAX
      of itself.
    * What all terms share, ``COMMON = 4 F32_UNIT`` of ``sum_j p_j
      |v_j|``, added whole: the split's average shrink of every P V
      product (F32_UNIT), the tensor cores' truncating sums (at most
      2**-23 at each of a KV step's four chained products: 2 F32_UNIT),
      and the rescales of O and the division by l (F32_UNIT).

    As :func:`bwd_bf16_rounding` does, the terms' own errors are taken as
    independent, about as often up as down, so they add as a random walk:
    ``F32_ROUNDING_SIGMAS * sqrt(sum_j p_j**2 (e_j**2 (v_j - o)**2 +
    (F32_SPLIT_MAX v_j)**2)) + 4 F32_UNIT sum_j p_j |v_j|``.  At logits
    of about N(0, 12**2) this is about 1.3x float32's 1e-5 limit (atol
    and rtol) in the median entry; where a row's weight sits on one
    column it is far below it, since only the P V term is left there.
    """
    D = q.shape[3]
    G = q.shape[1] // k.shape[1]
    qd, kd = q.double(), k.double()
    vd = v.double().repeat_interleave(G, dim=1)
    x, _, mask = _logits(qd, kd, causal, window, 0.0)
    a = torch.einsum("bhtd,bhsd->bhts", qd.abs(),
                     kd.abs().repeat_interleave(G, dim=1)) / math.sqrt(D)
    s = torch.tanh(x / softcap) * softcap if softcap > 0 else x
    p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1
                      ).nan_to_num(nan=0.0)
    o = torch.einsum("bhts,bhsd->bhtd", p, vd)
    w = (p * (F32_UNIT * a + 8 * F32_EPS * x.abs() + F32_UNIT)).square()
    # sum_j w_j (v_j - o)**2, expanded into three products
    spread = (torch.einsum("bhts,bhsd->bhtd", w, vd.square())
              - 2 * o * torch.einsum("bhts,bhsd->bhtd", w, vd)
              + o.square() * w.sum(-1, keepdim=True)).clamp(min=0)
    terms = F32_SPLIT_MAX**2 * torch.einsum("bhts,bhsd->bhtd", p.square(),
                                            vd.square())
    return (F32_ROUNDING_SIGMAS * (spread + terms).sqrt()
            + 4 * F32_UNIT * torch.einsum("bhts,bhsd->bhtd", p, vd.abs()))


def fwd_f32_margin(got: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, *, causal: bool = True, window: int = 0,
                   softcap: float = 0.0) -> float:
    """The largest ``|got - exact|`` over :func:`fwd_f32_rounding`, where
    ``exact`` is :func:`attention_ref` on float64 copies of the inputs:
    ``got``, a float32 evaluation of K6 on ``q``, ``k``, ``v``, is within
    float32's rounding of the exact answer where this is at most 1."""
    kw = dict(causal=causal, window=window, softcap=softcap)
    exact = attention_ref(q.double(), k.double(), v.double(), **kw)
    bound = fwd_f32_rounding(q, k, v, **kw)
    return float(((got.double() - exact).abs() / bound).max())
