"""xLSTM mixers (port of ``repro.models.mlstm``): the mLSTM (matrix memory,
chunkwise-parallel) and the sLSTM (scalar memory, sequential, with the
exponential-gate stabiliser).

The mLSTM's input gate is a log-sigmoid, as in JAX, so every exponent of
the chunkwise form is at most 0.  :func:`mlstm_chunkwise` loops over the
``T / L`` chunks (a Python loop in place of ``lax.scan``: 32 iterations at
T 2048, L 64); inside a chunk everything is ``L x L`` and ``L x dh``
products, and the ``(C, n)`` state crosses chunk boundaries.
:func:`mlstm_decode` is the step recurrence and :func:`slstm` is
sequential over T, as in JAX.  The gate weights ``w_if``, the sLSTM bias
``b`` and every state are float32 whatever the block's dtype.

**On their shards over ``model``** (``tp`` the
:class:`repro_torch.dist.sharding.ModelAxis` of a placed training step or
the :class:`repro_torch.dist.sharding.ServeAxis` of a placed serve state,
as JAX's GSPMD cells split the leaves): the mLSTM's ``w_up``/``w_gate``
come split on the inner width ``di``, ``wq``/``wk``/``wv``/``w_if`` on
heads and ``w_down`` on its rows; the sLSTM's ``wx_s`` and ``wr`` on heads
and ``w_down`` on its rows.  The input enters the column-split products
through ``tp.f``.  This rank computes its ``H / n`` heads: an mLSTM head
reads every column of ``xm = x @ w_up``, so ``xm`` is joined over
``model`` (``tp.join``); the heads' outputs ``h`` are this rank's block of
``di`` (or ``d``: ``H hd`` is the width), the block of columns that its
``z`` and its rows of ``w_down`` hold.  ``ln_out``'s RMS norm runs over the
whole width: the float32 sum of squares is summed over the ranks
(``rms_norm(tp=)``), and this rank scales by its slice of ``ln_out``.
``w_down``'s rows give a partial output that ``tp.g`` sums.  A state
passed in is whole over ``model`` (as JAX's ``cache_shardings`` keeps
it): this rank reads its heads' slice, and returns its heads' new state,
which the serve placement makes whole again.  The sliced ``ln_out`` and
``b`` get each rank's share of their gradient; the placement sums them
over ``model`` (``sharding._SLICED``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, rms_norm

NEG = -1e30


def _heads(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(inner width, heads, head dim) of the mLSTM."""
    di = int(cfg.proj_factor * cfg.d_model)
    return di, cfg.num_heads, max(1, di // cfg.num_heads)


def init_mlstm(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype = torch.float32) -> dict:
    d = cfg.d_model
    di, H, hd = _heads(cfg)
    return {
        "w_up": dense_init(gen, (d, di), dtype=dtype),        # mixer input
        "w_gate": dense_init(gen, (d, di), dtype=dtype),      # output gate z
        "wq": dense_init(gen, (di, H, hd), dtype=dtype),
        "wk": dense_init(gen, (di, H, hd), dtype=dtype),
        "wv": dense_init(gen, (di, H, hd), dtype=dtype),
        "w_if": dense_init(gen, (di, H, 2), dtype=torch.float32),  # i, f
        "ln_out": torch.zeros((di,), dtype=dtype, device=gen.device),
        "w_down": dense_init(gen, (di, d), dtype=dtype),
    }


class MLSTMState(NamedTuple):
    C: torch.Tensor    # [B, H, dk, dv] matrix memory, float32
    n: torch.Tensor    # [B, H, dk] normaliser, float32


def mlstm_init_state(cfg: ModelConfig, batch: int,
                     device: Optional[torch.device] = None) -> MLSTMState:
    _, H, hd = _heads(cfg)
    return _zero_state(batch, H, hd, device)


def _zero_state(B: int, H: int, hd: int, device) -> MLSTMState:
    return MLSTMState(
        C=torch.zeros((B, H, hd, hd), dtype=torch.float32, device=device),
        n=torch.zeros((B, H, hd), dtype=torch.float32, device=device))


def _head_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` [B, T, e] times ``w`` [e, H, k] -> [B, T, H, k]."""
    e, H, k = w.shape
    return (x @ w.reshape(e, H * k)).view(*x.shape[:-1], H, k)


def _block(x: torch.Tensor, dim: int, tp) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (``x`` itself without
    ``tp``)."""
    return x if tp is None else x.chunk(tp.n, dim=dim)[tp.index]


def _heads_of(state, tp):
    """This rank's heads (dim 1) of a state whole over ``model``."""
    if state is None or tp is None:
        return state
    return type(state)(*(_block(x, 1, tp) for x in state))


def _inputs(params: dict, x: torch.Tensor, tp):
    """The mLSTM's ``xm`` (every column of ``di``: joined over the ranks on
    a shard) and ``z`` (this rank's columns)."""
    if tp is None:
        return x @ params["w_up"], x @ params["w_gate"]
    x = tp.f(x)
    return tp.join(x @ params["w_up"], -1), x @ params["w_gate"]


def _qkv_gates(params: dict, cfg: ModelConfig, xm: torch.Tensor):
    q, k, v = (_head_proj(xm, params[w]) for w in ("wq", "wk", "wv"))
    gates = _head_proj(xm.float(), params["w_if"])
    li = F.logsigmoid(gates[..., 0])   # [B, T, H] log input gate (<= 0)
    lf = F.logsigmoid(gates[..., 1])   # [B, T, H] log forget gate (<= 0)
    return q, k, v, li, lf


def _scale(hd: int) -> float:
    """JAX's ``1 / sqrt(hd)`` in float32, as a host number (a float32
    tensor times a Python float multiplies by its float32 value)."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return float(one / torch.sqrt(torch.tensor(hd, dtype=torch.float32)))


def _out(params: dict, cfg: ModelConfig, h: torch.Tensor, z: torch.Tensor,
         x: torch.Tensor, tp=None) -> torch.Tensor:
    """The norm over the whole width, the gate, ``w_down``: the output, or
    on a shard this rank's partial sum, summed over the ranks."""
    h = rms_norm(h, _block(params["ln_out"], 0, tp), cfg.norm_eps, tp)
    out = (h.to(x.dtype) * F.silu(z)) @ params["w_down"]
    return out if tp is None else tp.g(out)


def mlstm_chunkwise(params: dict, cfg: ModelConfig, x: torch.Tensor,
                    state: Optional[MLSTMState] = None, tp=None
                    ) -> Tuple[torch.Tensor, MLSTMState]:
    """Prefill path, chunk-parallel over [B, T, d].  A ragged tail is padded
    with steps of input gate ``exp(NEG) = 0`` and forget gate 1, so the
    state passes through them unchanged and their outputs are dropped.
    ``tp``: on this rank's heads (the module docstring)."""
    B, T, _ = x.shape
    L = min(cfg.mlstm_chunk, T)
    xm, z = _inputs(params, x, tp)
    q, k, v, li, lf = _qkv_gates(params, cfg, xm)
    T_orig, pad = T, (-T) % L
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=NEG)
        lf = F.pad(lf, (0, 0, 0, pad), value=0.0)
        T += pad
    H, hd = q.shape[2], q.shape[3]
    scale = _scale(hd)
    C, n = (_zero_state(B, H, hd, x.device) if state is None
            else _heads_of(state, tp))
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    hs = []
    for c0 in range(0, T, L):
        blk = slice(c0, c0 + L)
        b = torch.cumsum(lf[:, blk], dim=1)                  # [B, L, H]
        lic = li[:, blk]
        qf = q[:, blk].float() * scale
        kf, vf = k[:, blk].float(), v[:, blk].float()
        eb = torch.exp(b)
        # inter-chunk: exp(b_i) q_i C_prev
        inter = torch.einsum("blhk,bhkv->blhv", qf * eb[..., None], C)
        n_inter = eb[..., None] * n[:, None]                 # [B, L, H, dk]
        # intra-chunk decay D_ij = exp(b_i - b_j + li_j), i >= j
        logD = b[:, :, None] - b[:, None, :] + lic[:, None, :, :]
        D = torch.exp(logD.masked_fill(~tri[None, :, :, None], NEG))
        S = torch.einsum("blhk,bmhk->blmh", qf, kf) * D      # [B, L, L, H]
        intra = torch.einsum("blmh,bmhv->blhv", S, vf)
        n_intra = torch.einsum("blmh,bmhk->blhk", D, kf)
        nn_ = n_inter + n_intra
        denom = torch.einsum("blhk,blhk->blh", qf, nn_).abs()
        hs.append((inter + intra) / torch.clamp(denom, min=1.0)[..., None])
        # the state at the chunk's end
        decay_end = torch.exp(b[:, -1])                      # [B, H]
        w_j = torch.exp(b[:, -1][:, None] - b + lic)         # [B, L, H]
        C = decay_end[..., None, None] * C + torch.einsum(
            "blhk,blhv->bhkv", kf * w_j[..., None], vf)
        n = decay_end[..., None] * n + torch.einsum("blh,blhk->bhk", w_j, kf)
    h = torch.cat(hs, dim=1).reshape(B, T, H * hd)[:, :T_orig]
    return _out(params, cfg, h, z, x, tp), MLSTMState(C, n)


def mlstm_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: MLSTMState, tp=None
                 ) -> Tuple[torch.Tensor, MLSTMState]:
    """The step recurrence over [B, T, d] (T = 1 in decode); the state is
    replaced, not written.  ``tp``: on this rank's heads (the module
    docstring)."""
    B, T, _ = x.shape
    xm, z = _inputs(params, x, tp)
    q, k, v, li, lf = _qkv_gates(params, cfg, xm)
    H, hd = q.shape[2], q.shape[3]
    scale = _scale(hd)
    C, n = _heads_of(state, tp)
    hs = []
    for t in range(T):
        qt = q[:, t].float() * scale          # [B, H, dk]
        kt, vt = k[:, t].float(), v[:, t].float()
        f = torch.exp(lf[:, t])[..., None]                   # [B, H, 1]
        i = torch.exp(li[:, t])[..., None]
        C = f[..., None] * C + i[..., None] * kt[..., :, None] \
            * vt[..., None, :]
        n = f * n + i * kt
        denom = torch.einsum("bhk,bhk->bh", qt, n).abs()
        hs.append(torch.einsum("bhk,bhkv->bhv", qt, C)
                  / torch.clamp(denom, min=1.0)[..., None])
    h = torch.stack(hs, dim=1).reshape(B, T, H * hd)
    return _out(params, cfg, h, z, x, tp), MLSTMState(C, n)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def init_slstm(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype = torch.float32) -> dict:
    d = cfg.d_model
    H, hd = cfg.num_heads, d // cfg.num_heads
    return {
        "wx_s": dense_init(gen, (d, H, 4 * hd), dtype=dtype),   # z, i, f, o
        "wr": dense_init(gen, (H, hd, 4 * hd), in_axis=1, dtype=dtype),
        "b": torch.zeros((H, 4 * hd), dtype=torch.float32, device=gen.device),
        "ln_out": torch.zeros((d,), dtype=dtype, device=gen.device),
        "w_down": dense_init(gen, (d, d), dtype=dtype),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor    # [B, H, hd], float32
    n: torch.Tensor    # [B, H, hd]
    m: torch.Tensor    # [B, H, hd] stabiliser
    h: torch.Tensor    # [B, H, hd]


def slstm_init_state(cfg: ModelConfig, batch: int,
                     device: Optional[torch.device] = None) -> SLSTMState:
    return _slstm_zero(batch, cfg.num_heads, cfg.d_model // cfg.num_heads,
                       device)


def _slstm_zero(B: int, H: int, hd: int, device) -> SLSTMState:
    z = torch.zeros((B, H, hd), dtype=torch.float32, device=device)
    return SLSTMState(z, z, torch.full_like(z, NEG), z)


def slstm(params: dict, cfg: ModelConfig, x: torch.Tensor,
          state: Optional[SLSTMState] = None, tp=None
          ) -> Tuple[torch.Tensor, SLSTMState]:
    """Sequential sLSTM over [B, T, d] (exponential gates with the ``m``
    stabiliser); the state is replaced, not written.  ``tp``: on this
    rank's heads (the module docstring): each head's recurrence reads its
    own ``h`` alone, through its block of ``wr``."""
    B, T, d = x.shape
    xproj = _head_proj(x if tp is None else tp.f(x),
                       params["wx_s"]).float()               # [B, T, H, 4hd]
    H, hd = xproj.shape[2], xproj.shape[3] // 4
    c, n, m, h = (_slstm_zero(B, H, hd, x.device) if state is None
                  else _heads_of(state, tp))
    wr = params["wr"].float()
    bias = _block(params["b"], 0, tp)
    hs = []
    for t in range(T):
        g = xproj[:, t] + torch.einsum("bhk,hkg->bhg", h, wr) + bias
        zt, it, ft, ot = torch.chunk(g, 4, dim=-1)           # [B, H, hd]
        zt = torch.tanh(zt)
        ot = torch.sigmoid(ot)
        lf = F.logsigmoid(ft)
        m_new = torch.maximum(lf + m, it)
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(lf + m - m_new)
        c = f_s * c + i_s * zt
        n = f_s * n + i_s
        m = m_new
        h = ot * c / torch.clamp(n.abs(), min=1.0)
        hs.append(h)
    out = torch.stack(hs, dim=1).reshape(B, T, H * hd)
    out = rms_norm(out, _block(params["ln_out"], 0, tp), cfg.norm_eps,
                   tp).to(x.dtype) @ params["w_down"]
    return (out if tp is None else tp.g(out)), SLSTMState(c, n, m, h)

