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
    return MLSTMState(
        C=torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        n=torch.zeros((batch, H, hd), dtype=torch.float32, device=device))


def _head_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` [B, T, e] times ``w`` [e, H, k] -> [B, T, H, k]."""
    e, H, k = w.shape
    return (x @ w.reshape(e, H * k)).view(*x.shape[:-1], H, k)


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
         x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["ln_out"], cfg.norm_eps)
    return (h.to(x.dtype) * F.silu(z)) @ params["w_down"]


def mlstm_chunkwise(params: dict, cfg: ModelConfig, x: torch.Tensor,
                    state: Optional[MLSTMState] = None
                    ) -> Tuple[torch.Tensor, MLSTMState]:
    """Prefill path, chunk-parallel over [B, T, d].  A ragged tail is padded
    with steps of input gate ``exp(NEG) = 0`` and forget gate 1, so the
    state passes through them unchanged and their outputs are dropped."""
    B, T, _ = x.shape
    L = min(cfg.mlstm_chunk, T)
    xm = x @ params["w_up"]
    z = x @ params["w_gate"]
    q, k, v, li, lf = _qkv_gates(params, cfg, xm)
    T_orig, pad = T, (-T) % L
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=NEG)
        lf = F.pad(lf, (0, 0, 0, pad), value=0.0)
        T += pad
    H, hd = q.shape[2], q.shape[3]
    scale = _scale(hd)
    if state is None:
        state = mlstm_init_state(cfg, B, x.device)
    C, n = state.C, state.n
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
    return _out(params, cfg, h, z, x), MLSTMState(C, n)


def mlstm_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: MLSTMState) -> Tuple[torch.Tensor, MLSTMState]:
    """The step recurrence over [B, T, d] (T = 1 in decode); the state is
    replaced, not written."""
    B, T, _ = x.shape
    xm = x @ params["w_up"]
    z = x @ params["w_gate"]
    q, k, v, li, lf = _qkv_gates(params, cfg, xm)
    H, hd = q.shape[2], q.shape[3]
    scale = _scale(hd)
    C, n = state.C, state.n
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
    return _out(params, cfg, h, z, x), MLSTMState(C, n)


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
    H, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    z = torch.zeros((batch, H, hd), dtype=torch.float32, device=device)
    return SLSTMState(z, z, torch.full_like(z, NEG), z)


def slstm(params: dict, cfg: ModelConfig, x: torch.Tensor,
          state: Optional[SLSTMState] = None
          ) -> Tuple[torch.Tensor, SLSTMState]:
    """Sequential sLSTM over [B, T, d] (exponential gates with the ``m``
    stabiliser); the state is replaced, not written."""
    B, T, d = x.shape
    if state is None:
        state = slstm_init_state(cfg, B, x.device)
    xproj = _head_proj(x, params["wx_s"]).float()            # [B, T, H, 4hd]
    wr = params["wr"].float()
    c, n, m, h = state
    hs = []
    for t in range(T):
        g = xproj[:, t] + torch.einsum("bhk,hkg->bhg", h, wr) + params["b"]
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
    out = torch.stack(hs, dim=1).reshape(B, T, d)
    out = rms_norm(out, params["ln_out"], cfg.norm_eps).to(x.dtype)
    return out @ params["w_down"], SLSTMState(c, n, m, h)

