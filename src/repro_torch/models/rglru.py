"""Griffin/RecurrentGemma recurrent block (port of ``repro.models.rglru``):
linear projection -> causal depthwise conv1d -> RG-LRU -> gated output.

RG-LRU, a gated linear recurrence per channel:

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gate matrices ``wa``, ``wx``, their biases and ``lambda`` are float32
whatever the block's dtype, and so is the carried state, as in JAX.  The
prefill pass (:func:`rglru`) scans the time axis in log depth, as JAX's
``lax.associative_scan`` does: ``ceil(log2 T)`` passes of the combine
``(a1 a2, a2 b1 + b2)`` over whole tensors (a Hillis-Steele scan), never a
Python loop over T.  Its float32 products run in another order than
JAX's, so it agrees with JAX to rounding, not to the bit.  Decode
(:func:`rglru_decode`) is one step carrying ``(h, conv window)``.

**On the width shard** (``tp`` the
:class:`repro_torch.dist.sharding.ModelAxis` of a placed training step,
or the :class:`repro_torch.dist.sharding.ServeAxis` of a placed serve
state, as JAX's GSPMD step and its decode and prefill cells split
``w_in``/``w_gate`` on columns, ``w_out`` on rows and, at serve time,
``h`` and ``conv`` on the width): this rank computes ``u``, the gate, the
depthwise conv and the recurrence on its ``w / n`` channels, with its
slice of the replicated per-channel leaves.  The input enters the
column-split products through ``tp.f``.  The gates multiply by the
replicated ``wa``/``wx`` [w, w], which read every channel of ``u``: ``u``
is joined over ``model`` (``tp.join``, whose backward sums the gradient
over the ranks and keeps this rank's channels), and this rank keeps its
columns of ``wa``/``wx``.  In training each rank's gradient of those
sliced leaves is its channels' only; the placement sums them over
``model`` (``sharding._SLICED``).  ``w_out``'s rows give a partial output
that ``tp.g`` sums.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init

LRU_C = 8.0


def init_rglru(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype = torch.float32) -> dict:
    d, dev = cfg.d_model, gen.device
    w = cfg.rnn_width or d
    # Lambda so that a = exp(-c softplus(Lambda)) is uniform in [0.9, 0.999]
    u = torch.empty((w,), dtype=torch.float32, device=dev).uniform_(
        0.9, 0.999, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(u) / LRU_C))
    return {
        "w_in": dense_init(gen, (d, w), dtype=dtype),
        "w_gate": dense_init(gen, (d, w), dtype=dtype),
        "conv_w": dense_init(gen, (cfg.conv_width, w), dtype=dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=dev),
        "wa": dense_init(gen, (w, w), dtype=torch.float32),
        "ba": torch.zeros((w,), dtype=torch.float32, device=dev),
        "wx": dense_init(gen, (w, w), dtype=torch.float32),
        "bx": torch.zeros((w,), dtype=torch.float32, device=dev),
        "lambda": lam,
        "w_out": dense_init(gen, (w, d), dtype=dtype),
    }


class RGLRUState(NamedTuple):
    h: torch.Tensor       # [B, w] recurrent state, float32
    conv: torch.Tensor    # [B, conv_width - 1, w] trailing conv inputs, f32


def rglru_init_state(cfg: ModelConfig, batch: int,
                     device: Optional[torch.device] = None) -> RGLRUState:
    w = cfg.rnn_width or cfg.d_model
    return RGLRUState(
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, w), dtype=torch.float32,
                         device=device))


def _conv1d(params: dict, cfg: ModelConfig, u: torch.Tensor,
            conv_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv by shifted adds; returns (out, new_state).  The
    carried state joins the input in the input's dtype; the new state is
    the last ``W - 1`` inputs in float32."""
    W = cfg.conv_width
    cw = params["conv_w"]                                    # [W, w]
    if conv_state is None:
        hist = F.pad(u, (0, 0, W - 1, 0))
    else:
        hist = torch.cat([conv_state.to(u.dtype), u], dim=1)
    n = hist.shape[1]
    out = hist[:, W - 1:n] * cw[W - 1]
    for j in range(1, W):
        out = out + hist[:, W - 1 - j:n - j] * cw[W - 1 - j]
    out = out + params["conv_b"]
    # a copy: a view would keep the whole history alive in the state
    return out, hist[:, -(W - 1):].to(torch.float32, copy=True)


def _gates(params: dict, u: torch.Tensor, tp=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of the recurrence ``h_t = a_t h_{t-1} + b_t``, float32.
    With ``tp``, ``u`` is this rank's channels and ``params`` its
    channels' slices (:func:`_channels`): the gate products read ``u``
    joined over the ranks."""
    uf = u.float()
    whole = tp.join(u, -1).float() if tp is not None else uf
    r = torch.sigmoid(whole @ params["wa"] + params["ba"])
    i = torch.sigmoid(whole @ params["wx"] + params["bx"])
    log_a = -LRU_C * F.softplus(params["lambda"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=0.0)) \
        * (i * uf)
    return a, b


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` over dim 1 from ``h_{-1} = 0``, in
    ``ceil(log2 T)`` passes: after the pass of stride ``s`` each position
    holds the combine of the last ``2 s`` steps ending there."""
    T = a.shape[1]
    s = 1
    while s < T:
        b = torch.cat([b[:, :s], torch.addcmul(b[:, s:], a[:, s:],
                                               b[:, :-s])], dim=1)
        if 2 * s < T:
            a = torch.cat([a[:, :s], a[:, :-s] * a[:, s:]], dim=1)
        s *= 2
    return b


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")        # jax.nn.gelu's tanh form


def _channels(params: dict, tp) -> dict:
    """``params`` on this rank's channels when ``tp`` says that
    ``w_in``/``w_gate``/``w_out`` came as its width shard: its slice of the
    per-channel leaves and its columns of ``wa``/``wx`` (the replicated
    leaves, views); ``params`` as they are otherwise."""
    if tp is None:
        return params
    w = params["w_in"].shape[1]
    cols = slice(tp.index * w, (tp.index + 1) * w)
    out = dict(params)
    out["conv_w"] = params["conv_w"][:, cols]
    out["wa"], out["wx"] = params["wa"][:, cols], params["wx"][:, cols]
    for name in ("conv_b", "ba", "bx", "lambda"):
        out[name] = params[name][cols]
    return out


def _out(params: dict, y: torch.Tensor, tp) -> torch.Tensor:
    """``y`` times ``w_out``; on the width shard, summed over the ranks."""
    out = y @ params["w_out"]
    return tp.g(out) if tp is not None else out


def rglru(params: dict, cfg: ModelConfig, x: torch.Tensor,
          state: Optional[RGLRUState] = None, tp=None
          ) -> Tuple[torch.Tensor, RGLRUState]:
    """[B, T, d] -> [B, T, d] and the state after the last step: the
    log-depth scan, a carried state folded into step 0.  ``tp``: on the
    width shard (the module docstring)."""
    params = _channels(params, tp)
    xin = tp.f(x) if tp is not None else x
    u = xin @ params["w_in"]
    gate = _gelu(xin @ params["w_gate"])
    u, conv_new = _conv1d(params, cfg, u, None if state is None
                          else state.conv)
    a, b = _gates(params, u, tp)                             # [B, T, w]
    if state is not None:
        b = torch.cat([(b[:, 0] + a[:, 0] * state.h)[:, None], b[:, 1:]],
                      dim=1)
    h = _scan(a, b)
    out = _out(params, (h * gate.float()).to(x.dtype), tp)
    # the last step copied: a view would keep all T steps alive in the
    # state (0.5 GiB a layer at recurrentgemma-9b's prefill)
    return out, RGLRUState(h=h[:, -1].clone(), conv=conv_new)


def rglru_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: RGLRUState, tp=None
                 ) -> Tuple[torch.Tensor, RGLRUState]:
    """One decode step ([B, 1, d]); the state is replaced, not written.
    ``tp``: on the width shard (the module docstring)."""
    params = _channels(params, tp)
    xin = tp.f(x) if tp is not None else x
    u = xin @ params["w_in"]
    gate = _gelu(xin @ params["w_gate"])
    u, conv_new = _conv1d(params, cfg, u, state.conv)
    a, b = _gates(params, u, tp)                             # [B, 1, w]
    h = a[:, 0] * state.h + b[:, 0]
    out = _out(params, (h[:, None] * gate.float()).to(x.dtype), tp)
    return out, RGLRUState(h=h, conv=conv_new)

