"""Gated MLP (SwiGLU / GeGLU) and the classic two-matrix FFN (port of
``repro.models.mlp``).  ``jax.nn.gelu`` is the tanh form, so ``gelu`` here
is ``approximate="tanh"``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init


def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype = torch.float32, d_ff=None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {}
    if cfg.gated_mlp:
        p["wg"] = dense_init(gen, (d, f), dtype=dtype)
    p["wu"] = dense_init(gen, (d, f), dtype=dtype)
    p["wd"] = dense_init(gen, (f, d), dtype=dtype)
    return p


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name in ("gelu", "geglu"):
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def mlp(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """``x`` [B, T, d] -> [B, T, d]."""
    u = x @ params["wu"]
    if cfg.gated_mlp:
        h = _act(cfg.act, x @ params["wg"]) * u
    else:
        h = _act(cfg.act, u)
    return h @ params["wd"]
