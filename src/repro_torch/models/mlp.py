"""Gated MLP (SwiGLU / GeGLU) and the classic two-matrix FFN (port of
``repro.models.mlp``).  ``jax.nn.gelu`` is the tanh form, so ``gelu`` here
is ``approximate="tanh"``.

On a placed state whose ``wu``/``wg`` come split on the hidden dim
(column-split) and ``wd`` on its rows (row-split), as ``tp`` (a
:class:`repro_torch.dist.sharding.ModelAxis`) says, this rank computes its
slice of the hidden activations, and ``tp.g`` sums the partial outputs over the ``model``
ranks (Megatron-LM's MLP, as JAX's GSPMD step computes it)."""
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


def mlp(params: dict, cfg: ModelConfig, x: torch.Tensor, tp=None
        ) -> torch.Tensor:
    """``x`` [B, T, d] -> [B, T, d]; with ``tp``, over this rank's slice
    of the hidden dim when the weights come split (see the module
    docstring)."""
    if tp is not None and "wu" in tp.local:
        return tp.g(mlp_product(params, cfg, tp.f(x)))
    return mlp_product(params, cfg, x)


def mlp_product(params: dict, cfg: ModelConfig, x: torch.Tensor
                ) -> torch.Tensor:
    """The MLP over the hidden slice its weights hold: the output, or on
    split weights this rank's partial sum of it (no collective; a mixture
    of experts adds its shared expert's partial sum to its experts' before
    one sum over the ranks)."""
    u = x @ params["wu"]
    if cfg.gated_mlp:
        h = _act(cfg.act, x @ params["wg"]) * u
    else:
        h = _act(cfg.act, u)
    return h @ params["wd"]
