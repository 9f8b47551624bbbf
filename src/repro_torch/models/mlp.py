"""Gated MLP (SwiGLU family); counterpart of ``repro.models.mlp``."""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from .common import ParamCollector, activation, tok_einsum


def init_mlp(col: ParamCollector, cfg: ArchConfig, prefix: str = "mlp",
             d_ff: int = 0):
    e = cfg.d_model
    f = d_ff or cfg.d_ff
    col.param(f"{prefix}/w_gate", (e, f), ("embed", "mlp"))
    col.param(f"{prefix}/w_up", (e, f), ("embed", "mlp"))
    col.param(f"{prefix}/w_down", (f, e), ("mlp", "embed"))


def mlp_forward(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    act = activation(cfg.act)
    g = act(tok_einsum("bse,ef->bsf", x, p["w_gate"].to(x.dtype)))
    u = tok_einsum("bse,ef->bsf", x, p["w_up"].to(x.dtype))
    return tok_einsum("bsf,fe->bse", g * u, p["w_down"].to(x.dtype))
