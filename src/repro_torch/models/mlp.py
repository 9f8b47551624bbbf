"""Gated MLP (SwiGLU family); counterpart of ``repro.models.mlp``.

Over a mesh (``shards``) whose "model" axis splits the hidden dim,
w_gate/w_up are column-parallel and w_down row-parallel (Megatron): the
input goes through "f", each shard computes its slice of the hidden
units, and "g" sums the shards' partial outputs. With the hidden dim
replicated (it does not divide) every shard computes the whole MLP."""

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


def mlp_forward(p, cfg: ArchConfig, x: torch.Tensor,
                shards=None) -> torch.Tensor:
    tp = shards is not None and shards.model_dim("w_down") is not None
    if tp:
        x = shards.f(x)
    act = activation(cfg.act)
    g = act(tok_einsum("bse,ef->bsf", x, p["w_gate"].to(x.dtype)))
    u = tok_einsum("bse,ef->bsf", x, p["w_up"].to(x.dtype))
    y = tok_einsum("bsf,fe->bse", g * u, p["w_down"].to(x.dtype))
    return shards.g(y) if tp else y
