"""Rotary position embeddings (supports partial-dim rotary for MLA);
counterpart of ``repro.models.rope``."""

from __future__ import annotations

import torch


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    """(dim/2,) inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, dim) or (..., seq, dim); positions: (..., seq)."""
    dim = x.shape[-1]
    inv = rope_freqs(dim, theta, x.device)                  # (dim/2,)
    ang = positions[..., None].to(torch.float32) * inv      # (..., seq, dim/2)
    if x.dim() == ang.dim() + 1:                            # heads axis
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
