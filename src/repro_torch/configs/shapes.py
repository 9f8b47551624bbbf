"""Assigned input shapes and abstract input specs (counterpart of
``repro.configs.shapes``).

    train_4k      seq_len=4096    global_batch=256   (training)
    prefill_32k   seq_len=32768   global_batch=32    (inference-prefill)
    decode_32k    seq_len=32768   global_batch=128   (one-token decode,
                                                      KV cache of seq_len)
    long_500k     seq_len=524288  global_batch=1     (long-context decode)

``long_500k`` is restricted to sub-quadratic archs (SSM / hybrid / SWA).
The abstract specs are tensors on the ``meta`` device: shapes and dtypes,
no allocation (where the JAX package returns ``ShapeDtypeStruct``s).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str       # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Is this (arch, shape) cell runnable? (Skips mandated by the spec.)"""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full quadratic attention at 524288-token context "
                       "has no sub-quadratic path (skip mandated by the "
                       "assignment; see DESIGN.md §Arch-applicability)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ArchConfig, shape: ShapeSpec,
                      seq: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Abstract train/prefill batch. seq_len counts the decoder/backbone
    sequence; VLM prefixes frontend_seq patch embeddings within it.
    ``seq`` overrides the token length while keeping frame-stub lengths
    pinned to the full shape."""
    b, s = shape.batch, seq or shape.seq
    if cfg.family == "audio":
        return {
            "frames": _meta((b, min(cfg.enc_seq, shape.seq), cfg.d_model),
                            torch.bfloat16),
            "tokens": _meta((b, s), torch.int32),
            "labels": _meta((b, s), torch.int32),
        }
    if cfg.family == "vlm" and cfg.frontend_seq:
        f = cfg.frontend_seq
        return {
            "frontend": _meta((b, f, cfg.d_model), torch.bfloat16),
            "tokens": _meta((b, s - f), torch.int32),
            "labels": _meta((b, s - f), torch.int32),
        }
    return {"tokens": _meta((b, s), torch.int32),
            "labels": _meta((b, s), torch.int32)}


def decode_specs(model, cfg: ArchConfig, shape: ShapeSpec):
    """Abstract (cache, tokens, cache_len) for a decode step: the cache
    built on the meta device."""
    b, s = shape.batch, shape.seq
    cache = model.init_cache(b, s, device="meta")
    return cache, _meta((b, 1), torch.int32), _meta((), torch.int32)


def concrete_train_batch(cfg: ArchConfig, batch: int, seq: int,
                         seed: int = 0, device: DeviceLike = "cuda"):
    """Small concrete batch for smoke tests / examples, drawn with numpy as
    the JAX package draws it (the same seed gives the same batch)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(batch, seq), dtype=np.int32)
    out = {"tokens": torch.as_tensor(toks, device=dev),
           "labels": torch.as_tensor(np.roll(toks, -1, axis=1), device=dev)}
    if cfg.family == "vlm" and cfg.frontend_seq:
        out["frontend"] = torch.as_tensor(
            rng.normal(0, 0.02, size=(batch, cfg.frontend_seq, cfg.d_model))
            .astype(np.float32), device=dev)
    if cfg.family == "audio":
        out["frames"] = torch.as_tensor(
            rng.normal(0, 0.02, size=(batch, min(cfg.enc_seq, 4 * seq),
                                      cfg.d_model)).astype(np.float32),
            device=dev)
    return out
