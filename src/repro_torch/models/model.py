"""Unified Model interface (counterpart of ``repro.models.model``):

    model = build_model(cfg)                 # on the card; device="cpu" asks
    params, axes = model.init(0)             # a seed, or a torch.Generator
    loss, metrics = model.loss(params, batch)
    cache = model.init_cache(batch_size, max_len)
    logits, cache = model.decode_step(params, cache, tokens, cache_len)

The decoder families (dense, moe, vlm: 7 of the 10 configs) are ported.
``model.init(None)`` builds on the meta device: shapes, dtypes and axes,
no memory.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from ..configs.base import ArchConfig
from ..device import DeviceLike
from . import lm
from .common import model_device

# ROADMAP queue A: the families whose modules are not ported yet
NOT_PORTED = {
    "ssm": "models/{mamba,ssm_lm}.py",
    "hybrid": "models/{mamba,hybrid}.py",
    "audio": "models/encdec.py",
}


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    mesh: Optional[Any]
    device: torch.device
    _init: Callable
    _loss: Callable
    _init_cache: Callable
    _decode: Callable
    _prefill: Optional[Callable] = None

    def init(self, key: Union[int, torch.Generator, None] = 0):
        """(params, axes): from a seed (a generator on the model's device),
        a ``torch.Generator`` (its device), or None (meta tensors)."""
        if isinstance(key, int):
            key = torch.Generator(device=self.device).manual_seed(key)
        return self._init(self.cfg, key, mesh=self.mesh)

    def loss(self, params, batch):
        return self._loss(params, self.cfg, batch, mesh=self.mesh)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device: Optional[DeviceLike] = None):
        return self._init_cache(self.cfg, batch, max_len, dtype,
                                device=self.device if device is None
                                else device)

    def decode_step(self, params, cache, tokens, cache_len):
        return self._decode(params, self.cfg, cache, tokens, cache_len,
                            mesh=self.mesh)

    def prefill(self, params, batch, max_len: int):
        if self._prefill is not None:
            return self._prefill(params, self.cfg, batch, max_len,
                                 mesh=self.mesh)
        # default: decode-step over the whole prompt at cache_len 0
        cache = self.init_cache(batch["tokens"].shape[0], max_len)
        return self.decode_step(params, cache, batch["tokens"], 0)


def build_model(cfg: ArchConfig, mesh=None,
                device: DeviceLike = "cuda") -> Model:
    """The model of ``cfg`` on ``device`` (the card unless the caller asks
    for the CPU, or "meta" for shapes only)."""
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return Model(cfg, mesh, model_device(device), lm.init_decoder_lm,
                     lm.lm_loss, lm.init_kv_cache, lm.lm_decode_step)
    if fam in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {fam} family is not ported yet (ROADMAP "
            f"queue A, {NOT_PORTED[fam]})")
    raise ValueError(f"unknown family: {fam}")
