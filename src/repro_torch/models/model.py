"""Unified Model interface (counterpart of ``repro.models.model``):

    model = build_model(cfg)                 # on the card; device="cpu" asks
    params, axes = model.init(0)             # a seed, or a torch.Generator
    loss, metrics = model.loss(params, batch)
    cache = model.init_cache(batch_size, max_len)
    logits, cache = model.decode_step(params, cache, tokens, cache_len)

Every family of the 10 configs is ported: the decoders (dense, moe, vlm),
ssm (falcon-mamba), hybrid (zamba2) and audio (seamless-m4t, an
encoder-decoder). ``model.init(None)`` builds on the meta device: shapes,
dtypes and axes, no memory. ``build_model(cfg, mesh=mesh)`` keeps the training mesh (a
``repro_torch.distributed.Mesh``) and passes it through, as the JAX
``Model`` does. The mesh and its rules live on the model alone:
``model.with_mesh(mesh, rules)`` (rules default: ``default_rules``) is the
one place they are set, ``model.shards()`` the parameters' layout under
them, and ``model.init(key, place=...)`` hands each drawn leaf to
``place`` (a rank keeps its shard).

A mesh carries training and decoding. ``model.loss`` over it is the
data-, tensor- and expert-parallel step; ``model.init_cache``,
``model.prefill`` and ``model.decode_step`` over it decode with the
weights in the same layout: the cache is a ``MeshCache``, this rank's
shards under ``model.cache_specs(batch, max_len)`` (the JAX dry-run's
layout, context-parallel over "model"), the tokens are the global batch
and the logits every row's on every rank (``models.decoding``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from ..configs.base import ArchConfig
from ..device import DeviceLike
from ..distributed.collectives import Shards
from ..distributed.sharding import cache_specs, default_rules, tree_specs
from . import encdec, hybrid, lm, ssm_lm
from .common import model_device
from .decoding import MeshCache, local_zeros


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
    _partial: Optional[Callable] = None
    rules: Optional[Any] = None
    _shards: Optional[Any] = dataclasses.field(default=None, repr=False)

    def init(self, key: Union[int, torch.Generator, None] = 0, place=None):
        """(params, axes): from a seed (a generator on the model's device),
        a ``torch.Generator`` (its device), or None (meta tensors);
        ``place`` as ``common.ParamCollector``'s."""
        if isinstance(key, int):
            key = torch.Generator(device=self.device).manual_seed(key)
        return self._init(self.cfg, key, mesh=self.mesh, place=place)

    def shards(self):
        """The parameters' layout on the mesh (None without one), from the
        family's own tree on the meta device; with the family's partial
        leaves (``Shards.partial``: the hybrid's split mamba2 layers')."""
        if self.mesh is not None and self._shards is None:
            params, axes = self._init(self.cfg, None)
            sh = Shards(self.mesh, tree_specs(axes, params, self.rules,
                                              self.mesh))
            if self._partial is not None:
                sh.partial = self._partial(self.cfg, sh)
            self._shards = sh
        return self._shards

    def with_mesh(self, mesh, rules=None) -> "Model":
        """This model on ``mesh`` under ``rules`` (default:
        ``default_rules``; itself if it is so already)."""
        if mesh is not None and rules is None:
            rules = default_rules("pod" in mesh.axis_names)
        if mesh is self.mesh and rules == self.rules:
            return self
        return dataclasses.replace(self, mesh=mesh, rules=rules,
                                   _shards=None)

    def loss(self, params, batch):
        return self._loss(params, self.cfg, batch, mesh=self.mesh,
                          shards=self.shards())

    def cache_specs(self, batch: int, max_len: int):
        """The specs of a ``batch`` x ``max_len`` decode cache's leaves on
        the mesh (``sharding.cache_specs``), in the cache's structure."""
        meta = self._init_cache(self.cfg, batch, max_len, torch.bfloat16,
                                device="meta")
        return cache_specs(meta, self.mesh, self.rules)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device: Optional[DeviceLike] = None):
        """A zero decode cache; over a mesh a ``MeshCache`` of this rank's
        shards."""
        dev = self.device if device is None else device
        if self.mesh is None:
            return self._init_cache(self.cfg, batch, max_len, dtype,
                                    device=dev)
        specs = self.cache_specs(batch, max_len)
        meta = self._init_cache(self.cfg, batch, max_len, dtype,
                                device="meta")
        return MeshCache(local_zeros(meta, specs, self.mesh,
                                     model_device(dev)), specs)

    def decode_step(self, params, cache, tokens, cache_len):
        if self.mesh is None:
            return self._decode(params, self.cfg, cache, tokens, cache_len,
                                mesh=None)
        if not isinstance(cache, MeshCache):
            raise TypeError("decode over a mesh takes the MeshCache that "
                            "init_cache, prefill or decode_step returned")
        logits, new = self._decode(params, self.cfg, cache.shards, tokens,
                                   cache_len, mesh=self.mesh,
                                   shards=self.shards(),
                                   cache_specs=cache.specs)
        return logits, MeshCache(new, cache.specs)

    def prefill(self, params, batch, max_len: int, dtype=torch.bfloat16):
        """(last position's logits, the cache after the prompt); ``dtype``:
        the KV cache's (and enc_out's) dtype."""
        if self._prefill is None:
            # default: decode-step over the whole prompt at cache_len 0
            cache = self.init_cache(batch["tokens"].shape[0], max_len,
                                    dtype)
            return self.decode_step(params, cache, batch["tokens"], 0)
        if self.mesh is None:
            return self._prefill(params, self.cfg, batch, max_len,
                                 cache_dtype=dtype)
        specs = self.cache_specs(batch["tokens"].shape[0], max_len)
        logits, new = self._prefill(params, self.cfg, batch, max_len,
                                    mesh=self.mesh, cache_dtype=dtype,
                                    shards=self.shards(), cache_specs=specs)
        return logits, MeshCache(new, specs)


def build_model(cfg: ArchConfig, mesh=None,
                device: DeviceLike = "cuda") -> Model:
    """The model of ``cfg`` on ``device`` (the card unless the caller asks
    for the CPU, or "meta" for shapes only; over a mesh, the mesh's
    device by default), on ``mesh`` under ``default_rules``."""
    fam = cfg.family
    if mesh is not None and device == "cuda":
        device = mesh.device
    dev = model_device(device)
    if fam in ("dense", "moe", "vlm"):
        model = Model(cfg, None, dev, lm.init_decoder_lm, lm.lm_loss,
                      lm.init_kv_cache, lm.lm_decode_step)
    elif fam == "ssm":
        model = Model(cfg, None, dev, ssm_lm.init_ssm_lm, ssm_lm.ssm_lm_loss,
                      ssm_lm.ssm_init_cache, ssm_lm.ssm_decode_step,
                      _prefill=ssm_lm.ssm_prefill)
    elif fam == "hybrid":
        model = Model(cfg, None, dev, hybrid.init_hybrid_lm,
                      hybrid.hybrid_lm_loss, hybrid.hybrid_init_cache,
                      hybrid.hybrid_decode_step,
                      _prefill=hybrid.hybrid_prefill,
                      _partial=hybrid.partial_keys)
    elif fam == "audio":
        model = Model(cfg, None, dev, encdec.init_encdec, encdec.encdec_loss,
                      encdec.encdec_init_cache, encdec.encdec_decode_step,
                      _prefill=encdec.encdec_prefill)
    else:
        raise ValueError(f"unknown family: {fam}")
    return model.with_mesh(mesh)
