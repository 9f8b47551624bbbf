"""Pure-SSM language model (counterpart of ``repro.models.ssm_lm``):
falcon-mamba, a mamba1 stack with no attention.

Decode keeps O(1) state per layer (the conv tail and the (d_inner, N) ssm
state), whatever the context length. ``ssm_prefill`` is the chunked
forward over the whole prompt, emitting each layer's state;
``ssm_decode_step`` with S > 1 runs the recurrent step token by token.

Over a mesh (``shards``) each layer runs column-parallel over "model"
(``mamba.mamba1_forward(shards=)``), forward and backward: its FSDP dims
gathered first thing inside its rematerialized block, its d_inner columns
kept split over "model", as the training rules lay them out. The
embedding and the logits are the decoder families' (``lm.embed_rows``,
``lm.token_loss``). Decode and prefill over a mesh (``models.decoding``)
run the same forward, the cache's states split over d_inner too
(``sharding.cache_specs`` puts d_inner, their longest dim, on "model").

Where the "model" size does not divide d_inner (so ``spec_for`` leaves
some of the layer's leaves whole, or the states' d_inner is not split)
the layer is gathered whole instead (``Shards.gather_whole``), with the
states, and every "model" rank computes it whole.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..device import DeviceLike
from .common import (ParamCollector, ScanBlock, StackedCollector,
                     constrain_act, dtype_of, layer_slices, local_batch,
                     rms_norm, slice_layer)
from .decoding import MeshStep, one_device
from .lm import _embed, _head, _logits, gather_head, token_loss
from .mamba import (Mamba1State, init_mamba1, mamba1_decode, mamba1_forward,
                    mamba1_init_state, split_layout)


def _mesh_plan(cfg: ArchConfig, mesh, shards, cache_specs):
    """(MeshStep or None, the layers' layout, the mamba layout when the
    layers run column-parallel, the states' keeps) of a decode over
    ``mesh``."""
    if one_device(mesh):
        return None, None, None, ()
    step = MeshStep(mesh, shards, cache_specs)
    lsh = shards.sub("layers", stacked=True)
    msh = split_layout(cfg, lsh)
    if not (step.split(cache_specs[0], 3) and step.split(cache_specs[1], 2)):
        msh = None
    keeps = ({1: "batch", 3: "model"}, {1: "batch", 2: "model"}) if msh \
        else ({1: "batch"}, {1: "batch"})
    return step, lsh, msh, keeps


def ssm_prefill(params, cfg: ArchConfig, batch, max_len: int, mesh=None,
                cache_dtype=None, shards=None, cache_specs=None):
    """Parallel prefill: the chunked forward over the whole prompt, emitting
    the per-layer recurrent states for decode continuation. Returns (last
    position's logits, (conv (L, B, K-1, d_inner), ssm (L, B, d_inner,
    N))); over ``mesh`` every row's logits and this rank's state shards
    under ``cache_specs`` (see the module docstring)."""
    step, lsh, msh, keeps = _mesh_plan(cfg, mesh, shards, cache_specs)
    tokens = batch["tokens"]
    if step is not None:
        tokens = step.rows(batch)["tokens"]
        params = gather_head(params, shards)
    else:
        shards = None
    x = _embed(params, cfg, tokens, shards)
    convs, ssms = [], []
    for p in layer_slices(slice_layer(params, "layers")):
        if lsh is not None:
            p = lsh.gather_layer(p, msh is not None)
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        y, st = mamba1_forward(slice_layer(p, "mamba"), cfg, h,
                               return_state=True, shards=msh)
        x = x + y
        convs.append(st.conv)
        ssms.append(st.ssm)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x[:, -1:], shards)[:, -1]
    cache = (torch.stack(convs), torch.stack(ssms))
    if step is None:
        return logits, cache
    logits = step.logits(logits, _head(params, cfg, shards)[1])
    return logits, tuple(step.finish(t, step.back(sp, keep))
                         for t, sp, keep in zip(cache, cache_specs, keeps))


def init_ssm_lm(cfg: ArchConfig, generator: Optional[torch.Generator],
                mesh=None, place=None):
    """(params, axes), drawn from ``generator`` on its device (None: meta
    tensors); ``place`` as ``ParamCollector``'s."""
    col = ParamCollector(generator, dtype_of(cfg.param_dtype), place)
    e = cfg.d_model
    col.param("embed", (cfg.vocab, e), ("vocab", "embed"), scale=0.02)
    if not cfg.tie_embeddings:
        col.param("lm_head", (e, cfg.vocab), ("embed", "vocab"), scale=0.02)
    col.param("final_norm", (e,), (None,), init="ones")
    sub = StackedCollector(col, cfg.n_layers, "layers")
    init_mamba1(sub, cfg, "mamba")
    sub.param("ln", (e,), (None,), init="ones")
    return col.params, col.axes


def _block(cfg: ArchConfig, mesh=None, shards=None):
    """The layer's block; ``shards``: one layer's layout (its leaves are
    gathered first thing in the block: their FSDP dims, or whole in the
    divisibility fallback)."""
    msh = split_layout(cfg, shards)

    def block(p, carry):
        x = carry
        if shards is not None:
            p = shards.gather_layer(p, msh is not None)
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        y = mamba1_forward(slice_layer(p, "mamba"), cfg, h, shards=msh)
        return constrain_act(x + y, mesh), None
    return block


def ssm_lm_loss(params, cfg: ArchConfig, batch, mesh=None, shards=None):
    """Next-token CE; returns (loss, metrics). Over ``mesh``: ``params``
    are this rank's shards (``shards``), ``batch`` the global batch (see
    ``lm.lm_loss``)."""
    if mesh is not None and shards is None:
        raise ValueError("ssm_lm_loss over a mesh needs the params' layout "
                         "(shards=)")
    batch, shared = local_batch(batch, mesh)
    params = gather_head(params, shards)
    x = constrain_act(_embed(params, cfg, batch["tokens"], shards), mesh)
    x, _ = ScanBlock.run(
        _block(cfg, mesh, shards and shards.sub("layers", stacked=True)),
        slice_layer(params, "layers"), x, remat=cfg.remat,
        unroll=cfg.unroll_scans)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    loss = token_loss(params, cfg, x, batch, shards, shared)
    return loss, {"loss": loss}


def ssm_init_cache(cfg: ArchConfig, batch: int, max_len: int = 0,
                   dtype=torch.bfloat16, device: DeviceLike = "cuda"):
    """(conv (L, B, K-1, d_inner) in ``dtype``, ssm (L, B, d_inner, N)
    fp32), zero."""
    st = mamba1_init_state(cfg, batch, dtype, device)
    n = cfg.n_layers
    return (st.conv.new_zeros((n,) + tuple(st.conv.shape)),
            st.ssm.new_zeros((n,) + tuple(st.ssm.shape)))


def ssm_decode_step(params, cfg: ArchConfig, cache, tokens, cache_len,
                    mesh=None, shards=None, cache_specs=None):
    """tokens (B, S) -> (logits (B, V) of the last position, new cache):
    S = 1 one recurrent step, S > 1 the recurrent step token by token (the
    states are the only carry). The cache passed in is left as it was.
    Over ``mesh``: as ``lm.lm_decode_step``, each layer column-parallel
    (see the module docstring)."""
    step, lsh, msh, keeps = _mesh_plan(cfg, mesh, shards, cache_specs)
    backs = (None, None)
    if step is not None:
        tokens = step.rows({"tokens": tokens})["tokens"]
        params = gather_head(params, shards)
        (conv_c, backs0), (ssm_c, backs1) = (
            step.working(c, sp, keep)
            for c, sp, keep in zip(cache, cache_specs, keeps))
        backs = (backs0, backs1)
    else:
        shards = None
        conv_c, ssm_c = cache
    x = _embed(params, cfg, tokens, shards)
    layers = layer_slices(slice_layer(params, "layers"))
    for t in range(x.shape[1]):
        xt = x[:, t:t + 1]
        convs, ssms = [], []
        for i, p in enumerate(layers):
            if lsh is not None:
                p = lsh.gather_layer(p, msh is not None)
            h = rms_norm(xt, p["ln"], cfg.norm_eps)
            y, st = mamba1_decode(slice_layer(p, "mamba"), cfg, h,
                                  Mamba1State(conv_c[i], ssm_c[i]),
                                  shards=msh)
            xt = xt + y
            convs.append(st.conv)
            ssms.append(st.ssm)
        conv_c, ssm_c = torch.stack(convs), torch.stack(ssms)
    x_out = rms_norm(xt, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x_out, shards)[:, -1]
    if step is None:
        return logits, (conv_c, ssm_c)
    logits = step.logits(logits, _head(params, cfg, shards)[1])
    return logits, (step.finish(conv_c, backs[0]),
                    step.finish(ssm_c, backs[1]))


__all__ = ["init_ssm_lm", "ssm_decode_step", "ssm_init_cache",
           "ssm_lm_loss", "ssm_prefill"]
