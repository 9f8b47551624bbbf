"""Hybrid SSM + shared-attention LM (counterpart of
``repro.models.hybrid``): zamba2, a mamba2 backbone with ONE shared
transformer block applied after every ``attn_every`` mamba blocks.

The JAX package's simplifications are kept: the shared block reads the
residual stream directly (no concat-with-embedding re-projection) and has
no LoRA adapters. The stacked mamba layers are unbound once
(``common.layer_slices``) and grouped in Python; a ``[lo:hi]`` slice of
each stack per group would, under autograd, build a zero tensor of the
whole stack per group in the backward pass. Decode keeps one shared KV
cache per group; the tail of ``n_layers % attn_every`` mamba layers has
none.

Over a training mesh (``shards``) each mamba layer gathers its leaves
whole inside its rematerialized block and every "model" rank computes it
whole (see ``ssm_lm``); the shared block's weights are gathered over their
FSDP axes once a step and it runs the Megatron branches of ``gqa_forward``
and ``mlp_forward``. Decode and prefill over a mesh are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..device import DeviceLike
from .attention import KVCache, gqa_forward, init_gqa
from .common import (ParamCollector, ScanBlock, StackedCollector,
                     constrain_act, dtype_of, layer_slices, local_batch,
                     merge, positions_of, rms_norm, slice_layer)
from .lm import (_embed, _logits, gather_head, no_mesh_decode,
                 token_loss)
from .mamba import (Mamba2State, init_mamba2, mamba2_decode, mamba2_forward,
                    mamba2_init_state)
from .mlp import init_mlp, mlp_forward


def _group_plan(cfg: ArchConfig):
    g = cfg.n_layers // cfg.attn_every    # full groups, shared attn after each
    tail = cfg.n_layers - g * cfg.attn_every
    return g, tail


def _groups(cfg: ArchConfig, layers):
    """The layer list cut into the groups (the full ones, then the tail
    when there is one): [(lo, layers[lo:hi], shared block after it)]."""
    g, tail = _group_plan(cfg)
    out = [(i * cfg.attn_every,
            layers[i * cfg.attn_every:(i + 1) * cfg.attn_every], True)
           for i in range(g)]
    if tail:
        out.append((g * cfg.attn_every, layers[g * cfg.attn_every:], False))
    return out


def init_hybrid_lm(cfg: ArchConfig, generator: Optional[torch.Generator],
                   mesh=None, place=None):
    """(params, axes), drawn from ``generator`` on its device (None: meta
    tensors); ``place`` as ``ParamCollector``'s (the shared block's leaves
    included)."""
    col = ParamCollector(generator, dtype_of(cfg.param_dtype), place)
    e = cfg.d_model
    col.param("embed", (cfg.vocab, e), ("vocab", "embed"), scale=0.02)
    if not cfg.tie_embeddings:
        col.param("lm_head", (e, cfg.vocab), ("embed", "vocab"), scale=0.02)
    col.param("final_norm", (e,), (None,), init="ones")
    sub = StackedCollector(col, cfg.n_layers, "layers")
    init_mamba2(sub, cfg, "mamba")
    sub.param("ln", (e,), (None,), init="ones")
    # ONE shared attention+mlp block (reused at every application)
    shared = ParamCollector(col._next(), col.dtype, col.child_place("shared"))
    init_gqa(shared, cfg)
    init_mlp(shared, cfg)
    shared.param("ln_attn", (e,), (None,), init="ones")
    shared.param("ln_mlp", (e,), (None,), init="ones")
    for k, v in shared.params.items():
        col.params[f"shared/{k}"] = v
        col.axes[f"shared/{k}"] = shared.axes[k]
    return col.params, col.axes


def _mamba_block(cfg: ArchConfig, mesh=None, shards=None):
    def block(p, carry):
        x = carry
        if shards is not None:
            p = shards.gather_whole(p)
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        y = mamba2_forward(slice_layer(p, "mamba"), cfg, h)
        return constrain_act(x + y, mesh), None
    return block


def _shared_attn(params, cfg: ArchConfig, x, positions, cache=None,
                 cache_len=None, shards=None):
    """The shared block; ``shards``: its layout (keys under "shared/")."""
    p = slice_layer(params, "shared")
    sub = lambda name: shards and shards.sub(name)
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    a, new_cache = gqa_forward(slice_layer(p, "attn"), cfg, h, positions,
                               causal=True, cache=cache, cache_len=cache_len,
                               shards=sub("attn"))
    x = x + a
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    return x + mlp_forward(slice_layer(p, "mlp"), cfg, h, sub("mlp")), \
        new_cache


def hybrid_lm_loss(params, cfg: ArchConfig, batch, mesh=None, shards=None):
    """Next-token CE; returns (loss, metrics). Over ``mesh``: ``params``
    are this rank's shards (``shards``), ``batch`` the global batch."""
    if mesh is not None and shards is None:
        raise ValueError("hybrid_lm_loss over a mesh needs the params' "
                         "layout (shards=)")
    batch, shared = local_batch(batch, mesh)
    params = gather_head(params, shards)
    shared_shards = None
    if shards is not None:
        sp = slice_layer(params, "shared")
        params = dict(params, **merge("shared",
                                      shards.sub("shared").gather(sp)))
        shared_shards = shards.sub("shared")
    tokens = batch["tokens"]
    x = constrain_act(_embed(params, cfg, tokens, shards), mesh)
    positions = positions_of(*tokens.shape, 0, x.device)
    block = _mamba_block(cfg, mesh,
                         shards and shards.sub("layers", stacked=True))
    layers = layer_slices(slice_layer(params, "layers"))
    for _, group, attn in _groups(cfg, layers):
        x, _ = ScanBlock.run_layers(block, group, x, remat=cfg.remat)
        if attn:
            x, _ = _shared_attn(params, cfg, x, positions,
                                shards=shared_shards)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    loss = token_loss(params, cfg, x, batch, shards, shared)
    return loss, {"loss": loss}


def hybrid_init_cache(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device: DeviceLike = "cuda"):
    """(conv (L, B, K-1, d_inner + 2N), ssm (L, B, H, hd, N) fp32, the
    shared block's K and V (groups, B, max_len, Hkv, D)), zero."""
    st = mamba2_init_state(cfg, batch, dtype, device)
    dev = st.ssm.device
    n = cfg.n_layers
    g, _ = _group_plan(cfg)
    kv = (g, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return (st.conv.new_zeros((n,) + tuple(st.conv.shape)),
            st.ssm.new_zeros((n,) + tuple(st.ssm.shape)),
            torch.zeros(kv, dtype=dtype, device=dev),
            torch.zeros(kv, dtype=dtype, device=dev))


def _one_token(params, cfg: ArchConfig, x, positions, conv_c, ssm_c, ck, cv,
               cache_len, layers=None):
    """Single-token pass through the full hybrid stack. x (B, 1, E).
    ``layers``: the stack's ``layer_slices`` (made here if not given)."""
    if layers is None:
        layers = layer_slices(slice_layer(params, "layers"))
    new_conv, new_ssm, new_k, new_v = [], [], [], []
    for gi, (lo, group, attn) in enumerate(_groups(cfg, layers)):
        for i, p in enumerate(group, start=lo):
            h = rms_norm(x, p["ln"], cfg.norm_eps)
            y, st = mamba2_decode(slice_layer(p, "mamba"), cfg, h,
                                  Mamba2State(conv_c[i], ssm_c[i]))
            x = x + y
            new_conv.append(st.conv)
            new_ssm.append(st.ssm)
        if attn:
            x, kvc = _shared_attn(params, cfg, x, positions,
                                  cache=KVCache(ck[gi], cv[gi]),
                                  cache_len=cache_len)
            new_k.append(kvc.k)
            new_v.append(kvc.v)
    return x, (torch.stack(new_conv), torch.stack(new_ssm),
               torch.stack(new_k), torch.stack(new_v))


def hybrid_prefill(params, cfg: ArchConfig, batch, max_len: int, mesh=None,
                   cache_dtype=torch.bfloat16):
    """Parallel prefill: the chunked mamba2 forward (with its states) and
    the shared block's KV cache built for the whole prompt. Returns (last
    position's logits, cache as ``hybrid_init_cache``'s)."""
    no_mesh_decode(mesh)
    tokens = batch["tokens"]
    x = _embed(params, cfg, tokens)
    b, s = tokens.shape
    positions = positions_of(b, s, 0, x.device)
    kv = (b, max_len, cfg.n_kv_heads, cfg.head_dim)
    layers = layer_slices(slice_layer(params, "layers"))
    new_conv, new_ssm, new_k, new_v = [], [], [], []
    for _, group, attn in _groups(cfg, layers):
        for p in group:
            h = rms_norm(x, p["ln"], cfg.norm_eps)
            y, st = mamba2_forward(slice_layer(p, "mamba"), cfg, h,
                                   return_state=True)
            x = x + y
            new_conv.append(st.conv)
            new_ssm.append(st.ssm)
        if attn:
            kv0 = KVCache(torch.zeros(kv, dtype=cache_dtype, device=x.device),
                          torch.zeros(kv, dtype=cache_dtype, device=x.device))
            x, kvc = _shared_attn(params, cfg, x, positions, cache=kv0,
                                  cache_len=0)
            new_k.append(kvc.k)
            new_v.append(kvc.v)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x[:, -1:])[:, -1]
    return logits, (torch.stack(new_conv), torch.stack(new_ssm),
                    torch.stack(new_k), torch.stack(new_v))


def hybrid_decode_step(params, cfg: ArchConfig, cache, tokens, cache_len,
                       mesh=None):
    """tokens (B, S) at positions cache_len.. -> (logits (B, V) of the last
    position, new cache): S = 1 decode, S > 1 the token steps one after
    another (the mamba recurrence is sequential at inference). The cache
    passed in is left as it was."""
    no_mesh_decode(mesh)
    cl = int(cache_len)
    x = _embed(params, cfg, tokens)
    b, s = tokens.shape
    layers = layer_slices(slice_layer(params, "layers"))
    for t in range(s):
        xt, cache = _one_token(params, cfg, x[:, t:t + 1],
                               positions_of(b, 1, cl + t, x.device), *cache,
                               cl + t, layers=layers)
    x = rms_norm(xt, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x)[:, -1]
    return logits, cache


__all__ = ["hybrid_decode_step", "hybrid_init_cache", "hybrid_lm_loss",
           "hybrid_prefill", "init_hybrid_lm"]
