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

Over a training mesh (``shards``) each mamba2 layer runs split over
"model" by heads (``mamba.mamba2_forward(shards=)``), forward and
backward: its FSDP dims gathered first thing inside its rematerialized
block, its d_inner leaves kept split. Its replicated ``conv_w``,
``conv_b``, ``dt_bias``, ``a_log`` and ``d`` get each rank's part of
their gradient; ``partial_keys`` names them to ``Model.shards``
(``Shards.partial``) and the step sums them over "model" once
(``train.loop.sum_replicated_grads``). Where the "model" size does not
divide the head count (the divisibility fallback) the layer gathers its
leaves whole (``Shards.gather_whole``) and every "model" rank computes it
whole. The shared block's weights are gathered over their FSDP axes once
a step and it runs the Megatron branches of ``gqa_forward`` and
``mlp_forward``.

Decode and prefill over a mesh (``models.decoding``) run each mamba2
layer split over "model" by heads (``mamba.mamba2_forward(shards=)``, the
layer's FSDP dims gathered, its d_inner leaves kept split). The states
keep ``sharding.cache_specs``' layout, which splits their longest dim
over "model" and which mamba2's heads do not follow (the conv state's x,
B and C channels side by side; the ssm state's N, or at smoke size its
head dim). A step all-gathers both whole over "model"
once (the conv tail and the ssm state, every layer's at once), and each
layer takes its heads' slice of the ssm state; the layer returns the new
conv tail whole (the gathered ``w_in`` product holds every channel's new
row) and its heads' new ssm state, and one all-gather over the heads at
the end of the step (every layer's at once) gives every rank the whole
new state to cut its shard from. Collectives a step over "model", beyond
the shared block's and the FSDP gathers: two all-gathers of the states,
three a layer (the ``w_in`` product, the norm's and "g"'s all-reduces)
and one all-gather of the new ssm states; a prefill makes the last alone
of the states'. The shared block's KV cache is context-parallel
(``models.attention``).

Where the "model" size does not divide the head count (or leaves one of
``w_in``, ``norm_w``, ``w_out`` whole) a decode gathers each mamba2 layer
and its states whole instead (``Shards.gather_whole``), as training's
fallback does, and every "model" rank computes the layer whole.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..device import DeviceLike
from ..distributed.collectives import MODEL, all_gather
from .attention import KVCache, gqa_forward, init_gqa
from .common import (ParamCollector, ScanBlock, StackedCollector,
                     constrain_act, dtype_of, layer_slices, local_batch,
                     merge, positions_of, rms_norm, slice_layer)
from .decoding import MeshStep, local_zeros, one_device
from .lm import KV_KEEP, _embed, _head, _logits, gather_head, token_loss
from .mamba import (MAMBA2_PARTIAL_KEYS, Mamba2State, init_mamba2,
                    mamba2_decode, mamba2_forward, mamba2_init_state,
                    split_layout)
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
    """The mamba2 layer's block; ``shards``: one layer's layout (its
    leaves gathered first thing in the block: their FSDP dims when the
    layer runs split over "model", else whole)."""
    msh = split_layout(cfg, shards)

    def block(p, carry):
        x = carry
        if shards is not None:
            p = shards.gather_layer(p, msh is not None)
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        y = mamba2_forward(slice_layer(p, "mamba"), cfg, h, shards=msh)
        return constrain_act(x + y, mesh), None
    return block


def partial_keys(cfg: ArchConfig, shards) -> tuple:
    """The leaves replicated over "model" whose gradient each "model" rank
    computes only its part of (``Shards.partial``): the mamba2 layers'
    ``MAMBA2_PARTIAL_KEYS`` where the layers run split."""
    if split_layout(cfg, shards.sub("layers", stacked=True)) is None:
        return ()
    return tuple(f"layers/mamba/{k}" for k in MAMBA2_PARTIAL_KEYS)


def _shared_attn(params, cfg: ArchConfig, x, positions, cache=None,
                 cache_len=None, shards=None, seq_split: bool = False):
    """The shared block; ``shards``: its layout (keys under "shared/");
    with a cache over a mesh ``seq_split`` as ``gqa_forward``'s."""
    p = slice_layer(params, "shared")
    sub = lambda name: shards and shards.sub(name)
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    a, new_cache = gqa_forward(slice_layer(p, "attn"), cfg, h, positions,
                               causal=True, cache=cache, cache_len=cache_len,
                               shards=sub("attn"), seq_split=seq_split)
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


# the states' keeps (gathered whole over "model"), then the shared KV's
KEEPS = ({1: "batch"}, {1: "batch"}, KV_KEEP, KV_KEEP)


class _Mesh:
    """A hybrid decode's view of the mesh: the step, the mamba layers' and
    the shared block's layouts, the mamba2 layout when the layers run
    split (else None), the shared block's weights gathered over their FSDP
    axes, whether the KV slots are split over "model"."""

    def __init__(self, cfg: ArchConfig, params, mesh, shards, cache_specs):
        self.step = MeshStep(mesh, shards, cache_specs)
        self.layers = shards.sub("layers", stacked=True)
        self.mamba = split_layout(cfg, self.layers)
        self.shared = shards.sub("shared")
        self.params = dict(params, **merge("shared", self.shared.gather(
            slice_layer(params, "shared"))))
        self.backs = [self.step.back(sp, k)
                      for sp, k in zip(cache_specs, KEEPS)]
        self.seq_split = self.backs[2][2] is None and self.step.split(
            cache_specs[2], 2)

    def heads(self, cache):
        """A working cache (the states whole over "model") with the ssm
        states cut to this rank's heads where the layers run split."""
        if self.mamba is None:
            return cache
        conv, ssm, *kv = cache
        return (conv, ssm.chunk(self.mamba.tp, 2)[self.mamba.mi], *kv)

    def whole(self, cache):
        """``heads``' inverse: the ranks' ssm states all-gathered over the
        heads."""
        if self.mamba is None:
            return cache
        conv, ssm, *kv = cache
        return (conv, all_gather(ssm, 2, self.step.mesh, MODEL), *kv)


def _plan(params, cfg: ArchConfig, mesh, shards, cache_specs):
    """(params with the head and shared block gathered, _Mesh or None)."""
    if one_device(mesh):
        return params, None
    m = _Mesh(cfg, gather_head(params, shards), mesh, shards, cache_specs)
    return m.params, m


def _one_token(params, cfg: ArchConfig, x, positions, conv_c, ssm_c, ck, cv,
               cache_len, layers=None, m: Optional[_Mesh] = None):
    """Single-token pass through the full hybrid stack. x (B, 1, E).
    ``layers``: the stack's ``layer_slices`` (made here if not given);
    ``m``: a mesh step's ``_Mesh`` (the states as ``_Mesh.heads`` gives
    them and returns)."""
    if layers is None:
        layers = layer_slices(slice_layer(params, "layers"))
    new_conv, new_ssm, new_k, new_v = [], [], [], []
    for gi, (lo, group, attn) in enumerate(_groups(cfg, layers)):
        for i, p in enumerate(group, start=lo):
            if m is not None:
                p = m.layers.gather_layer(p, m.mamba is not None)
            h = rms_norm(x, p["ln"], cfg.norm_eps)
            y, st = mamba2_decode(slice_layer(p, "mamba"), cfg, h,
                                  Mamba2State(conv_c[i], ssm_c[i]),
                                  shards=m and m.mamba)
            x = x + y
            new_conv.append(st.conv)
            new_ssm.append(st.ssm)
        if attn:
            x, kvc = _shared_attn(params, cfg, x, positions,
                                  cache=KVCache(ck[gi], cv[gi]),
                                  cache_len=cache_len,
                                  shards=m and m.shared,
                                  seq_split=m is not None and m.seq_split)
            new_k.append(kvc.k)
            new_v.append(kvc.v)
    return x, (torch.stack(new_conv), torch.stack(new_ssm),
               torch.stack(new_k), torch.stack(new_v))


def hybrid_prefill(params, cfg: ArchConfig, batch, max_len: int, mesh=None,
                   cache_dtype=torch.bfloat16, shards=None,
                   cache_specs=None):
    """Parallel prefill: the chunked mamba2 forward (with its states) and
    the shared block's KV cache built for the whole prompt. Returns (last
    position's logits, cache as ``hybrid_init_cache``'s); over ``mesh``
    every row's logits and this rank's cache shards (see the module
    docstring)."""
    params, m = _plan(params, cfg, mesh, shards, cache_specs)
    tokens = batch["tokens"]
    if m is not None:
        tokens = m.step.rows(batch)["tokens"]
    else:
        shards = None
    x = _embed(params, cfg, tokens, shards)
    b, s = tokens.shape
    positions = positions_of(b, s, 0, x.device)
    kv = (b, max_len, cfg.n_kv_heads, cfg.head_dim)
    if m is not None:
        # the KV cache's working shard: its slots split as they stay
        spec = tuple(None if bk is not None else e
                     for e, bk in zip(cache_specs[2], m.backs[2]))
        whole = (1, batch["tokens"].shape[0]) + kv[1:]
        kv0 = local_zeros((torch.empty(whole, dtype=cache_dtype,
                                       device="meta"),),
                          ((None,) + spec[1:],), mesh, x.device)[0][0]
    layers = layer_slices(slice_layer(params, "layers"))
    new_conv, new_ssm, new_k, new_v = [], [], [], []
    for _, group, attn in _groups(cfg, layers):
        for p in group:
            if m is not None:
                p = m.layers.gather_layer(p, m.mamba is not None)
            h = rms_norm(x, p["ln"], cfg.norm_eps)
            y, st = mamba2_forward(slice_layer(p, "mamba"), cfg, h,
                                   return_state=True, shards=m and m.mamba)
            x = x + y
            new_conv.append(st.conv)
            new_ssm.append(st.ssm)
        if attn:
            if m is None:
                kv0 = torch.zeros(kv, dtype=cache_dtype, device=x.device)
            x, kvc = _shared_attn(params, cfg, x, positions,
                                  cache=KVCache(kv0, kv0), cache_len=0,
                                  shards=m and m.shared,
                                  seq_split=m is not None and m.seq_split)
            new_k.append(kvc.k)
            new_v.append(kvc.v)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x[:, -1:], shards)[:, -1]
    cache = (torch.stack(new_conv), torch.stack(new_ssm),
             torch.stack(new_k), torch.stack(new_v))
    if m is None:
        return logits, cache
    logits = m.step.logits(logits, _head(params, cfg, shards)[1])
    return logits, tuple(m.step.finish(t, bk)
                         for t, bk in zip(m.whole(cache), m.backs))


def hybrid_decode_step(params, cfg: ArchConfig, cache, tokens, cache_len,
                       mesh=None, shards=None, cache_specs=None):
    """tokens (B, S) at positions cache_len.. -> (logits (B, V) of the last
    position, new cache): S = 1 decode, S > 1 the token steps one after
    another (the mamba recurrence is sequential at inference). The cache
    passed in is left as it was. Over ``mesh``: as
    ``lm.lm_decode_step`` (see the module docstring)."""
    params, m = _plan(params, cfg, mesh, shards, cache_specs)
    if m is not None:
        tokens = m.step.rows({"tokens": tokens})["tokens"]
        cache = m.heads(tuple(m.step.working(c, sp, k)[0]
                              for c, sp, k in zip(cache, cache_specs, KEEPS)))
    else:
        shards = None
    cl = int(cache_len)
    x = _embed(params, cfg, tokens, shards)
    b, s = tokens.shape
    layers = layer_slices(slice_layer(params, "layers"))
    for t in range(s):
        xt, cache = _one_token(params, cfg, x[:, t:t + 1],
                               positions_of(b, 1, cl + t, x.device), *cache,
                               cl + t, layers=layers, m=m)
    x = rms_norm(xt, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x, shards)[:, -1]
    if m is None:
        return logits, cache
    logits = m.step.logits(logits, _head(params, cfg, shards)[1])
    return logits, tuple(m.step.finish(t, bk)
                         for t, bk in zip(m.whole(cache), m.backs))


__all__ = ["hybrid_decode_step", "hybrid_init_cache", "hybrid_lm_loss",
           "hybrid_prefill", "init_hybrid_lm", "partial_keys"]
