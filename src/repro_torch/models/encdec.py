"""Encoder-decoder transformer (counterpart of ``repro.models.encdec``):
the seamless-m4t backbone, a speech encoder stub and a text decoder with
cross-attention. The modality frontend is the JAX package's stub:
``batch["frames"]`` carries precomputed frame embeddings at d_model.

Cross-attention has no mask, no rope and a zero bias, through
``attention.sdpa``. The encoder's K/V are recomputed in every decoder
layer and every step, as in the JAX package (no cross-KV cache). The
decode cache holds ``enc_out`` in the cache dtype, widened on read.

Over a training mesh (``shards``) each encoder and decoder layer gathers
its FSDP-sharded weights first thing inside its rematerialized block and
runs the Megatron branches: self-attention and the MLP through
``gqa_forward`` and ``mlp_forward``; cross-attention's q, k and v
column-parallel over the heads ("f" on the decoder's and on the encoder's
input), ``wo`` row-parallel and "g" after it. ``local_batch`` splits the
frames with the tokens.

Decode and prefill over a mesh (``models.decoding``) run the encoder and
the decoder's cross-attention and MLP on those same branches, the
decoder's self-attention context-parallel over its KV cache
(``models.attention``). ``enc_out`` stays in the cache laid out as
``sharding.cache_specs`` lays it out (as the JAX dry-run's heuristic
does: enc_seq on the batch axes, d_model on "model"); a decode step
all-gathers it whole once and reads its rows. Over a mesh the frames
must number ``cfg.enc_seq``, the cache's enc_out length.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..configs.base import ArchConfig
from ..device import DeviceLike
from ..distributed.collectives import all_gather
from ..distributed.sharding import local_shard
from .attention import KVCache, gqa_forward, init_gqa, sdpa
from .common import (ParamCollector, ScanBlock, StackedCollector,
                     constrain_act, dtype_of, layer_slices, local_batch,
                     model_device, positions_of, rms_norm, slice_layer,
                     tok_einsum)
from .decoding import MeshStep, local_zeros, one_device
from .lm import KV_KEEP, _embed, _head, _logits, gather_head, token_loss
from .mlp import init_mlp, mlp_forward


def init_encdec(cfg: ArchConfig, generator: Optional[torch.Generator],
                mesh=None, place=None):
    """(params, axes), drawn from ``generator`` on its device (None: meta
    tensors); ``place`` as ``ParamCollector``'s."""
    col = ParamCollector(generator, dtype_of(cfg.param_dtype), place)
    e = cfg.d_model
    col.param("embed", (cfg.vocab, e), ("vocab", "embed"), scale=0.02)
    if not cfg.tie_embeddings:
        col.param("lm_head", (e, cfg.vocab), ("embed", "vocab"), scale=0.02)
    col.param("final_norm", (e,), (None,), init="ones")
    col.param("enc_norm", (e,), (None,), init="ones")

    enc = StackedCollector(col, cfg.n_enc_layers, "enc")
    init_gqa(enc, cfg)
    init_mlp(enc, cfg)
    enc.param("ln_attn", (e,), (None,), init="ones")
    enc.param("ln_mlp", (e,), (None,), init="ones")

    dec = StackedCollector(col, cfg.n_layers, "dec")
    init_gqa(dec, cfg)                       # self-attention
    # cross-attention
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dec.param("xattn/wq", (e, h, d), ("embed", "heads", "head_dim"))
    dec.param("xattn/wk", (e, hk, d), ("embed", "kv_heads", "head_dim"))
    dec.param("xattn/wv", (e, hk, d), ("embed", "kv_heads", "head_dim"))
    dec.param("xattn/wo", (h, d, e), ("heads", "head_dim", "embed"))
    init_mlp(dec, cfg)
    dec.param("ln_attn", (e,), (None,), init="ones")
    dec.param("ln_xattn", (e,), (None,), init="ones")
    dec.param("ln_mlp", (e,), (None,), init="ones")
    return col.params, col.axes


def _encode(params, cfg: ArchConfig, frames, mesh=None, shards=None):
    """The encoder over the frames (B, S_enc, E); ``shards``: one encoder
    layer's layout. Returns the final-normed encoder output."""
    x = constrain_act(frames.to(dtype_of(cfg.compute_dtype)), mesh)
    sub = lambda name: shards and shards.sub(name)

    def block(p, carry):
        x, positions = carry
        if shards is not None:
            p = shards.gather(p)
        h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
        a, _ = gqa_forward(slice_layer(p, "attn"), cfg, h, positions,
                           causal=False, shards=sub("attn"))
        x = x + a
        h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
        x = x + mlp_forward(slice_layer(p, "mlp"), cfg, h, sub("mlp"))
        return (constrain_act(x, mesh), positions), None

    positions = positions_of(x.shape[0], x.shape[1], 0, x.device)
    (x, _), _ = ScanBlock.run(block, slice_layer(params, "enc"),
                              (x, positions), remat=cfg.remat,
                              unroll=cfg.unroll_scans)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _heads_split(shards) -> bool:
    return shards is not None and shards.model_dim("xattn/wo") is not None


def _cross_attn(p, cfg: ArchConfig, x, xk, xv, shards=None):
    """Cross-attention with precomputed encoder K/V (no mask, no rope);
    ``shards``: the decoder layer's layout (this shard's heads)."""
    split = _heads_split(shards)
    if split:
        x = shards.f(x)
    q = tok_einsum("bse,ehd->bshd", x, p["xattn/wq"].to(x.dtype))
    bias = torch.zeros((x.shape[0], x.shape[1], xk.shape[1]),
                       dtype=torch.float32, device=x.device)
    out = sdpa(cfg, q, xk.to(x.dtype), xv.to(x.dtype), bias)
    out = tok_einsum("bshd,hde->bse", out, p["xattn/wo"].to(x.dtype))
    return shards.g(out) if split else out


def _enc_kv(p, cfg: ArchConfig, enc_out, shards=None):
    """The encoder's K and V for the decoder layer ``p``: (B, S_enc, Hkv,
    D) each, or this shard's (with the kv heads replicated over "model",
    the kv head of each of its q heads)."""
    if not _heads_split(shards):
        return tuple(tok_einsum("bse,ehd->bshd", enc_out,
                                p[w].to(enc_out.dtype))
                     for w in ("xattn/wk", "xattn/wv"))
    e = shards.f(enc_out)
    if shards.model_dim("xattn/wk") is not None:
        return tuple(tok_einsum("bse,ehd->bshd", e, p[w].to(e.dtype))
                     for w in ("xattn/wk", "xattn/wv"))
    hq = p["xattn/wq"].shape[1]
    group = cfg.n_heads // cfg.n_kv_heads
    kv = (shards.mi * hq + torch.arange(hq, device=e.device)) // group
    lo, hi = shards.mi * hq // group, (shards.mi * hq + hq - 1) // group + 1
    return tuple(tok_einsum("bse,ehd->bshd", e, shards.f(p[w])[:, lo:hi]
                            .to(e.dtype))[:, :, kv - lo]
                 for w in ("xattn/wk", "xattn/wv"))


def _dec_block(cfg: ArchConfig, mesh=None, shards=None,
               seq_split: bool = False):
    """One decoder layer: block(p, (x, enc_out, positions), cache_slice,
    cache_len) -> ((x, enc_out, positions), new self-attention cache);
    ``seq_split``: a mesh cache's slots split over "model"."""
    sub = lambda name: shards and shards.sub(name)

    def block(p, carry, cache_slice=None, cache_len=None):
        x, enc_out, positions = carry
        if shards is not None:
            p = shards.gather(p)
        h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
        a, new_cache = gqa_forward(
            slice_layer(p, "attn"), cfg, h, positions, causal=True,
            cache=None if cache_slice is None else KVCache(*cache_slice),
            cache_len=cache_len, shards=sub("attn"), seq_split=seq_split)
        x = x + a
        h = rms_norm(x, p["ln_xattn"], cfg.norm_eps)
        xk, xv = _enc_kv(p, cfg, enc_out, shards)
        x = x + _cross_attn(p, cfg, h, xk, xv, shards)
        h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
        x = x + mlp_forward(slice_layer(p, "mlp"), cfg, h, sub("mlp"))
        return (constrain_act(x, mesh), enc_out, positions), new_cache
    return block


def _decoder(params, cfg: ArchConfig, tokens, enc_out, positions,
             self_cache=None, cache_len=None, mesh=None, shards=None,
             seq_split: bool = False):
    """The decoder's final-normed hidden states (B, S, E) and, with
    ``self_cache`` ((L, B, T, Hkv, D) K and V), the new cache;
    ``shards``: the params' layout."""
    x = constrain_act(_embed(params, cfg, tokens, shards), mesh)
    block = _dec_block(cfg, mesh, shards and shards.sub("dec", stacked=True),
                       seq_split)
    stacked = slice_layer(params, "dec")
    carry = (x, enc_out, positions)
    if self_cache is None:
        carry, _ = ScanBlock.run(lambda p, c: (block(p, c)[0], None),
                                 stacked, carry, remat=cfg.remat,
                                 unroll=cfg.unroll_scans)
        new_cache = None
    else:
        ks, vs = [], []
        for i, p in enumerate(layer_slices(stacked)):
            carry, nc = block(p, carry, (self_cache[0][i], self_cache[1][i]),
                              cache_len)
            ks.append(nc.k)
            vs.append(nc.v)
        new_cache = (torch.stack(ks), torch.stack(vs))
    return rms_norm(carry[0], params["final_norm"], cfg.norm_eps), new_cache


def encdec_loss(params, cfg: ArchConfig, batch, mesh=None, shards=None):
    """Next-token CE of the decoder given the encoded frames; returns
    (loss, metrics). Over ``mesh``: ``params`` are this rank's shards
    (``shards``), ``batch`` the global batch (frames split with the
    tokens)."""
    if mesh is not None and shards is None:
        raise ValueError("encdec_loss over a mesh needs the params' layout "
                         "(shards=)")
    batch, shared = local_batch(batch, mesh)
    params = gather_head(params, shards)
    enc_out = _encode(params, cfg, batch["frames"], mesh,
                      shards and shards.sub("enc", stacked=True))
    tokens = batch["tokens"]
    x, _ = _decoder(params, cfg, tokens, enc_out,
                    positions_of(*tokens.shape, 0, enc_out.device),
                    mesh=mesh, shards=shards)
    loss = token_loss(params, cfg, x, batch, shards, shared)
    return loss, {"loss": loss}


class EncDecCache(NamedTuple):
    self_k: torch.Tensor     # (L, B, T, Hkv, D)
    self_v: torch.Tensor
    enc_out: torch.Tensor    # (B, S_enc, E)


def encdec_init_cache(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device: DeviceLike = "cuda"):
    dev = model_device(device)
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return EncDecCache(
        torch.zeros(kv, dtype=dtype, device=dev),
        torch.zeros(kv, dtype=dtype, device=dev),
        torch.zeros((batch, cfg.enc_seq, cfg.d_model), dtype=dtype,
                    device=dev))


ENC_KEEPS = (KV_KEEP, KV_KEEP, {})     # enc_out gathered whole


def _mesh_step(mesh, shards, cache_specs):
    return None if one_device(mesh) else MeshStep(mesh, shards, cache_specs)


def encdec_prefill(params, cfg: ArchConfig, batch, max_len: int, mesh=None,
                   cache_dtype=torch.bfloat16, shards=None,
                   cache_specs=None):
    """Encode the frames and run the decoder over the prompt, building the
    self-attention cache; ``enc_out`` is stored in ``cache_dtype``. Over
    ``mesh``: every row's logits and this rank's cache shards (see the
    module docstring)."""
    step = _mesh_step(mesh, shards, cache_specs)
    if step is None:
        enc_out = _encode(params, cfg, batch["frames"])
        cache = encdec_init_cache(cfg, batch["tokens"].shape[0], max_len,
                                  cache_dtype, device=enc_out.device)
        cache = cache._replace(enc_out=enc_out.to(cache_dtype))
        return encdec_decode_step(params, cfg, cache, batch["tokens"], 0)
    b = batch["tokens"].shape[0]
    if batch["frames"].shape[1] != cfg.enc_seq:
        raise ValueError(f"over a mesh the frames must number enc_seq "
                         f"({cfg.enc_seq}), the cache's enc_out length; "
                         f"got {batch['frames'].shape[1]}")
    rows = step.rows(batch)
    enc_out = _encode(params, cfg, rows["frames"], mesh,
                      shards.sub("enc", stacked=True)).to(cache_dtype)
    if not step.shared:
        enc_out = all_gather(enc_out, 0, mesh, step.batch)
    meta = encdec_init_cache(cfg, b, max_len, cache_dtype, device="meta")
    cache = local_zeros(meta, cache_specs, mesh, enc_out.device)
    cache = cache._replace(enc_out=local_shard(enc_out, cache_specs[2],
                                               mesh).contiguous())
    return encdec_decode_step(params, cfg, cache, batch["tokens"], 0,
                              mesh=mesh, shards=shards,
                              cache_specs=cache_specs)


def encdec_decode_step(params, cfg: ArchConfig, cache, tokens, cache_len,
                       mesh=None, shards=None, cache_specs=None):
    """tokens (B, S) at positions cache_len.. -> (logits (B, V) of the last
    position, new cache). The cache passed in is left as it was. Over
    ``mesh``: as ``lm.lm_decode_step`` (see the module docstring)."""
    step = _mesh_step(mesh, shards, cache_specs)
    cl = int(cache_len)
    if step is None:
        b, s = tokens.shape
        enc_out = cache.enc_out.to(dtype_of(cfg.compute_dtype))
        x, new_cache = _decoder(params, cfg, tokens, enc_out,
                                positions_of(b, s, cl, enc_out.device),
                                self_cache=(cache.self_k, cache.self_v),
                                cache_len=cl)
        logits = _logits(params, cfg, x[:, -1:])[:, -1]
        return logits, EncDecCache(new_cache[0], new_cache[1], cache.enc_out)
    tokens = step.rows({"tokens": tokens})["tokens"]
    params = gather_head(params, shards)
    (k, bk), (v, bv), (enc, _) = (step.working(c, sp, keep) for c, sp, keep
                                  in zip(cache, cache_specs, ENC_KEEPS))
    enc_out = step.whole_rows(enc).to(dtype_of(cfg.compute_dtype))
    seq_split = bk[2] is None and step.split(cache_specs[0], 2)
    b, s = tokens.shape
    x, new_cache = _decoder(params, cfg, tokens, enc_out,
                            positions_of(b, s, cl, enc_out.device),
                            self_cache=(k, v), cache_len=cl, mesh=mesh,
                            shards=shards, seq_split=seq_split)
    logits = _logits(params, cfg, x[:, -1:], shards)[:, -1]
    logits = step.logits(logits, _head(params, cfg, shards)[1])
    return logits, EncDecCache(step.finish(new_cache[0], bk),
                               step.finish(new_cache[1], bv), cache.enc_out)


__all__ = ["EncDecCache", "encdec_decode_step", "encdec_init_cache",
           "encdec_loss", "encdec_prefill", "init_encdec"]
