"""Decoder-only language model assembly, dense / MoE / MLA / VLM-backbone
(counterpart of ``repro.models.lm``).

Layers are stacked on a leading axis, as in the JAX package, and applied
one slice at a time. The same block code serves the loss, prefill (build
the KV cache and logits) and decode (one token, cache update); decode uses
MLA's absorbed path where the config has MLA.

VLM-stub models consume a prefix of precomputed frontend embeddings
(``batch["frontend"]``, already at d_model) followed by text tokens; the
loss is masked to text positions.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..device import DeviceLike
from .attention import (KVCache, MLACache, gqa_forward, init_gqa, init_mla,
                        mla_decode, mla_forward)
from .common import (ParamCollector, ScanBlock, StackedCollector,
                     constrain_act, dtype_of, layer_slices,
                     model_device, remat_block, rms_norm, slice_layer,
                     tok_einsum)
from .mlp import init_mlp, mlp_forward
from .moe import init_moe, moe_forward, moe_forward_ref


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------

def init_decoder_lm(cfg: ArchConfig, generator: Optional[torch.Generator],
                    mesh=None):
    """(params, axes), drawn from ``generator`` on its device (None: meta
    tensors)."""
    col = ParamCollector(generator, dtype_of(cfg.param_dtype))
    e = cfg.d_model
    col.param("embed", (cfg.vocab, e), ("vocab", "embed"), scale=0.02)
    if not cfg.tie_embeddings:
        col.param("lm_head", (e, cfg.vocab), ("embed", "vocab"), scale=0.02)
    col.param("final_norm", (e,), (None,), init="ones")

    def layer_block(col2, moe: bool):
        if cfg.attn_kind == "mla":
            init_mla(col2, cfg)
        else:
            init_gqa(col2, cfg)
        col2.param("ln_attn", (e,), (None,), init="ones")
        col2.param("ln_mlp", (e,), (None,), init="ones")
        if moe:
            init_moe(col2, cfg)
        else:
            init_mlp(col2, cfg, d_ff=(cfg.d_ff_dense or cfg.d_ff))

    n_scan = cfg.n_layers - cfg.first_k_dense
    # leading dense layers (deepseek-v2 pattern), unstacked
    for i in range(cfg.first_k_dense):
        sub = ParamCollector(col._next(), col.dtype)
        layer_block(sub, moe=False)
        for k, v in sub.params.items():
            col.params[f"dense{i}/{k}"] = v
            col.axes[f"dense{i}/{k}"] = sub.axes[k]
    # stacked layers — per-layer randomness via the stack dim
    layer_block(StackedCollector(col, n_scan, "layers"), moe=cfg.is_moe)
    return col.params, col.axes


# ----------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------

def _moe(p, cfg, h, mesh):
    mp = slice_layer(p, "moe")
    if mesh is not None:
        return moe_forward(mp, cfg, h, mesh)
    return moe_forward_ref(mp, cfg, h)


def _block_train(cfg: ArchConfig, mesh):
    def block(p, carry):
        x, positions, aux = carry
        h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
        ap = slice_layer(p, "attn")
        if cfg.attn_kind == "mla":
            a = mla_forward(ap, cfg, h, positions)
        else:
            a, _ = gqa_forward(ap, cfg, h, positions, mesh=mesh)
        x = x + a
        h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
        if "moe/router" in p:
            m, aux_l = _moe(p, cfg, h, mesh)
            aux = aux + aux_l
        else:
            m = mlp_forward(slice_layer(p, "mlp"), cfg, h)
        return (constrain_act(x + m, mesh), positions, aux), None
    return block


def _block_decode(cfg: ArchConfig, mesh):
    def block(p, carry, cache_slice, cache_len):
        x, positions = carry
        h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
        ap = slice_layer(p, "attn")
        if cfg.attn_kind == "mla":
            a, new_cache = mla_decode(ap, cfg, h, positions,
                                      MLACache(*cache_slice), cache_len)
        else:
            a, new_cache = gqa_forward(ap, cfg, h, positions, causal=True,
                                       cache=KVCache(*cache_slice),
                                       cache_len=cache_len)
        x = x + a
        h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
        if "moe/router" in p:
            m, _ = _moe(p, cfg, h, mesh)
        else:
            m = mlp_forward(slice_layer(p, "mlp"), cfg, h)
        return (constrain_act(x + m, mesh), positions), tuple(new_cache)
    return block


# ----------------------------------------------------------------------
# forward passes
# ----------------------------------------------------------------------

def _embed(params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The token rows of the table, through ``F.embedding``: its backward
    sums the rows of repeated tokens in a fixed order, where PyTorch lists
    indexing's backward on the CPU (an ``index_put_`` with accumulation)
    as nondeterministic; the training checks compare grads bitwise."""
    return F.embedding(tokens.long(), params["embed"]).to(
        dtype_of(cfg.compute_dtype))


def _embed_inputs(params, cfg: ArchConfig, batch: Dict[str, Any]):
    x = _embed(params, cfg, batch["tokens"])
    if cfg.frontend != "none" and "frontend" in batch:
        fe = batch["frontend"].to(x.dtype)
        x = torch.cat([fe, x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    return x, positions


def _run_layers(params, cfg: ArchConfig, x, positions, mesh):
    x = constrain_act(x, mesh)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = _block_train(cfg, mesh)
    dense = remat_block(block, "full" if cfg.remat != "none" else "none")
    for i in range(cfg.first_k_dense):
        (x, positions, aux), _ = dense(slice_layer(params, f"dense{i}"),
                                       (x, positions, aux))
    stacked = slice_layer(params, "layers")
    (x, positions, aux), _ = ScanBlock.run(
        block, stacked, (x, positions, aux), remat=cfg.remat,
        unroll=cfg.unroll_scans)
    return x, aux


def _logits(params, cfg: ArchConfig, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return tok_einsum("bse,ev->bsv", x, head.to(x.dtype))


def lm_loss(params, cfg: ArchConfig, batch, mesh=None):
    """Next-token CE, masked to text positions. Returns (loss, metrics);
    differentiable, with each stacked layer under ``cfg.remat``."""
    x, positions = _embed_inputs(params, cfg, batch)
    x, aux = _run_layers(params, cfg, x, positions, mesh)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    f = cfg.frontend_seq if (cfg.frontend != "none"
                             and "frontend" in batch) else 0
    x = x[:, f:]                                   # text region only
    logits = _logits(params, cfg, x).float()
    targets = batch["labels"].long()
    mask = batch.get("loss_mask")
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets[..., None], dim=-1)[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp(torch.sum(mask), min=1.0)
    else:
        denom = nll.numel()
    loss = torch.sum(nll) / denom
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux_loss": aux}


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device: DeviceLike = "cuda"):
    """Stacked KV cache over all layers. MLA caches latents (dc + dr); SWA
    keeps a ring of at most ``window`` slots."""
    dev = model_device(device)
    l = cfg.n_layers
    if cfg.attn_kind == "mla":
        return (torch.zeros((l, batch, max_len, cfg.kv_lora_rank),
                            dtype=dtype, device=dev),
                torch.zeros((l, batch, max_len, cfg.qk_rope_dim),
                            dtype=dtype, device=dev))
    hk, d = cfg.n_kv_heads, cfg.head_dim
    if cfg.attn_kind == "swa":
        max_len = min(max_len, cfg.window)
    return (torch.zeros((l, batch, max_len, hk, d), dtype=dtype, device=dev),
            torch.zeros((l, batch, max_len, hk, d), dtype=dtype, device=dev))


def lm_decode_step(params, cfg: ArchConfig, cache, tokens, cache_len,
                   mesh=None):
    """tokens (B, S) at positions cache_len.. -> (logits (B, V) of the last
    position, new cache). cache_len: an int (or a 0-d tensor). The cache
    passed in is left as it was."""
    cl = int(cache_len)
    x = _embed(params, cfg, tokens)
    b, s, _ = x.shape
    positions = (cl + torch.arange(s, device=x.device))[None].expand(b, s)
    block = _block_decode(cfg, mesh)

    new_slices = []
    x_pos = (x, positions)
    for i in range(cfg.first_k_dense):
        x_pos, nc = block(slice_layer(params, f"dense{i}"), x_pos,
                          tuple(c[i] for c in cache), cl)
        new_slices.append(nc)
    stacked = slice_layer(params, "layers")
    for j, layer in enumerate(layer_slices(stacked)):
        li = cfg.first_k_dense + j
        x_pos, nc = block(layer, x_pos,
                          tuple(c[li] for c in cache), cl)
        new_slices.append(nc)
    x = rms_norm(x_pos[0], params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x)[:, -1]
    new_cache = tuple(torch.stack(parts) for parts in zip(*new_slices))
    return logits, new_cache


def lm_prefill(params, cfg: ArchConfig, batch, max_len: int, mesh=None,
               cache_dtype=torch.bfloat16):
    """Process a full prompt: returns (last-position logits, filled cache)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache = init_kv_cache(cfg, b, max_len, cache_dtype,
                          device=params["embed"].device)
    return lm_decode_step(params, cfg, cache, tokens, 0, mesh=mesh)
