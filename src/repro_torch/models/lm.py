"""Decoder-only language model assembly, dense / MoE / MLA / VLM-backbone
(counterpart of ``repro.models.lm``).

Layers are stacked on a leading axis, as in the JAX package, and applied
one slice at a time. The same block code serves the loss, prefill (build
the KV cache and logits) and decode (one token, cache update); decode uses
MLA's absorbed path where the config has MLA.

VLM-stub models consume a prefix of precomputed frontend embeddings
(``batch["frontend"]``, already at d_model) followed by text tokens; the
loss is masked to text positions.

``lm_loss`` over a mesh takes the global batch and runs this rank's rows
(``common.local_batch``). Each layer all-gathers its FSDP-sharded weights
inside the layer's rematerialized block, so the backward pass gathers
them again instead of keeping every layer's. The embedding table is
gathered once and serves the lookup and, tied, the logits. With the vocab
split over "model", the lookup takes the rank's vocab slice, masked, then
"g"; the logits are vocab-parallel and so is their cross-entropy (the
row max and the exp-sum all-reduced over "model"). The loss is the global
token mean: the masked sum and the count are summed over the batch axes
(not the per-rank means: a VLM batch's masked counts differ by rank);
``token_loss`` is that tail, which the ssm, hybrid and audio families'
losses share.

Decode and prefill over a mesh (``models.decoding``) keep the weights in
the training layout and gather each layer's FSDP shards as the loss does;
attention over the cache is context-parallel (``models.attention``), the
MLP Megatron's, the MoE layer ``moe_forward`` over the mesh (expert
parallel, with its capacity: drop-free while a rank's tokens x top_k <= 8
x experts, as in decode), and the logits vocab-parallel, gathered whole
for every row on every rank.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..device import DeviceLike
from ..distributed import collectives as coll
from .attention import (KVCache, MLACache, gqa_forward, init_gqa, init_mla,
                        mla_decode, mla_forward)
from .common import (ParamCollector, ScanBlock, StackedCollector,
                     constrain_act, dtype_of, layer_slices, local_batch,
                     model_device, remat_block, rms_norm, slice_layer,
                     tok_einsum)
from .decoding import MeshStep, local_zeros, one_device
from .mlp import init_mlp, mlp_forward
from .moe import init_moe, moe_forward, moe_forward_ref


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------

def init_decoder_lm(cfg: ArchConfig, generator: Optional[torch.Generator],
                    mesh=None, place=None):
    """(params, axes), drawn from ``generator`` on its device (None: meta
    tensors); ``place`` as ``ParamCollector``'s."""
    col = ParamCollector(generator, dtype_of(cfg.param_dtype), place)
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
        sub = ParamCollector(col._next(), col.dtype,
                             col.child_place(f"dense{i}"))
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

def _moe(p, cfg, h, mesh, shards=None):
    mp = slice_layer(p, "moe")
    if mesh is not None:
        return moe_forward(mp, cfg, h, mesh,
                           shards=shards and shards.sub("moe"))
    return moe_forward_ref(mp, cfg, h)


def _block_train(cfg: ArchConfig, mesh, shards=None):
    """The layer's block; ``shards``: one layer's layout (its FSDP-sharded
    weights are gathered first thing in the block)."""
    sub = lambda name: shards and shards.sub(name)

    def block(p, carry):
        x, positions, aux = carry
        if shards is not None:
            p = shards.gather(p)
        h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
        ap = slice_layer(p, "attn")
        if cfg.attn_kind == "mla":
            a = mla_forward(ap, cfg, h, positions, shards=sub("attn"))
        else:
            a, _ = gqa_forward(ap, cfg, h, positions, mesh=mesh,
                               shards=sub("attn"))
        x = x + a
        h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
        if "moe/router" in p:
            m, aux_l = _moe(p, cfg, h, mesh, shards)
            aux = aux + aux_l
        else:
            m = mlp_forward(slice_layer(p, "mlp"), cfg, h, sub("mlp"))
        return (constrain_act(x + m, mesh), positions, aux), None
    return block


def _block_decode(cfg: ArchConfig, mesh, shards=None,
                  seq_split: bool = False):
    """The decode block; over a mesh ``shards`` is one layer's layout (its
    FSDP shards gathered first thing) and ``seq_split`` says whether the
    cache's slots are split over "model"."""
    sub = lambda name: shards and shards.sub(name)

    def block(p, carry, cache_slice, cache_len):
        x, positions = carry
        if shards is not None:
            p = shards.gather(p)
        h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
        ap = slice_layer(p, "attn")
        if cfg.attn_kind == "mla":
            a, new_cache = mla_decode(ap, cfg, h, positions,
                                      MLACache(*cache_slice), cache_len,
                                      shards=sub("attn"), seq_split=seq_split)
        else:
            a, new_cache = gqa_forward(ap, cfg, h, positions, causal=True,
                                       cache=KVCache(*cache_slice),
                                       cache_len=cache_len,
                                       shards=sub("attn"),
                                       seq_split=seq_split)
        x = x + a
        h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
        if "moe/router" in p:
            m, _ = _moe(p, cfg, h, mesh, shards)
        else:
            m = mlp_forward(slice_layer(p, "mlp"), cfg, h, sub("mlp"))
        return (constrain_act(x + m, mesh), positions), tuple(new_cache)
    return block


# ----------------------------------------------------------------------
# forward passes
# ----------------------------------------------------------------------

def embed_rows(emb: torch.Tensor, tokens: torch.Tensor,
               shards=None) -> torch.Tensor:
    """The token rows of the table ``emb`` in its dtype, through
    ``F.embedding``: its backward sums the rows of repeated tokens in a
    fixed order, where PyTorch lists indexing's backward on the CPU (an
    ``index_put_`` with accumulation) as nondeterministic; the training
    checks compare grads bitwise. With the vocab split over "model"
    (``shards``), each rank looks up its own slice, zeroes the rows of the
    tokens outside it and "g" sums them."""
    tokens = tokens.long()
    if shards is None or shards.model_dim("embed") is None:
        return F.embedding(tokens, emb)
    t = tokens - shards.mi * emb.shape[0]
    inside = (t >= 0) & (t < emb.shape[0])
    rows = F.embedding(torch.where(inside, t, 0), emb)
    return shards.g(torch.where(inside[..., None], rows, rows.new_zeros(())))


def _embed(params, cfg: ArchConfig, tokens: torch.Tensor,
           shards=None) -> torch.Tensor:
    return embed_rows(params["embed"], tokens, shards).to(
        dtype_of(cfg.compute_dtype))


def _embed_inputs(params, cfg: ArchConfig, batch: Dict[str, Any],
                  shards=None):
    x = _embed(params, cfg, batch["tokens"], shards)
    if cfg.frontend != "none" and "frontend" in batch:
        fe = batch["frontend"].to(x.dtype)
        x = torch.cat([fe, x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    return x, positions


def _run_layers(params, cfg: ArchConfig, x, positions, mesh, shards=None):
    x = constrain_act(x, mesh)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.first_k_dense):
        block = _block_train(cfg, mesh, shards and shards.sub(f"dense{i}"))
        dense = remat_block(block, "full" if cfg.remat != "none" else "none")
        (x, positions, aux), _ = dense(slice_layer(params, f"dense{i}"),
                                       (x, positions, aux))
    stacked = slice_layer(params, "layers")
    block = _block_train(cfg, mesh,
                         shards and shards.sub("layers", stacked=True))
    (x, positions, aux), _ = ScanBlock.run(
        block, stacked, (x, positions, aux), remat=cfg.remat,
        unroll=cfg.unroll_scans)
    return x, aux


def _head(params, cfg: ArchConfig, shards=None):
    """(the output head (E, V or V / tp), vocab split over "model")."""
    if cfg.tie_embeddings:
        head, key, vdim = params["embed"].T, "embed", 0
    else:
        head, key, vdim = params["lm_head"], "lm_head", 1
    return head, shards is not None and shards.model_dim(key) == vdim


def _logits(params, cfg: ArchConfig, x, shards=None):
    head, split = _head(params, cfg, shards)
    if split:
        x = shards.f(x)
    return tok_einsum("bse,ev->bsv", x, head.to(x.dtype))


def _nll(logits: torch.Tensor, targets: torch.Tensor, shards=None,
         split: bool = False) -> torch.Tensor:
    """Per-token cross-entropy of fp32 logits; ``split``: the logits are
    this rank's vocab slice (vocab-parallel: the row max and the exp-sum
    all-reduced over "model", the gold logit summed from its owner)."""
    if not split:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, targets[..., None],
                                    dim=-1)[..., 0]
        return lse - gold
    vloc = logits.shape[-1]
    top = coll.all_reduce_(logits.detach().amax(dim=-1), shards.mesh,
                           coll.MODEL, op=torch.distributed.ReduceOp.MAX)
    lse = torch.log(shards.g(torch.sum(torch.exp(logits - top[..., None]),
                                       dim=-1))) + top
    t = targets - shards.mi * vloc
    inside = (t >= 0) & (t < vloc)
    gold = torch.take_along_dim(logits, torch.where(inside, t, 0)[..., None],
                                dim=-1)[..., 0]
    return lse - shards.g(torch.where(inside, gold, gold.new_zeros(())))


def gather_head(params, shards):
    """``params`` with the embedding table (and the head) gathered over
    their FSDP axes, once for the lookup and the logits (as it is, without
    a mesh)."""
    if shards is None:
        return params
    return dict(params, **shards.gather(
        {k: params[k] for k in ("embed", "lm_head") if k in params}))


def lm_loss(params, cfg: ArchConfig, batch, mesh=None, shards=None):
    """Next-token CE, masked to text positions. Returns (loss, metrics);
    differentiable, with each stacked layer under ``cfg.remat``. Over
    ``mesh``: ``params`` are this rank's shards, laid out as ``shards``
    says (``Model.shards()``), ``batch`` the global
    batch; the loss is the global one on every rank, and each rank's
    gradients are its shards' (summed over the batch axes by the FSDP
    reduce-scatter; the caller sums those of the leaves replicated over
    them)."""
    if mesh is not None and shards is None:
        raise ValueError("lm_loss over a mesh needs the params' layout "
                         "(shards=)")
    batch, shared = local_batch(batch, mesh)
    params = gather_head(params, shards)
    x, positions = _embed_inputs(params, cfg, batch, shards)
    x, aux = _run_layers(params, cfg, x, positions, mesh, shards)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    f = cfg.frontend_seq if (cfg.frontend != "none"
                             and "frontend" in batch) else 0
    x = x[:, f:]                                   # text region only
    loss = token_loss(params, cfg, x, batch, shards, shared)
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux_loss": aux}


def token_loss(params, cfg: ArchConfig, x, batch, shards=None,
               shared: bool = False) -> torch.Tensor:
    """The mean next-token cross-entropy of the final-normed hidden states
    ``x`` against ``batch["labels"]`` (masked by ``batch["loss_mask"]``
    where there is one), through the output head; over a mesh the global
    token mean (see ``lm_loss``; ``shared``: ``local_batch``'s flag)."""
    logits = _logits(params, cfg, x, shards).float()
    targets = batch["labels"].long()
    mask = batch.get("loss_mask")
    nll = _nll(logits, targets, shards, _head(params, cfg, shards)[1])
    dp = 1 if shards is None or shared else shards.dp
    if mask is not None:
        nll = nll * mask
        denom = torch.sum(mask)
        if dp > 1:
            denom = coll.all_reduce_(denom.clone(), shards.mesh,
                                     shards.batch_axes)
        denom = torch.clamp(denom, min=1.0)
    else:
        denom = nll.numel() * dp
    num = torch.sum(nll)
    if dp > 1:
        num = coll.reduce_from(num, shards.mesh, shards.batch_axes)
    loss = num / denom
    if shared:
        # every rank ran the whole batch: their summed gradients count it
        # once
        loss = coll.scale_grad(loss, 1.0 / shards.dp)
    return loss


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


KV_KEEP = {1: "batch", 2: "model"}     # a KV cache's natively split dims


def lm_decode_step(params, cfg: ArchConfig, cache, tokens, cache_len,
                   mesh=None, shards=None, cache_specs=None):
    """tokens (B, S) at positions cache_len.. -> (logits (B, V) of the last
    position, new cache). cache_len: an int (or a 0-d tensor). The cache
    passed in is left as it was. Over ``mesh``: ``params`` are this rank's
    shards (``shards``), ``cache`` its cache shards under ``cache_specs``,
    ``tokens`` the global batch; the logits are every row's, the cache
    this rank's (see the module docstring)."""
    if one_device(mesh):
        mesh = shards = None
    step = None if mesh is None else MeshStep(mesh, shards, cache_specs)
    seq_split = False
    if step is not None:
        tokens = step.rows({"tokens": tokens})["tokens"]
        params = gather_head(params, shards)
        cache, backs = zip(*(step.working(c, sp, KV_KEEP)
                             for c, sp in zip(cache, cache_specs)))
        seq_split = backs[0][2] is None and step.split(cache_specs[0], 2)
    cl = int(cache_len)
    x = _embed(params, cfg, tokens, shards)
    b, s, _ = x.shape
    positions = (cl + torch.arange(s, device=x.device))[None].expand(b, s)
    sub = lambda name, stacked=False: shards and shards.sub(name, stacked)

    new_slices = []
    x_pos = (x, positions)
    for i in range(cfg.first_k_dense):
        block = _block_decode(cfg, mesh, sub(f"dense{i}"), seq_split)
        x_pos, nc = block(slice_layer(params, f"dense{i}"), x_pos,
                          tuple(c[i] for c in cache), cl)
        new_slices.append(nc)
    stacked = slice_layer(params, "layers")
    block = _block_decode(cfg, mesh, sub("layers", True), seq_split)
    for j, layer in enumerate(layer_slices(stacked)):
        li = cfg.first_k_dense + j
        x_pos, nc = block(layer, x_pos,
                          tuple(c[li] for c in cache), cl)
        new_slices.append(nc)
    x = rms_norm(x_pos[0], params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x[:, -1:], shards)[:, -1]
    new_cache = tuple(torch.stack(parts) for parts in zip(*new_slices))
    if step is not None:
        logits = step.logits(logits, _head(params, cfg, shards)[1])
        new_cache = tuple(step.finish(t, b)
                          for t, b in zip(new_cache, backs))
    return logits, new_cache


def lm_prefill(params, cfg: ArchConfig, batch, max_len: int, mesh=None,
               cache_dtype=torch.bfloat16, shards=None, cache_specs=None):
    """Process a full prompt: returns (last-position logits, filled cache).
    Over ``mesh`` the cache is this rank's shards under ``cache_specs``."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = params["embed"].device
    if one_device(mesh):
        cache = init_kv_cache(cfg, b, max_len, cache_dtype, device=dev)
    else:
        cache = local_zeros(init_kv_cache(cfg, b, max_len, cache_dtype,
                                          device="meta"),
                            cache_specs, mesh, dev)
    return lm_decode_step(params, cfg, cache, tokens, 0, mesh=mesh,
                          shards=shards, cache_specs=cache_specs)
