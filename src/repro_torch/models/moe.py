"""Mixture-of-Experts layer, mixtral / deepseek-v2 style (counterpart of
``repro.models.moe``).

``moe_forward``: the capacity-bounded dispatch the JAX package runs inside
its ``shard_map`` region: route each token to its top-k experts, rank each
(token, slot) within its expert by a cumulative count in token order, keep
the first C per expert (later ones are dropped, as in the JAX package),
pack them into an (E, C, D) buffer, run the experts' FFNs, gather back and
combine with the routing weights. Active-expert FLOPs only. Without a mesh
one shard holds every expert. Over a mesh each "model" shard owns
ne * repl / tp virtual experts (repl = tp / ne when tp > ne: an expert's
hidden dim split over repl shards, the JAX package's virtual experts),
routes its own tokens (the rank's rows of the batch) with capacity from
their count, packs only its experts' tokens, and one "g" over "model" sums
the experts' outputs and the split FFNs; the auxiliary loss is averaged
over every rank.

``moe_forward_ref``: the exact dense loop over experts (no capacity drops)
that the JAX package's models run without a mesh, and so the one the
decoder here runs on one card; its products, like the router's, are
computed in fixed token blocks (``common.tok_einsum``), so a token's
output does not depend on how many tokens share the call.

Capacity: C = max(1, ceil(T*k*cf/E)); when T*k <= 8*E (decode and test
shapes) C = T*k, which makes the layer exactly drop-free.

Ties in the router's top-k go to the lower expert index, as
``jax.lax.top_k`` breaks them (a stable descending sort; ``torch.topk``
does not promise an order among equal values).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..distributed.collectives import mean_all
from .common import ParamCollector, activation, tok_einsum
from .mlp import init_mlp, mlp_forward


def init_moe(col: ParamCollector, cfg: ArchConfig, prefix: str = "moe"):
    e, f, ne = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    col.param(f"{prefix}/router", (e, ne), ("embed_nofsdp", None),
              dtype=torch.float32)
    col.param(f"{prefix}/w_gate", (ne, e, f), ("expert", "embed", "expert_mlp"))
    col.param(f"{prefix}/w_up", (ne, e, f), ("expert", "embed", "expert_mlp"))
    col.param(f"{prefix}/w_down", (ne, f, e), ("expert", "expert_mlp", "embed"))
    if cfg.n_shared_experts:
        init_mlp(col, cfg, f"{prefix}/shared",
                 d_ff=cfg.n_shared_experts * cfg.d_ff_expert)


def top_k(values: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, cfg: ArchConfig, x_flat):
    """x_flat (T, E) -> (ids (T,k), weights (T,k) renormalized, aux)."""
    logits = tok_einsum("bse,en->bsn", x_flat.float()[None], p["router"])[0]
    probs = torch.softmax(logits, dim=-1)
    w, ids = top_k(probs, cfg.top_k)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    # load-balance auxiliary (Switch-style): E * mean(frac_tokens * mean_prob)
    dispatch = torch.zeros_like(probs)
    dispatch.index_put_((torch.arange(ids.shape[0], device=ids.device)[:, None]
                         .expand_as(ids), ids),
                        torch.ones_like(w), accumulate=True)
    aux = cfg.n_experts * torch.mean(torch.mean(dispatch, 0)
                                     * torch.mean(probs, 0))
    return ids, w.to(x_flat.dtype), aux


def _capacity(t: int, cfg: ArchConfig) -> int:
    tk = t * cfg.top_k
    if tk <= 8 * cfg.n_experts:
        return tk  # exact (drop-free) — decode/smoke shapes
    return max(1, math.ceil(tk * cfg.capacity_factor / cfg.n_experts))


def _expert_ffn(w_gate, w_up, w_down, act, buf):
    """buf (E_loc, C, D) -> (E_loc, C, D)."""
    g = act(torch.einsum("ecd,edf->ecf", buf, w_gate))
    u = torch.einsum("ecd,edf->ecf", buf, w_up)
    return torch.einsum("ecf,efd->ecd", g * u, w_down)


def _shared(p, cfg: ArchConfig, x, shards=None):
    shared = {k[len("shared/"):]: v for k, v in p.items()
              if k.startswith("shared/")}
    return mlp_forward(shared, cfg, x,
                       None if shards is None else shards.sub("shared"))


def _dispatch(router, w_gate, w_up, w_down, cfg: ArchConfig, x,
              first: int = 0, repl: int = 1):
    """The capacity-bounded dispatch of x (B, S, E) to the experts whose
    weights are given, virtual experts first .. first + len(w_gate) - 1
    (virtual expert v is real expert v // repl); returns (this shard's
    share of y, aux)."""
    b, s, e = x.shape
    ne, k = cfg.n_experts, cfg.top_k
    ne_loc = w_gate.shape[0]
    t = b * s
    xf = x.reshape(t, e)
    ids, w, aux = _route({"router": router}, cfg, xf)
    c = _capacity(t, cfg)
    # rank of each (token, slot) within its REAL expert, in token order
    flat_ids = ids.reshape(-1)                                # (T*k,)
    oh = F.one_hot(flat_ids, ne)                              # (T*k, E)
    pos = (torch.cumsum(oh, dim=0) - 1)[
        torch.arange(t * k, device=x.device), flat_ids]       # (T*k,)
    keep = pos < c
    if ne_loc == ne and repl == 1:                    # every expert is here
        local_e, mine = flat_ids, keep
    else:
        real_of_local = (first + torch.arange(ne_loc, device=x.device)) \
            // repl
        match = flat_ids[:, None] == real_of_local[None, :]  # (T*k, ne_loc)
        local_e = torch.argmax(match.to(torch.int32), dim=1)
        mine = torch.any(match, dim=1) & keep
    e_idx = torch.where(mine, local_e, 0)
    c_idx = torch.where(mine, pos, 0)
    src = torch.repeat_interleave(xf, k, dim=0)               # (T*k, D)
    buf = torch.zeros((ne_loc, c, e), dtype=x.dtype, device=x.device)
    buf.index_put_((e_idx, c_idx), src * mine[:, None].to(src.dtype),
                   accumulate=True)
    out = _expert_ffn(w_gate.to(x.dtype), w_up.to(x.dtype),
                      w_down.to(x.dtype), activation(cfg.act), buf)
    vals = out[e_idx, c_idx] * mine[:, None].to(out.dtype)
    y = torch.sum((vals * w.reshape(-1, 1)).reshape(t, k, e), dim=1)
    return y.reshape(b, s, e), aux


def moe_forward(p, cfg: ArchConfig, x, mesh=None, model_axis: str = "model",
                batch_axes=None, shards=None):
    """x (B, S, E) -> (y, aux_loss).

    Without a mesh: the dispatch on one shard holding every expert. Over
    ``mesh``: x is this rank's tokens (its rows of the batch, or the whole
    batch where the batch does not split over the batch axes); ``p`` holds
    this rank's "model" shard of each weight, whole over the batch axes
    (the FSDP gather is the caller's); ``shards`` is its layout, the
    caller's (``Model.shards()``'s layer under "moe"). ``model_axis`` and
    ``batch_axes`` are the JAX signature's; the layout names them here."""
    if mesh is None:
        y, aux = _dispatch(p["router"], p["w_gate"], p["w_up"], p["w_down"],
                           cfg, x)
        if cfg.n_shared_experts:
            y = y + _shared(p, cfg, x)
        return y, aux
    if shards is None:
        raise ValueError("moe_forward over a mesh needs the layer's layout "
                         "(shards=)")
    sh = shards
    tp, ne = sh.tp, cfg.n_experts
    repl = max(1, tp // ne)
    if (ne * repl) % tp or cfg.d_ff_expert % repl:
        raise ValueError(f"{ne} experts (d_ff_expert {cfg.d_ff_expert}) do "
                         f"not split over a model axis of {tp}")
    ne_loc = ne * repl // tp
    ws = [p["w_gate"], p["w_up"], p["w_down"]]
    if tp > 1 and sh.model_dim("w_gate") is None:
        # experts replicated over "model" (tp > ne): cut this shard's
        # virtual experts out of the whole weights
        wg, wu, wd = (sh.f(w) for w in ws)
        e, f = cfg.d_model, cfg.d_ff_expert
        fr = f // repl
        wg = wg.reshape(ne, e, repl, fr).transpose(1, 2).reshape(
            ne * repl, e, fr)
        wu = wu.reshape(ne, e, repl, fr).transpose(1, 2).reshape(
            ne * repl, e, fr)
        wd = wd.reshape(ne * repl, fr, e)
        mine = slice(sh.mi * ne_loc, (sh.mi + 1) * ne_loc)
        ws = [wg[mine], wu[mine], wd[mine]]
    y, aux = _dispatch(sh.f_replicated(p, "router"), *ws, cfg, sh.f(x),
                       first=sh.mi * ne_loc, repl=repl)
    y = sh.g(y)                         # combine experts + ffn splits
    aux = mean_all(aux, sh.mesh)
    if cfg.n_shared_experts:
        y = y + _shared(p, cfg, x, sh)
    return y, aux


def moe_forward_ref(p, cfg: ArchConfig, x):
    """Exact dense reference: loop over experts, no capacity drops."""
    b, s, e = x.shape
    xf = x.reshape(b * s, e)
    ids, w, aux = _route(p, cfg, xf)
    act = activation(cfg.act)
    y = torch.zeros_like(xf)
    zero = torch.zeros_like(w)
    rows = xf[None]
    for ex in range(cfg.n_experts):
        g = act(tok_einsum("bse,ef->bsf", rows,
                           p["w_gate"][ex].to(xf.dtype)))
        u = tok_einsum("bse,ef->bsf", rows, p["w_up"][ex].to(xf.dtype))
        o = tok_einsum("bsf,fe->bse", g * u,
                       p["w_down"][ex].to(xf.dtype))[0]
        gate = torch.sum(torch.where(ids == ex, w, zero), dim=-1)
        y = y + o * gate[:, None]
    y = y.reshape(b, s, e)
    if cfg.n_shared_experts:
        y = y + _shared(p, cfg, x)
    return y, aux
