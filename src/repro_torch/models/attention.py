"""Attention (counterpart of ``repro.models.attention``): GQA (full /
sliding-window), optional qk-norm, MLA (DeepSeek-V2 multi-head latent
attention with absorbed decode), the einsum, chunked and SWA-banded chunked
implementations, KV-cache decode paths.

Shapes: activations (B, S, E); q (B, S, H, D); kv (B, S, Hkv, D) with
H = G * Hkv. Masks are built from absolute positions so the same code serves
train, prefill and decode. The products are plain ``torch.einsum``, as the
JAX package's are plain ``jnp.einsum`` (no Pallas kernel, no fused library
attention); those of token rows with weights in fixed token blocks
(``common.tok_einsum``), so decode and prefill give the same bits. The
chunked forms are the same online-softmax loops written
as Python loops over the chunks. Cache writes return new tensors (the
cache passed in is left as it was), clamping a write that would run past
the end to the last slots, as ``dynamic_update_slice`` does.

Over a mesh (``shards``, training only) whose "model" axis splits the
heads, each shard runs its own q heads (Megatron): "f" before the
head-splitting products (q/k/v from x; for MLA, from the replicated
latents c_kv, k_rope and cq) and "g" after wo. Where the kv heads do not
divide by the axis (kv_heads falls back to replicated), each shard takes
the kv heads its own q heads group with, one per q head. Weights
replicated over "model" that a shard uses only part of (those kv heads,
the qk-norm scales) go through "f" themselves, so their gradients are
summed over the shards. With the heads replicated every shard runs the
whole attention. The JAX package's ``_seq_shard`` (``attn_seq_shard``) is
a GSPMD layout hint with no numeric effect and has no counterpart here.

Decode and prefill over a mesh (``shards`` with a cache; the cache laid
out by ``sharding.cache_specs``) are context-parallel: each "model" rank
holds its slice of the cache's slots for every KV head. The rank's q/k/v
heads (column-parallel, as in training) are all-gathered over "model" in
one call, so every rank has every head; the rank whose slots hold a new
position writes its K/V; each rank runs the online softmax over its own
slots (``_online_partial``) and one all-gather of the partials (output,
running max and sum) over "model" merges them by their log-sum-exp; the
rank's own heads of the merged output go through ``wo`` and "g". MLA's
absorbed decode does the same with its latents (one "KV head": the
latent and rotary key parts side by side). A cache whose sequence is not
split over "model" is attended whole on every rank, as on one device. A
prompt longer than an SWA ring (S >= window) attends within itself on
every rank, as on one device, and each rank keeps its slots of the ring.
One cache path (``_gqa_cache``, ``mla_decode``) serves both: without a
mesh (``shards`` None) one "rank" holds every head and slot, and nothing
is gathered or merged.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..configs.base import ArchConfig
from ..distributed.collectives import MODEL, all_gather
from .common import ParamCollector, block_of, rms_norm, tok_einsum
from .rope import apply_rope

NEG_INF = -1e9


# ----------------------------------------------------------------------
# parameter init
# ----------------------------------------------------------------------

def init_gqa(col: ParamCollector, cfg: ArchConfig, prefix: str = "attn"):
    e, h, hk, d = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    col.param(f"{prefix}/wq", (e, h, d), ("embed", "heads", "head_dim"))
    col.param(f"{prefix}/wk", (e, hk, d), ("embed", "kv_heads", "head_dim"))
    col.param(f"{prefix}/wv", (e, hk, d), ("embed", "kv_heads", "head_dim"))
    col.param(f"{prefix}/wo", (h, d, e), ("heads", "head_dim", "embed"))
    if cfg.qk_norm:
        col.param(f"{prefix}/q_norm", (d,), ("head_dim",), init="ones")
        col.param(f"{prefix}/k_norm", (d,), ("head_dim",), init="ones")


def init_mla(col: ParamCollector, cfg: ArchConfig, prefix: str = "attn"):
    e, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dc, dq = cfg.kv_lora_rank, cfg.q_lora_rank
    col.param(f"{prefix}/w_dkv", (e, dc), ("embed", "kv_lora"))
    col.param(f"{prefix}/w_kr", (e, dr), ("embed", "rope"))
    if dq:
        col.param(f"{prefix}/w_dq", (e, dq), ("embed", "q_lora"))
        col.param(f"{prefix}/w_uq", (dq, h, dn + dr),
                  ("q_lora", "heads", "head_dim"))
    else:
        col.param(f"{prefix}/w_q", (e, h, dn + dr),
                  ("embed", "heads", "head_dim"))
    col.param(f"{prefix}/w_uk", (dc, h, dn), ("kv_lora", "heads", "head_dim"))
    col.param(f"{prefix}/w_uv", (dc, h, dv), ("kv_lora", "heads", "head_dim"))
    col.param(f"{prefix}/wo", (h, dv, e), ("heads", "head_dim", "embed"))


# ----------------------------------------------------------------------
# masking
# ----------------------------------------------------------------------

def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int = 0,
               k_len_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., Sq, Sk) additive fp32 bias from absolute positions. Negative
    key positions (empty ring-buffer slots) are always masked."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    kp = k_pos[..., None, :]
    masked = kp < 0
    if causal:
        masked = masked | (diff < 0)
    if window > 0:
        masked = masked | (diff >= window)
    if k_len_valid is not None:
        masked = masked | (kp >= k_len_valid)
    shape = torch.broadcast_shapes(masked.shape, diff.shape)
    return torch.zeros(shape, dtype=torch.float32,
                       device=diff.device).masked_fill_(
        masked.expand(shape), NEG_INF)


# ----------------------------------------------------------------------
# core attention math (einsum / chunked)
# ----------------------------------------------------------------------

def _sdpa_einsum(q, k, v, bias, scale):
    """q (B,Sq,Hk,G,D); k,v (B,Sk,Hk,D); bias (B?,Sq,Sk) -> (B,Sq,Hk,G,D)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() * scale
    s = s + bias[:, None, None]
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v)


def _chunk_sizes(sq: int, sk: int, q_chunk: int, kv_chunk: int):
    qc = min(q_chunk, sq)
    kc = min(kv_chunk, sk)
    while sq % qc:
        qc //= 2
    while sk % kc:
        kc //= 2
    return qc, kc, sq // qc, sk // kc


def _online_partial(qb, chunks, scale):
    """One query chunk qb (b,qc,hk,g,d) against ``chunks``, an iterable of
    (kb, vb, bias block (b,qc,kc), valid): flash-style accumulation with a
    running max; returns the unnormalized (acc (b,hk,g,qc,dv), running max
    m and sum l (b,hk,g,qc) in fp32)."""
    b, qc, hk, g, _ = qb.shape
    acc = m = l = None
    for kb, vb, bk, valid in chunks:
        s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb).float()
        s = s * scale + bk[:, None, None]
        if not valid:
            s = torch.full_like(s, NEG_INF)
        if acc is None:
            acc = torch.zeros((b, hk, g, qc, vb.shape[-1]), dtype=qb.dtype,
                              device=qb.device)
            m = torch.full((b, hk, g, qc), NEG_INF, dtype=torch.float32,
                           device=qb.device)
            l = torch.zeros((b, hk, g, qc), dtype=torch.float32,
                            device=qb.device)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(qb.dtype), vb)
        acc = acc * corr[..., None].to(acc.dtype) + pv
        m = m_new
    return acc, m, l


def _online_softmax(qb, chunks, scale):
    """``_online_partial`` normalized: (b,qc,hk,g,dv)."""
    acc, _, l = _online_partial(qb, chunks, scale)
    out = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
    return out.permute(0, 3, 1, 2, 4)                     # (b,qc,hk,g,d)


def _sdpa_chunked(q, k, v, bias, scale, q_chunk: int, kv_chunk: int,
                  unroll=1):
    """Flash-style two-level loop with online softmax (memory-bounded)."""
    sq, sk = q.shape[1], k.shape[1]
    qc, kc, nq, nk = _chunk_sizes(sq, sk, block_of(q_chunk, sq, q.device),
                                  block_of(kv_chunk, sk, q.device))
    outs = []
    for iq in range(nq):
        qs = slice(iq * qc, (iq + 1) * qc)
        outs.append(_online_softmax(q[:, qs], (
            (k[:, ik * kc:(ik + 1) * kc], v[:, ik * kc:(ik + 1) * kc],
             bias[:, qs, ik * kc:(ik + 1) * kc], True)
            for ik in range(nk)), scale))
    return torch.cat(outs, dim=1)


def _sdpa_chunked_banded(q, k, v, bias, scale, q_chunk, kv_chunk,
                         window: int, unroll=1):
    """SWA-banded flash attention: each query chunk visits only a FIXED
    band of ceil(window/kc)+1 kv chunks, newest first; slots before the
    sequence start are masked (clipping would count chunk 0 twice).
    Compute drops from O(S^2) to O(S * window)."""
    sq, sk = q.shape[1], k.shape[1]
    qc, kc, nq, nk = _chunk_sizes(sq, sk, q_chunk, kv_chunk)
    nband = min(nk, window // kc + (qc + kc - 1) // kc + 1)
    outs = []
    for iq in range(nq):
        qs = slice(iq * qc, (iq + 1) * qc)

        def band(iq=iq, qs=qs):
            for bi in range(nband):
                ki_raw = (iq * qc + qc - 1) // kc - bi
                ki = min(max(ki_raw, 0), nk - 1)
                ks = slice(ki * kc, (ki + 1) * kc)
                yield k[:, ks], v[:, ks], bias[:, qs, ks], ki_raw >= 0

        outs.append(_online_softmax(q[:, qs], band(), scale))
    return torch.cat(outs, dim=1)


def sdpa(cfg: ArchConfig, q, k, v, bias):
    """Grouped-query attention dispatch. q (B,S,H,D), k/v (B,T,Hkv,D)."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    g = h // hk
    qg = q.reshape(b, s, hk, g, d)
    scale = 1.0 / math.sqrt(d)
    if cfg.attention_impl == "chunked" and s > 1:
        if cfg.swa_banded and cfg.attn_kind == "swa" and s == k.shape[1]:
            out = _sdpa_chunked_banded(qg, k, v, bias, scale,
                                       cfg.attn_q_chunk, cfg.attn_kv_chunk,
                                       cfg.window)
        else:
            out = _sdpa_chunked(qg, k, v, bias, scale,
                                cfg.attn_q_chunk, cfg.attn_kv_chunk)
    else:
        out = _sdpa_einsum(qg, k, v, bias, scale)
    return out.reshape(b, s, h, out.shape[-1])


# ----------------------------------------------------------------------
# GQA module (train / prefill / decode)
# ----------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor           # (B, T, Hkv, D)
    v: torch.Tensor


def _heads_split(shards, key: str = "wo") -> bool:
    return shards is not None and shards.model_dim(key) is not None


def _gqa_qkv(p, cfg: ArchConfig, x, shards):
    """q, k, v of this shard's q heads: (B,S,Hq,D), (B,S,Hk,D) x 2."""
    if not _heads_split(shards):
        return tuple(tok_einsum("bse,ehd->bshd", x, p[w].to(x.dtype))
                     for w in ("wq", "wk", "wv"))
    x = shards.f(x)
    q = tok_einsum("bse,ehd->bshd", x, p["wq"].to(x.dtype))
    if shards.model_dim("wk") is not None:
        return (q,) + tuple(tok_einsum("bse,ehd->bshd", x, p[w].to(x.dtype))
                            for w in ("wk", "wv"))
    # kv heads replicated: the kv head of each of this shard's q heads
    hq = q.shape[2]
    group = cfg.n_heads // cfg.n_kv_heads
    kv = (shards.mi * hq + torch.arange(hq, device=x.device)) // group
    lo, hi = shards.mi * hq // group, (shards.mi * hq + hq - 1) // group + 1
    k, v = (tok_einsum("bse,ehd->bshd", x,
                       shards.f(p[w])[:, lo:hi].to(x.dtype))[:, :, kv - lo]
            for w in ("wk", "wv"))
    return q, k, v


def gqa_forward(p, cfg: ArchConfig, x, positions, causal=True,
                cache: Optional[KVCache] = None, cache_len=None, mesh=None,
                shards=None, seq_split: bool = False):
    """x (B,S,E). With cache: decode/append mode — writes new kv at
    positions, attends over the cache (``_gqa_cache``). Returns (out,
    new_cache). ``shards``: the layout of ``p`` on the mesh; with a cache,
    the cache is this rank's shard, its slots split over "model" when
    ``seq_split`` (context-parallel, see the module docstring)."""
    if cache is not None:
        return _gqa_cache(p, cfg, x, positions, causal, cache, cache_len,
                          shards, seq_split)
    q, k, v = _gqa_qkv(p, cfg, x, shards)
    if cfg.qk_norm:
        qn, kn = p["q_norm"], p["k_norm"]
        if _heads_split(shards):
            qn, kn = shards.f(qn), shards.f(kn)
        q = rms_norm(q, qn, cfg.norm_eps)
        k = rms_norm(k, kn, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.window if cfg.attn_kind == "swa" else 0
    out = sdpa(cfg, q, k, v, _mask_bias(positions, positions, causal,
                                        window))
    out = tok_einsum("bshd,hde->bse", out, p["wo"].to(x.dtype))
    if _heads_split(shards):
        out = shards.g(out)
    return out, None


# ----------------------------------------------------------------------
# attention over a cache, on one device or context-parallel over a mesh
# ----------------------------------------------------------------------

def _gather_heads(parts, shards):
    """Tensors (B, S, heads of this rank, ...) all-gathered over "model"
    along their head dim, in one call: (B, S, every head, ...) each, in
    head order (a rank's heads are a contiguous run)."""
    widths = [t.shape[2] for t in parts]
    g = all_gather(torch.cat(parts, 2)[:, :, None], 2, shards.mesh, MODEL)
    out, lo = [], 0
    for w in widths:
        t = g[:, :, :, lo:lo + w]
        out.append(t.reshape(t.shape[0], t.shape[1], -1, *t.shape[4:]))
        lo += w
    return out


def _all_heads(p, cfg: ArchConfig, x, shards):
    """q (B,S,H,D), k, v (B,S,Hk,D) of every head on every "model" rank:
    the heads split over "model" computed column-parallel and gathered;
    kv heads replicated over "model" (or no mesh) computed whole."""
    q, k, v = (tok_einsum("bse,ehd->bshd", x, p[w].to(x.dtype))
               for w in ("wq", "wk", "wv"))
    split = [_heads_split(shards, w) for w in ("wq", "wk", "wv")]
    if not any(split):
        return q, k, v
    it = iter(_gather_heads([t for t, s in zip((q, k, v), split) if s],
                            shards))
    return tuple(next(it) if s else t for t, s in zip((q, k, v), split))


def _merge_partials(acc, m, l, shards):
    """The partial softmaxes of every "model" rank (``_online_partial``'s
    acc, m, l), all-gathered in one call and merged by their log-sum-exp:
    (b,qc,hk,g,dv)."""
    packed = torch.cat([acc.float(), m[..., None], l[..., None]], dim=-1)
    allp = all_gather(packed[None], 0, shards.mesh, MODEL)
    accs, ms, ls = allp[..., :-2], allp[..., -2], allp[..., -1]
    w = torch.exp(ms - torch.amax(ms, dim=0))
    num = torch.sum(accs * w[..., None], dim=0)
    den = torch.clamp(torch.sum(ls * w, dim=0), min=1e-30)
    return (num / den[..., None]).to(acc.dtype).permute(0, 3, 1, 2, 4)


def _cache_attend(cfg: ArchConfig, q, k, v, bias, scale, shards,
                  seq_split: bool):
    """q (B,S,H,Dq) every head; k (B,Tl,Hk,Dq), v (B,Tl,Hk,Dv) the rank's
    slots (the whole cache when not ``seq_split``); bias (B,S,Tl). Not
    split: the one-device attention (``sdpa``'s chunked or einsum form).
    Split: the online softmax over the rank's slots (in the config's
    chunks when chunked and S > 1), merged over "model": (B,S,H,Dv)."""
    b, s, h, d = q.shape
    hk, tl = k.shape[2], k.shape[1]
    qg = q.reshape(b, s, hk, h // hk, d)
    chunked = cfg.attention_impl == "chunked" and s > 1
    if not seq_split:
        out = _sdpa_chunked(qg, k, v, bias, scale, cfg.attn_q_chunk,
                            cfg.attn_kv_chunk) if chunked \
            else _sdpa_einsum(qg, k, v, bias, scale)
        return out.reshape(b, s, h, out.shape[-1])
    qc, kc, nq, nk = _chunk_sizes(
        s, tl, block_of(cfg.attn_q_chunk, s, q.device),
        block_of(cfg.attn_kv_chunk, tl, q.device)) if chunked \
        else (s, tl, 1, 1)
    outs = []
    for iq in range(nq):
        qs = slice(iq * qc, (iq + 1) * qc)
        acc, m, l = _online_partial(qg[:, qs], (
            (k[:, ik * kc:(ik + 1) * kc], v[:, ik * kc:(ik + 1) * kc],
             bias[:, qs, ik * kc:(ik + 1) * kc], True)
            for ik in range(nk)), scale)
        outs.append(_merge_partials(acc, m, l, shards))
    out = torch.cat(outs, dim=1) if nq > 1 else outs[0]
    return out.reshape(b, s, h, out.shape[-1])


def _slots(cache_t: torch.Tensor, shards, seq_split: bool):
    """(global slot count, this rank's first slot) of a cache whose dim 1
    is its slots (split over "model" when ``seq_split``)."""
    tl = cache_t.shape[1]
    if not seq_split:
        return tl, 0
    return tl * shards.tp, shards.mi * tl


def _update_shard(cache: torch.Tensor, new: torch.Tensor, idx: int,
                  t: int, off: int) -> torch.Tensor:
    """A copy of the slots [off, off + Tl) of a cache of ``t`` slots (the
    whole cache: off 0, Tl = t) with the rows of new (B, S, ...) that land
    there written at slots [idx, idx + S), the start clamped into [0, t -
    S] as ``dynamic_update_slice`` does (a decode step, S = 1, and a
    prefill at cache_len 0 with S <= t never wrap a ring); the cache itself
    when none land there."""
    s, tl = new.shape[1], cache.shape[1]
    start = min(max(idx, 0), t - s)
    lo, hi = max(start, off), min(start + s, off + tl)
    if lo >= hi:
        return cache
    out = cache.clone()
    out[:, lo - off:hi - off] = new[:, lo - start:hi - start]
    return out


def _own_heads_out(p, out, shards, wo: str = "wo", pre=None):
    """The rank's heads of ``out`` (B,S,H,...) through ``pre`` (if given)
    and ``wo``, "g" over "model" when the heads are split."""
    split = _heads_split(shards, wo)
    if split:
        hl = p[wo].shape[0]
        out = out[:, :, shards.mi * hl:(shards.mi + 1) * hl]
    if pre is not None:
        out = pre(out)
    out = tok_einsum("bshd,hde->bse", out, p[wo].to(out.dtype))
    return shards.g(out) if split else out


def _gqa_cache(p, cfg: ArchConfig, x, positions, causal, cache,
               cache_len, shards, seq_split: bool):
    """``gqa_forward`` with a cache, without a mesh (``shards`` None) or
    over one (see the module docstring): (out (B,S,E), the new cache, this
    rank's shard of it)."""
    q, k, v = _all_heads(p, cfg, x, shards)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.window if cfg.attn_kind == "swa" else 0
    b, s = x.shape[:2]
    t, off = _slots(cache.k, shards, seq_split)
    tl = cache.k.shape[1]
    cl = int(cache_len)
    if s >= t:
        # a prompt at least as long as the cache (an SWA ring): attend
        # within the prompt, then keep its last t tokens at slots pos % t
        # (the ring convention of the decode step), this rank's of them
        bias = _mask_bias(positions, positions, causal, window)
        out = sdpa(cfg, q, k, v, bias)
        shift = (cl + s - t) % t if t > 0 else 0
        ck = torch.roll(k[:, -t:].to(cache.k.dtype), shift,
                        dims=1)[:, off:off + tl]
        cv = torch.roll(v[:, -t:].to(cache.v.dtype), shift,
                        dims=1)[:, off:off + tl]
    else:
        # ring write: the token at absolute position p lives at slot p % t
        idx = cl % t
        ck = _update_shard(cache.k, k.to(cache.k.dtype), idx, t, off)
        cv = _update_shard(cache.v, v.to(cache.v.dtype), idx, t, off)
        # each slot's absolute position, the newest entry at idx + s - 1
        newest = cl + s - 1
        slot = off + torch.arange(tl, device=x.device)
        k_pos = (newest - torch.remainder(idx + s - 1 - slot, t))[None] \
            .expand(b, tl)
        bias = _mask_bias(positions, k_pos, causal, window)
        out = _cache_attend(cfg, q, ck.to(q.dtype), cv.to(q.dtype), bias,
                            1.0 / math.sqrt(q.shape[-1]), shards, seq_split)
    return _own_heads_out(p, out, shards), KVCache(ck, cv)


# ----------------------------------------------------------------------
# MLA module (DeepSeek-V2): train full-rank path + absorbed decode path
# ----------------------------------------------------------------------

class MLACache(NamedTuple):
    c_kv: torch.Tensor        # (B, T, dc)   compressed kv latents
    k_rope: torch.Tensor      # (B, T, dr)   shared rotary key part


def _mla_q(p, cfg, x, positions, f=lambda t: t):
    """(q_nope, q_rope) of the heads of ``p``; ``f`` is applied to the
    replicated tensor the head-splitting product reads."""
    if cfg.q_lora_rank:
        cq = tok_einsum("bse,er->bsr", x, p["w_dq"].to(x.dtype))
        q = tok_einsum("bsr,rhd->bshd", f(cq), p["w_uq"].to(x.dtype))
    else:
        q = tok_einsum("bse,ehd->bshd", f(x), p["w_q"].to(x.dtype))
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def mla_forward(p, cfg: ArchConfig, x, positions, causal=True,
                shards=None):
    """Training/prefill path: decompress K/V and run standard attention.
    ``shards``: the layout of ``p`` on the training mesh."""
    split = _heads_split(shards)
    f = shards.f if split else (lambda t: t)
    q_nope, q_rope = _mla_q(p, cfg, x, positions, f)
    c_kv = f(tok_einsum("bse,ec->bsc", x, p["w_dkv"].to(x.dtype)))
    k_rope = f(apply_rope(tok_einsum("bse,ed->bsd", x,
                                       p["w_kr"].to(x.dtype)),
                          positions, cfg.rope_theta))
    k_nope = tok_einsum("bsc,chd->bshd", c_kv, p["w_uk"].to(x.dtype))
    v = tok_einsum("bsc,chd->bshd", c_kv, p["w_uv"].to(x.dtype))

    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], cfg.qk_rope_dim)], dim=-1)
    bias = _mask_bias(positions, positions, causal)
    # full multi-head (n_kv == n_heads) attention with (dn+dr) keys, dv values
    d_full = cfg.qk_nope_dim + cfg.qk_rope_dim
    scale = 1.0 / math.sqrt(d_full)
    b_, s_, h, _ = q.shape
    if cfg.attention_impl == "chunked" and s_ > 1:
        out = _sdpa_chunked(q.reshape(b_, s_, h, 1, d_full), k, v, bias,
                            scale, cfg.attn_q_chunk, cfg.attn_kv_chunk)
        out = out.reshape(b_, s_, h, cfg.v_head_dim)
    else:
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        sc = sc + bias[:, None]
        pr = torch.softmax(sc, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", pr, v)
    out = tok_einsum("bshd,hde->bse", out, p["wo"].to(x.dtype))
    return shards.g(out) if split else out


def _latent_attend(q_lat, q_rope, c_kv, k_rope, bias, scale):
    """Absorbed attention over a whole latent cache (no mesh, or a mesh
    that does not split its slots): the latent and rotary scores as two
    products, summed; (B,S,H,dc)."""
    sc = (torch.einsum("bshc,btc->bhst", q_lat, c_kv)
          + torch.einsum("bshd,btd->bhst", q_rope, k_rope))
    sc = sc.float() * scale
    pr = torch.softmax(sc + bias[:, None], dim=-1).to(q_lat.dtype)
    return torch.einsum("bhst,btc->bshc", pr, c_kv)


def mla_decode(p, cfg: ArchConfig, x, positions, cache: MLACache,
               cache_len, shards=None, seq_split: bool = False):
    """Absorbed decode: attention runs entirely in the dc-dim latent space —
    the cache stores only (c_kv, k_rope): (dc + dr) per token instead of
    2*H*D. Over a mesh (``shards``): the rank's heads' absorbed queries
    gathered over "model", the latents (computed whole: their weights are
    replicated over "model") written by the rank owning their slots; over
    slots split by "model" (``seq_split``) the online softmax over the
    rank's slots (the queries' latent and rotary parts side by side
    against the latents and rotary keys, one "KV head") merged over
    "model"; then the rank's heads through ``w_uv`` and ``wo`` and "g"."""
    b, s, _ = x.shape
    cl = int(cache_len)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    # absorb W_UK into q: q_lat[bshc] = q_nope . W_UK
    q_lat = tok_einsum("bshd,chd->bshc", q_nope, p["w_uk"].to(x.dtype))
    if _heads_split(shards, "w_uk"):
        q, = _gather_heads([torch.cat([q_lat, q_rope], dim=-1)], shards)
        q_lat, q_rope = q.split([q_lat.shape[-1], q_rope.shape[-1]], -1)
    c_new = tok_einsum("bse,ec->bsc", x, p["w_dkv"].to(x.dtype))
    kr_new = apply_rope(tok_einsum("bse,ed->bsd", x,
                                     p["w_kr"].to(x.dtype)),
                        positions, cfg.rope_theta)
    t, off = _slots(cache.c_kv, shards, seq_split)
    tl = cache.c_kv.shape[1]
    c_kv = _update_shard(cache.c_kv, c_new.to(cache.c_kv.dtype), cl, t, off)
    k_rope = _update_shard(cache.k_rope, kr_new.to(cache.k_rope.dtype), cl,
                           t, off)
    idx = positions[:, 0] if positions.dim() == 2 else positions
    k_pos = (off + torch.arange(tl, device=x.device))[None].expand(b, tl)
    bias = _mask_bias(positions, k_pos, True,
                      k_len_valid=(idx + s)[:, None, None])
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    if seq_split:
        out_lat = _cache_attend(
            cfg, torch.cat([q_lat, q_rope], dim=-1),
            torch.cat([c_kv, k_rope], dim=-1).to(x.dtype)[:, :, None],
            c_kv.to(x.dtype)[:, :, None], bias, scale, shards, True)
    else:
        out_lat = _latent_attend(q_lat, q_rope, c_kv.to(x.dtype),
                                 k_rope.to(x.dtype), bias, scale)
    out = _own_heads_out(p, out_lat, shards, pre=lambda o: tok_einsum(
        "bshc,chd->bshd", o, p["w_uv"].to(x.dtype)))
    return out, MLACache(c_kv, k_rope)
