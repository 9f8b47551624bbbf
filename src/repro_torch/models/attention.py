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
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..configs.base import ArchConfig
from .common import ParamCollector, rms_norm, tok_einsum
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


def _online_softmax(qb, chunks, scale):
    """One query chunk qb (b,qc,hk,g,d) against ``chunks``, an iterable of
    (kb, vb, bias block (b,qc,kc), valid): flash-style accumulation with a
    running max, returns (b,qc,hk,g,dv)."""
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
    out = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
    return out.permute(0, 3, 1, 2, 4)                     # (b,qc,hk,g,d)


def _sdpa_chunked(q, k, v, bias, scale, q_chunk: int, kv_chunk: int,
                  unroll=1):
    """Flash-style two-level loop with online softmax (memory-bounded)."""
    sq, sk = q.shape[1], k.shape[1]
    qc, kc, nq, nk = _chunk_sizes(sq, sk, q_chunk, kv_chunk)
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
    lo, hi = int(kv[0]), int(kv[-1]) + 1
    k, v = (tok_einsum("bse,ehd->bshd", x,
                       shards.f(p[w])[:, lo:hi].to(x.dtype))[:, :, kv - lo]
            for w in ("wk", "wv"))
    return q, k, v


def gqa_forward(p, cfg: ArchConfig, x, positions, causal=True,
                cache: Optional[KVCache] = None, cache_len=None, mesh=None,
                shards=None):
    """x (B,S,E). With cache: decode/append mode — writes new kv at
    positions, attends over the cache. Returns (out, new_cache).
    ``shards``: the layout of ``p`` on the training mesh (no cache)."""
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
    if cache is None:
        bias = _mask_bias(positions, positions, causal, window)
        out = sdpa(cfg, q, k, v, bias)
        new_cache = None
    else:
        b, s = x.shape[:2]
        t = cache.k.shape[1]
        cl = int(cache_len)
        if s >= t:
            # Prefill longer than the cache (SWA ring buffer): attend within
            # the current sequence, then store the last t tokens at slots
            # pos % t (ring convention shared with the decode path).
            bias = _mask_bias(positions, positions, causal, window)
            out = sdpa(cfg, q, k, v, bias)
            shift = (cl + s - t) % t if t > 0 else 0
            ck = torch.roll(k[:, -t:].to(cache.k.dtype), shift, dims=1)
            cv = torch.roll(v[:, -t:].to(cache.v.dtype), shift, dims=1)
        else:
            # ring write: token with absolute position p lives at slot p % t
            idx = cl % t
            ck = _ring_update(cache.k, k.to(cache.k.dtype), idx)
            cv = _ring_update(cache.v, v.to(cache.v.dtype), idx)
            # absolute position of each slot given newest entry at idx+s-1
            newest = cl + s - 1
            slot = torch.arange(t, device=x.device)
            k_pos = newest - torch.remainder(idx + s - 1 - slot, t)
            k_pos = k_pos[None].expand(b, t)
            bias = _mask_bias(positions, k_pos, causal, window)
            out = sdpa(cfg, q, ck.to(q.dtype), cv.to(q.dtype), bias)
        new_cache = KVCache(ck, cv)
    out = tok_einsum("bshd,hde->bse", out, p["wo"].to(x.dtype))
    if _heads_split(shards):
        out = shards.g(out)
    return out, new_cache


def _update_slice(cache: torch.Tensor, new: torch.Tensor,
                  idx: int) -> torch.Tensor:
    """A copy of cache (B, T, ...) with new (B, S, ...) written at slots
    [idx, idx+S), the start clamped into [0, T - S]."""
    t, s = cache.shape[1], new.shape[1]
    start = min(max(idx, 0), t - s)
    out = cache.clone()
    out[:, start:start + s] = new
    return out


def _ring_update(cache, new, idx):
    """Write `new` (B, S, ...) at ring slots [idx, idx+S) mod T. A decode
    step (S = 1) and a prefill at cache_len 0 with S <= T never wrap."""
    return _update_slice(cache, new, idx)


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


def mla_decode(p, cfg: ArchConfig, x, positions, cache: MLACache,
               cache_len):
    """Absorbed decode: attention runs entirely in the dc-dim latent space —
    the cache stores only (c_kv, k_rope): (dc + dr) per token instead of
    2*H*D."""
    b, s, _ = x.shape
    cl = int(cache_len)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    # absorb W_UK into q: q_lat[bshc] = q_nope . W_UK
    q_lat = tok_einsum("bshd,chd->bshc", q_nope, p["w_uk"].to(x.dtype))

    c_new = tok_einsum("bse,ec->bsc", x, p["w_dkv"].to(x.dtype))
    kr_new = apply_rope(tok_einsum("bse,ed->bsd", x,
                                     p["w_kr"].to(x.dtype)),
                        positions, cfg.rope_theta)
    c_kv = _update_slice(cache.c_kv, c_new.to(cache.c_kv.dtype), cl)
    k_rope = _update_slice(cache.k_rope, kr_new.to(cache.k_rope.dtype), cl)

    t = c_kv.shape[1]
    d_full = cfg.qk_nope_dim + cfg.qk_rope_dim
    scale = 1.0 / math.sqrt(d_full)
    sc = (torch.einsum("bshc,btc->bhst", q_lat, c_kv.to(x.dtype))
          + torch.einsum("bshd,btd->bhst", q_rope, k_rope.to(x.dtype)))
    sc = sc.float() * scale
    idx = positions[:, 0] if positions.dim() == 2 else positions
    k_pos = torch.arange(t, device=x.device)[None].expand(b, t)
    bias = _mask_bias(positions, k_pos, True,
                      k_len_valid=(idx + s)[:, None, None])
    pr = torch.softmax(sc + bias[:, None], dim=-1).to(x.dtype)
    out_lat = torch.einsum("bhst,btc->bshc", pr, c_kv.to(x.dtype))
    out = tok_einsum("bshc,chd->bshd", out_lat, p["w_uv"].to(x.dtype))
    out = tok_einsum("bshd,hde->bse", out, p["wo"].to(x.dtype))
    return out, MLACache(c_kv, k_rope)
