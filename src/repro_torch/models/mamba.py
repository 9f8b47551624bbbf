"""Mamba state-space layers (counterpart of ``repro.models.mamba``).

mamba1 (falcon-mamba): selective scan h_t = exp(dt A) h_{t-1} + dt B_t x_t,
y_t = C_t h_t + D x_t. Time is processed in chunks, as in the JAX package:
within a chunk an inclusive scan by log-step doubling (Hillis-Steele, out
of place, so autograd keeps each level when a layer is recomputed), and the
(B, d_inner, N) state carried across chunks in a loop. The scan's order of
products differs from ``jax.lax.associative_scan``'s by fp32 rounding only.
Live memory is one chunk of states: (B, chunk, d_inner, N) fp32, 33.5 MB a
batch row at falcon-mamba-7b's width.

mamba2 (zamba2): the chunked SSD algorithm, an attention-like quadratic
term within a chunk and the low-rank state passed between chunks. The
intra-chunk decay is ``exp(where(causal, seg, -inf))``: above the diagonal
``seg`` is positive and its ``exp`` can overflow, where the JAX package's
``where(causal, exp(seg), 0)`` would then give a backward of 0 * inf; the
forward values are the same.

Both have O(1)-state decode steps (the last d_conv - 1 pre-conv inputs and
the ssm state). The depthwise conv sums its taps in one order in the
prefill and the decode step, so both give a position the same bits. Every
product of token rows with a weight goes through ``common.tok_einsum``.

Over a mesh's "model" axis (``shards``: the layer's layout, keys without
the "mamba/" prefix) both run split, in the layout the training rules
give their leaves (d_inner on "model"), forward and backward:

  * mamba1, column-parallel over d_inner: "f" on the input, each rank
    projects its contiguous chunk of ``w_in``'s [x | z] columns and one
    all-gather (``collectives.gather``: its backward a reduce-scatter)
    gives every rank both halves, of which it keeps its own d_inner
    columns; the depthwise conv and the scan run on those columns and its
    slice of the state; ``w_x``'s contraction over d_inner is summed over
    "model" with ``reduce_sum`` (its output feeds each rank's own columns,
    so its backward sums too) and ``w_out``'s with "g". Collectives a
    layer: forward an all-gather (B x L x 2 d_inner) and two all-reduces
    (B x L x (dt_rank + 2 N), B x L x d_model); backward a reduce-scatter
    (B x L x 2 d_inner / tp) and two all-reduces (B x L x (dt_rank + 2 N),
    "f"'s B x L x d_model). Training, prefill and decode run it.
  * mamba2, over heads: one all-gather of the ``w_in`` product [z | x | B
    | C | dt] (its 2 d_inner + 2 N + H columns cut contiguously across
    "model", not by head), of which each rank keeps its heads' z, x and dt
    columns and the whole of B and C; the depthwise conv runs on its x
    channels and B and C, the SSD scan on its heads; the gated RMSNorm
    sums the ranks' sums of squares (``reduce_sum``); "g" after ``w_out``
    (``norm_w`` and ``w_out`` are split by d_inner, aligned with the
    heads). Each sum over the ranks is taken in fp32 on fp32 partials and
    rounded to bf16 once, where one device rounds its own sum: the
    products from inputs widened to fp32 (``w_in``'s x gradient, ``w_out``),
    B and C's gradient through "f" in fp32 before the conv's backward, so
    every rank holds it whole and the first alone passes B and C's part on
    (``collectives.grad_on_first``): a bf16 pass rounds where one
    device's does. The replicated ``conv_w``, ``conv_b``, ``dt_bias``,
    ``a_log`` and ``d`` (MAMBA2_PARTIAL_KEYS) get each rank's part of
    their gradient, for the caller to sum over "model" (training: once a
    step, ``train.loop.sum_replicated_grads``). Training, prefill and
    decode run it.
    Collectives a layer: forward an all-gather (B x L x (2 d_inner + 2 N
    + H)) and two fp32 all-reduces (B x L x 1, B x L x d_model); backward
    a reduce-scatter and three fp32 all-reduces (the norm's B x L x 1,
    "f"'s B x L x d_model and B and C's B x L x 2 N). The prefill and
    decode state's
    conv tail comes out whole on every rank (the gathered product holds
    every column), the ssm state as the rank's heads.

``split_layout`` says whether a layer can run so: a "model" axis of more
than one rank whose size divides d_inner (mamba2: the head count) and
every such leaf split over it. Otherwise (the divisibility fallback) the
callers gather the layer whole and every "model" rank computes it whole.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..device import DeviceLike
from ..distributed.collectives import (MODEL, gather, grad_on_first,
                                      reduce_sum)
from .common import (ParamCollector, block_of, model_device, rms_norm,
                     tok_einsum)


def _chunk_of(chunk: int, length: int) -> int:
    """The chunk length: ``chunk`` (at most ``length``), halved until it
    divides ``length``."""
    ck = min(chunk, length)
    while length % ck:
        ck //= 2
    return ck


# ----------------------------------------------------------------------
# shared: causal depthwise conv (explicit shifts; decode keeps the tail)
# ----------------------------------------------------------------------

def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, L, C); w (K, C) depthwise taps (tap k multiplies x[t-K+1+k])."""
    k, length = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for i in range(k):
        shift = k - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :length]
        out = out + xi * w[i][None, None, :]
    if bias is not None:
        out = out + bias[None, None, :]
    return out


def _conv_step(state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None):
    """state (B, K-1, C) past inputs; x_t (B, C). Returns (y_t, new_state);
    the taps summed in ``_causal_conv``'s order."""
    full = torch.cat([state, x_t[:, None]], dim=1)             # (B, K, C)
    y = torch.zeros_like(full[:, 0])
    for i in range(w.shape[0]):
        y = y + full[:, i] * w[i][None, :]
    if bias is not None:
        y = y + bias[None, :]
    return y, full[:, 1:]


def _conv_tail(raw: torch.Tensor, km1: int) -> torch.Tensor:
    """The decode state's conv part: the last ``km1`` pre-conv inputs,
    left-padded with zeros when the prompt is shorter."""
    tail = raw[:, -km1:]
    return F.pad(tail, (0, 0, max(km1 - raw.shape[1], 0), 0))


# ----------------------------------------------------------------------
# mamba1
# ----------------------------------------------------------------------

class Mamba1State(NamedTuple):
    conv: torch.Tensor    # (B, K-1, d_inner)
    ssm: torch.Tensor     # (B, d_inner, N)


def init_mamba1(col: ParamCollector, cfg: ArchConfig, prefix: str = "mamba"):
    e, di, n, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    col.param(f"{prefix}/w_in", (e, 2 * di), ("embed", "inner"))
    col.param(f"{prefix}/conv_w", (cfg.d_conv, di), ("conv", "inner"),
              scale=0.5)
    col.param(f"{prefix}/conv_b", (di,), ("inner",), init="zeros")
    col.param(f"{prefix}/w_x", (di, dtr + 2 * n), ("inner", None))
    col.param(f"{prefix}/w_dt", (dtr, di), (None, "inner"))
    col.param(f"{prefix}/dt_bias", (di,), ("inner",), init="zeros")
    col.param(f"{prefix}/a_log", (di, n), ("inner", "state"), init="zeros")
    col.param(f"{prefix}/d", (di,), ("inner",), init="ones")
    col.param(f"{prefix}/w_out", (di, e), ("inner", "embed"))


MAMBA1_KEYS = ("w_in", "conv_w", "conv_b", "w_x", "w_dt", "dt_bias",
               "a_log", "d", "w_out")
MAMBA2_SPLIT_KEYS = ("w_in", "norm_w", "w_out")


def split_layout(cfg: ArchConfig, lsh):
    """The layout of a mamba layer's leaves (keys without "mamba/") when
    the layer runs split over "model" under ``lsh``, the stack's one-layer
    layout; None without a mesh or in the divisibility fallback."""
    if lsh is None:
        return None
    msh = lsh.sub("mamba")
    if cfg.mamba_version == 1:
        split = msh.split(MAMBA1_KEYS, cfg.d_inner)
    else:
        split = msh.split(MAMBA2_SPLIT_KEYS, cfg.d_inner // cfg.ssm_head_dim)
    return msh if split else None


def _gathered_product(x: torch.Tensor, w: torch.Tensor, shards):
    """x @ w with w's columns split over "model": "f" on x, the rank's
    columns, then every rank's all-gathered (backward: reduce-scatter)."""
    part = tok_einsum("ble,ei->bli", shards.f(x), w.to(x.dtype))
    return gather(part, part.dim() - 1, shards.mesh, MODEL)


def _mamba1_inputs(p, cfg: ArchConfig, x: torch.Tensor, shards=None):
    """(u, z): the input projection split into the conv branch and the
    gate; column-parallel over "model" (``shards``), this rank's d_inner
    columns of each."""
    if shards is None:
        xz = tok_einsum("ble,ei->bli", x, p["w_in"].to(x.dtype))
        u, z = xz.chunk(2, dim=-1)
        return u, z
    xz = _gathered_product(x, p["w_in"], shards)
    c = cfg.d_inner // shards.tp
    lo = shards.mi * c
    return xz[..., lo:lo + c], xz[..., cfg.d_inner + lo:cfg.d_inner + lo + c]


def _mamba1_ssm_params(p, cfg: ArchConfig, u: torch.Tensor, shards=None):
    """(dt, A, B, C) of the selective scan, in fp32 (over "model": the
    contraction over d_inner summed, dt of this rank's columns)."""
    dtr, n = cfg.dt_rank, cfg.ssm_state
    proj = tok_einsum("bli,ir->blr", u, p["w_x"].to(u.dtype))
    if shards is not None:
        proj = reduce_sum(proj, shards.mesh)
    dt_in, b_in, c_in = proj.split([dtr, n, n], dim=-1)
    dt = F.softplus(
        tok_einsum("blr,ri->bli", dt_in, p["w_dt"].to(u.dtype)).float()
        + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())                # (di, N), negative
    return dt, a, b_in.float(), c_in.float()


def _scan_chunk(adt: torch.Tensor, bx: torch.Tensor):
    """Inclusive scan along dim 1 of h_t = adt_t h_{t-1} + bx_t from a zero
    state, by log-step doubling: (the decay products from each chunk start,
    the states). Each level makes new tensors (out of place)."""
    a, b = adt, bx
    d, length = 1, adt.shape[1]
    while d < length:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a, b


def mamba1_forward(p, cfg: ArchConfig, x: torch.Tensor,
                   return_state: bool = False, shards=None):
    """x (B, L, E) -> (B, L, E). Chunked scan over time. With return_state:
    also returns Mamba1State for decode continuation (the parallel-prefill
    path). ``shards``: column-parallel over "model" (see the module
    docstring; the state is this rank's d_inner columns)."""
    b, length, _ = x.shape
    u_raw, z = _mamba1_inputs(p, cfg, x, shards)
    u = F.silu(_causal_conv(u_raw, p["conv_w"].to(x.dtype),
                            p["conv_b"].to(x.dtype)))
    dt, a, b_in, c_in = _mamba1_ssm_params(p, cfg, u, shards)
    # the scan's only counted product, C . h, sums over the chunks alike
    ck = block_of(_chunk_of(cfg.ssm_chunk, length), length, x.device)
    uf = u.float()
    h = torch.zeros((b, u.shape[-1], cfg.ssm_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for lo in range(0, length, ck):
        sl = slice(lo, lo + ck)
        dt_k, u_k, b_k, c_k = dt[:, sl], uf[:, sl], b_in[:, sl], c_in[:, sl]
        adt = torch.exp(dt_k[..., None] * a[None, None])      # (B,ck,di,N)
        bx = (dt_k * u_k)[..., None] * b_k[:, :, None, :]
        a_acc, h_in = _scan_chunk(adt, bx)
        hs = h_in + a_acc * h[:, None]                       # carried state
        ys.append(torch.einsum("bldn,bln->bld", hs, c_k))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    y = y + uf * p["d"].float()[None, None]
    y = y.to(x.dtype) * F.silu(z)
    out = tok_einsum("bli,ie->ble", y, p["w_out"].to(x.dtype))
    if shards is not None:
        out = shards.g(out)
    if return_state:
        return out, Mamba1State(_conv_tail(u_raw, cfg.d_conv - 1), h)
    return out


def mamba1_decode(p, cfg: ArchConfig, x: torch.Tensor, state: Mamba1State,
                  shards=None):
    """Single-token step: x (B, 1, E) -> (y (B, 1, E), new state);
    ``shards``: column-parallel, as ``mamba1_forward``."""
    u, z = _mamba1_inputs(p, cfg, x, shards)
    u1, conv_state = _conv_step(state.conv, u[:, 0],
                                p["conv_w"].to(x.dtype),
                                p["conv_b"].to(x.dtype))
    u1 = F.silu(u1)[:, None]                               # (B, 1, di)
    dt, a, b_in, c_in = _mamba1_ssm_params(p, cfg, u1, shards)
    u1 = u1[:, 0].float()
    adt = torch.exp(dt[:, 0, :, None] * a[None])           # (B, di, N)
    bx = (dt[:, 0] * u1)[..., None] * b_in[:, 0, None, :]
    h = state.ssm * adt + bx
    y = torch.einsum("bdn,bn->bd", h, c_in[:, 0])
    y = y + u1 * p["d"].float()[None]
    y = (y.to(x.dtype) * F.silu(z[:, 0]))[:, None]
    out = tok_einsum("bli,ie->ble", y, p["w_out"].to(x.dtype))
    if shards is not None:
        out = shards.g(out)
    return out, Mamba1State(conv_state, h)


def mamba1_init_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                      device: DeviceLike = "cuda") -> Mamba1State:
    device = model_device(device)
    return Mamba1State(
        conv=torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                        dtype=torch.float32, device=device))


# ----------------------------------------------------------------------
# mamba2 (SSD) — zamba2 backbone
# ----------------------------------------------------------------------

class Mamba2State(NamedTuple):
    conv: torch.Tensor    # (B, K-1, d_inner + 2*N)
    ssm: torch.Tensor     # (B, H, hd, N)


def init_mamba2(col: ParamCollector, cfg: ArchConfig, prefix: str = "mamba"):
    e, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = di // cfg.ssm_head_dim
    conv_dim = di + 2 * n
    col.param(f"{prefix}/w_in", (e, 2 * di + 2 * n + nh), ("embed", "inner"))
    col.param(f"{prefix}/conv_w", (cfg.d_conv, conv_dim), ("conv", None),
              scale=0.5)
    col.param(f"{prefix}/conv_b", (conv_dim,), (None,), init="zeros")
    col.param(f"{prefix}/dt_bias", (nh,), (None,), init="zeros")
    col.param(f"{prefix}/a_log", (nh,), (None,), init="zeros")
    col.param(f"{prefix}/d", (nh,), (None,), init="ones")
    col.param(f"{prefix}/norm_w", (di,), ("inner",), init="ones")
    col.param(f"{prefix}/w_out", (di, e), ("inner", "embed"))


def _mamba2_split(p, cfg: ArchConfig, x: torch.Tensor, shards=None):
    """(z, xbc, dt): the gate, the conv branch (x, B, C) and dt (B, L,
    heads); over "model" (``shards``) z and dt of this rank's heads and
    the whole conv branch (``_my_channels`` picks the rank's)."""
    di, n = cfg.d_inner, cfg.ssm_state
    nh = di // cfg.ssm_head_dim
    if shards is None:
        zxbcdt = tok_einsum("ble,ei->bli", x, p["w_in"].to(x.dtype))
        z, xbc, dt = zxbcdt.split([di, di + 2 * n, nh], dim=-1)
        return z, xbc, dt
    # the rank's columns from x and w widened to fp32 (exact products, fp32
    # sums, one rounding, as one device's product); "f" sums x's gradient
    # over the ranks in fp32, before its one rounding
    part = tok_einsum("ble,ei->bli", shards.f(x.float()),
                      p["w_in"].float()).to(x.dtype)
    zxbcdt = gather(part, part.dim() - 1, shards.mesh, MODEL)
    c, hc = di // shards.tp, nh // shards.tp
    lo, hlo = shards.mi * c, 2 * di + 2 * n + shards.mi * hc
    return (zxbcdt[..., lo:lo + c], zxbcdt[..., di:2 * di + 2 * n],
            zxbcdt[..., hlo:hlo + hc])


def _my_channels(t: torch.Tensor, cfg: ArchConfig, shards=None):
    """This rank's conv channels (its heads' x, then B and C) of ``t``,
    whose last dim is the conv branch's d_inner + 2N (all of it without
    ``shards``). Every rank computes B and C's channels whole, with the
    same whole gradient (``_ssd_inputs``), so only the first rank passes
    theirs on to the sums over "model" that follow (the product's
    reduce-scatter, the replicated leaves' sum)."""
    if shards is None:
        return t
    c = cfg.d_inner // shards.tp
    lo = shards.mi * c
    return torch.cat([t[..., lo:lo + c],
                      grad_on_first(t[..., cfg.d_inner:], shards.mesh)],
                     dim=-1)


# mamba2's leaves replicated over "model" of which each rank uses its conv
# channels or heads: split over "model", each rank's gradient of them is
# partial, and the caller sums it over "model"
MAMBA2_PARTIAL_KEYS = ("conv_w", "conv_b", "dt_bias", "a_log", "d")


def _mamba2_local(p, cfg: ArchConfig, shards=None):
    """(conv_w, conv_b, dt_bias, a_log, d) of this rank's conv channels and
    heads (MAMBA2_PARTIAL_KEYS)."""
    if shards is None:
        return tuple(p[k] for k in MAMBA2_PARTIAL_KEYS)
    hc = cfg.d_inner // cfg.ssm_head_dim // shards.tp
    h = slice(shards.mi * hc, (shards.mi + 1) * hc)
    return (_my_channels(p["conv_w"], cfg, shards),
            _my_channels(p["conv_b"], cfg, shards),
            *(p[k][h] for k in MAMBA2_PARTIAL_KEYS[2:]))


def _ssd_inputs(xbc: torch.Tensor, cfg: ArchConfig, shards=None):
    """(x, B, C) of the conv branch's output, B and C in fp32; over
    "model" B and C through "f" in fp32: the rank's heads give part of
    their gradient, summed before its one rounding to bf16, as one
    device's sum over every head is."""
    n = cfg.ssm_state
    xs, bc = xbc.split([xbc.shape[-1] - 2 * n, 2 * n], dim=-1)
    bc = bc.float() if shards is None else shards.f(bc.float())
    return (xs, *bc.split([n, n], dim=-1))


def _mamba2_out(y: torch.Tensor, w: torch.Tensor, shards=None):
    """y @ w_out; over "model" the ranks' partial products in fp32 (from
    y and w widened), summed ("g") and rounded once, as one device's."""
    if shards is None:
        return tok_einsum("bli,ie->ble", y, w.to(y.dtype))
    out = tok_einsum("bli,ie->ble", y.float(), w.float())
    return shards.g(out).to(y.dtype)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                cfg: ArchConfig, shards=None) -> torch.Tensor:
    """mamba2's gated RMSNorm over d_inner; over "model" the ranks' sums of
    squares of their columns summed (``reduce_sum``)."""
    g = y * F.silu(z)
    if shards is None:
        return rms_norm(g, w, cfg.norm_eps)
    gf = g.float()
    ss = reduce_sum((gf * gf).sum(-1, keepdim=True), shards.mesh)
    return (gf * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
            * w.float()).to(g.dtype)


def _ssd_chunked(xh, b_in, c_in, dt, a, chunk: int, h0=None):
    """SSD scan. xh (B,L,H,hd); b_in/c_in (B,L,N); dt (B,L,H) (softplus'd);
    a (H,) negative. Returns (y (B,L,H,hd), final state (B,H,hd,N)). The
    chunks' products are batched over a chunk dim c; only the state they
    carry, an elementwise update, loops from chunk to chunk."""
    b, length, h, hd = xh.shape
    n = b_in.shape[-1]
    ck = _chunk_of(chunk, length)
    nc = length // ck
    x_k = xh.float().reshape(b, nc, ck, h, hd)
    b_k, c_k = b_in.reshape(b, nc, ck, n), c_in.reshape(b, nc, ck, n)
    dt_k = dt.reshape(b, nc, ck, h)
    cum = torch.cumsum(dt_k * a, dim=2)                  # (B,c,ck,H) log-decay
    causal = torch.ones((ck, ck), dtype=torch.bool,
                        device=xh.device).tril()[:, :, None]
    # intra-chunk (attention-like) term
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,c,l,m,H) l-m
    decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
    cb = torch.einsum("bcln,bcmn->bclm", c_k, b_k)       # (B,c,ck,ck)
    w = cb[..., None] * decay * dt_k[:, :, None, :, :]   # (B,c,l,m,H)
    y = torch.einsum("bclmh,bcmhd->bclhd", w, x_k)
    # each chunk's inputs decayed to its end: the state it adds
    rev = cum[:, :, -1:, :] - cum
    contrib = torch.einsum("bclhd,bcln->bchdn",
                           x_k * (torch.exp(rev) * dt_k)[..., None], b_k)
    # the state each chunk starts from, carried through the chunks
    keep = torch.exp(cum[:, :, -1])[..., None, None]     # (B,c,H,1,1)
    state = h0 if h0 is not None else torch.zeros(
        (b, h, hd, n), dtype=torch.float32, device=xh.device)
    starts = []
    for i in range(nc):
        starts.append(state)
        state = state * keep[:, i] + contrib[:, i]
    # inter-chunk: the contribution of the carried state
    y = y + torch.einsum("bcln,bchdn->bclhd", c_k,
                         torch.stack(starts, dim=1)) \
        * torch.exp(cum)[..., None]
    return y.reshape(b, length, h, hd), state


def mamba2_forward(p, cfg: ArchConfig, x: torch.Tensor,
                   return_state: bool = False, shards=None):
    """x (B, L, E) -> (B, L, E); with return_state also the Mamba2State
    for decode continuation. ``shards``: split over "model" by heads (see
    the module docstring; the state's conv tail whole, its ssm this rank's
    heads)."""
    b, length, _ = x.shape
    hd = cfg.ssm_head_dim
    z, xbc_raw, dt = _mamba2_split(p, cfg, x, shards)
    conv_w, conv_b, dt_bias, a_log, d = _mamba2_local(p, cfg, shards)
    xbc = F.silu(_causal_conv(_my_channels(xbc_raw, cfg, shards),
                              conv_w.to(x.dtype), conv_b.to(x.dtype)))
    xs, b_in, c_in = _ssd_inputs(xbc, cfg, shards)
    dt = F.softplus(dt.float() + dt_bias.float())
    a = -torch.exp(a_log.float())
    xh = xs.reshape(b, length, -1, hd)
    y, ssm_state = _ssd_chunked(xh, b_in, c_in, dt, a, cfg.ssm_chunk)
    y = y + xh.float() * d.float()[None, None, :, None]
    y = _gated_norm(y.reshape(b, length, -1).to(x.dtype), z, p["norm_w"],
                    cfg, shards)
    out = _mamba2_out(y, p["w_out"], shards)
    if return_state:
        return out, Mamba2State(_conv_tail(xbc_raw, cfg.d_conv - 1),
                                ssm_state)
    return out


def mamba2_decode(p, cfg: ArchConfig, x: torch.Tensor, state: Mamba2State,
                  shards=None):
    """Single-token step: x (B, 1, E) -> (y (B, 1, E), new state);
    ``shards``: split as ``mamba2_forward``, the state's conv tail whole
    and its ssm this rank's heads, in and out."""
    b = x.shape[0]
    hd = cfg.ssm_head_dim
    z, xbc, dt = _mamba2_split(p, cfg, x, shards)
    conv_w, conv_b, dt_bias, a_log, d = _mamba2_local(p, cfg, shards)
    xbc1, _ = _conv_step(_my_channels(state.conv, cfg, shards),
                         _my_channels(xbc[:, 0], cfg, shards),
                         conv_w.to(x.dtype), conv_b.to(x.dtype))
    conv_state = torch.cat([state.conv, xbc], dim=1)[:, 1:]  # every channel
    xs, b_in, c_in = _ssd_inputs(F.silu(xbc1), cfg, shards)
    dt1 = F.softplus(dt[:, 0].float() + dt_bias.float())        # (B, nh)
    a = -torch.exp(a_log.float())
    xh = xs.reshape(b, -1, hd).float()
    decay = torch.exp(dt1 * a[None])                            # (B, nh)
    h = state.ssm * decay[..., None, None] + torch.einsum(
        "bhd,bn->bhdn", xh * dt1[..., None], b_in)
    y = torch.einsum("bhdn,bn->bhd", h, c_in)
    y = y + xh * d.float()[None, :, None]
    y = _gated_norm(y.reshape(b, -1).to(x.dtype), z[:, 0], p["norm_w"],
                    cfg, shards)[:, None]
    out = _mamba2_out(y, p["w_out"], shards)
    return out, Mamba2State(conv_state, h)


def mamba2_init_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                      device: DeviceLike = "cuda") -> Mamba2State:
    device = model_device(device)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    nh = cfg.d_inner // cfg.ssm_head_dim
    return Mamba2State(
        conv=torch.zeros((batch, cfg.d_conv - 1, conv_dim), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, nh, cfg.ssm_head_dim, cfg.ssm_state),
                        dtype=torch.float32, device=device))


__all__ = ["Mamba1State", "Mamba2State", "init_mamba1", "init_mamba2",
           "mamba1_decode", "mamba1_forward", "mamba1_init_state",
           "mamba2_decode", "mamba2_forward", "mamba2_init_state",
           "MAMBA2_PARTIAL_KEYS", "split_layout"]
