"""The plain reference of the hybrid family: Zamba2 (Glorioso et al.,
arXiv:2411.15242), a backbone of Mamba-2 blocks (Dao and Gu,
arXiv:2405.21060) with one shared attention-and-MLP block applied after
every ``attn_every`` of them, and tied input and output embeddings.

Each Mamba-2 block, pre-normed and residual: one input projection to the
gate z, the convolved branch (x, B, C) and the step dt; a causal
depthwise convolution of the branch with bias, then SiLU; dt = softplus(dt
+ dt_bias), A = -exp(a_log) a head; the SSD scan y_t = sum_{s<=t} (C_t .
B_s) exp(sum_{r=s+1..t} dt_r A) dt_s x_s, plus D x_t (one group: B and C
shared by the heads); the gated RMSNorm of y * silu(z); the output
projection. The scan is the paper's chunked form (its ``ssd_minimal``
listing, with the stable segment sums), in chunks of ``SSD_CHUNK``
positions. The shared block: RMSNorm, causal multi-head attention with
rotary embeddings on the two halves of each head (theta ``rope_theta``),
residual; RMSNorm, a SiLU-gated MLP, residual. A final RMSNorm, the
logits against the embedding table, the mean cross-entropy.

Departures from the published Zamba2, the port's own and written in its
configuration: the shared block reads the residual stream alone (no
concatenation with the input embeddings and no projection back), and it
has no LoRA adapters. Everything runs in float32 from the weights as
given; layers are recomputed in the backward pass (``checkpoint``) so
that a sequence of 2,048 tokens fits beside the state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import FP32, Precision, fan_in_scale

SSD_CHUNK = 128


def leaves(cfg: dict) -> dict:
    """{path: (shape, init, scale)} of the model's weights."""
    e, n_l = cfg["d_model"], cfg["n_layers"]
    di, n = cfg["d_inner"], cfg["ssm_state"]
    nh = di // cfg["ssm_head_dim"]
    h, hk, d, f = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], \
        cfg["d_ff"]
    conv = di + 2 * n
    out = {"embed": ((cfg["vocab"], e), "normal", 0.02)}
    if not cfg["tie_embeddings"]:
        out["lm_head"] = ((e, cfg["vocab"]), "normal",
                          fan_in_scale((e, cfg["vocab"]), stacked=False))
    out["final_norm"] = ((e,), "ones", None)
    stacked = {
        "layers/mamba/w_in": ((e, 2 * di + 2 * n + nh), "normal", None),
        "layers/mamba/conv_w": ((cfg["d_conv"], conv), "normal", 0.5),
        "layers/mamba/conv_b": ((conv,), "zeros", None),
        "layers/mamba/dt_bias": ((nh,), "zeros", None),
        "layers/mamba/a_log": ((nh,), "zeros", None),
        "layers/mamba/d": ((nh,), "ones", None),
        "layers/mamba/norm_w": ((di,), "ones", None),
        "layers/mamba/w_out": ((di, e), "normal", None),
        "layers/ln": ((e,), "ones", None),
    }
    for k, (shape, init, scale) in stacked.items():
        shape = (n_l,) + shape
        out[k] = (shape, init, scale if scale is not None or init != "normal"
                  else fan_in_scale(shape, stacked=True))
    shared = {
        "shared/attn/wq": (e, h, d), "shared/attn/wk": (e, hk, d),
        "shared/attn/wv": (e, hk, d), "shared/attn/wo": (h, d, e),
        "shared/mlp/w_gate": (e, f), "shared/mlp/w_up": (e, f),
        "shared/mlp/w_down": (f, e)}
    for k, shape in shared.items():
        out[k] = (shape, "normal", fan_in_scale(shape, stacked=False))
    out["shared/ln_attn"] = ((e,), "ones", None)
    out["shared/ln_mlp"] = ((e,), "ones", None)
    return out


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def segsum(x):
    """(..., T) -> (..., T, T): out[..., i, j] = x[j+1] + ... + x[i] for
    i >= j, -inf above the diagonal (summed after masking, so no large
    difference of cumulative sums is taken)."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    lower = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device),
                       diagonal=-1)
    x = x.masked_fill(~lower, 0.0)
    s = torch.cumsum(x, dim=-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return s.masked_fill(~keep, float("-inf"))


def ssd(x, a_dt, b, c, chunk: int = SSD_CHUNK):
    """The SSD scan of one sequence batch from a zero state. x (B, L, H,
    P) (already times dt), a_dt (B, L, H), b and c (B, L, N). Returns y
    (B, L, H, P)."""
    bsz, length, h, p = x.shape
    q = math.gcd(chunk, length)
    nc = length // q
    x = x.reshape(bsz, nc, q, h, p)
    b = b.reshape(bsz, nc, q, -1)
    c = c.reshape(bsz, nc, q, -1)
    a = a_dt.reshape(bsz, nc, q, h).permute(0, 3, 1, 2)   # (B, H, c, l)
    a_cum = torch.cumsum(a, dim=-1)
    # within each chunk
    decay = torch.exp(segsum(a))                           # (B, H, c, l, s)
    y = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", c, b, decay, x)
    # each chunk's final state, then the states carried between chunks
    to_end = torch.exp(a_cum[..., -1:] - a_cum)            # (B, H, c, l)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", b, to_end, x)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    carry = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))  # (B,H,c+1,c+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", carry, states)[:, :-1]
    # the carried states read out at each position
    y = y + torch.einsum("bcln,bchpn,bhcl->bclhp", c, states,
                         torch.exp(a_cum))
    return y.reshape(bsz, length, h, p)


def mamba2(p: dict, x, cfg: dict, prec: Precision):
    """One Mamba-2 mixer: x (B, L, E) -> (B, L, E)."""
    di, n, hd = cfg["d_inner"], cfg["ssm_state"], cfg["ssm_head_dim"]
    nh = di // hd
    bsz, length, _ = x.shape
    zxbcdt = prec.einsum("ble,ei->bli", x, p["w_in"])
    z, xbc, dt = zxbcdt.split([di, di + 2 * n, nh], dim=-1)
    k = cfg["d_conv"]
    conv = F.conv1d(xbc.transpose(1, 2), p["conv_w"].t()[:, None, :],
                    p["conv_b"], padding=k - 1, groups=xbc.shape[-1])
    xbc = F.silu(conv[..., :length].transpose(1, 2))
    xs, b, c = xbc.split([di, n, n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])                     # (B, L, H)
    a = -torch.exp(p["a_log"])
    xh = xs.reshape(bsz, length, nh, hd)
    y = ssd(xh * dt[..., None], dt * a, b, c)
    y = y + xh * p["d"][:, None]
    y = rms_norm(y.reshape(bsz, length, di) * F.silu(z), p["norm_w"],
                 cfg["norm_eps"])
    return prec.einsum("bli,ie->ble", y, p["w_out"])


def rope(x, theta: float):
    """Rotary embedding of x (B, L, H, D) at positions 0..L-1, rotating
    the pairs (i, i + D/2)."""
    length, d = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=x.device) / d)
    ang = (torch.arange(length, dtype=torch.float64, device=x.device)[:, None]
           * inv[None])[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def shared_block(p: dict, x, cfg: dict, prec: Precision):
    """The shared attention and MLP block, residual around each."""
    h = rms_norm(x, p["ln_attn"], cfg["norm_eps"])
    q = prec.einsum("ble,ehd->blhd", h, p["attn/wq"])
    k = prec.einsum("ble,ehd->blhd", h, p["attn/wk"])
    v = prec.einsum("ble,ehd->blhd", h, p["attn/wv"])
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    group = cfg["n_heads"] // cfg["n_kv_heads"]
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    length = x.shape[1]
    s = prec.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(cfg["head_dim"])
    causal = torch.ones(length, length, dtype=torch.bool,
                        device=x.device).tril()
    w = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = prec.einsum("bhqk,bkhd->bqhd", w, v)
    x = x + prec.einsum("blhd,hde->ble", o, p["attn/wo"])
    h = rms_norm(x, p["ln_mlp"], cfg["norm_eps"])
    act = {"silu": F.silu, "gelu": lambda t: F.gelu(t, approximate="tanh")
           }[cfg["act"]]
    g = act(prec.einsum("ble,ef->blf", h, p["mlp/w_gate"]))
    u = prec.einsum("ble,ef->blf", h, p["mlp/w_up"])
    return x + prec.einsum("blf,fe->ble", g * u, p["mlp/w_down"])


def _sub(params: dict, prefix: str) -> dict:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + "/")}


def loss(params: dict, tokens, labels, cfg: dict,
         prec: Precision = FP32, remat: bool = True):
    """The mean cross-entropy of next-token prediction over the tokens of
    one micro-batch (B, L), from float32 ``params`` (paths as
    ``leaves``)."""
    eps = cfg["norm_eps"]
    x = params["embed"][tokens.long()]
    layers = {k: torch.unbind(v, 0)
              for k, v in _sub(params, "layers").items()}
    shared = _sub(params, "shared")

    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat \
            else fn(*args)

    def mamba_layer(x, *leaf):
        p = dict(zip(names, leaf))
        h = rms_norm(x, p["ln"], eps)
        return x + mamba2(_sub(p, "mamba"), h, cfg, prec)

    def attn(x, *leaf):
        return shared_block(dict(zip(shared_names, leaf)), x, cfg, prec)

    names = list(layers)
    shared_names = list(shared)
    every = cfg["attn_every"]
    for i in range(cfg["n_layers"]):
        x = run(mamba_layer, x, *(layers[k][i] for k in names))
        if (i + 1) % every == 0:
            x = run(attn, x, *(shared[k] for k in shared_names))
    x = rms_norm(x, params["final_norm"], eps)
    head = params["embed"].t() if cfg["tie_embeddings"] \
        else params["lm_head"]
    logits = prec.einsum("ble,ev->blv", x, head)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.long().reshape(-1))


__all__ = ["SSD_CHUNK", "leaves", "loss", "mamba2", "rms_norm", "rope",
           "segsum", "shared_block", "ssd"]
