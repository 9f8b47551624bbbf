"""The plain reference: decentralized kernel PCA (the paper's Alg. 1 over
a ring, global centring, the ball projection) and its serving scores,
written out in plain PyTorch from the inputs the benchmark made. It
imports nothing of the port: gamma, the Grams, the centring, the
eigendecompositions, the ADMM iterations and the served model's centring
terms are all worked out again here.

``Precision`` says how: ``EXACT`` computes in float64 (what ``correct`` is
judged against); ``TF32`` is the control, the same algebra in float32
with every product's inputs rounded to TF32 (10 mantissa bits, round to
nearest even) as a TF32 tensor-core product takes them.
"""

from __future__ import annotations

import dataclasses

import torch

MEDIAN_ROWS = 256      # rows the median heuristic looks at
EIG_FLOOR = 1e-6       # eigenvalues floored at this share of the largest
PINV_CUT = 1e-5        # directions below this share of the largest dropped


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype
    tf32: bool = False

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b (batched) in this precision."""
        if self.tf32:
            return round_tf32(a.float()) @ round_tf32(b.float())
        return a.to(self.dtype) @ b.to(self.dtype)


EXACT = Precision(torch.float64)
TF32 = Precision(torch.float32, tf32=True)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties to even)."""
    bits = x.contiguous().view(torch.int32)
    keep = (bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000
    return keep.view(torch.float32)


def sqdist(x, y, p: Precision):
    """(..., n, k) squared distances, clamped at 0."""
    x, y = p.cast(x), p.cast(y)
    sx = torch.sum(x * x, dim=-1)
    sy = torch.sum(y * y, dim=-1)
    d2 = sx[..., :, None] + sy[..., None, :] - 2.0 * p.mm(x, y.transpose(-1, -2))
    return torch.clamp(d2, min=0.0)


def median_gamma(x, p: Precision):
    """RBF bandwidth by the median heuristic: 1 / the median squared
    distance between the first 256 rows (the diagonal pushed past the
    maximum; an even count averages its two middle values)."""
    n = min(x.shape[0], MEDIAN_ROWS)
    d2 = sqdist(x[:n], x[:n], p)
    d2 = d2 + torch.eye(n, dtype=d2.dtype, device=d2.device) * torch.max(d2)
    med = torch.quantile(d2.reshape(-1), 0.5, interpolation="midpoint")
    return 1.0 / torch.clamp(med, min=1e-12)


def rbf(x, y, gamma, p: Precision):
    return torch.exp(-gamma * sqdist(x, y, p))


def ring_slots(nodes: int, hops: int):
    """(src, rsl): src[j, s] the node whose data fills slot s of node j
    (slot 0 itself, then offsets -hops..-1, 1..hops); rsl[j, s] the slot
    of j in src[j, s]'s list (the slot of the opposite offset)."""
    offs = list(range(-hops, 0)) + list(range(1, hops + 1))
    slot = {o: i + 1 for i, o in enumerate(offs)}
    src = [[j] + [(j + o) % nodes for o in offs] for j in range(nodes)]
    rsl = [[0] + [slot[-o] for o in offs] for _ in range(nodes)]
    return torch.tensor(src), torch.tensor(rsl)


@dataclasses.dataclass
class Fit:
    alpha: torch.Tensor        # (J, N) after the iterations
    coefs: torch.Tensor        # (J*N,) the packaged dual coefficients
    row_mean_coef: torch.Tensor   # 0-d
    bias: torch.Tensor            # 0-d
    scale: dict                # magnitudes the comparisons divide by


def fit(x_nodes, alpha0, cfg: dict, p: Precision = EXACT) -> Fit:
    """Alg. 1 on the ring ``ring(J, hops)`` from ``alpha0``: the setup
    phase (median gamma, the pooled Gram's global kernel-mean statistics,
    every slot's centred Gram block, each node's eigendecomposition),
    ``iterations`` ADMM steps (rho1 on the self slot, rho2 on the paper's
    warm-up schedule, the ball projection), then the packaging of the
    pooled solution concat_j(alpha_j) / J for serving."""
    dt = p.dtype
    x = x_nodes.to(dt)
    j, n, m = x.shape
    dev = x.device
    src, rsl = (t.to(dev) for t in ring_slots(j, cfg["hops"]))
    s = src.shape[1]
    pooled = x.reshape(j * n, m)
    gamma = median_gamma(pooled, p)
    kc = rbf(pooled, pooled, gamma, p)                   # (JN, JN)
    mrow = torch.mean(kc, dim=1)    # global stats, also the packaging's
    mu = torch.mean(mrow)
    kc -= mrow[:, None]
    kc -= mrow[None, :]
    kc += mu
    kc = kc.reshape(j, n, j, n)
    # kcross[j, a, b] = centred K(X_src[j,a], X_src[j,b])
    kcross = kc[src[:, :, None], :, src[:, None, :], :]  # (J, S, S, N, N)
    del kc
    kj = kcross[:, 0, 0]
    lam, vec = torch.linalg.eigh(kj)
    lam = torch.maximum(lam, EIG_FLOOR * torch.clamp(lam[:, -1:], min=1e-30))
    pinv = torch.where(lam > PINV_CUT * lam[:, -1:], 1.0 / lam,
                       torch.zeros_like(lam))
    alpha = alpha0.to(dev, dt)
    b = torch.zeros((j, n, s), dtype=dt, device=dev)
    bounds, values = cfg["rho2"]["boundaries"], cfg["rho2"]["values"]
    for t in range(cfg["iterations"]):
        rho2 = float(values[sum(t >= bb for bb in bounds) - 1])
        rho = torch.full((j, s), rho2, dtype=dt, device=dev)
        rho[:, 0] = cfg["rho1"]
        # message round 1: K^+ B columns and alpha
        m1 = p.mm(vec, pinv[:, :, None] * p.mm(vec.transpose(1, 2), b))
        recv_m1 = m1.transpose(1, 2)[src, rsl]                # (J, S, N)
        recv_a = alpha[src]                                   # (J, S, N)
        rho_bar = torch.sum(rho, dim=1)
        c = (recv_m1 + rho[..., None] * recv_a) / rho_bar[:, None, None]
        # z update and its projection onto the unit ball
        k2 = kcross.permute(0, 1, 3, 2, 4).reshape(j, s * n, s * n)
        kc_apply = p.mm(k2, c.reshape(j, s * n, 1)).reshape(j, s, n)
        znorm2 = torch.sum(c * kc_apply, dim=(1, 2))
        scale = torch.where(znorm2 > 1.0, torch.rsqrt(znorm2),
                            torch.ones_like(znorm2))
        proj = scale[:, None, None] * kc_apply                # (J, S, N)
        # message round 2: the projections
        g = proj[src, rsl].transpose(1, 2)                    # (J, N, S)
        # alpha update (eq. 12) and dual update (eq. 13)
        rho_sum = torch.sum(rho, dim=1)
        den = rho_sum[:, None] * lam - 2.0 * lam * lam
        inv = torch.where((lam > PINV_CUT * lam[:, -1:]) & (den > 0),
                          1.0 / den, torch.zeros_like(den))
        rhs = torch.sum(rho[:, None, :] * g - b, dim=2)       # (J, N)
        alpha = p.mm(vec, inv[:, :, None]
                     * p.mm(vec.transpose(1, 2), rhs[:, :, None]))[..., 0]
        ka = p.mm(kj, alpha[:, :, None])[..., 0]
        b = b + rho[:, None, :] * (ka[:, :, None] - g)
    coefs = alpha.reshape(j * n) / j
    row_mean_coef, bias, terms = centring_terms(mrow, mu, coefs)
    return Fit(alpha=alpha, coefs=coefs, row_mean_coef=row_mean_coef,
               bias=bias, scale=dict(alpha=torch.max(torch.abs(alpha)),
                                     bias=terms))


def centring_terms(mrow, mu, coefs):
    """A centred served model's terms from the support's kernel-mean
    statistics (m_i = mean_l K(x_i, x_l), mu = mean m) and its dual
    coefficients a: score(x) = K(x, X) a + mean_l K(x, x_l) c + b with
    c = -sum(a), b = mu sum(a) - m . a. Also returns the size of b's two
    terms (|mu sum(a)| + sum |m_i a_i|), the scale its rounding is judged
    against."""
    a = coefs.to(mrow.dtype)
    asum = torch.sum(a)
    bias = mu * asum - torch.dot(mrow, a)
    terms = torch.abs(mu * asum) + torch.sum(torch.abs(mrow * a))
    return -asum, bias, terms


@dataclasses.dataclass
class Served:
    support: torch.Tensor
    coefs: torch.Tensor
    row_mean_coef: torch.Tensor
    bias: torch.Tensor
    gamma: torch.Tensor


def served_model(support, coefs, p: Precision = EXACT) -> Served:
    """The served model's terms, worked out from the rows and dual
    coefficients the benchmark drew (median gamma, centred)."""
    x = support.to(p.dtype)
    gamma = median_gamma(x, p)
    mrow = torch.mean(rbf(x, x, gamma, p), dim=1)
    rmc, bias, _ = centring_terms(mrow, torch.mean(mrow), coefs)
    return Served(support=x, coefs=coefs.to(p.dtype), row_mean_coef=rmc,
                  bias=bias, gamma=gamma)


def scores(model: Served, xq, p: Precision = EXACT, block: int = 4096):
    """(B,) scores of query rows, and (B,) the size of each score's terms
    (sum_l |K a_l| + |mean K c| + |b|), in blocks of ``block`` rows."""
    out, size = [], []
    for lo in range(0, xq.shape[0], block):
        k = rbf(xq[lo:lo + block].to(p.dtype), model.support, model.gamma, p)
        ka = p.mm(k, model.coefs[:, None])[:, 0]
        mean = torch.mean(k, dim=1) * model.row_mean_coef
        out.append(ka + mean + model.bias)
        size.append(p.mm(k, torch.abs(model.coefs)[:, None])[:, 0]
                    + torch.abs(mean) + torch.abs(model.bias))
    return torch.cat(out), torch.cat(size)


__all__ = ["EXACT", "Fit", "Precision", "Served", "TF32", "centring_terms",
           "fit", "median_gamma", "rbf", "ring_slots", "round_tf32",
           "scores", "served_model", "sqdist"]
