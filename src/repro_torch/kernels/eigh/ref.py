"""Plain PyTorch version of the batched Jacobi eigensolve: the kernel's
arithmetic (``csrc/eigh.cu``) written with tensors, for the tests and the
card-side checks. The same circle order of pairs, rotation formulas,
stopping rule, block-wise symmetric update, ranking and column norms; the
roundings differ where the compiler fuses a product into an add. CPU
tensors do not take it (``ops.eigh_op`` keeps ``torch.linalg.eigh`` there),
and it is never a fallback for a CUDA tensor."""

from __future__ import annotations

import torch

from .eigh import MAX_SWEEPS


def _circle_pairs(np_: int, r: int, device=None):
    """Round r's pairs over np_ (even) indices: (p (np_/2,), q (np_/2,)),
    position 0 fixed and the others turned by r."""
    pos = torch.arange(np_, device=device)
    idx = torch.where(pos == 0, 0, 1 + (pos - 1 + r) % (np_ - 1))
    m = np_ // 2
    return idx[:m], torch.flip(idx[m:], (0,))


def sym_eigh_reference(k: torch.Tensor, max_sweeps: int = MAX_SWEEPS):
    """Same contract as ``eigh.sym_eigh``: k (B, n, n) fp32, its lower
    triangle read. Returns (lam (B, n) ascending, vec (B, n, n), sweeps
    (B,) int32; a matrix holding NaN or inf gets NaN and 0 sweeps)."""
    b, n, _ = k.shape
    dev = k.device
    eps = torch.finfo(torch.float32).eps
    np_ = n + (n & 1)
    low = torch.tril(k.float())
    a = torch.zeros((b, np_, np_), dtype=torch.float32, device=dev)
    a[:, :n, :n] = low + torch.tril(low, -1).transpose(1, 2)
    v = torch.eye(np_, device=dev).repeat(b, 1, 1)
    fro = torch.sqrt(torch.sum(a * a, dim=(1, 2)))
    floor_off = (eps * fro / n)[:, None]
    finite = torch.isfinite(fro)              # else NaN out, no sweep
    active = finite.clone()
    sweeps = torch.zeros(b, dtype=torch.int32, device=dev)
    pair_of = torch.empty(np_, dtype=torch.long, device=dev)
    for _ in range(max_sweeps):
        sweeps += active.int()
        rotated = torch.zeros(b, dtype=torch.bool, device=dev)
        for r in range(np_ - 1):
            p, q = _circle_pairs(np_, r, dev)
            app, aqq, apq = a[:, p, p], a[:, q, q], a[:, p, q]    # (B, m)
            off = apq.abs()
            rot = (active[:, None] & (off > floor_off)
                   & (off > eps * torch.sqrt(app.abs())
                      * torch.sqrt(aqq.abs())))
            theta = (aqq - app) / (2.0 * torch.where(rot, apq, 1.0))
            t = 1.0 / (theta.abs() + torch.sqrt(theta * theta + 1.0))
            t = torch.where(rot, torch.where(theta < 0, -t, t), 0.0)
            c = 1.0 / torch.sqrt(t * t + 1.0)
            s = t * c
            rotated |= rot.any(dim=1)
            # rows by each row's pair, then columns by each column's
            cr, sr = c[:, :, None], s[:, :, None]
            rows = a.clone()
            rows[:, p] = cr * a[:, p] - sr * a[:, q]
            rows[:, q] = sr * a[:, p] + cr * a[:, q]
            cc, sc = c[:, None, :], s[:, None, :]
            full = rows.clone()
            full[:, :, p] = cc * rows[:, :, p] - sc * rows[:, :, q]
            full[:, :, q] = sc * rows[:, :, p] + cc * rows[:, :, q]
            # the kernel writes each block between pairs P < Q and mirrors
            # it; a pair's own block by Rutishauser's update
            pair_of[p] = torch.arange(p.numel(), device=dev)
            pair_of[q] = pair_of[p]
            upper = pair_of[:, None] < pair_of[None, :]
            lower = pair_of[:, None] > pair_of[None, :]
            new = torch.where(upper, full, a)
            new = torch.where(lower, full.transpose(1, 2), new)
            new[:, p, p] = app - t * apq
            new[:, q, q] = aqq + t * apq
            new[:, p, q] = torch.where(rot, 0.0, apq)
            new[:, q, p] = new[:, p, q]
            a = new
            vp, vq = v[:, :, p].clone(), v[:, :, q].clone()
            v[:, :, p] = cc * vp - sc * vq
            v[:, :, q] = sc * vp + cc * vq
        active &= rotated
        if not bool(active.any()):
            break
    d = torch.diagonal(a, dim1=1, dim2=2)[:, :n]
    key = torch.where(torch.isnan(d), torch.inf, d)
    _, perm = torch.sort(key, dim=1, stable=True)
    lam = torch.gather(d, 1, perm)
    v = v[:, :n, :n]
    v = v / torch.sqrt(torch.sum(v * v, dim=1, keepdim=True))
    vec = torch.gather(v, 2, perm[:, None, :].expand(b, n, n))
    lam = torch.where(finite[:, None], lam, torch.nan)
    vec = torch.where(finite[:, None, None], vec, torch.nan)
    return lam, vec, sweeps


__all__ = ["sym_eigh_reference"]
