"""Projection-consensus gradient compression, PowerSGD-style low rank with
error feedback (counterpart of ``repro.optim.compression``).

Per parameter of two or more dims, its gradient G folded to (m, n):

    1. Q = orth(G^T P_prev)     one power-iteration step against the
    2. P = G Q                  previous consensus subspace (warm start)
    3. all-reduce P (and Q) instead of G:  m*r + n*r numbers vs m*n
    4. G_hat = P Q^T;  error e = G - G_hat is fed back into the next step.

``compressed_psum_grads`` averages over the ranks of a ``torch.distributed``
group, or over the data axes of a device mesh (a
``repro_torch.distributed.Mesh``: the ranks of its "data" sub-group, as
the JAX package averages over a mesh's data axes inside a ``shard_map``):
each mean is an ``all_reduce`` of the sum over the group, divided by its
size, and no gradient is gathered. ``compress_local`` is the
same math on one worker. 1-D parameters are averaged exactly (they are
tiny).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist


def _fold(g: torch.Tensor) -> torch.Tensor:
    """Fold to 2D: leading dims (incl. layer stacks) merge into rows."""
    if g.dim() == 1:
        return g[None, :]
    return g.reshape(-1, g.shape[-1])


def _orthonormalize(q: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt via QR (r is small)."""
    qq, _ = torch.linalg.qr(q)
    return qq


def init_compression_state(params: Dict[str, torch.Tensor], rank: int = 4,
                           seed: int = 0):
    """Per-param error-feedback buffer and warm-start P, drawn in key order
    from one ``torch.Generator`` seeded with ``seed`` on the parameters'
    device (not ``jax.random``'s numbers)."""
    state, generator = {}, None
    for k, v in params.items():
        if v.dim() < 2:
            continue
        if generator is None:
            generator = torch.Generator(device=v.device).manual_seed(seed)
        rows, cols = _fold(v).shape
        state[k] = {
            "err": torch.zeros((rows, cols), dtype=torch.float32,
                               device=v.device),
            "p": torch.randn((rows, rank), generator=generator,
                             dtype=torch.float32, device=v.device),
        }
    return state


def compress_local(g: torch.Tensor, err: torch.Tensor, p_prev: torch.Tensor):
    """One PowerSGD round on a single worker's gradient (no reduction).
    Returns (p, q, new_err) with g_hat = p @ q.T."""
    g2 = _fold(g.to(torch.float32)) + err
    q = _orthonormalize(g2.T @ p_prev)            # (n, r)
    p = g2 @ q                                    # (m, r)
    g_hat = p @ q.T
    return p, q, g2 - g_hat


def _pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the group's ranks (a new tensor)."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out / dist.get_world_size(group)


def compressed_psum_grads(grads: Dict[str, torch.Tensor], state, group=None,
                          data_axes=("data",)):
    """Average gradients over the ranks of ``group`` (default: the world;
    a device mesh: its sub-group over ``data_axes``) with low-rank
    compression.

    grads are this rank's own (un-averaged) values. Returns (averaged
    grads, new state). As in PowerSGD, the mean of P with the SAME Q on
    every rank approximates the mean of G projected onto span(Q)."""
    from ..distributed.collectives import Mesh
    if isinstance(group, Mesh):
        group = group.group(data_axes)
    new_grads, new_state = {}, {}
    for k, g in grads.items():
        if k not in state:
            new_grads[k] = _pmean(g.to(torch.float32), group).to(g.dtype)
            continue
        st = state[k]
        g2 = _fold(g.to(torch.float32)) + st["err"]
        # consensus subspace: every rank uses the SAME p_prev (replicated),
        # so q is identical across ranks after the mean below.
        q = _orthonormalize(_pmean(g2.T @ st["p"], group))
        p = _pmean(g2 @ q, group)                  # the compressed mean
        g_hat = p @ q.T
        new_state[k] = {"err": g2 - g_hat, "p": p}
        new_grads[k] = g_hat.reshape(g.shape).to(g.dtype)
    return new_grads, new_state


def compression_ratio(params: Dict[str, torch.Tensor], rank: int) -> float:
    """Communication volume ratio: compressed / dense."""
    dense = comp = 0
    for v in params.values():
        n = v.numel()
        dense += n
        if v.dim() < 2:
            comp += n
        else:
            g2 = _fold(v)
            comp += rank * (g2.shape[0] + g2.shape[1])
    return comp / dense


__all__ = ["compress_local", "compressed_psum_grads", "compression_ratio",
           "init_compression_state"]
