#!/usr/bin/env python3
"""Which of the ring fit's per-node operations give a node the same bits
whether it is computed alone or in a batch of nodes, on the card.

    PYTHONPATH=src python3 scripts/ring_batch_bits.py

The ring fit (``core/dkpca.py``) batches a rank's L nodes into every
operation: L = 1 with one node a rank (the activation probe over four
cards), L = J on one card. A node's result is the same in both only if
every operation is batch-invariant. At the probe's shapes (J = 4 nodes of
N = 24 pooled rows, M = 3072 features at the pooled embeddings' scale,
rbf with the median bandwidth, hops = 1, so S = 3 slots) this runs each
operation once on the batch of 4 and once on each node alone, and prints
one JSON line per operation: bitwise or not, and the largest difference.
Operations: the sweep's cross-Gram and the slot Grams (the gram kernel),
the eigendecomposition (``psd_jitter_eigh``, the eigh kernel), the fused
eq. 12-13 update (the admm_step kernel), a batched matrix product of the
solver's kind (cuBLAS), ``_sym_apply``, the centring statistics' row sums
and node means, the z-update's two einsums and the residual's per-node
sum; the same four in the form the ring runs them
(``RingComm.local``: ``rows=True``, summed along contiguous rows), here
and at the ring fit's shapes (J = 20, N = 100, S = 5: 20 nodes against
blocks of 5 and of 1); and the one operation that is not per node, the
global-centring mean: one card sums the 4 nodes' means with
``torch.sum``, four ranks with an all-reduce, which adds them in its own
order (a left fold in rank order is printed as one such order). Also
prints the card's name and power limit. Needs a CUDA card.
"""

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

J, N, M, S = 4, 24, 3072, 3


def compare(name, batched, alone) -> None:
    import torch
    diff = max(float((b - a).abs().max()) for b, a in zip(batched, alone))
    print(json.dumps(dict(op=name, bitwise=all(
        torch.equal(b, a) for b, a in zip(batched, alone)),
        max_abs_diff=diff)), flush=True)


def rows_forms(j, n, s, blocks, dev, gen, label) -> None:
    """Two plain per-node sums (the residual's and the centring
    statistics' kind), then the solver's four operations with rows=True,
    on a batch of j nodes against the same on blocks of each size in
    ``blocks``."""
    import torch
    from repro_torch.core.solver import (_kcross_apply, _res_part,
                                         _sym_apply, _znorm2)
    vec = torch.linalg.qr(torch.randn((j, n, n), generator=gen,
                                      device=dev))[0]
    scale = torch.rand((j, n), generator=gen, device=dev)
    x = torch.randn((j, n, s), generator=gen, device=dev)
    kcross = torch.randn((j, s, s, n, n), generator=gen, device=dev)
    c = torch.randn((j, s, n), generator=gen, device=dev)
    kc = _kcross_apply(kcross, c, rows=True)
    d = torch.randn((j, n, s), generator=gen, device=dev)
    for name, fn in (("torch.sum(d * d, dim=(1, 2)) (L,)",
                      lambda d: torch.sum(d * d, dim=(1, 2))),
                     ("torch.sum(d, dim=1) (L, S)",
                      lambda d: torch.sum(d, dim=1))):
        whole = fn(d)
        for blk in blocks:
            compare(f"{label} {name}, {j} against blocks of {blk}", [whole],
                    [torch.cat([fn(d[i:i + blk]) for i in range(0, j, blk)])])
    ops = (("_sym_apply rows=True (L, N, S)", _sym_apply, (vec, scale, x)),
           ("z-update rows=True (L, S, N)", _kcross_apply, (kcross, c)),
           ("z norm rows=True (L,)", _znorm2, (c, kc)),
           ("residual rows=True (L,)", _res_part,
            ((torch.rand((j, s), generator=gen, device=dev) > 0.3).float(),
             d)))
    for name, fn, args in ops:
        whole = fn(*args, rows=True)
        for blk in blocks:
            parts = torch.cat([fn(*(a[i:i + blk] for a in args), rows=True)
                               for i in range(0, j, blk)])
            compare(f"{label} {name}, {j} against blocks of {blk}",
                    [whole], [parts])


def main() -> int:
    import torch
    from repro_torch.core.kernels_math import (KernelSpec, gram,
                                               psd_jitter_eigh, resolve_gamma)
    from repro_torch.kernels import admm_local_update_op
    if not torch.cuda.is_available():
        raise SystemExit("ring_batch_bits: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((J, N, M), generator=gen, device=dev) * 0.005
    spec = KernelSpec(kind="rbf")
    g = resolve_gamma(spec, x.reshape(J * N, M)).reshape(())
    rot = torch.roll(x, 1, dims=0)
    compare("gram sweep cross-Gram (L, N, N)", gram(spec, x, rot, gamma=g),
            [gram(spec, x[i:i + 1], rot[i:i + 1], gamma=g)[0]
             for i in range(J)])
    xs = torch.cat([x, rot, torch.roll(x, -1, dims=0)], dim=1)
    kfull = gram(spec, xs, gamma=g)
    compare("gram slot Grams (L, S*N, S*N)", kfull,
            [gram(spec, xs[i:i + 1], gamma=g)[0] for i in range(J)])
    k = kfull[:, :N, :N].contiguous()
    lam, vec = psd_jitter_eigh(k)
    alone = [psd_jitter_eigh(k[i:i + 1]) for i in range(J)]
    compare("eigh eigenvalues (L, N)", lam, [a[0][0] for a in alone])
    compare("eigh eigenvectors (L, N, N)", vec, [a[1][0] for a in alone])
    b = torch.randn((J, N, S), generator=gen, device=dev)
    gg = torch.randn((J, N, S), generator=gen, device=dev)
    rho = torch.rand((J, 1, S), generator=gen, device=dev)
    inv = 1.0 / (lam[..., None] + 1.0)
    out = admm_local_update_op(vec.contiguous(), inv, k, b, gg, rho)
    one = [admm_local_update_op(vec[i:i + 1].contiguous(), inv[i:i + 1],
                                k[i:i + 1], b[i:i + 1], gg[i:i + 1],
                                rho[i:i + 1]) for i in range(J)]
    compare("admm_step alpha (L, N, 1)", out[0], [o[0][0] for o in one])
    compare("bmm V @ (L, N, S)", vec @ b, [vec[i] @ b[i] for i in range(J)])
    # the ring's other per-node operations (core/dkpca.py and
    # core/solver.admm_step), each on the batch of J and on each node alone
    from repro_torch.core.solver import _pinv_lam, _sym_apply
    pinv = _pinv_lam(lam)
    compare("_sym_apply K^-1 B (L, N, S)", _sym_apply(vec, pinv, b),
            [_sym_apply(vec[i:i + 1], pinv[i:i + 1], b[i:i + 1])[0]
             for i in range(J)])
    kb = gram(spec, x, rot, gamma=g)
    compare("centring sweep row sums torch.sum(kb, dim=2) (L, N)",
            torch.sum(kb, dim=2), [torch.sum(kb[i:i + 1], dim=2)[0]
                                   for i in range(J)])
    m_own = torch.sum(kb, dim=2) / (J * N)
    compare("centring node means torch.sum(m_own, dim=1) (L,)",
            [torch.sum(m_own, dim=1)], [torch.stack([
                torch.sum(m_own[i:i + 1], dim=1)[0] for i in range(J)])])
    kcross = kfull.reshape(J, S, N, S, N).permute(0, 1, 3, 2, 4).contiguous()
    c = torch.randn((J, S, N), generator=gen, device=dev)
    kc = torch.einsum("jabnm,jbm->jan", kcross, c)
    compare("z-update einsum jabnm,jbm->jan (L, S, N)", kc,
            [torch.einsum("jabnm,jbm->jan", kcross[i:i + 1], c[i:i + 1])[0]
             for i in range(J)])
    compare("z norm einsum jan,jan->j (L,)",
            [torch.einsum("jan,jan->j", c, kc)],
            [torch.stack([torch.einsum("jan,jan->j", c[i:i + 1],
                                       kc[i:i + 1])[0] for i in range(J)])])
    diff = gg - b
    compare("residual torch.sum(d * d, dim=(1, 2)) (L,)",
            [torch.sum(diff * diff, dim=(1, 2))],
            [torch.stack([torch.sum(diff[i:i + 1] * diff[i:i + 1],
                                    dim=(1, 2))[0] for i in range(J)])])
    # the global-centring statistics as core/dkpca.py forms them
    macc = sum(torch.sum(gram(spec, x, torch.roll(x, -t, dims=0), gamma=g),
                         dim=2) for t in range(J))
    node_means = torch.sum(macc / (J * N), dim=1) / N            # (J,)
    fold = node_means[0]
    for v in node_means[1:]:
        fold = fold + v
    compare("centring mean: torch.sum against a left fold over the nodes",
            [torch.sum(node_means)], [fold])
    # the forms the ring runs (RingComm.local: rows=True), at the probe's
    # shapes (4 nodes against each alone) and the ring fit's (20 nodes of
    # N = 100, S = 5: a world-1 ring against blocks of 5, the four-card
    # ring's, and of 1)
    rows_forms(J, N, S, (1,), dev, gen, "probe")
    rows_forms(20, 100, 5, (5, 1), dev, gen, "ring fit")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
