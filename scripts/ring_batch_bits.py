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
the eigendecomposition (``psd_jitter_eigh``, cuSOLVER), the fused eq.
12-13 update (the admm_step kernel), and a batched matrix product of the
solver's kind (cuBLAS); and the one operation that is not per node, the
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
    # the global-centring statistics as core/dkpca.py forms them
    macc = sum(torch.sum(gram(spec, x, torch.roll(x, -t, dims=0), gamma=g),
                         dim=2) for t in range(J))
    node_means = torch.sum(macc / (J * N), dim=1) / N            # (J,)
    fold = node_means[0]
    for v in node_means[1:]:
        fold = fold + v
    compare("centring mean: torch.sum against a left fold over the nodes",
            [torch.sum(node_means)], [fold])
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
