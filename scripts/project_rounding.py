#!/usr/bin/env python3
"""CPU model of the project kernel's rounding against float64.

    PYTHONPATH=src python scripts/project_rounding.py

Builds the models that ``chip_smoke.py`` serves (central kPCA on the
pooled 2000 x 784 data of ``node_dataset(20, 100, seed=0)``, and its
500-landmark compression) and projects the smoke's queries in three ways,
each held against a float64 projection: the plain fp32 version on the CPU,
and the kernel's arithmetic (3xTF32 products, each ``wgmma`` instruction's
sum of eight products rounded toward zero, 12 instructions per 32-feature
stage before an fp32 promotion) with and without shifting both sides by the
support's mean row. Round-toward-zero is a model of the tensor cores' fp32
accumulation, not a measurement of it. Prints one JSON line per model and
batch size.
"""

import json

import torch

from repro_torch.core import KernelSpec, oos
from repro_torch.core.kernels_math import resolve_gamma
from repro_torch.data import kpca_dataset, node_dataset
from repro_torch.kernels import project_reference
from repro_torch.kernels.project.project import split_tf32


def round_toward_zero(t: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    f = t.float()
    return torch.where(f.double().abs() > t.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def tensor_core_dot(xq: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """xq . xs^T as the kernel forms it, under the round-toward-zero model."""
    (qh, ql), (sh, sl) = split_tf32(xq), split_tf32(xs)
    acc = torch.zeros((xq.shape[0], xs.shape[0]))
    for k0 in range(0, sh.shape[1], 32):
        part = torch.zeros(acc.shape, dtype=torch.float64)
        for kk in range(k0, k0 + 32, 8):
            f = slice(kk, kk + 8)
            for x, y in ((qh, sl), (ql, sh), (qh, sh)):
                part = round_toward_zero(
                    part + x[:, f].double() @ y[:, f].double().T).double()
        acc = acc + part.float()
    return acc


def modelled_scores(model, xq: torch.Tensor, shift: bool) -> torch.Tensor:
    xs = model.x_support
    mu = xs.mean(dim=0) if shift else torch.zeros(xs.shape[1])
    q, s = xq - mu, xs - mu
    d2 = (torch.sum(q * q, -1)[:, None] + torch.sum(s * s, -1)[None, :]
          - 2.0 * tensor_core_dot(q, s))
    k = torch.exp(-model.gamma * torch.clamp(d2, min=0.0)).double()
    return (k @ model.coefs.double()
            + k.mean(dim=1, keepdim=True) * model.row_mean_coef.double()
            + model.bias.double())


def main() -> None:
    spec = KernelSpec(kind="rbf")
    _, pooled = node_dataset(20, 100, m=784, seed=0)
    pooled = torch.as_tensor(pooled)
    gamma = resolve_gamma(spec, pooled).reshape(())
    full = oos.fit_central(pooled, spec, gamma=gamma, device="cpu")
    small, _ = oos.compress(full, 500, seed=0)
    queries = torch.as_tensor(kpca_dataset(128, m=784, seed=7))
    for name, model in (("compressed", small), ("full", full)):
        ops = (model.x_support, model.coefs, model.row_mean_coef, model.bias,
               model.gamma)
        for b in (8, 128):
            xq = queries[:b]
            exact = project_reference(spec, xq.double(),
                                      *(t.double() for t in ops))

            def err(got):
                return float((got.double() - exact).abs().max())

            print(json.dumps(dict(
                model=name, support=model.n_support, batch=b,
                plain_fp32=err(project_reference(spec, xq, *ops)),
                kernel_model_unshifted=err(modelled_scores(model, xq, False)),
                kernel_model_shifted=err(modelled_scores(model, xq, True)),
                norm_ratio=float(torch.sum(xq * xq) / torch.sum(
                    (xq - model.x_support.mean(dim=0)) ** 2)))), flush=True)


if __name__ == "__main__":
    main()
