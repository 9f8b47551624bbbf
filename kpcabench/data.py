"""The benchmark's inputs, made from the seed on the device they live on.

A frozen copy of the port's synthetic digits-manifold generator
(``repro_torch.data.synthetic.kpca_dataset``: the MNIST regime of the
paper's §6.1, M = 784 features in [0, 1], a dominant nonlinear factor, a
few class offsets, weak secondary factors and noise), written for a
``torch.Generator`` and batched over many datasets, so that a pool of a
few hundred datasets is a handful of large calls on the card. It draws the
same structure as the numpy original, not its numbers.

Every draw goes through one generator seeded with the run's seed, in a
fixed order, so one seed gives the same inputs on every run (on the same
kind of device).
"""

from __future__ import annotations

import math

import torch

LATENT_DIM = 6      # weak secondary factors (as the port's generator)


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` (any whole number;
    folded into 63 bits)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def population(gen: torch.Generator, count: int, m: int, n_classes: int,
               device) -> dict:
    """The frozen embedding maps of ``count`` independent populations:
    the dominant factor's (count, 2, m), the secondary factors' (count, 6,
    m) and the class offsets (count, n_classes, m)."""
    kw = dict(generator=gen, device=device)
    return dict(
        w_dom=torch.randn((count, 2, m), **kw) / math.sqrt(2.0),
        w_sec=torch.randn((count, LATENT_DIM, m), **kw)
        / math.sqrt(LATENT_DIM),
        offs=torch.randn((count, n_classes, m), **kw) * 0.6)


def rows(gen: torch.Generator, pop: dict, n: int, noise: float = 0.05,
         dominant: float = 3.0) -> torch.Tensor:
    """(count, n, m) float32 rows in [0, 1], n from each population,
    in a random order (class labels interleaved, as the original's)."""
    w_dom, w_sec, offs = pop["w_dom"], pop["w_sec"], pop["offs"]
    count, n_classes, m = offs.shape
    dev = offs.device
    kw = dict(generator=gen, device=dev)
    t = torch.rand((count, n), **kw) * (2.0 * math.pi)
    dom = torch.stack([(4.0 / 3.0) * dominant * torch.cos(t),
                       0.5 * dominant * torch.sin(2.0 * t)], dim=2)
    sec = torch.tanh(torch.randn((count, n, LATENT_DIM), **kw)) * 0.4
    labels = torch.arange(n, device=dev) % n_classes
    x = torch.bmm(dom, w_dom) + torch.bmm(sec, w_sec) + offs[:, labels]
    x += torch.randn((count, n, m), **kw) * (noise * math.sqrt(m) / 4.0)
    x = torch.sigmoid(x * (8.0 / math.sqrt(m)))
    order = torch.argsort(torch.rand((count, n), **kw), dim=1)
    return torch.gather(x, 1, order[:, :, None].expand(-1, -1, m))


def fit_pool(gen: torch.Generator, count: int, nodes: int, per_node: int,
             m: int, data: dict, device, chunk: int = 16) -> torch.Tensor:
    """(count, nodes, per_node, m): ``count`` independent node-distributed
    datasets, made ``chunk`` datasets a call."""
    out = torch.empty((count, nodes, per_node, m), dtype=torch.float32,
                      device=device)
    for lo in range(0, count, chunk):
        k = min(chunk, count - lo)
        pop = population(gen, k, m, data["n_classes"], device)
        out[lo:lo + k] = rows(gen, pop, nodes * per_node, data["noise"],
                              data["dominant"]).reshape(k, nodes, per_node, m)
    return out


def alpha0(gen: torch.Generator, count: int, nodes: int, per_node: int,
           device) -> torch.Tensor:
    """(count, nodes, per_node): each fit's starting point, the paper's
    own initialisation (entrywise standard normal, unnormalised)."""
    return torch.randn((count, nodes, per_node), generator=gen,
                       device=device)


def serve_inputs(gen: torch.Generator, support: int, queries: int, m: int,
                 data: dict, device) -> tuple:
    """A served model's inputs and its queries, from one population:
    the support rows (support, m), their dual coefficients (support,),
    drawn N(0, 1/support), and a pool of query rows (queries, m)."""
    pop = population(gen, 1, m, data["n_classes"], device)
    x = rows(gen, pop, support + queries, data["noise"], data["dominant"])[0]
    coefs = torch.randn((support,), generator=gen, device=device) \
        / math.sqrt(support)
    return x[:support].contiguous(), coefs, x[support:].contiguous()


__all__ = ["alpha0", "fit_pool", "generator", "population", "rows",
           "serve_inputs"]
