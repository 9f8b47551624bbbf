"""Card-side tests of the port: each hand-written CUDA kernel against its
plain PyTorch version on the same CUDA tensors, and the slice on the card.

Run on a machine with an NVIDIA card:
    python -m pytest -m gpu tests/test_torch_gpu.py
Without a CUDA device every test here skips (decided in the ``cuda``
fixture, never at import, so every xdist worker collects the same tests).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import KernelSpec
from repro_torch.kernels import (gram_op, gram_reference, gram_tiles,
                                 project_op, project_partial_op,
                                 project_partial_reference, project_reference,
                                 project_tiles)

pytestmark = pytest.mark.gpu

# fp32 on both sides; the kernel accumulates over M in another order than
# cuBLAS, and the rbf exp amplifies that (the JAX package's own gate:
# 2e-5, 2e-4 where M >= 300).
def _tol(m):
    return 2e-4 if m >= 300 else 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only "
                    "on the card)")
    return torch.device("cuda")


def _rand(shape, seed, dev, scale=1.0):
    a = np.random.default_rng(seed).normal(size=shape) * scale
    return torch.as_tensor(a.astype(np.float32), device=dev)


SPECS = {
    "rbf": KernelSpec(kind="rbf", gamma=0.3),
    "linear": KernelSpec(kind="linear"),
    "poly": KernelSpec(kind="poly", degree=2, scale=0.1),
}


@pytest.mark.parametrize("kind", sorted(SPECS))
@pytest.mark.parametrize("n,k,m", [(1, 1, 1), (17, 9, 5), (64, 64, 64),
                                   (100, 37, 300), (130, 257, 784)])
def test_gram_kernel_matches_plain(cuda, kind, n, k, m):
    spec = SPECS[kind]
    x = _rand((n, m), n + m, cuda, 1.0 / np.sqrt(m))
    y = _rand((k, m), k + 2 * m, cuda, 1.0 / np.sqrt(m))
    got = gram_op(spec, x, y)
    want = gram_reference(spec, x, y)
    torch.cuda.synchronize()
    tol = _tol(m)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_gram_kernel_batched_one_launch(cuda):
    spec = KernelSpec(kind="rbf", gamma=1.0 / 30)
    x = torch.rand((4, 70, 784), device=cuda)
    before = gram_tiles.launches
    got = gram_op(spec, x, gamma=torch.tensor(1.0 / 30, device=cuda))
    assert gram_tiles.launches == before + 1
    want = gram_reference(spec, x, gamma=torch.tensor(1.0 / 30, device=cuda))
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kind", sorted(SPECS))
@pytest.mark.parametrize("b,l,m,c", [(1, 1, 3, 1), (8, 500, 784, 1),
                                     (33, 77, 40, 3), (128, 2000, 784, 1),
                                     (5, 130, 24, 31)])
def test_project_kernel_matches_plain(cuda, kind, b, l, m, c):
    spec = SPECS[kind]
    xq = _rand((b, m), b + m, cuda, 1.0 / np.sqrt(m))
    xs = _rand((l, m), l + m, cuda, 1.0 / np.sqrt(m))
    coefs = _rand((l, c), 3, cuda, 1.0 / np.sqrt(l))
    rmc, bias = _rand((c,), 4, cuda), _rand((c,), 5, cuda)
    got = project_op(spec, xq, xs, coefs, rmc, bias)
    want = project_reference(spec, xq, xs, coefs, rmc, bias)
    tol = _tol(m)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_project_partial_kernel_matches_plain(cuda):
    spec = KernelSpec(kind="rbf", gamma=0.05)
    xq = _rand((19, 784), 1, cuda, 0.05)
    xs = _rand((300, 784), 2, cuda, 0.05)
    ext = torch.cat([_rand((300, 2), 3, cuda, 0.1),
                     torch.ones((300, 1), device=cuda)], dim=1)
    ext[250:, :] = 0.0                    # shard padding rows
    got = project_partial_op(spec, xq, xs, ext)
    want = project_partial_reference(spec, xq, xs, ext)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_project_rows_do_not_depend_on_batching(cuda):
    spec = KernelSpec(kind="rbf", gamma=0.05)
    xs = _rand((2000, 784), 7, cuda, 0.05)
    coefs = _rand((2000, 1), 8, cuda, 0.02)
    xq = _rand((128, 784), 9, cuda, 0.05)
    full = project_op(spec, xq, xs, coefs)
    head = project_op(spec, xq[:8].contiguous(), xs, coefs)
    assert torch.equal(full[:8], head)


def test_project_kernel_rejects_too_many_components(cuda):
    spec = KernelSpec(kind="rbf", gamma=0.1)
    with pytest.raises(ValueError, match="at most"):
        project_op(spec, torch.zeros((2, 4), device=cuda),
                   torch.zeros((3, 4), device=cuda),
                   torch.zeros((3, 40), device=cuda))


def test_project_wrapper_counts_launches(cuda):
    spec = KernelSpec(kind="rbf", gamma=0.1)
    before = project_tiles.launches
    project_op(spec, torch.rand((4, 8), device=cuda),
               torch.rand((9, 8), device=cuda), torch.rand((9, 2),
                                                            device=cuda))
    assert project_tiles.launches == before + 1


def test_slice_on_card_matches_cpu(cuda):
    """fit -> consensus -> package -> serve on the card against the port's
    own CPU path, from one shared alpha0 (cuSOLVER and LAPACK may pick
    other eigenvector signs, and init="local" keys on them); both kernels
    launch on the way."""
    from repro_torch.core import (build_setup, central_kpca, initial_alpha,
                                  oos, ring, run_admm, similarity)
    from repro_torch.data import kpca_dataset, node_dataset
    from repro_torch.serve import KpcaEngine, KpcaServeConfig
    spec = KernelSpec()
    nodes, pooled = node_dataset(6, 40, m=784, seed=0)
    s_cpu = build_setup(nodes, ring(6, 1), spec, device="cpu")
    s_gpu = build_setup(nodes, ring(6, 1), spec, device=cuda)
    torch.testing.assert_close(s_gpu.kcross.cpu(), s_cpu.kcross, rtol=2e-4,
                               atol=2e-4)
    alpha0 = initial_alpha(s_cpu, "local")
    g0, p0 = gram_tiles.launches, project_tiles.launches
    r_cpu = run_admm(s_cpu, n_iters=10, alpha0=alpha0)
    r_gpu = run_admm(s_gpu, n_iters=10, alpha0=alpha0.to(cuda))
    torch.testing.assert_close(r_gpu.alpha_hist.cpu(), r_cpu.alpha_hist,
                               rtol=1e-3, atol=1e-4)
    a_gt, _, _ = central_kpca(pooled, spec, 1, gamma=s_gpu.gamma,
                              device=cuda)
    sim = similarity(r_gpu.alpha[0], s_gpu.x[0], a_gt[:, 0],
                     s_gpu.x.reshape(240, 784), spec, gamma=s_gpu.gamma)
    a_cpu, _, _ = central_kpca(pooled, spec, 1, gamma=s_cpu.gamma,
                               device="cpu")
    sim_cpu = similarity(r_cpu.alpha[0], s_cpu.x[0], a_cpu[:, 0],
                         s_cpu.x.reshape(240, 784), spec, gamma=s_cpu.gamma)
    assert float(sim) == pytest.approx(float(sim_cpu), abs=1e-4)
    model = oos.from_decentralized(nodes, r_gpu.alpha, spec,
                                   gamma=s_gpu.gamma, device=cuda)
    reqs = [kpca_dataset(q, m=784, seed=q) for q in (3, 17, 40)]
    outs = KpcaEngine(model, KpcaServeConfig(max_batch=16, min_bucket=4),
                      device=cuda).project_many(reqs)
    plain = model.to("cpu")
    for req, out in zip(reqs, outs):
        np.testing.assert_allclose(
            out, oos.project(plain, torch.as_tensor(req)).numpy(),
            rtol=2e-4, atol=2e-4)
    assert gram_tiles.launches > g0 and project_tiles.launches > p0


def test_engine_on_card_is_batch_independent(cuda):
    """A request's scores on the card are bit-identical to projecting it
    alone, however the engine packed it into slabs."""
    from repro_torch.core import oos
    from repro_torch.data import kpca_dataset, node_dataset
    from repro_torch.serve import KpcaEngine, KpcaServeConfig
    _, pooled = node_dataset(4, 100, m=784, seed=1)
    alpha = np.random.default_rng(0).normal(size=400).astype(np.float32)
    model = oos.from_dual(pooled, alpha * 1e-3, KernelSpec(), device=cuda)
    reqs = [kpca_dataset(q, m=784, seed=q) for q in (5, 37, 64, 3)]
    outs = KpcaEngine(model, KpcaServeConfig(max_batch=32, min_bucket=8),
                      device=cuda).project_many(reqs)
    for req, out in zip(reqs, outs):
        alone = oos.project(model, torch.as_tensor(req, device=cuda))
        np.testing.assert_array_equal(out, alone.cpu().numpy())


def test_engine_on_card_reforms_operands_on_publish(cuda):
    """The engine forms a model version's projection operands once; a
    published model is served with its own, bit-identical to projecting
    against it directly."""
    from repro_torch.core import oos
    from repro_torch.data import kpca_dataset, node_dataset
    from repro_torch.serve import KpcaEngine, KpcaServeConfig, ModelHandle
    _, pooled = node_dataset(4, 50, m=784, seed=2)
    alpha = np.random.default_rng(1).normal(size=200).astype(np.float32)
    model = oos.from_dual(pooled, alpha * 1e-3, KernelSpec(), device=cuda)
    handle = ModelHandle(model)
    engine = KpcaEngine(handle, KpcaServeConfig(max_batch=16, min_bucket=8),
                        device=cuda)
    req = kpca_dataset(21, m=784, seed=4)
    xq = torch.as_tensor(req, device=cuda)
    for current in (model, oos.refresh_coefficients(model, -2 * model.coefs)):
        if current is not model:
            handle.publish(current)
        out, = engine.project_many([req])
        np.testing.assert_array_equal(out,
                                      oos.project(current, xq).cpu().numpy())


@pytest.mark.parametrize("center", ["global", "neighborhood", "block",
                                    "none"])
def test_build_setup_on_card_matches_cpu(cuda, center):
    """The setup phase on the card (one batched gram launch for every
    node's slot Grams) against the port's CPU path, in every centering
    mode; eigenvalues agree, eigenvectors up to sign."""
    from repro_torch.core import build_setup, ring
    from repro_torch.data import node_dataset
    nodes, _ = node_dataset(6, 40, m=784, seed=3)
    got = build_setup(nodes, ring(6, 2), KernelSpec(), center=center,
                      device=cuda)
    want = build_setup(nodes, ring(6, 2), KernelSpec(), center=center,
                       device="cpu")
    assert float(got.gamma) == pytest.approx(float(want.gamma), rel=1e-5)
    for f in ("kcross", "k", "lam"):
        torch.testing.assert_close(getattr(got, f).cpu(), getattr(want, f),
                                   rtol=2e-4, atol=2e-4)
    top_t, top_c = got.vec[..., -1].cpu(), want.vec[..., -1]
    torch.testing.assert_close(top_t[:, :, None] * top_t[:, None, :],
                               top_c[:, :, None] * top_c[:, None, :],
                               rtol=0, atol=1e-4)
