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
from repro_torch.kernels import (admm_local_update, admm_local_update_op,
                                 admm_local_update_reference, center_op,
                                 center_reference, center_tiles, eigh_op,
                                 gram_op, gram_reference, gram_tiles,
                                 project_op, project_partial_op,
                                 project_partial_reference, project_reference,
                                 project_tiles, sym_eigh, sym_eigh_reference)
from repro_torch.kernels.eigh import MAX_N as EIGH_MAX_N
from repro_torch.kernels.eigh import MAX_SWEEPS
from repro_torch.kernels.gram.ops import row_norms
from repro_torch.kernels.project.project import prepare_support, split_tf32

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
                                   (100, 37, 300), (130, 257, 784),
                                   # the short-row route (split_count > 1)
                                   (24, 24, 3072), (72, 72, 3072),
                                   (96, 96, 1024), (96, 96, 4096),
                                   (100, 20, 1500), (40, 100, 2048)])
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


EDGES = (1, 63, 64, 65, 127, 129, 500)


@pytest.mark.parametrize("kind", sorted(SPECS))
@pytest.mark.parametrize("m", [5, 31, 32, 33, 784])
@pytest.mark.parametrize("n", EDGES)
def test_gram_kernel_tile_edges(cuda, kind, n, m):
    """Rows on both sides of the 64- and 128-row tile edges, features on
    both sides of the 32-float K-tile: a cross Gram against the next edge
    size, and a batched self-Gram, which must be exactly symmetric."""
    spec = SPECS[kind]
    k = EDGES[(EDGES.index(n) + 1) % len(EDGES)]
    x = _rand((n, m), n + m, cuda, 1.0 / np.sqrt(m))
    y = _rand((k, m), k + 3 * m, cuda, 1.0 / np.sqrt(m))
    tol = _tol(m)
    torch.testing.assert_close(gram_op(spec, x, y), gram_reference(spec, x, y),
                               rtol=tol, atol=tol)
    xb = _rand((3, n, m), n + 5 * m, cuda, 1.0 / np.sqrt(m))
    got = gram_op(spec, xb)
    torch.cuda.synchronize()
    assert torch.equal(got, got.mT)
    torch.testing.assert_close(got, gram_reference(spec, xb), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("kind", sorted(SPECS))
@pytest.mark.parametrize("shape", ["130x257x784", "2000x784",
                                   "24x24x3072", "72x3072", "96x1024",
                                   "96x4096"])
def test_gram_kernel_is_fp32_grade(cuda, kind, shape):
    """3xTF32 keeps fp32's accuracy: against a float64 Gram on the card,
    the kernel's largest error is at most twice the plain fp32 version's.
    (Plain TF32 products would miss by orders of magnitude.)"""
    spec = SPECS[kind]
    n, *rest = map(int, shape.split("x"))
    k, m = rest if len(rest) == 2 else (None, rest[0])
    x = _rand((n, m), 1, cuda, 1.0 / np.sqrt(m))
    y = None if k is None else _rand((k, m), 2, cuda, 1.0 / np.sqrt(m))
    g = torch.tensor(0.3, device=cuda)
    got = gram_op(spec, x, y, gamma=g)
    plain = gram_reference(spec, x, y, gamma=g)
    exact = gram_reference(spec, x.double(), None if y is None
                           else y.double(), gamma=g.double())
    err_kernel = float((got.double() - exact).abs().max())
    err_plain = float((plain.double() - exact).abs().max())
    assert err_kernel <= 2.0 * err_plain, (err_kernel, err_plain)


@pytest.mark.parametrize("case", ["2000x784", "20x500x784", "100x2000x784",
                                  "3x96x3072"])
def test_gram_kernel_same_bits_every_call(cuda, case):
    """No atomics: the same call gives the same bits every time."""
    spec = KernelSpec(kind="rbf", gamma=1.0 / 30)
    if case == "100x2000x784":
        y = _rand((2000, 784), 3, cuda, 0.05)
        x = y[:100]
    else:
        x = _rand(tuple(map(int, case.split("x"))), 4, cuda, 0.05)
        y = None
    first = gram_op(spec, x, y)
    for _ in range(3):
        assert torch.equal(gram_op(spec, x, y), first)


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


@pytest.mark.parametrize("b", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("l", [500, 2000])
def test_project_kernel_at_engine_buckets(cuda, b, l):
    """Every pow2 slab the engine sends against both served support sizes
    (8 and 2 feature slices): against the plain version, and each row
    bit-identical to projecting it alone."""
    spec = KernelSpec(kind="rbf", gamma=0.05)
    xs = _rand((l, 784), l, cuda, 0.05)
    coefs = _rand((l, 2), 3, cuda, 1.0 / np.sqrt(l))
    rmc, bias = _rand((2,), 4, cuda), _rand((2,), 5, cuda)
    xq = _rand((b, 784), b, cuda, 0.05)
    got = project_op(spec, xq, xs, coefs, rmc, bias)
    want = project_reference(spec, xq, xs, coefs, rmc, bias)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    last = xq[b - 1:].contiguous()
    assert torch.equal(got[b - 1:], project_op(spec, last, xs, coefs, rmc,
                                               bias))


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_project_kernel_is_fp32_grade(cuda, kind):
    """3xTF32 keeps fp32's accuracy at the largest served slab (B128 x
    L2000 x M784): against a float64 projection on the card, the kernel's
    largest error is at most twice the plain fp32 version's."""
    spec = SPECS[kind]
    xq = _rand((128, 784), 1, cuda, 1.0 / np.sqrt(784))
    xs = _rand((2000, 784), 2, cuda, 1.0 / np.sqrt(784))
    coefs = _rand((2000, 1), 3, cuda, 1.0 / np.sqrt(2000))
    rmc, bias = _rand((1,), 4, cuda), _rand((1,), 5, cuda)
    ops = (xq, xs, coefs, rmc, bias)
    got = project_op(spec, *ops)
    plain = project_reference(spec, *ops)
    exact = project_reference(spec, *(t.double() for t in ops))
    err_kernel = float((got.double() - exact).abs().max())
    err_plain = float((plain.double() - exact).abs().max())
    assert err_kernel <= 2.0 * err_plain, (err_kernel, err_plain)


@pytest.mark.parametrize("b,l", [(8, 500), (128, 2000), (200, 77)])
def test_project_kernel_same_bits_every_call(cuda, b, l):
    """No atomics: the same call gives the same bits every time."""
    spec = KernelSpec(kind="rbf", gamma=0.05)
    xs = _rand((l, 784), 1, cuda, 0.05)
    coefs = _rand((l, 1), 2, cuda, 0.02)
    xq = _rand((b, 784), 3, cuda, 0.05)
    first = project_op(spec, xq, xs, coefs)
    for _ in range(3):
        assert torch.equal(project_op(spec, xq, xs, coefs), first)


@pytest.mark.parametrize("kind", sorted(SPECS))
@pytest.mark.parametrize("l,m", [(1, 3), (77, 40), (2000, 784)])
def test_project_support_split_matches_plain(cuda, kind, l, m):
    """``prepare_support`` on the card (the split pass, a block a row)
    against its plain version on the same shifted rows: the TF32 halves bit
    for bit, the norms or self-kernels to fp32 rounding (rtol 5e-5: 784
    squares summed in another order)."""
    spec = SPECS[kind]
    xs = _rand((l, m), l + m, cuda, 1.0 / np.sqrt(m))
    got = prepare_support(spec, xs)
    rows = xs if got.shift is None else xs - got.shift
    hi, lo = split_tf32(rows)
    assert torch.equal(got.hi, hi) and torch.equal(got.lo, lo)
    torch.testing.assert_close(got.ss, row_norms(spec, rows), rtol=5e-5,
                               atol=1e-6)


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
    own CPU path, from one shared alpha0 (the card's eigensolve and LAPACK
    may pick other eigenvector signs, and init="local" keys on them); both
    kernels launch on the way."""
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


def _centred_node_grams(b, n, seed, dev):
    """Centred RBF Grams of ``node_dataset``'s nodes on ``dev`` (b, n, n),
    the bandwidth from the pooled rows: the fit's kind of node Gram."""
    from repro_torch.core import center_gram, gram, resolve_gamma
    from repro_torch.data import node_dataset
    nodes, _ = node_dataset(b, n, m=784, seed=seed)
    x = torch.as_tensor(nodes, device=dev)
    spec = KernelSpec()
    g = resolve_gamma(spec, x.reshape(b * n, -1))
    return center_gram(gram(spec, x, gamma=g))


# eigenvalues and V diag(lam) V^T within 1e-5 of max |lam|, V^T V - I within
# 1e-5: the CPU tests' gate for the plain version (tests/test_torch_eigh.py)
EIGH_TOL = 1e-5


@pytest.mark.parametrize("b,n", [(80, 100), (6, 40), (3, EIGH_MAX_N),
                                 (2, 1)])
def test_eigh_kernel_matches_plain_and_library(cuda, b, n):
    """The Jacobi kernel on centred RBF node Grams (the fit's are 80 x 100 x
    100) against float64 ``torch.linalg.eigh`` and its plain version on the
    same CUDA tensor: ascending eigenvalues, V diag(lam) V^T and V^T V; the
    top eigenvector's projector (its eigenvalue stands far from the next)
    against both at 1e-4, as the setup test holds it; the sweeps under the
    cap and within one of the plain version's (fused roundings may move the
    last rotation across the threshold); one launch a call."""
    k = _centred_node_grams(b, n, 11 + n, cuda)
    before = sym_eigh.launches
    lam, vec, sweeps = sym_eigh(k)
    assert sym_eigh.launches == before + 1
    plam, pvec, psweeps = sym_eigh_reference(k)
    want, wvec = torch.linalg.eigh(k.double())
    torch.cuda.synchronize()
    scale = want.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
    assert lam.shape == (b, n) and vec.shape == (b, n, n)
    assert bool((lam[:, 1:] >= lam[:, :-1]).all())
    for got in (lam, plam):
        assert float(((got.double() - want) / scale).abs().max()) <= EIGH_TOL
    v = vec.double()
    rec = v @ torch.diag_embed(lam.double()) @ v.transpose(1, 2)
    assert float(((rec - k.double()) / scale[..., None]).abs().max()) \
        <= EIGH_TOL
    eye = torch.eye(n, dtype=torch.float64, device=cuda)
    assert float((v.transpose(1, 2) @ v - eye).abs().max()) <= EIGH_TOL
    top = vec[..., -1]
    for other in (pvec[..., -1], wvec[..., -1].float()):
        torch.testing.assert_close(top[:, :, None] * top[:, None, :],
                                   other[:, :, None] * other[:, None, :],
                                   rtol=0, atol=1e-4)
    assert bool((sweeps >= 1).all()) and bool((sweeps < MAX_SWEEPS).all())
    assert int((sweeps - psweeps).abs().max()) <= 1


def test_eigh_kernel_marks_non_finite_input(cuda):
    """A matrix holding NaN or inf comes out NaN with 0 sweeps; the batch's
    other matrices are bitwise what they are alone (one block a matrix)."""
    k = _centred_node_grams(3, 40, 9, cuda)
    k[0, 4, 1] = float("nan")
    k[2, 3, 3] = float("inf")
    lam, vec, sweeps = sym_eigh(k)
    alone = sym_eigh(k[1:2].contiguous())
    torch.cuda.synchronize()
    for i in (0, 2):
        assert bool(lam[i].isnan().all()) and bool(vec[i].isnan().all())
    assert sweeps.tolist()[0] == 0 and sweeps.tolist()[2] == 0
    assert torch.equal(lam[1:2], alone[0]) and torch.equal(vec[1:2], alone[1])


def test_eigh_route_by_size(cuda):
    """Past MAX_N the kernel's wrapper raises, and psd_jitter_eigh takes
    cuSOLVER there (counted in ``eigh_op.library_calls``, no launch); at
    MAX_N, and on an unbatched or doubly batched Gram, it launches once."""
    from repro_torch.core import psd_jitter_eigh
    k = _centred_node_grams(2, EIGH_MAX_N + 1, 5, cuda)
    with pytest.raises(ValueError, match=f"n <= {EIGH_MAX_N}"):
        sym_eigh(k)
    launches, library = sym_eigh.launches, eigh_op.library_calls
    lam, vec = psd_jitter_eigh(k)
    assert (sym_eigh.launches, eigh_op.library_calls) == (launches,
                                                          library + 1)
    # cuSOLVER's own result, floored (it reads 4.7e-5 of max |lam| from
    # float64 here, the kernel 2e-6)
    want, _ = torch.linalg.eigh(k)
    want = torch.maximum(want, 1e-6 * want[:, -1:])
    torch.testing.assert_close(lam, want, rtol=0,
                               atol=1e-6 * float(want.max()))
    small = k[:, :EIGH_MAX_N, :EIGH_MAX_N]
    for case in (small, small[0], small[None]):
        launches = sym_eigh.launches
        lam, vec = psd_jitter_eigh(case)
        assert sym_eigh.launches == launches + 1
        assert lam.shape == case.shape[:-1] and vec.shape == case.shape
    assert eigh_op.library_calls == library + 1


def _strided_blocks(dev):
    """The setup's (J, S, S, N, N) block view of a (J, SN, SN) Gram, as
    ``build_setup(center="block")`` centres it: not contiguous."""
    kfull = _rand((3, 4 * 33, 4 * 33), 11, dev)
    return kfull.reshape(3, 4, 33, 4, 33).permute(0, 1, 3, 2, 4)


@pytest.mark.parametrize("case", ["1x1", "7x33", "100x300", "2000x2000",
                                  "20x100x100", "20x500x500", "blocks",
                                  "transposed", "copied", "128x128",
                                  "129x129", "132x222x222", "132x223x223",
                                  "3x300x170", "2x170x301",
                                  "1x100000", "500x500"])
def test_center_kernel_matches_plain(cuda, case):
    """Ragged, batched and strided inputs against the plain version on the
    same CUDA tensor, on both sides of each switch to two passes (a lone
    block past 64 KB; a wave of blocks past the shared memory); one launch
    per call."""
    shapes = {"1x1": (1, 1), "7x33": (7, 33), "100x300": (100, 300),
              "2000x2000": (2000, 2000), "20x100x100": (20, 100, 100),
              "20x500x500": (20, 500, 500), "128x128": (128, 128),
              "129x129": (129, 129), "132x222x222": (132, 222, 222),
              "132x223x223": (132, 223, 223), "3x300x170": (3, 300, 170),
              "2x170x301": (2, 170, 301), "1x100000": (1, 100000),
              "500x500": (500, 500)}
    if case in shapes:
        k = _rand(shapes[case], 5, cuda)
    elif case == "blocks":
        k = _strided_blocks(cuda)
    elif case == "transposed":
        k = _rand((3, 40, 70), 6, cuda).transpose(1, 2)
    else:                       # three unmergeable batch dims
        k = _rand((2, 3, 4, 9, 10), 7, cuda).permute(2, 0, 1, 3, 4)[:, :, ::2]
    before = center_tiles.launches
    got = center_op(k)
    assert center_tiles.launches == before + 1
    want = center_reference(k)
    torch.cuda.synchronize()
    assert got.shape == k.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", ["2000x2000", "20x100x100", "blocks",
                                  "transposed"])
def test_center_op_launches_only_its_kernels(cuda, case):
    """The op forms its means itself: a trace of one call holds the
    centering kernels and no PyTorch kernel (no reduction, no copy of the
    strided block view)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    k = {"2000x2000": lambda: _rand((2000, 2000), 8, cuda),
         "20x100x100": lambda: _rand((20, 100, 100), 9, cuda),
         "blocks": lambda: _strided_blocks(cuda),
         "transposed": lambda: _rand((3, 40, 70), 6, cuda).transpose(1, 2)
         }[case]()
    center_op(k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        center_op(k)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.device_time_total > 0}
    assert names and all("center_" in n and "_kernel" in n
                         for n in names), names


def test_block_centered_setup_on_card_launches_center(cuda):
    from repro_torch.core import build_setup, ring
    from repro_torch.data import node_dataset
    nodes, _ = node_dataset(5, 30, m=64, seed=4)
    before = center_tiles.launches
    got = build_setup(nodes, ring(5, 2), KernelSpec(), center="block",
                      device=cuda)
    assert center_tiles.launches == before + 1
    want = build_setup(nodes, ring(5, 2), KernelSpec(), center="block",
                       device="cpu")
    torch.testing.assert_close(got.kcross.cpu(), want.kcross, rtol=2e-4,
                               atol=2e-4)


def _admm_inputs(j, n, s, dev, seed=0):
    rng = np.random.default_rng(seed + n + s)
    v = rng.normal(size=(j, n, n)) / np.sqrt(n)
    ins = (v, rng.uniform(0.1, 1.0, size=(j, n, 1)),
           rng.normal(size=(j, n, n)) / np.sqrt(n),
           rng.normal(size=(j, n, s)), rng.normal(size=(j, n, s)),
           rng.uniform(0.0, 2.0, size=(j, 1, s)))
    return [torch.as_tensor(a.astype(np.float32), device=dev) for a in ins]


@pytest.mark.parametrize("j,n,s", [(1, 1, 1), (4, 17, 3), (20, 100, 5),
                                   (2, 128, 5), (1, 256, 9), (3, 33, 40),
                                   (2, 1000, 5), (1, 4096, 2)])
def test_admm_kernel_matches_plain(cuda, j, n, s):
    """Ragged N, N past one warp and past one block of threads, S past one
    warp, the main path's J20 x N100 x S5, and the kernel's N limit."""
    ins = _admm_inputs(j, n, s, cuda)
    before = admm_local_update.launches
    got = admm_local_update_op(*ins)
    assert admm_local_update.launches == before + 1
    want = admm_local_update_reference(*ins)
    torch.cuda.synchronize()
    for name, g_t, w_t in zip(("alpha", "b_new", "ka"), got, want):
        torch.testing.assert_close(g_t, w_t, rtol=2e-4, atol=2e-4, msg=name)


@pytest.mark.parametrize("n", [168, 169])
def test_admm_kernel_at_the_staged_limit(cuda, n):
    """The largest N whose V and K are staged in shared memory, and the
    first that reads them from device memory."""
    from repro_torch.kernels.admm_step.admm_step import STAGED_MAX_N
    assert STAGED_MAX_N == 168
    ins = _admm_inputs(3, n, 5, cuda)
    got = admm_local_update_op(*ins)
    want = admm_local_update_reference(*ins)
    torch.cuda.synchronize()
    for name, g_t, w_t in zip(("alpha", "b_new", "ka"), got, want):
        torch.testing.assert_close(g_t, w_t, rtol=2e-4, atol=2e-4, msg=name)


@pytest.mark.parametrize("j,n,s", [(20, 100, 5), (2, 300, 5)])
def test_admm_kernel_same_bits_every_call(cuda, j, n, s):
    """No atomics, on either path: the same call gives the same bits."""
    ins = _admm_inputs(j, n, s, cuda, seed=4)
    first = admm_local_update_op(*ins)
    for _ in range(3):
        for g_t, w_t in zip(admm_local_update_op(*ins), first):
            assert torch.equal(g_t, w_t)


def test_admm_kernel_reads_strided_b_and_g(cuda):
    v, inv, k, b, g, rho = _admm_inputs(5, 60, 5, cuda, seed=3)
    bt = b.transpose(1, 2).contiguous().transpose(1, 2)
    gt = g.transpose(1, 2).contiguous().transpose(1, 2)
    assert not bt.is_contiguous() and not gt.is_contiguous()
    got = admm_local_update(v, inv, k, bt, gt, rho)
    want = admm_local_update_reference(v, inv, k, b, g, rho)
    for g_t, w_t in zip(got, want):
        torch.testing.assert_close(g_t, w_t, rtol=2e-4, atol=2e-4)


def test_admm_kernel_rejects_n_past_its_limit(cuda):
    from repro_torch.kernels.admm_step.admm_step import MAX_N
    n = MAX_N + 1
    z = torch.zeros((1, n, n), device=cuda)
    with pytest.raises(ValueError, match=f"N <= {MAX_N}"):
        admm_local_update_op(z, torch.zeros((1, n, 1), device=cuda), z,
                             torch.zeros((1, n, 3), device=cuda),
                             torch.zeros((1, n, 3), device=cuda),
                             torch.zeros((1, 1, 3), device=cuda))


def _shared_setups(cuda):
    """One CPU setup and the same tensors on the card (so both runs start
    from the same eigenvectors)."""
    import dataclasses
    from repro_torch.core import build_setup, ring
    from repro_torch.data import node_dataset
    nodes, _ = node_dataset(8, 50, m=784, seed=5)
    s_cpu = build_setup(nodes, ring(8, 2), KernelSpec(), device="cpu")
    moved = {f.name: getattr(s_cpu, f.name).to(cuda)
             for f in dataclasses.fields(s_cpu)
             if isinstance(getattr(s_cpu, f.name), torch.Tensor)}
    return s_cpu, dataclasses.replace(s_cpu, **moved)


def test_run_admm_fused_on_card_matches_cpu(cuda):
    """Alg. 1 with the fused update on the card against the port's CPU run
    from the same constants: one admm_step launch per iteration."""
    from repro_torch.core import run_admm
    s_cpu, s_gpu = _shared_setups(cuda)
    before = admm_local_update.launches
    r_gpu = run_admm(s_gpu, n_iters=12)
    assert admm_local_update.launches == before + 12
    r_cpu = run_admm(s_cpu, n_iters=12)
    torch.testing.assert_close(r_gpu.alpha_hist.cpu(), r_cpu.alpha_hist,
                               rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(r_gpu.primal_residual.cpu(),
                               r_cpu.primal_residual, rtol=1e-3, atol=1e-4)


def test_slot_mask_step_on_card_matches_plain(cuda):
    """A censored step (a node hearing only itself, one isolated outright)
    through the fused kernel against the CPU's plain step."""
    import dataclasses
    from repro_torch.core import admm_step, dense_parts, init_state
    from repro_torch.core.admm import _slot_rho, initial_alpha
    s_cpu, s_gpu = _shared_setups(cuda)
    mask = torch.ones((8, s_cpu.n_slots))
    mask[2, 1:] = 0.0
    mask[5, :] = 0.0
    b0 = torch.as_tensor(np.random.default_rng(2).normal(
        size=(8, 50, s_cpu.n_slots)).astype(np.float32))
    out = {}
    for name, s in (("cpu", s_cpu), ("gpu", s_gpu)):
        ops, comm = dense_parts(s)
        state = dataclasses.replace(
            init_state(initial_alpha(s_cpu).to(s.device), s.n_slots),
            b=b0.to(s.device))
        out[name] = admm_step(ops, comm, state, _slot_rho(s, 100.0, 10.0),
                              slot_mask=mask.to(s.device))
    (new_c, res_c), (new_g, res_g) = out["cpu"], out["gpu"]
    for f in ("alpha", "b", "g"):
        torch.testing.assert_close(getattr(new_g, f).cpu(), getattr(new_c, f),
                                   rtol=1e-3, atol=1e-4, msg=f)
    assert torch.equal(new_g.alpha[5].cpu(), initial_alpha(s_cpu)[5])
    assert float(res_g) == pytest.approx(float(res_c), rel=1e-3)


def test_baselines_and_topk_on_card_match_cpu(cuda):
    """local_kpca (one batched gram, centering and eigh), neighborhood_kpca
    and top-2 deflation on the card against the port's CPU path."""
    from repro_torch.core import (local_kpca, neighborhood_kpca, ring,
                                  run_admm_topk)
    from repro_torch.data import node_dataset
    nodes, _ = node_dataset(6, 40, m=784, seed=6)
    g = torch.tensor(1.0 / 300.0)
    c0 = center_tiles.launches
    loc = local_kpca(nodes, KernelSpec(), 2, gamma=g.to(cuda), device=cuda)
    assert center_tiles.launches == c0 + 1
    loc_cpu = local_kpca(nodes, KernelSpec(), 2, gamma=g, device="cpu")
    # eigenvector sign is arbitrary: compare the top component's rank-1
    # projectors
    a, w = loc[..., 0].cpu(), loc_cpu[..., 0]
    torch.testing.assert_close(a[:, :, None] * a[:, None, :],
                               w[:, :, None] * w[:, None, :],
                               rtol=1e-3, atol=1e-4)
    nb = neighborhood_kpca(nodes, ring(6, 1), KernelSpec(), gamma=g.to(cuda),
                           device=cuda)
    nb_cpu = neighborhood_kpca(nodes, ring(6, 1), KernelSpec(), gamma=g,
                               device="cpu")
    for (a, _), (w, _) in zip(nb, nb_cpu):
        a = a[:, 0].cpu()
        w = w[:, 0]
        torch.testing.assert_close(torch.outer(a, a), torch.outer(w, w),
                                   rtol=1e-3, atol=1e-4)
    # Top-2: the first round starts from the same eigenvectors on both
    # sides; the second from each side's own eigh of the deflated Grams,
    # whose signs may differ, so it is held to orthogonality instead.
    from repro_torch.core.deflation import _deflate_setup
    s_cpu, s_gpu = _shared_setups(cuda)
    top_gpu = run_admm_topk(s_gpu, k=2, n_iters=10)
    top_cpu = run_admm_topk(s_cpu, k=2, n_iters=10)
    torch.testing.assert_close(top_gpu[0].cpu(), top_cpu[0], rtol=1e-3,
                               atol=1e-4)
    torch.testing.assert_close(
        _deflate_setup(s_gpu, top_cpu[0].to(cuda)).kcross.cpu(),
        _deflate_setup(s_cpu, top_cpu[0]).kcross, rtol=1e-3, atol=1e-4)
    k = s_gpu.k
    a1, a2 = top_gpu
    cos = torch.einsum("jn,jnm,jm->j", a1, k, a2) / torch.sqrt(
        torch.einsum("jn,jnm,jm->j", a1, k, a1)
        * torch.einsum("jn,jnm,jm->j", a2, k, a2))
    assert bool(torch.isfinite(a2).all()) and float(cos.abs().max()) < 0.25


# ---- the serving stack on the card: bf16 slabs, partials, async, sharded ---

def _served_model(cuda, l, seed=1):
    from repro_torch.core import oos
    from repro_torch.data import node_dataset
    _, pooled = node_dataset(4, l // 4, m=784, seed=seed)
    alpha = np.random.default_rng(seed).normal(size=l).astype(np.float32)
    return oos.from_dual(pooled, alpha * 1e-3, KernelSpec(), device=cuda)


@pytest.mark.parametrize("b", [1, 8, 77, 128])
@pytest.mark.parametrize("l", [500, 2000])
def test_project_bf16_queries_bitwise_fp32_of_widened(cuda, b, l):
    """A bf16 query batch through the bf16 instance of the split pass
    gives the bits of its widened fp32 copy, and counts as a bf16 launch."""
    from repro_torch.core import oos
    from repro_torch.data import kpca_dataset
    model = _served_model(cuda, l)
    project = oos.projector(model)
    xq = torch.as_tensor(kpca_dataset(b, m=784, seed=b), device=cuda)
    xb = xq.bfloat16()
    n0 = project_tiles.bf16_launches
    got = project(xb)
    assert project_tiles.bf16_launches == n0 + 1
    want = project(xb.float())
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    plain = project_reference(model.spec, xb, model.x_support, model.coefs,
                              model.row_mean_coef, model.bias, model.gamma)
    torch.testing.assert_close(got, plain, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_partial_projector_on_card(cuda, kind):
    """The per-shard partial projector: the support split once (one
    ``prepare_support`` launch at build, none per call), each call one
    raw-partial kernel launch, against the plain version; bf16 queries
    give their widened copy's bits."""
    from repro_torch.kernels import partial_projector, prepare_support
    spec = SPECS[kind]
    xs = _rand((300, 784), 3, cuda, 1.0 / 28)
    ext = torch.cat([_rand((300, 2), 4, cuda), torch.ones((300, 1),
                                                          device=cuda)], 1)
    ext[250:, -1] = 0.0
    s0 = prepare_support.launches
    fn = partial_projector(spec, xs, ext)
    assert prepare_support.launches == s0 + 1
    xq = _rand((40, 784), 5, cuda, 1.0 / 28)
    p0 = project_tiles.partial_launches
    got = fn(xq)
    got_b = fn(xq.bfloat16())
    want_b = fn(xq.bfloat16().float())
    torch.cuda.synchronize()
    assert prepare_support.launches == s0 + 1
    assert project_tiles.partial_launches == p0 + 3
    assert torch.equal(got_b, want_b)
    want = project_partial_reference(spec, xq, xs, ext)
    scale = torch.clamp(want.abs(), min=1.0)
    assert float(((got - want).abs() / scale).max()) <= 2e-4


def _stream(n, seed=0):
    from repro_torch.data import kpca_dataset
    rng = np.random.default_rng(seed)
    return [kpca_dataset(int(q), m=784, seed=seed * 1000 + i)
            for i, q in enumerate(rng.integers(1, 70, n))]


def _submit_all(engine, reqs, threads=4):
    import threading
    futs = [None] * len(reqs)

    def submit(idx):
        for i in idx:
            futs[i] = engine.submit(reqs[i])

    ts = [threading.Thread(target=submit, args=(range(t, len(reqs),
                                                      threads),))
          for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    return [f.result(timeout=60) for f in futs]


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_async_engine_on_card_bitwise_vs_sync(cuda, dtype):
    """Four submitter threads against the started engine (flusher and
    device-runner threads on the engine's stream, pinned staging, a small
    arena that wraps often): every request bitwise the
    synchronous engine's on it alone, within 2e-4 of the plain projection
    (of the bf16-rounded queries for bf16 slabs)."""
    from repro_torch.serve import KpcaEngine, KpcaServeConfig
    model = _served_model(cuda, 500)
    cfg = KpcaServeConfig(max_batch=64, min_bucket=8, arena_factor=1,
                          query_dtype=dtype)
    reqs = _stream(120)
    with KpcaEngine(model, cfg, device=cuda) as eng:
        assert eng._arena.pinned
        assert torch.from_numpy(eng._arena.buf).is_pinned()
        got = _submit_all(eng, reqs)
    sync = KpcaEngine(model, cfg, device=cuda)
    assert eng.stats.n_compiles == 0 and eng.stats.n_donated > 0
    assert eng._arena.stats()["live_runs"] == 0
    for req, g in zip(reqs, got):
        np.testing.assert_array_equal(g, sync.project_many([req])[0])
        xq = torch.as_tensor(req, device=cuda)
        if dtype is not None:
            xq = xq.bfloat16()
        plain = project_reference(model.spec, xq, model.x_support,
                                  model.coefs, model.row_mean_coef,
                                  model.bias, model.gamma)
        np.testing.assert_allclose(g, plain.cpu().numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_bf16_engine_bitwise_vs_fp32_engine_of_rounded(cuda):
    """bf16 slabs: the same bits as the fp32 engine fed the bf16-rounded
    queries, at half the host-to-card bytes."""
    from repro_torch.serve import KpcaEngine, KpcaServeConfig
    model = _served_model(cuda, 2000)
    reqs = _stream(40, seed=3)
    rounded = [torch.as_tensor(r).bfloat16().float().numpy() for r in reqs]
    e_b = KpcaEngine(model, KpcaServeConfig(query_dtype=torch.bfloat16),
                     device=cuda)
    e_f = KpcaEngine(model, KpcaServeConfig(), device=cuda)
    n0 = project_tiles.bf16_launches
    got, want = e_b.project_many(reqs), e_f.project_many(rounded)
    assert project_tiles.bf16_launches > n0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 2 * e_b.stats.n_h2d_bytes == e_f.stats.n_h2d_bytes > 0


@pytest.mark.parametrize("routing", ["auto", "single", "mp", "dp"])
@pytest.mark.parametrize("budget", [None, 125])
def test_sharded_engine_on_card(cuda, routing, budget):
    """A 4-shard model (and its 125-landmark-per-shard compression,
    formed through gram on the card) served over [card, card]: every
    request within 3e-4 of the unsharded plain projection (of the
    compressed model's gathered form where compressed); auto routes
    single; steady drains hit the placement cache and never re-split a
    support."""
    from repro_torch.core import oos
    from repro_torch.kernels import prepare_support
    from repro_torch.serve import KpcaEngine, KpcaServeConfig
    full = _served_model(cuda, 2000)
    g0 = gram_tiles.launches
    sh, _ = oos.shard_fitted(full, 4, landmarks_per_shard=budget)
    assert (gram_tiles.launches > g0) == (budget is not None)
    ref = oos.gather_fitted(sh) if budget else full
    eng = KpcaEngine(sh, KpcaServeConfig(max_batch=64, min_bucket=8,
                                         routing=routing),
                     device=cuda, mesh=[cuda, cuda])
    eng.warmup()
    s0, p0 = prepare_support.launches, project_tiles.partial_launches
    reqs = _stream(30, seed=5)
    with eng:
        got = _submit_all(eng, reqs)
    assert prepare_support.launches == s0
    assert project_tiles.partial_launches > p0
    assert eng.router.n_placement_hits > 0
    want_policy = "single" if routing == "auto" else routing
    assert getattr(eng.stats, f"n_routed_{want_policy}") > 0
    for req, g in zip(reqs, got):
        plain = project_reference(
            ref.spec, torch.as_tensor(req, device=cuda), ref.x_support,
            ref.coefs, ref.row_mean_coef, ref.bias, ref.gamma)
        np.testing.assert_allclose(g, plain.cpu().numpy(), rtol=3e-4,
                                   atol=3e-4)


def test_router_on_card_refuses_a_cpu_shard(cuda):
    from repro_torch.core import oos
    from repro_torch.serve import KpcaEngine
    sh, _ = oos.shard_fitted(_served_model(cuda, 500), 2)
    with pytest.raises(ValueError, match="all be CUDA"):
        KpcaEngine(sh, device=cuda, mesh=[cuda, torch.device("cpu")])


def test_kernels_launch_on_every_card(cuda):
    """Kernels that opt in to more than 48 KB of shared memory do so per
    card: after a launch on the first card, the same kernels launch on
    every other card (a once-per-process opt-in failed there with CUDA
    error 1). Skips on a one-card host."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    spec = KernelSpec(kind="rbf", gamma=0.01)
    for i in range(n):
        dev = torch.device("cuda", i)
        x = _rand((300, 784), 1, dev, 0.05)
        got = gram_op(spec, x)
        torch.testing.assert_close(got, gram_reference(spec, x), rtol=2e-4,
                                   atol=2e-4)
        xs, co = _rand((2000, 784), 2, dev, 0.05), _rand((2000, 1), 3, dev)
        xq = _rand((64, 784), 4, dev, 0.05)
        torch.testing.assert_close(project_op(spec, xq, xs, co),
                                   project_reference(spec, xq, xs, co),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("which", ["x", "y", "both", "self"])
@pytest.mark.parametrize("shape", [(1, 17, 9, 5), (20, 100, 100, 784),
                                   (1, 130, 257, 784), (1, 24, 24, 3072),
                                   (4, 24, 24, 3072), (3, 96, 96, 3072)])
def test_gram_kernel_bf16_bits_of_widened(cuda, which, shape):
    """A bf16 operand through the split pass's bf16 instance gives the bits
    of its widened fp32 copy, fp32 out, within the plain version's
    tolerance, and counts as a bf16 launch."""
    z, n, k, m = shape
    spec = SPECS["rbf"]
    x = _rand((z, n, m), n + m, cuda, 1.0 / np.sqrt(m))
    y = _rand((z, k, m), k + m, cuda, 1.0 / np.sqrt(m))
    rx, ry = x.bfloat16(), y.bfloat16()
    args = {"x": (rx, y), "y": (x, ry), "both": (rx, ry),
            "self": (rx, None)}[which]
    widened = tuple(None if a is None else a.float() for a in args)
    n0 = gram_tiles.bf16_launches
    got = gram_op(spec, *args)
    assert gram_tiles.bf16_launches == n0 + 1
    assert got.dtype == torch.float32
    want = gram_op(spec, *widened)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    torch.testing.assert_close(got, gram_reference(spec, *args),
                               rtol=_tol(m), atol=_tol(m))


def test_center_op_bf16_on_card(cuda):
    k = _rand((3, 48, 40), 1, cuda)
    got = center_op(k.bfloat16())
    assert got.dtype == torch.float32
    want = center_op(k.bfloat16().float())
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    torch.testing.assert_close(got, center_reference(k.bfloat16()),
                               rtol=2e-4, atol=2e-4)


def _fault_plan():
    from repro_torch.faults import (FaultPlan, LinkFault, NodeDropout,
                                    StragglerStall, link_delay)
    return FaultPlan(seed=3, dropouts=(NodeDropout(t=6, node=2),),
                     links=(LinkFault(t0=1, t1=5, u=0, v=1),
                            link_delay(3, 2, u=4, v=5)),
                     stragglers=(StragglerStall(t0=2, t1=4, node=6),))


def test_masked_run_chunked_on_card_matches_cpu(cuda):
    """A run under a link mask (link loss, a delay, a straggler) through
    the fused kernel against the port's CPU run from the same constants
    and alpha0; the ledgers agree."""
    from repro_torch.core import initial_alpha, run_chunked
    from repro_torch.obs import CommLedger
    s_cpu, s_gpu = _shared_setups(cuda)
    lm = _fault_plan().link_mask(s_cpu.src.numpy(), s_cpu.mask.numpy(), 0,
                                 12)
    alpha0 = initial_alpha(s_cpu)
    out = {}
    for name, s in (("cpu", s_cpu), ("gpu", s_gpu)):
        led = CommLedger()
        a0 = admm_local_update.launches
        chunks = list(run_chunked(s, n_iters=12, chunk=5, ledger=led,
                                  alpha0=alpha0.to(s.device), link_mask=lm))
        out[name] = (torch.cat([c.alpha_hist for c in chunks]).cpu(), led,
                     admm_local_update.launches - a0)
    (h_c, led_c, _), (h_g, led_g, launches) = out["cpu"], out["gpu"]
    assert launches == 12
    torch.testing.assert_close(h_g, h_c, rtol=1e-3, atol=1e-4)
    assert led_g.snapshot() == led_c.snapshot()


def test_fault_tolerant_run_on_card_matches_cpu(cuda, monkeypatch):
    """FaultTolerantRun (link loss, a delay, a straggler, a dropout at t=6)
    on the card against the CPU from one shared state: the card builds each
    setup (before and after the re-knit, through gram on the card) and the
    CPU run steps from the same constants."""
    import dataclasses
    from repro_torch.core import init_state, initial_alpha, ring
    from repro_torch.core.admm import build_setup
    from repro_torch.data import node_dataset
    from repro_torch.faults import FaultTolerantRun
    from repro_torch.faults import driver
    built = []

    def card_setup(x_nodes, graph, spec, device="cuda", **kw):
        if torch.device(device).type == "cuda":
            built.append(build_setup(x_nodes, graph, spec, device=cuda, **kw))
            return built[-1]
        s = built.pop(0)
        return dataclasses.replace(s, **{
            f.name: getattr(s, f.name).cpu() for f in dataclasses.fields(s)
            if isinstance(getattr(s, f.name), torch.Tensor)})

    monkeypatch.setattr(driver, "build_setup", card_setup)
    nodes, _ = node_dataset(8, 50, m=784, seed=5)
    runs, hist = {}, {}
    for dev in (cuda, torch.device("cpu")):
        g0 = gram_tiles.launches
        run = FaultTolerantRun(nodes, ring(8, 2), KernelSpec(), _fault_plan(),
                               n_iters=12, chunk=5, device=dev)
        if dev.type == "cuda":
            alpha0 = initial_alpha(run.setup).cpu()
            assert gram_tiles.launches > g0
        run.state = init_state(alpha0.to(dev), run.setup.n_slots)
        hist[dev.type] = [c.alpha_hist.cpu() for c in run.chunks()]
        runs[dev.type] = run
    assert [h.shape for h in hist["cuda"]] == [h.shape for h in hist["cpu"]]
    for g, c in zip(hist["cuda"], hist["cpu"]):
        torch.testing.assert_close(g, c, rtol=1e-3, atol=1e-4)
    assert list(runs["cuda"].node_ids) == list(runs["cpu"].node_ids) == \
        [0, 1, 3, 4, 5, 6, 7]
    assert runs["cuda"].state.alpha.device.type == "cuda"
    assert [e.kind for e in runs["cuda"].events] == \
        ["link", "link", "straggler", "dropout"]


def test_shard_loss_on_card(cuda):
    """A 4-shard model served on the card under a shard loss at the first
    dispatch: every future resolves (success, or a typed FaultError),
    exactly one re-balance publish, and the survivors' scores match the
    plain projection of the gathered survivor model."""
    from repro_torch.core import oos
    from repro_torch.faults import (FaultError, FaultPlan, ShardLoss,
                                    ShardLossInjector, ShardRebalancer)
    from repro_torch.serve import KpcaEngine, KpcaServeConfig, ModelHandle
    sh, _ = oos.shard_fitted(_served_model(cuda, 2000), 4)
    handle = ModelHandle(sh)
    injector = ShardLossInjector(FaultPlan(
        shard_losses=(ShardLoss(at_dispatch=0, shard=1),)))
    rebalancer = ShardRebalancer()
    eng = KpcaEngine(handle, KpcaServeConfig(max_batch=64, min_bucket=8,
                                             max_retries=4,
                                             retry_backoff_s=0.005),
                     device=cuda, inject_fault=injector, on_fault=rebalancer)
    reqs = _stream(40, seed=7)
    p0 = project_tiles.partial_launches
    with eng:
        futs = [eng.submit(r) for r in reqs]
        outs = []
        for f in futs:
            try:
                outs.append(f.result(timeout=30))
            except FaultError as e:
                outs.append(e)
    assert rebalancer.n_rebalances == 1 and injector.n_raised >= 1
    assert handle.version == 1 and handle.current().shard_sizes[1] == 0
    assert project_tiles.partial_launches > p0
    survivor = oos.gather_fitted(handle.current())
    served = [(r, o) for r, o in zip(reqs, outs)
              if not isinstance(o, Exception)]
    assert served
    for req, got in served:
        plain = project_reference(
            survivor.spec, torch.as_tensor(req, device=cuda),
            survivor.x_support, survivor.coefs, survivor.row_mean_coef,
            survivor.bias, survivor.gamma)
        np.testing.assert_allclose(got, plain.cpu().numpy(), rtol=3e-4,
                                   atol=3e-4)


@pytest.fixture
def nccl_world1(cuda, tmp_path):
    """This process as a NCCL group of world 1 (a file store under the
    test's temporary directory), destroyed after the test."""
    import torch.distributed as dist
    from repro_torch.launch import make_process_group
    group, dev = make_process_group(cuda, rank=0, world_size=1,
                                    local_rank=0,
                                    init_method=f"file://{tmp_path}/store")
    yield group, dev
    dist.destroy_process_group()


@pytest.mark.parametrize("center,project", [("global", "ball"),
                                            ("none", "rescale")])
def test_ring_world1_on_card_matches_dense_fit(nccl_world1, center, project):
    """The ring fit with every node on the card against the dense fit on
    the card from the same alpha0, at the reference's SPMD gate; its
    launches: one gram per centring-sweep step and one for the slot Grams,
    one admm_step an iteration."""
    from repro_torch.core import (build_setup, dkpca_distributed,
                                  initial_alpha, ring, run_admm)
    from repro_torch.data import node_dataset
    from repro_torch.obs import CommLedger
    group, dev = nccl_world1
    spec = KernelSpec(kind="rbf")
    nodes, _ = node_dataset(8, 32, 64, seed=0)
    setup = build_setup(nodes, ring(8, hops=2), spec, center=center,
                        device=dev)
    alpha0 = initial_alpha(setup, "local")
    dense = run_admm(setup, n_iters=20, alpha0=alpha0, project=project)
    g0, a0 = gram_tiles.launches, admm_local_update.launches
    led = CommLedger()
    got = dkpca_distributed(nodes, group=group, hops=2, spec=spec,
                            center=center, project=project, n_iters=20,
                            alpha0=alpha0, ledger=led, device=dev)
    torch.cuda.synchronize()
    assert gram_tiles.launches - g0 == (8 if center == "global" else 0) + 1
    assert admm_local_update.launches - a0 == 20
    assert got.alpha.device.type == "cuda"
    assert got.alpha_hist.shape == (20, 8, 32)
    scale = float(dense.alpha.abs().max())
    assert float((got.alpha - dense.alpha).abs().max()) \
        < 5e-3 * scale + 1e-4
    assert led.per_iter.bytes == 3 * 4 * 32 * 4


def test_ring_bf16_messages_on_card(nccl_world1):
    """bf16 messages on the card: the exchange carries each neighbour column
    as its bf16 rounding and the self slot exactly (bitwise the fp32
    exchange of the rounded columns); a bf16 fit is finite at half the
    fp32 bytes."""
    from repro_torch.core import RingComm, dkpca_distributed
    from repro_torch.data import node_dataset
    from repro_torch.obs import CommLedger
    group, dev = nccl_world1
    ring_args = (8, [-2, -1, 1, 2], [4, 3, 2, 1])
    cols = _rand((8, 5, 32), 3, dev)
    got = RingComm(*ring_args, group=group, device=dev,
                   message_dtype=torch.bfloat16).exchange(cols)
    want = RingComm(*ring_args, group=group, device=dev).exchange(
        cols.bfloat16().float())
    want[:, 0] = cols[:, 0]
    assert torch.equal(got, want)
    nodes, _ = node_dataset(8, 32, 64, seed=0)
    led = CommLedger()
    bf16 = dkpca_distributed(nodes, group=group, hops=2,
                             spec=KernelSpec(kind="rbf"), n_iters=20,
                             message_dtype=torch.bfloat16, ledger=led,
                             device=dev)
    assert torch.isfinite(bf16.alpha_hist).all()
    assert led.per_iter.bytes == 3 * 4 * 32 * 2


# ---- the tile autotuner on the card ------------------------------------

@pytest.fixture
def empty_table(cuda):
    from repro_torch.kernels import autotune
    autotune.set_default_table(autotune.TileTable())
    yield autotune
    autotune.set_default_table(None)


def test_empty_table_dispatch_is_derived_on_card(empty_table):
    from repro_torch.kernels.centering.centering import (center_plan,
                                                         dispatch_plan)
    from repro_torch.kernels.gram.gram import dispatch_rows, tile_rows
    from repro_torch.kernels.project.project import (dispatch_slices,
                                                     support_chunking)
    dev = torch.device("cuda", torch.cuda.current_device())
    assert empty_table.device_backend(dev.index) == \
        "cuda:" + torch.cuda.get_device_name(dev.index)
    for z, n, k, sym in ((20, 100, 100, False), (1, 2000, 2000, True),
                         (20, 500, 500, True)):
        assert dispatch_rows(z, n, k, 784, sym, torch.float32, dev) == \
            tile_rows(z, n, k, sym)
    for l in (125, 500, 2000):
        assert dispatch_slices("project", l, 784, dev) == \
            support_chunking(l)[1]
    for z, n in ((1, 2000), (20, 100)):
        assert dispatch_plan(z, n, n, dev) == center_plan(z, n, n)


# the DKPCA probe's Grams (z, n, k, m, self-Gram): the ring's sweep and
# slot Grams at a rank's and the world-1 ring's batch, the pooled mean
# statistics at the narrowest and widest family width, the node Grams; and
# self-Grams on the route's two smaller tiles (64 x 32, 64 x 128)
SHORT_ROW_GRAMS = [(1, 24, 24, 3072, False), (4, 24, 24, 3072, False),
                   (1, 72, 72, 3072, True), (4, 72, 72, 3072, True),
                   (1, 96, 96, 1024, True), (1, 96, 96, 4096, True),
                   (3, 96, 96, 3072, True), (2, 17, 17, 1024, True),
                   (2, 40, 40, 2048, True)]


@pytest.mark.parametrize("kind", sorted(SPECS))
@pytest.mark.parametrize("z,n,k,m,sym", SHORT_ROW_GRAMS)
def test_gram_short_row_route(cuda, kind, z, n, k, m, sym):
    """The short-row route (a cluster splitting the feature axis) at the
    probe's shapes: one counted launch; the kernel gate against the plain
    version (2e-4 x max(1, |plain|)); fp32 grade (within 2x the plain
    version's error against float64); a self-Gram exactly symmetric; and
    every batch element the bits of the same operands alone, in a batch of
    four (the probe's ring on four cards against its world-1 ring)."""
    from repro_torch.kernels.gram.gram import split_count
    assert split_count(n, k, m) > 1
    spec = SPECS[kind]
    g = torch.tensor(0.3, device=cuda)
    x = _rand((4, n, m), n + m, cuda, 1.0 / np.sqrt(m))
    y = None if sym else _rand((4, k, m), k + 2 * m, cuda, 1.0 / np.sqrt(m))
    xz = x[:z].contiguous()
    yz = None if sym else y[:z].contiguous()
    launches = gram_tiles.launches
    got = gram_tiles(spec, xz, yz, g)
    assert gram_tiles.launches == launches + 1
    plain = gram_reference(spec, xz, yz, gamma=g)
    exact = gram_reference(spec, xz.double(), None if sym
                           else yz.double(), gamma=g.double())
    four = gram_tiles(spec, x, y, g)
    torch.cuda.synchronize()
    assert float(((got - plain).abs() / plain.abs().clamp(min=1.0)).max()) \
        <= 2e-4
    err = float((got.double() - exact).abs().max())
    err_plain = float((plain.double() - exact).abs().max())
    assert err <= 2.0 * err_plain, (err, err_plain)
    if sym:
        assert torch.equal(got, got.mT)
    assert torch.equal(four[:z], got)
    for e in range(4):
        one = gram_tiles(spec, x[e:e + 1], None if sym else y[e:e + 1], g)
        assert torch.equal(four[e:e + 1], one)


def test_gram_rows_64_and_128_give_the_same_bits(cuda):
    """The autotuner holds gram candidates to the default bitwise: both
    tile heights accumulate each output over the same K-tiles in order."""
    spec = KernelSpec(kind="rbf", gamma=1.0 / 30)
    x = _rand((20, 100, 784), 1, cuda, 0.05)
    y = _rand((20, 100, 784), 2, cuda, 0.05)
    g = torch.tensor(1.0 / 30, device=cuda)
    assert torch.equal(gram_tiles(spec, x, y, g, rows=64),
                       gram_tiles(spec, x, y, g, rows=128))


def test_tune_on_card_writes_and_hits_the_table(empty_table):
    at = empty_table
    spec = KernelSpec(kind="rbf")
    table = at.TileTable()
    x = _rand((20, 100, 784), 3, torch.device("cuda"), 0.05)
    y = _rand((20, 100, 784), 4, torch.device("cuda"), 0.05)
    knobs, trials = at.tune_gram(spec, x, y, k=2, table=table)
    assert knobs["rows"] in (64, 128) and len(trials) == 2
    xs = _rand((500, 784), 5, torch.device("cuda"), 0.05)
    coefs = _rand((500, 2), 6, torch.device("cuda"))
    queries = [_rand((b, 784), 7 + b, torch.device("cuda"), 0.05)
               for b in (8, 128)]
    knobs, trials = at.tune_project(spec, queries, xs, coefs, k=2,
                                    table=table)
    assert knobs["slices"] in (1, 2, 4, 8) and 1 <= len(trials) <= 4
    km = gram_op(spec, _rand((20, 100, 784), 8, torch.device("cuda"), 0.05),
                 gamma=torch.tensor(0.3, device="cuda"))
    knobs, trials = at.tune_centering(km, k=2, table=table)
    assert len(trials) == len(at.centering_candidates(20, 100, 100))
    assert len(table) == 3
    for entry in table.entries.values():
        assert entry["us"] > 0 and entry["default_us"] > 0
        assert entry["us"] <= entry["default_us"]
    # a second search answers from the table
    assert at.tune_gram(spec, x, y, k=2, table=table)[1] == []
    assert at.tune_project(spec, queries, xs, coefs, table=table)[1] == []


def test_batch_invariance_under_a_tuned_table(empty_table):
    """A table entry changes project's slicing for every batch of one L, so
    a query's scores alone are bitwise its row of a B128 slab, and within
    2e-5 of the default slicing's."""
    from repro_torch.kernels.project.project import support_chunking
    at = empty_table
    dev = torch.device("cuda", torch.cuda.current_device())
    spec = KernelSpec(kind="rbf", gamma=0.3)
    xs = _rand((2000, 784), 9, dev, 0.05)
    coefs = _rand((2000, 2), 10, dev)
    xq = _rand((128, 784), 11, dev, 0.05)
    default = support_chunking(2000)[1]
    tuned = 8 if default != 8 else 1
    before = project_op(spec, xq, xs, coefs)
    table = at.TileTable()
    table.put("project", (2000, 784), torch.float32, at.device_backend(
        dev.index), {"slices": tuned}, 1e-5)
    at.set_default_table(table)
    from repro_torch.kernels.project.ops import projector
    project = projector(spec, xs, coefs)
    slab = project(xq)
    for i in (0, 5, 127):
        assert torch.equal(project(xq[i:i + 1]), slab[i:i + 1])
    torch.testing.assert_close(slab, before, rtol=2e-5, atol=2e-5)


def test_center_plans_agree_on_card(cuda):
    from repro_torch.kernels import autotune
    from repro_torch.kernels.centering.centering import plan_of
    for shape in ((1, 2000, 2000), (20, 100, 100)):
        k = _rand(shape, 12, cuda)
        want = center_reference(k)
        for knobs in autotune.centering_candidates(*shape):
            got = center_tiles(k, plan=plan_of(*shape, knobs))
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


# ---- the LM serving path on the card ------------------------------------

@pytest.mark.parametrize("name", ["llama3.2-3b", "mixtral-8x22b"])
def test_lm_decode_on_card_matches_cpu(cuda, name):
    """Smoke-size weights drawn on the CPU and copied to the card: the
    greedy tokens agree step by step (a differing token only at a near tie,
    within 2e-2 of the CPU's choice), the logits within 2e-2."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import DecodeEngine, ServeConfig
    cfg = get_config(name, smoke=True)
    cpu_model = build_model(cfg, device="cpu")
    params, _ = cpu_model.init(0)
    card_model = build_model(cfg, device="cuda")
    card_params = {k: v.to(cuda) for k, v in params.items()}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=rng.integers(4, 12)).tolist()
               for _ in range(8)]
    calls = {}
    outs = {}
    for side, model, p in (("cpu", cpu_model, params),
                           ("card", card_model, card_params)):
        eng = DecodeEngine(model, p, 4, ServeConfig(max_len=64,
                                                    max_new_tokens=16))
        seen = calls.setdefault(side, [])
        inner = eng._sample
        eng._sample = lambda lg, inner=inner, seen=seen: (
            seen.append(lg.float().cpu().numpy()), inner(lg))[1]
        outs[side] = eng.generate(prompts)
    steps = 17
    for w in range(2):
        for s in range(steps):
            want, got = calls["cpu"][w * steps + s], \
                calls["card"][w * steps + s]
            np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
            wt, gt = want.argmax(-1), got.argmax(-1)
            if (wt != gt).any():
                rows = np.nonzero(wt != gt)[0]
                assert (want[rows, wt[rows]] - want[rows, gt[rows]]
                        <= 2e-2).all()
                break


# ---- the LM training path on the card -----------------------------------

def _opt_tensors(dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (3, 40, 50), "m2": (60, 7), "b": (50,)}
    params = {k: torch.as_tensor(rng.normal(size=s).astype(np.float32))
              .to(dtype) for k, s in shapes.items()}
    grads = [{k: torch.as_tensor((rng.normal(size=s) * 3).astype(np.float32))
              .to(dtype) for k, s in shapes.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_place", [False, True])
def test_adamw_on_card_matches_cpu(cuda, dtype, in_place):
    """AdamW (functional, or the loop's in-place form) on the card against
    the CPU on the same tensors: params, moments and the grad norm at
    1e-6 * max(1, |x|)."""
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   cosine_with_warmup)
    from repro_torch.optim.adamw import adamw_update_
    cfg = AdamWConfig(schedule=cosine_with_warmup(1, 5))
    params, grads = _opt_tensors(dtype, cuda)
    sides = {}
    for dev in ("cpu", cuda):
        p = {k: v.clone().to(dev) for k, v in params.items()}
        st = adamw_init(p)
        for g in grads:
            g = {k: v.to(dev) for k, v in g.items()}
            if in_place:
                met = adamw_update_(cfg, p, g, st)
            else:
                p, st, met = adamw_update(cfg, p, g, st)
        sides[str(dev)] = (p, st, met)
    (pc, sc, mc), (pg, sg, mg) = sides["cpu"], sides[str(cuda)]

    def near(a, b):
        a, b = a.float().cpu(), b.float()
        assert float((a - b).abs().max()) <= 1e-6 * max(
            1.0, float(b.abs().max()))
    for k in pc:
        near(pg[k], pc[k])
        near(sg["m"][k], sc["m"][k])
        near(sg["v"][k], sc["v"][k])
    near(mg["grad_norm"], mc["grad_norm"])


def _fp32_smoke(name="llama3.2-3b"):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name, smoke=True),
                               param_dtype="float32",
                               compute_dtype="float32")


def test_train_steps_on_card_match_cpu(cuda):
    """The fp32 llama3.2-3b-smoke, 8 AdamW steps from the same weights on
    the card and the CPU: losses within 1e-4 relative, the final params
    within 1e-4 max|p| of each tensor."""
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_with_warmup
    from repro_torch.train import build_train_step
    cfg = _fp32_smoke()
    opt = AdamWConfig(schedule=cosine_with_warmup(1, 8))
    weights, _ = build_model(cfg, device="cpu").init(0)
    runs = {}
    for dev in ("cpu", "cuda"):
        _, step_fn = build_train_step(build_model(cfg, device=dev), opt)
        p = {k: v.clone().to(dev) for k, v in weights.items()}
        state = dict(params=p, **adamw_init(p))
        data = TokenStream(cfg.vocab, 4, 32, seed=0, device=dev)
        losses = [float(step_fn(state, data.next_batch())[1]["loss"])
                  for _ in range(8)]
        runs[dev] = (losses, state["params"])
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    for k, want in runs["cpu"][1].items():
        got = runs["cuda"][1][k].cpu()
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max()), k


def test_resume_on_card_is_bitwise(cuda, tmp_path):
    """8 straight steps against 4, a checkpoint, a restore and 4 more
    (bf16 smoke config): the same losses and state, bitwise; the data
    stream's state comes back from the metadata."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, cosine_with_warmup
    from repro_torch.train import TrainConfig, train
    cfg = get_config("llama3.2-3b", smoke=True)
    model = build_model(cfg, device="cuda")
    opt = AdamWConfig(schedule=cosine_with_warmup(1, 8))
    tc = lambda steps, d: TrainConfig(steps=steps, ckpt_dir=str(d),
                                      ckpt_every=4, log_every=0)
    stream = lambda: TokenStream(cfg.vocab, 4, 32, seed=0, device="cuda")
    a, ha = train(model, opt, stream(), tc(8, tmp_path / "a"))
    train(model, opt, stream(), tc(4, tmp_path / "b"))
    data = stream()
    b, hb = train(model, opt, data, tc(8, tmp_path / "b"))
    assert ha["loss"][4:] == hb["loss"] and data.step == 8
    assert int(a["step"]) == int(b["step"]) == 8
    for g in ("params", "m", "v"):
        for k in a[g]:
            assert torch.equal(a[g][k], b[g][k]), (g, k)


@pytest.mark.parametrize("name", ["llama3.2-3b", "mixtral-8x22b",
                                  "deepseek-v2-236b"])
def test_remat_modes_on_card_are_bitwise(cuda, name):
    import dataclasses
    from repro_torch.configs import concrete_train_batch, get_config
    from repro_torch.models import build_model
    from repro_torch.train.loop import loss_and_grads
    base = get_config(name, smoke=True)
    params = None
    grads = {}
    for remat in ("none", "full", "dots"):
        model = build_model(dataclasses.replace(base, remat=remat),
                            device="cuda")
        if params is None:
            params, _ = model.init(0)
        batch = concrete_train_batch(model.cfg, 2, 32, device="cuda")
        grads[remat] = loss_and_grads(model, params, batch)[2]
    for remat in ("full", "dots"):
        for k, g in grads["none"].items():
            assert torch.equal(grads[remat][k], g), (remat, k)


def test_probe_on_card_matches_its_cpu_run(cuda):
    """The activation probe launches gram and admm_step on the card; the
    same build_setup + run_admm on the CPU from the card's alpha0 gives
    alpha within 2e-4 max|alpha|, and the probe's outputs are the card
    run's."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core import (KernelSpec, RhoSchedule, build_setup,
                                  initial_alpha, ring, run_admm)
    from repro_torch.models import build_model
    from repro_torch.train import activation_probe
    from repro_torch.train.probes import pooled_activations
    cfg = ArchConfig(name="t", family="dense", n_layers=2, d_model=48,
                     n_heads=2, n_kv_heads=1, d_ff=96, vocab=256,
                     head_dim=24, tie_embeddings=True, remat="none",
                     param_dtype="float32", compute_dtype="float32")
    params, _ = build_model(cfg, device="cuda").init(0)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, size=(96, 16), dtype=np.int32), device=cuda)
    g0, a0 = gram_tiles.launches, admm_local_update.launches
    out = activation_probe(params, {"tokens": toks}, n_iters=8)
    assert gram_tiles.launches > g0 and admm_local_update.launches - a0 == 8
    acts = pooled_activations(params, toks).reshape(3, 32, -1)
    runs = {}
    for dev in ("cuda", "cpu"):
        setup = build_setup(acts.to(dev), ring(3, hops=1),
                            KernelSpec(kind="rbf"), device=dev)
        if dev == "cuda":
            alpha0 = initial_alpha(setup, "local")
        runs[dev] = run_admm(setup, n_iters=8, rho2=RhoSchedule(),
                             alpha0=alpha0.to(dev))
    card = runs["cuda"]
    assert out["consensus_residual"] == float(card.primal_residual[-1])
    scale = float(card.alpha.abs().max())
    assert float((runs["cpu"].alpha - card.alpha.cpu()).abs().max()) \
        <= 2e-4 * scale


# ---- the ssm, hybrid and audio families on the card -----------------------

FAMILIES = ["falcon-mamba-7b", "zamba2-1.2b", "seamless-m4t-large-v2"]


def _rel_gap(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _greedy(model, params, batch, steps):
    """Prefill ``batch`` (frames and a prompt), then ``steps`` greedy decode
    steps: each step's logits (fp32, host)."""
    logits, cache = model.prefill(params, batch, 32)
    out = [logits.float().cpu().numpy()]
    plen = batch["tokens"].shape[1]
    for i in range(steps):
        nxt = logits.argmax(-1)[:, None].to(torch.int32)
        logits, cache = model.decode_step(params, cache, nxt, plen + i)
        out.append(logits.float().cpu().numpy())
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_family_decode_on_card_matches_cpu(cuda, name):
    """Smoke-size bf16 weights drawn on the CPU and copied to the card:
    falcon and zamba2 through DecodeEngine (8 prompts of 4-11 tokens, 6 new
    tokens), seamless by prefill (frames and an 8-token prompt) and 6
    greedy steps. Each step's logits within 2e-2 of the CPU's as a whole
    (relative L2 norm), the same greedy tokens until a near tie (within
    2e-2 of the CPU's choice)."""
    from repro_torch.configs import concrete_train_batch, get_config
    from repro_torch.models import build_model
    from repro_torch.serve import DecodeEngine, ServeConfig
    cfg = get_config(name, smoke=True)
    cpu_model = build_model(cfg, device="cpu")
    params, _ = cpu_model.init(0)
    card_model = build_model(cfg, device="cuda")
    card_params = {k: v.to(cuda) for k, v in params.items()}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=rng.integers(4, 12)).tolist()
               for _ in range(8)]
    batch = concrete_train_batch(cfg, 4, 8, device="cpu")
    calls = {}
    for side, model, p in (("cpu", cpu_model, params),
                           ("card", card_model, card_params)):
        if cfg.family == "audio":
            calls[side] = _greedy(model, p, {
                k: v.to(model.device) for k, v in batch.items()
                if k in ("tokens", "frames")}, 6)
            continue
        eng = DecodeEngine(model, p, 4, ServeConfig(max_len=64,
                                                    max_new_tokens=6))
        seen = calls.setdefault(side, [])
        inner = eng._sample
        eng._sample = lambda lg, inner=inner, seen=seen: (
            seen.append(lg.float().cpu().numpy()), inner(lg))[1]
        eng.generate(prompts)
    steps = 7
    assert len(calls["cpu"]) == len(calls["card"])
    for w in range(len(calls["cpu"]) // steps):
        for s in range(steps):
            want, got = calls["cpu"][w * steps + s], \
                calls["card"][w * steps + s]
            assert _rel_gap(got, want) <= 2e-2, (w, s, _rel_gap(got, want))
            wt, gt = want.argmax(-1), got.argmax(-1)
            if (wt != gt).any():
                rows = np.nonzero(wt != gt)[0]
                assert (want[rows, wt[rows]] - want[rows, gt[rows]]
                        <= 2e-2).all()
                break


@pytest.mark.parametrize("name", FAMILIES)
def test_family_train_step_on_card_matches_cpu(cuda, name):
    """One fp32 AdamW step of the smoke config from the same weights on the
    card and the CPU: the loss within 1e-4 relative, the params within
    1e-4 max|p| of each tensor, and the leaves drawn as zeros (a_log,
    dt_bias, conv_b) within 1e-4 max(1, max|p|): they hold one normalized
    Adam step of about lr each, and an element whose gradient is near
    Adam's eps moves with its gradient's rounding
    (scripts/family_smoke_gap.py)."""
    from repro_torch.configs import concrete_train_batch
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import build_train_step
    cfg = _fp32_smoke(name)
    weights, _ = build_model(cfg, device="cpu").init(0)
    batch = concrete_train_batch(cfg, 4, 16, device="cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        _, step_fn = build_train_step(build_model(cfg, device=dev),
                                      AdamWConfig())
        p = {k: v.clone().to(dev) for k, v in weights.items()}
        state = dict(params=p, **adamw_init(p))
        _, met = step_fn(state, {k: v.to(dev) for k, v in batch.items()})
        runs[dev] = (float(met["loss"]), state["params"])
    assert abs(runs["cuda"][0] - runs["cpu"][0]) <= 1e-4 * abs(runs["cpu"][0])
    for k, want in runs["cpu"][1].items():
        got = runs["cuda"][1][k].cpu()
        top = float(want.abs().max())
        if not weights[k].any():
            top = max(1.0, top)
        assert float((got - want).abs().max()) <= 1e-4 * top, k


def test_probe_on_family_params_launches_gram_2_and_admm_8(cuda):
    """The activation probe on zamba2-smoke's params (96 x 16 tokens: J=3
    nodes of N=32): exactly 2 gram launches (the mean statistics and the
    node Grams) and 8 admm_step launches (one an iteration)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import activation_probe
    cfg = get_config("zamba2-1.2b", smoke=True)
    params, _ = build_model(cfg, device="cuda").init(0)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(96, 16), dtype=np.int32), device=cuda)
    torch.cuda.synchronize()
    g0, a0 = gram_tiles.launches, admm_local_update.launches
    out = activation_probe(params, {"tokens": toks}, n_iters=8)
    assert not out["skipped"]
    assert gram_tiles.launches - g0 == 2
    assert admm_local_update.launches - a0 == 8


# ---------------------------------------------------------------------------
# training over a device mesh


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mesh_world1_step_on_card_is_the_step(nccl_world1, dtype):
    """A (1, 1) mesh on a NCCL group of world 1 against no mesh: two steps
    of the llama3.2-3b smoke config (remat "full") from the same seed give
    the same losses and state, bit for bit, and issue no collective."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, cosine_with_warmup
    from repro_torch.train import build_train_step
    _, dev = nccl_world1
    cfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True),
                              param_dtype=dtype, compute_dtype=dtype,
                              remat="full")
    mesh = make_mesh((1, 1), ("data", "model"), device=dev)
    opt = AdamWConfig(schedule=cosine_with_warmup(1, 2))
    runs = []
    for m in (None, mesh):
        init_fn, step_fn = build_train_step(build_model(cfg, device=dev),
                                            opt, m)
        state, _ = init_fn(0)
        data = TokenStream(cfg.vocab, 4, 32, seed=0, device=dev)
        losses = [float(step_fn(state, data.next_batch())[1]["loss"])
                  for _ in range(2)]
        runs.append((losses, state))
    assert runs[0][0] == runs[1][0]
    for g in ("params", "m", "v"):
        for k, v in runs[0][1][g].items():
            assert torch.equal(v, runs[1][1][g][k]), (g, k)
    assert not mesh.counts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba2_mesh_world1_step_is_the_step(nccl_world1, dtype):
    """zamba2-smoke (remat "full"), one step over a (1, 1) mesh on a NCCL
    group of world 1 against no mesh: the same loss and state, bit for
    bit, and no collective issued."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import build_train_step
    _, dev = nccl_world1
    cfg = dataclasses.replace(get_config("zamba2-1.2b", smoke=True),
                              param_dtype=dtype, compute_dtype=dtype,
                              remat="full")
    mesh = make_mesh((1, 1), ("data", "model"), device=dev)
    runs = []
    for m in (None, mesh):
        init_fn, step_fn = build_train_step(build_model(cfg, device=dev),
                                            AdamWConfig(), m)
        state, _ = init_fn(0)
        batch = TokenStream(cfg.vocab, 4, 32, seed=0,
                            device=dev).next_batch()
        runs.append((float(step_fn(state, batch)[1]["loss"]), state))
    assert runs[0][0] == runs[1][0]
    for g in ("params", "m", "v"):
        for k, v in runs[0][1][g].items():
            assert torch.equal(v, runs[1][1][g][k]), (g, k)
    assert not mesh.counts


MESH_CARDS = 4


def _mesh_rank(rank, world, store, out, shapes):
    """One rank of the four-card case: the fp32 smoke model's params after
    2 steps on each mesh, gathered, written by rank 0."""
    from repro_torch.distributed.collectives import gather_full
    from repro_torch.launch import make_mesh
    from repro_torch.models import build_model
    from repro_torch.data import TokenStream
    from repro_torch.optim import AdamWConfig, cosine_with_warmup
    from repro_torch.train import build_train_step
    import torch.distributed as dist
    cfg = _fp32_smoke()
    try:
        meshes = [make_mesh(s, ("data", "model"), device="cuda", rank=rank,
                            world_size=world, local_rank=rank,
                            init_method=f"file://{store}") for s in shapes]
        for shape, mesh in zip(shapes, meshes):
            model = build_model(cfg, mesh=mesh)
            init_fn, step_fn = build_train_step(
                model, AdamWConfig(schedule=cosine_with_warmup(1, 2)), mesh)
            state, _ = init_fn(0)
            data = TokenStream(cfg.vocab, 4, 32, seed=0, device=mesh.device)
            for _ in range(2):
                step_fn(state, data.next_batch())
            sh = model.shards()
            full = {k: gather_full(v, sh.specs[k], mesh).cpu()
                    for k, v in state["params"].items()}
            if rank == 0:
                torch.save(full, f"{out}/{shape[0]}x{shape[1]}.pt")
    finally:
        dist.destroy_process_group()


def test_mesh_steps_on_four_cards_match_one_card(cuda, tmp_path):
    """The fp32 llama3.2-3b-smoke on (4, 1), (2, 2) and (1, 4) meshes of
    four NCCL ranks (spawned, one card each) against one card: params
    after 2 steps within 1e-4 max|p| of each tensor."""
    import multiprocessing
    if torch.cuda.device_count() < MESH_CARDS:
        pytest.skip(f"needs {MESH_CARDS} CUDA devices, this host has "
                    f"{torch.cuda.device_count()}")
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, cosine_with_warmup
    from repro_torch.train import build_train_step
    shapes = ((4, 1), (2, 2), (1, 4))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_mesh_rank, args=(
        r, MESH_CARDS, str(tmp_path / "store"), str(tmp_path), shapes))
        for r in range(MESH_CARDS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not any(alive) and [p.exitcode for p in procs] == [0] * 4
    cfg = _fp32_smoke()
    init_fn, step_fn = build_train_step(
        build_model(cfg, device=cuda),
        AdamWConfig(schedule=cosine_with_warmup(1, 2)))
    state, _ = init_fn(0)
    data = TokenStream(cfg.vocab, 4, 32, seed=0, device=cuda)
    for _ in range(2):
        step_fn(state, data.next_batch())
    for shape in shapes:
        got = torch.load(tmp_path / f"{shape[0]}x{shape[1]}.pt")
        for k, v in state["params"].items():
            want = v.cpu()
            assert float((got[k] - want).abs().max()) <= 1e-4 * float(
                want.abs().max()), (shape, k)
