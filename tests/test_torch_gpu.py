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
                                 center_reference, center_tiles, gram_op,
                                 gram_reference, gram_tiles, project_op,
                                 project_partial_op,
                                 project_partial_reference, project_reference,
                                 project_tiles)
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
@pytest.mark.parametrize("shape", ["130x257x784", "2000x784"])
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


@pytest.mark.parametrize("case", ["2000x784", "20x500x784", "100x2000x784"])
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
