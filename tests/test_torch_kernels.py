"""Parity of the port's kernel ops (their plain PyTorch path, which CPU
tensors take) with the JAX package's Pallas kernels in interpret mode, on
the same seeded numpy inputs; and the launch wrappers' refusal of anything
but fp32 CUDA tensors (no fallback).

Tolerances are the JAX package's own (tests/test_kernels_gram.py,
tests/test_oos_projection.py): 2e-5, or 2e-4 where M >= 300, where the exp
epilogue amplifies fp32 summation-order differences.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import KernelSpec as JKernelSpec
from repro.kernels import admm_local_update_op as j_admm_op
from repro.kernels import center_op as j_center_op
from repro.kernels import gram_op as j_gram_op
from repro.kernels import project_op as j_project_op
from repro.kernels.project import project_partial_op as j_partial_op
from repro_torch.core import KernelSpec
from repro_torch.kernels import (admm_local_update, admm_local_update_op,
                                 center_op, center_reference, center_tiles,
                                 gram_op, gram_tiles, project_op,
                                 project_partial_op, project_tiles)
from repro_torch.kernels.project.project import (prepare_support,
                                                  split_tf32,
                                                  support_chunking)

SPEC_KW = {
    "rbf": dict(kind="rbf", gamma=0.3),
    "linear": dict(kind="linear"),
    "poly": dict(kind="poly", degree=2, scale=0.1),
}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _tol(m):
    return 2e-4 if m >= 300 else 2e-5


@pytest.mark.parametrize("kind", sorted(SPEC_KW))
@pytest.mark.parametrize("n,k,m", [(8, 8, 4), (17, 9, 9), (100, 37, 37),
                                   (33, 70, 300),
                                   # the probe's short rows, long features
                                   (24, 24, 3072), (96, 96, 4096)])
def test_gram_op_matches_jax(kind, n, k, m):
    x = _rand((n, m), n + m, 1 / np.sqrt(m))
    y = _rand((k, m), k + m + 1, 1 / np.sqrt(m))
    want = np.asarray(j_gram_op(JKernelSpec(**SPEC_KW[kind]), jnp.asarray(x),
                                jnp.asarray(y), interpret=True))
    got = gram_op(KernelSpec(**SPEC_KW[kind]), torch.as_tensor(x),
                  torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=_tol(m), atol=_tol(m))


def test_gram_op_median_gamma_matches_jax():
    x = _rand((40, 16), 3)
    want = np.asarray(j_gram_op(JKernelSpec(), jnp.asarray(x),
                                interpret=True))
    got = gram_op(KernelSpec(), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_gram_op_batch_matches_per_item():
    spec = KernelSpec(kind="rbf", gamma=0.2)
    x = torch.as_tensor(_rand((3, 12, 10), 4))
    y = torch.as_tensor(_rand((3, 7, 10), 5))
    got = gram_op(spec, x, y)
    for z in range(3):
        torch.testing.assert_close(got[z], gram_op(spec, x[z], y[z]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", sorted(SPEC_KW))
@pytest.mark.parametrize("b,l,m,c", [(1, 5, 3, 1), (13, 40, 24, 2),
                                     (8, 130, 300, 1)])
def test_project_op_matches_jax(kind, b, l, m, c):
    xq = _rand((b, m), b + m, 1 / np.sqrt(m))
    xs = _rand((l, m), l + m, 1 / np.sqrt(m))
    coefs = _rand((l, c), 3, 1 / np.sqrt(l))
    rmc, bias = _rand((c,), 4), _rand((c,), 5)
    want = np.asarray(j_project_op(
        JKernelSpec(**SPEC_KW[kind]), jnp.asarray(xq), jnp.asarray(xs),
        jnp.asarray(coefs), jnp.asarray(rmc), jnp.asarray(bias),
        interpret=True))
    got = project_op(KernelSpec(**SPEC_KW[kind]), *map(
        torch.as_tensor, (xq, xs, coefs, rmc, bias))).numpy()
    np.testing.assert_allclose(got, want, rtol=_tol(m), atol=_tol(m))


@pytest.mark.parametrize("kind", sorted(SPEC_KW))
def test_projector_matches_project_op(kind):
    """The per-model half done once serves batches of any width as
    ``project_op`` does."""
    from repro_torch.kernels import projector
    spec = KernelSpec(**SPEC_KW[kind])
    xs, coefs = _rand((40, 24), 1, 0.2), _rand((40, 2), 2)
    rmc, bias = _rand((2,), 3), _rand((2,), 4)
    ops = tuple(map(torch.as_tensor, (xs, coefs, rmc, bias)))
    project = projector(spec, *ops)
    for b in (1, 13, 64):
        xq = torch.as_tensor(_rand((b, 24), b, 0.2))
        torch.testing.assert_close(project(xq), project_op(spec, xq, *ops),
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="shapes disagree"):
        projector(spec, ops[0], ops[1][:30])


def test_project_partial_op_matches_jax():
    xq, xs = _rand((11, 20), 1, 0.3), _rand((30, 20), 2, 0.3)
    ext = np.concatenate([_rand((30, 2), 3), np.ones((30, 1), np.float32)],
                         axis=1)
    ext[25:] = 0.0                                  # shard padding rows
    want = np.asarray(j_partial_op(
        JKernelSpec(kind="rbf", gamma=0.4), jnp.asarray(xq), jnp.asarray(xs),
        jnp.asarray(ext), gamma=jnp.asarray(0.4), interpret=True))
    got = project_partial_op(KernelSpec(kind="rbf", gamma=0.4),
                             torch.as_tensor(xq), torch.as_tensor(xs),
                             torch.as_tensor(ext),
                             gamma=torch.tensor(0.4)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _launch_counts():
    return (gram_tiles.launches, project_tiles.launches,
            center_tiles.launches, admm_local_update.launches)


def test_cpu_tensors_never_launch_a_kernel():
    spec = KernelSpec(kind="rbf", gamma=0.1)
    before = _launch_counts()
    x = torch.rand((6, 4))
    gram_op(spec, x)
    project_op(spec, x, x, torch.rand((6, 1)))
    center_op(torch.rand((2, 6, 6)))
    v = torch.rand((2, 6, 6))
    admm_local_update_op(v, torch.rand((2, 6, 1)), v, torch.rand((2, 6, 3)),
                         torch.rand((2, 6, 3)), torch.rand((2, 1, 3)))
    assert _launch_counts() == before


@pytest.mark.parametrize("wrapper", ["gram", "project", "center",
                                     "admm_step"])
def test_launch_wrappers_refuse_cpu_tensors(wrapper):
    """The kernel wrappers take CUDA tensors only: a CPU tensor raises
    instead of quietly running the plain version."""
    spec = KernelSpec(kind="rbf", gamma=0.1)
    g = torch.tensor(0.1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if wrapper == "gram":
            x = torch.rand((1, 4, 3))
            gram_tiles(spec, x, x, g)
        elif wrapper == "project":
            project_tiles(spec, torch.rand((2, 3)),
                          prepare_support(spec, torch.rand((4, 3))),
                          torch.rand((4, 2)), g)
        elif wrapper == "center":
            center_tiles(torch.rand((1, 2, 4, 3)))
        else:
            v = torch.rand((1, 4, 4))
            admm_local_update(v, torch.rand((1, 4, 1)), v,
                              torch.rand((1, 4, 2)), torch.rand((1, 4, 2)),
                              torch.rand((1, 1, 2)))


@pytest.mark.parametrize("wrapper", ["gram_self", "center_strided"])
def test_launch_wrappers_refuse_cpu_tensors_on_new_paths(wrapper):
    """The symmetric gram path and a strided centring view refuse CPU
    tensors as the plain calls do."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        if wrapper == "gram_self":
            gram_tiles(KernelSpec(kind="linear"), torch.rand((2, 5, 3)), None,
                       torch.tensor(0.0))
        else:
            center_tiles(torch.rand((3, 6, 8)).transpose(1, 2))


def _tf32_rna(t):
    """Round fp32 to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero, by bit masking: what ``cvt.rna.tf32.f32`` does."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_3xtf32(t):
    hi = _tf32_rna(t)
    return hi, _tf32_rna(t - hi)


def _gram_3xtf32(spec, x, y):
    """The gram kernel's arithmetic in plain PyTorch: the dot products
    from the 3xTF32 split (lo.hi + hi.lo + hi.hi), the epilogue on the fp32
    row norms."""
    (xh, xl), (yh, yl) = _split_3xtf32(x), _split_3xtf32(y)
    return _epilogue(spec, xl @ yh.T + xh @ yl.T + xh @ yh.T, x, y)


def _epilogue(spec, dot, x, y):
    """The kernels' epilogue on the dot products of x against y."""
    from repro_torch.core.kernels_math import _self_k
    if spec.kind == "rbf":
        d2 = (torch.sum(x * x, -1)[:, None] + torch.sum(y * y, -1)[None, :]
              - 2.0 * dot)
        return torch.exp(-spec.gamma * torch.clamp(d2, min=0.0))
    k = dot * spec.scale
    if spec.kind == "poly":
        k = (k + spec.coef) ** spec.degree
    if spec.normalize:
        k = k / torch.sqrt(torch.clamp(
            _self_k(spec, x)[:, None] * _self_k(spec, y)[None, :], min=1e-12))
    return k


@pytest.mark.parametrize("m", [5, 37, 300, 784])
def test_tf32_split_reconstructs_fp32(m):
    x = torch.as_tensor(_rand((64, m), m))
    hi, lo = _split_3xtf32(x)
    for part in (hi, lo):          # TF32: the low 13 mantissa bits are zero
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs().clamp(min=1e-30))
    assert float(rel.max()) <= 2.0 ** -21


@pytest.mark.parametrize("kind", sorted(SPEC_KW))
@pytest.mark.parametrize("n,k,m", [(8, 8, 4), (17, 9, 9), (100, 37, 37),
                                   (33, 70, 300)])
def test_gram_3xtf32_emulation_matches_jax(kind, n, k, m):
    """``test_gram_op_matches_jax``'s inputs through the kernel's 3xTF32
    arithmetic, at 2e-5: the split loses nothing fp32 keeps."""
    x = _rand((n, m), n + m, 1 / np.sqrt(m))
    y = _rand((k, m), k + m + 1, 1 / np.sqrt(m))
    want = np.asarray(j_gram_op(JKernelSpec(**SPEC_KW[kind]), jnp.asarray(x),
                                jnp.asarray(y), interpret=True))
    got = _gram_3xtf32(KernelSpec(**SPEC_KW[kind]), torch.as_tensor(x),
                       torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("m", [3, 24, 40, 784])
def test_project_support_split_is_padded_3xtf32(m):
    """``split_tf32`` (the projector's per-model support halves) is the
    bit-masked 3xTF32 split at a row stride padded to 32 floats with
    zeros."""
    x = torch.as_tensor(_rand((70, m), m))
    hi, lo = split_tf32(x)
    mp = -(-m // 32) * 32
    assert hi.shape == lo.shape == (70, mp)
    want_hi, want_lo = _split_3xtf32(x)
    assert torch.equal(hi[:, :m], want_hi) and torch.equal(lo[:, :m], want_lo)
    assert not hi[:, m:].any() and not lo[:, m:].any()


@pytest.mark.parametrize("kind", sorted(SPEC_KW))
def test_project_support_plain_version(kind):
    """``prepare_support`` on a CPU tensor, the split pass's plain version:
    for rbf the rows less their mean row, else the rows as they are, split
    as ``split_tf32`` splits them, with their squared norms (rbf, against
    float64) or self-kernels (linear/poly, the diagonal of the JAX Gram
    without normalize)."""
    x = _rand((70, 40), 7, 1 / np.sqrt(40))
    spec = KernelSpec(**SPEC_KW[kind])
    sup = prepare_support(spec, torch.as_tensor(x))
    rows = x - x.mean(axis=0) if kind == "rbf" else x
    if kind == "rbf":
        np.testing.assert_allclose(sup.shift.numpy(), x.mean(axis=0),
                                   rtol=1e-5, atol=1e-6)
        want_ss = (rows.astype(np.float64) ** 2).sum(axis=1)
    else:
        assert sup.shift is None
        want_ss = np.diag(np.asarray(j_gram_op(
            JKernelSpec(**SPEC_KW[kind], normalize=False), jnp.asarray(x),
            jnp.asarray(x), interpret=True)))
    hi, lo = split_tf32(torch.as_tensor(x) if sup.shift is None
                        else torch.as_tensor(x) - sup.shift)
    assert torch.equal(sup.hi, hi) and torch.equal(sup.lo, lo)
    np.testing.assert_allclose(sup.ss.numpy(), want_ss, rtol=2e-5, atol=2e-6)


def _project_3xtf32(spec, xq, xs, coefs, rmc, bias):
    """The project kernel's arithmetic in plain PyTorch: both sides shifted
    by the support's mean row (rbf), 3xTF32 dot products per 32-feature
    stage, summed per feature slice and the slices in order; the epilogue;
    64-row support tiles' partials summed in tile order; the centering
    terms."""
    tiles, slices = support_chunking(xs.shape[0])
    sh, sl, shift, _ = prepare_support(spec, xs)
    if shift is not None:
        xq, xs = xq - shift, xs - shift
    qh, ql = split_tf32(xq)
    kt = sh.shape[1] // 32
    dot = torch.zeros((xs.shape[0], xq.shape[0]))
    for r in range(slices):
        part = torch.zeros_like(dot)
        for k in range(r * kt // slices, (r + 1) * kt // slices):
            f = slice(32 * k, 32 * k + 32)
            part = part + (sl[:, f] @ qh[:, f].T + sh[:, f] @ ql[:, f].T
                           + sh[:, f] @ qh[:, f].T)
        dot = dot + part
    kmat = _epilogue(spec, dot.T, xq, xs)
    a_ext = torch.cat([coefs, torch.ones((xs.shape[0], 1))], dim=1)
    p = torch.zeros((xq.shape[0], a_ext.shape[1]))
    for t in range(tiles):
        rows = slice(64 * t, 64 * t + 64)
        p = p + kmat[:, rows] @ a_ext[rows]
    c = coefs.shape[1]
    return p[:, :c] + p[:, c:] / xs.shape[0] * rmc + bias


@pytest.mark.parametrize("kind", sorted(SPEC_KW))
@pytest.mark.parametrize("b,l,m,c", [(1, 5, 3, 1), (13, 40, 24, 2),
                                     (8, 130, 300, 1), (33, 500, 784, 1)])
def test_project_3xtf32_emulation_matches_jax(kind, b, l, m, c):
    """``test_project_op_matches_jax``'s inputs (and the main path's
    L500 x M784) through the project kernel's tiling, feature slices and
    3xTF32 arithmetic, at the JAX package's tolerance."""
    xq = _rand((b, m), b + m, 1 / np.sqrt(m))
    xs = _rand((l, m), l + m, 1 / np.sqrt(m))
    coefs = _rand((l, c), 3, 1 / np.sqrt(l))
    rmc, bias = _rand((c,), 4), _rand((c,), 5)
    want = np.asarray(j_project_op(
        JKernelSpec(**SPEC_KW[kind]), jnp.asarray(xq), jnp.asarray(xs),
        jnp.asarray(coefs), jnp.asarray(rmc), jnp.asarray(bias),
        interpret=True))
    got = _project_3xtf32(KernelSpec(**SPEC_KW[kind]), *map(
        torch.as_tensor, (xq, xs, coefs, rmc, bias))).numpy()
    np.testing.assert_allclose(got, want, rtol=_tol(m), atol=_tol(m))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_op_dtypes_like_jax(dtype):
    """``TestGramKernel.test_dtypes``: the op on fp32 or bf16 input against
    the fp32 Gram of the widened input, at its 2e-5 / 5e-2; and against the
    JAX package's op on the same rounded input."""
    spec = dict(kind="rbf", gamma=0.5)
    x = _rand((40, 16), 3)
    xt = torch.as_tensor(x).to(getattr(torch, dtype))
    got = gram_op(KernelSpec(**spec), xt)
    assert got.dtype == torch.float32
    want = np.asarray(j_gram_op(JKernelSpec(**spec), jnp.asarray(x)))
    tol = 5e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    j_got = np.asarray(j_gram_op(JKernelSpec(**spec), jnp.asarray(x).astype(
        getattr(jnp, dtype)), interpret=True))
    np.testing.assert_allclose(got.numpy(), j_got, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind", sorted(SPEC_KW))
@pytest.mark.parametrize("which", ["x", "y", "both", "self"])
def test_gram_op_bf16_is_fp32_of_the_rounded_input(kind, which):
    """A bf16 operand is widened: fp32 out, within 2e-5 of the fp32 op on
    the rounded input (the median bandwidth included)."""
    x = torch.as_tensor(_rand((24, 20), 5, 1 / np.sqrt(20)))
    y = torch.as_tensor(_rand((9, 20), 6, 1 / np.sqrt(20)))
    rx, ry = x.bfloat16(), y.bfloat16()
    args = {"x": (rx, y), "y": (x, ry), "both": (rx, ry),
            "self": (rx, None)}[which]
    spec = KernelSpec(**dict(SPEC_KW[kind], gamma=None))
    got = gram_op(spec, *args)
    assert got.dtype == torch.float32
    want = gram_op(spec, *(None if a is None else a.float() for a in args))
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_center_op_bf16_is_fp32_of_the_rounded_input():
    k = torch.as_tensor(_rand((3, 48, 40), 1))
    kb = k.bfloat16()
    got = center_op(kb)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, center_op(kb.float()), rtol=2e-4,
                               atol=2e-4)
    want = np.asarray(j_center_op(jnp.asarray(k[0].numpy()).astype(
        jnp.bfloat16), interpret=True))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("m,want", [(1, 32), (5, 32), (31, 32), (32, 32),
                                    (33, 64), (784, 800)])
def test_gram_padded_row_stride(m, want):
    from repro_torch.kernels.gram.gram import padded_stride
    assert padded_stride(m) == want


@pytest.mark.parametrize("z,n,k,symmetric,want", [
    (1, 2000, 2000, True, 128),        # central / similarity self-Gram
    (20, 500, 500, True, 128),         # the setup's batched slot Grams
    (1, 5, 5, True, 128),              # symmetric tiles stay square
    (1, 100, 2000, False, 64),         # similarity's cross Gram: 16 tiles
    (1, 500, 2000, False, 64),         # compress: 64 tiles at 128 rows
    (1, 2000, 2000, False, 128),       # a full grid of 256 tiles
    (20, 100, 2000, False, 128)])      # 20 x 16 tiles: past one wave
def test_gram_tile_rows(z, n, k, symmetric, want):
    from repro_torch.kernels.gram.gram import tile_rows
    assert tile_rows(z, n, k, symmetric) == want


@pytest.mark.parametrize("z,n,m,want", [
    (20, 100, 100, (True, 0, 0, 0)),        # local baseline: 40 KB blocks
    (500, 100, 100, (True, 0, 0, 0)),       # the setup's block view
    (1, 7, 33, (True, 0, 0, 0)),
    (1, 128, 128, (True, 0, 0, 0)),         # a lone 64 KB block
    (1, 129, 129, (False, 12, 11, 2)),      # a lone block past 64 KB
    (132, 222, 222, (True, 0, 0, 0)),       # a wave of 197 KB blocks
    (132, 223, 223, (False, 223, 1, 2)),    # past the shared memory
    (1, 222, 222, (False, 16, 14, 2)),      # fits, but alone
    (1, 2000, 2000, (False, 118, 17, 16)),  # central: 272 blocks
    (20, 500, 500, (False, 125, 4, 4)),     # setup's slot Grams: 320
    (1, 500, 500, (False, 23, 22, 4)),      # a neighbourhood's Gram
    (1, 1, 100000, (False, 1, 1, 782))])    # one row, 782 column tiles
def test_center_plan(z, n, m, want):
    from repro_torch.kernels.centering.centering import center_plan
    plan = center_plan(z, n, m)
    assert (plan.small, plan.rows, plan.slabs, plan.col_tiles) == want
    if not plan.small:
        assert plan.rows * plan.slabs >= n > plan.rows * (plan.slabs - 1)
        assert plan.rows <= 256


@pytest.mark.parametrize("n,m", [(8, 8), (50, 70), (256, 256), (100, 300)])
def test_center_op_matches_jax(n, m):
    """``TestCenteringKernel``'s shapes and inputs."""
    k = np.random.default_rng(n).normal(size=(n, m)).astype(np.float32)
    want = np.asarray(j_center_op(jnp.asarray(k), interpret=True))
    got = center_op(torch.as_tensor(k)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(center_reference(torch.as_tensor(k)).numpy(),
                               want, rtol=2e-5, atol=2e-5)


def test_center_op_composes_with_gram_like_jax():
    x = np.random.default_rng(7).normal(size=(60, 20)).astype(np.float32)
    spec = dict(kind="rbf", gamma=0.3)
    want = np.asarray(j_center_op(j_gram_op(JKernelSpec(**spec),
                                            jnp.asarray(x), interpret=True),
                                  interpret=True))
    got = center_op(gram_op(KernelSpec(**spec), torch.as_tensor(x))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape,strides,want", [
    ((3, 4), (4, 1), ((1, 0), (1, 0))),
    ((2, 3, 4, 4), (48, 16, 4, 1), ((1, 0), (6, 16))),
    # the setup's (J, S, S, N, N) block view: (J, S) merge, the last S not
    ((2, 3, 3, 4, 4), (144, 48, 4, 12, 1), ((6, 48), (3, 4))),
    ((2, 1, 5, 4), (20, 20, 1, 5), ((1, 0), (2, 20))),
])
def test_center_view_merges_batch_dims(shape, strides, want):
    from repro_torch.kernels.centering.centering import merge_batch_dims
    assert merge_batch_dims(shape[:-2], strides[:-2]) == want


def test_center_view_copies_past_two_batch_dims():
    from repro_torch.kernels.centering.centering import merge_batch_dims
    t = torch.rand((2, 3, 4, 5, 6)).permute(2, 0, 1, 3, 4)[:, :, ::2]
    assert merge_batch_dims(tuple(t.shape[:-2]), t.stride()[:-2]) is None
    c = t.contiguous()
    assert merge_batch_dims(tuple(c.shape[:-2]),
                            c.stride()[:-2]) == ((1, 0), (16, 30))


@pytest.mark.parametrize("j,n,s", [(1, 16, 3), (4, 32, 5), (2, 128, 5),
                                   (1, 256, 9)])
def test_admm_local_update_op_matches_jax(j, n, s):
    """``TestAdmmStepKernel``'s shapes and inputs, at its 2e-4."""
    rng = np.random.default_rng(n + s)
    v = rng.normal(size=(j, n, n)).astype(np.float32)
    invd = rng.uniform(0.1, 1.0, size=(j, n, 1)).astype(np.float32)
    k = rng.normal(size=(j, n, n)).astype(np.float32)
    b = rng.normal(size=(j, n, s)).astype(np.float32)
    g = rng.normal(size=(j, n, s)).astype(np.float32)
    rho = rng.uniform(0.0, 2.0, size=(j, 1, s)).astype(np.float32)
    ins = (v, invd, k, b, g, rho)
    want_a, want_b = j_admm_op(*map(jnp.asarray, ins), interpret=True)
    got_a, got_b, got_ka = admm_local_update_op(*map(torch.as_tensor, ins))
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got_ka.numpy(), k @ np.asarray(want_a),
                               rtol=2e-4, atol=2e-4)


def test_matches_admm_iteration_algebra():
    """The fused op reproduces the alpha/B update inside the port's own
    ``admm_iteration`` (same rhs/solve/eta algebra), as
    ``TestAdmmStepKernel`` holds the JAX kernel to the JAX solver."""
    from repro_torch.core import admm_iteration, build_setup, ring
    from repro_torch.core.admm import _slot_rho
    from repro_torch.data import node_dataset
    nodes, _ = node_dataset(5, 16, 8, seed=0)
    setup = build_setup(nodes, ring(5, 1), KernelSpec("rbf", 0.5),
                        device="cpu")
    alpha = torch.as_tensor(_rand((5, 16), 0))
    b = torch.zeros((5, 16, setup.n_slots))
    a_ref, b_ref, g, _ = admm_iteration(setup, alpha, b, 100.0, 10.0)
    rho_slots = _slot_rho(setup, 100.0, 10.0)
    lam = setup.lam
    den = torch.sum(rho_slots, dim=1)[:, None] * lam - 2.0 * lam * lam
    inv = torch.where(lam > 1e-5 * lam[:, -1:],
                      1.0 / torch.maximum(den, 1e-6 * lam),
                      torch.zeros_like(lam))
    mask = setup.mask.to(torch.float32)[:, None, :]
    got_a, got_b, _ = admm_local_update_op(setup.vec, inv[..., None], setup.k,
                                           b * mask, g, rho_slots[:, None, :])
    torch.testing.assert_close(got_a[..., 0], a_ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got_b * mask, b_ref, rtol=2e-4, atol=2e-4)


def test_mixed_devices_raise():
    from repro_torch.kernels._util import on_card
    with pytest.raises(ValueError, match="one CUDA device"):
        on_card(torch.rand(2), torch.rand(2, device="meta"))


@pytest.mark.parametrize("l,want", [(1, (1, 8)), (500, (8, 8)),
                                    (2000, (32, 2)), (2048, (32, 2)),
                                    (5000, (79, 1))])
def test_support_chunking_depends_on_l_only(l, want):
    assert support_chunking(l) == want
