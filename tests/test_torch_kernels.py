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
from repro.kernels import gram_op as j_gram_op
from repro.kernels import project_op as j_project_op
from repro.kernels.project import project_partial_op as j_partial_op
from repro_torch.core import KernelSpec
from repro_torch.kernels import (gram_op, gram_tiles, project_op,
                                 project_partial_op, project_tiles)
from repro_torch.kernels.project.project import support_chunking

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
                                   (33, 70, 300)])
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


def test_cpu_tensors_never_launch_a_kernel():
    spec = KernelSpec(kind="rbf", gamma=0.1)
    g0, p0 = gram_tiles.launches, project_tiles.launches
    x = torch.rand((6, 4))
    gram_op(spec, x)
    project_op(spec, x, x, torch.rand((6, 1)))
    assert (gram_tiles.launches, project_tiles.launches) == (g0, p0)


@pytest.mark.parametrize("wrapper", ["gram", "project"])
def test_launch_wrappers_refuse_cpu_tensors(wrapper):
    """The kernel wrappers take CUDA tensors only: a CPU tensor raises
    instead of quietly running the plain version."""
    spec = KernelSpec(kind="rbf", gamma=0.1)
    g = torch.tensor(0.1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if wrapper == "gram":
            x = torch.rand((1, 4, 3))
            gram_tiles(spec, x, x, torch.rand((1, 4)), torch.rand((1, 4)), g)
        else:
            project_tiles(spec, torch.rand((2, 3)), torch.rand((4, 3)),
                          torch.rand((4, 2)), torch.rand((4,)), g)


def test_mixed_devices_raise():
    from repro_torch.kernels._util import on_card
    with pytest.raises(ValueError, match="one CUDA device"):
        on_card(torch.rand(2), torch.rand(2, device="meta"))


@pytest.mark.parametrize("l,want", [(1, (1, 1)), (500, (1, 16)),
                                    (2000, (1, 63)), (2048, (1, 64)),
                                    (5000, (3, 53))])
def test_support_chunking_depends_on_l_only(l, want):
    assert support_chunking(l) == want
