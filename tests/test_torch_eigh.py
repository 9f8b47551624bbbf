"""The batched Jacobi eigensolve's plain version (``kernels/eigh/ref.py``,
the kernel's arithmetic in PyTorch) against ``torch.linalg.eigh``, and the
route that keeps CPU tensors on the library.

Truth is ``torch.linalg.eigh`` of the same fp32 matrices in float64.
Tolerances: 1e-5 of max |lam| for eigenvalues and the reconstruction
V diag(lam) V^T, 1e-5 for V^T V - I. The plain version reads at most 1.8e-6,
1.1e-7 and 3.3e-6 on centred RBF node Grams up to n = 168, where LAPACK's
fp32 solve reads 3.4e-7, 1.4e-7 and 1.7e-6. Eigenvectors are compared only
through the reconstruction: within a repeated eigenvalue any basis is right.
About 3 s alone.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (KernelSpec, center_gram, gram, psd_jitter_eigh,
                              resolve_gamma)
from repro_torch.data import node_dataset
from repro_torch.kernels import eigh_op, sym_eigh, sym_eigh_reference
from repro_torch.kernels.eigh import MAX_SWEEPS

TOL = 1e-5


def _symmetric(b, n, seed):
    x = np.random.default_rng(seed).normal(size=(b, n, n))
    return torch.as_tensor((x + x.transpose(0, 2, 1)).astype(np.float32))


def _rbf_grams(b, n, seed):
    """Centred RBF Grams of ``node_dataset``'s nodes: rank-deficient (the
    centring's zero eigenvalue) with a tail of tiny, clustered ones."""
    nodes, _ = node_dataset(b, n, m=784, seed=seed)
    x = torch.as_tensor(nodes)
    spec = KernelSpec()
    g = resolve_gamma(spec, x.reshape(b * n, -1))
    return center_gram(gram(spec, x, gamma=g))


def _repeated():
    """Eigenvalues 0 0 1 1 1 2 2 3 3 3 3 5 in a random orthogonal basis."""
    q, _ = np.linalg.qr(np.random.default_rng(4).normal(size=(12, 12)))
    d = np.array([1, 1, 1, 2, 2, 3, 3, 3, 3, 0, 0, 5], dtype=np.float64)
    return torch.as_tensor(((q * d) @ q.T)[None].astype(np.float32))


CASES = {
    "n1": lambda: _symmetric(1, 1, 0),
    "n2": lambda: _symmetric(1, 2, 1),
    "n7": lambda: _symmetric(1, 7, 2),
    "n33": lambda: _symmetric(1, 33, 3),
    "n40": lambda: _symmetric(1, 40, 5),
    "batch3": lambda: _symmetric(3, 24, 6),
    "rbf_rank_deficient": lambda: _rbf_grams(2, 40, 3),
    "repeated": _repeated,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_library(case):
    k = CASES[case]()
    lam, vec, sweeps = sym_eigh_reference(k)
    want, _ = torch.linalg.eigh(k.double())
    n = k.shape[-1]
    scale = want.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
    assert lam.dtype == torch.float32 and vec.shape == k.shape
    assert bool((lam[:, 1:] >= lam[:, :-1]).all())
    assert float(((lam.double() - want) / scale).abs().max()) <= TOL
    v = vec.double()
    rec = v @ torch.diag_embed(lam.double()) @ v.transpose(1, 2)
    assert float(((rec - k.double()) / scale[..., None]).abs().max()) <= TOL
    eye = torch.eye(n, dtype=torch.float64)
    assert float((v.transpose(1, 2) @ v - eye).abs().max()) <= TOL
    assert bool((sweeps >= 1).all()) and bool((sweeps < MAX_SWEEPS).all())


def test_plain_version_reads_the_lower_triangle():
    """As ``torch.linalg.eigh``: the upper triangle is never read."""
    k = _symmetric(2, 9, 7)
    junk = torch.triu(torch.full_like(k, 1e3), diagonal=1)
    got, want = sym_eigh_reference(torch.tril(k) + junk), sym_eigh_reference(k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_plain_version_marks_non_finite_input():
    """A matrix holding NaN or inf comes out NaN with 0 sweeps (the kernel
    would otherwise see no off-diagonal above a NaN threshold and return
    its diagonal); the batch's other matrices are untouched."""
    k = _symmetric(3, 6, 8)
    k[0, 4, 1] = float("nan")
    k[2, 3, 3] = float("inf")
    lam, vec, sweeps = sym_eigh_reference(k)
    alone = sym_eigh_reference(k[1:2])
    for i in (0, 2):
        assert bool(lam[i].isnan().all()) and bool(vec[i].isnan().all())
    assert sweeps[0] == 0 and sweeps[2] == 0
    assert torch.equal(lam[1:2], alone[0]) and torch.equal(vec[1:2], alone[1])


def test_cpu_tensors_keep_the_library_and_never_launch():
    """psd_jitter_eigh on a CPU tensor is torch.linalg.eigh and the flooring,
    bit for bit, as before the kernel; no launch, no library-route count
    (that counts card calls)."""
    k = _rbf_grams(3, 20, 1)
    before = (sym_eigh.launches, eigh_op.library_calls)
    lam, vec = psd_jitter_eigh(k)
    want_lam, want_vec = torch.linalg.eigh(k)
    lam_max = torch.clamp(want_lam[..., -1:], min=1e-30)
    assert torch.equal(lam, torch.maximum(want_lam, 1e-6 * lam_max))
    assert torch.equal(vec, want_vec)
    got = eigh_op(k[0])                       # unbatched (n, n) too
    assert all(torch.equal(g, w) for g, w in zip(got, torch.linalg.eigh(k[0])))
    assert (sym_eigh.launches, eigh_op.library_calls) == before


def test_launch_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only: a CPU tensor raises
    instead of quietly running the plain version or the library."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        sym_eigh(_symmetric(1, 4, 0))
