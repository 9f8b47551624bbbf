"""Parity of the port's core (CPU path) with the JAX package on the same
seeded numpy inputs: gamma, the setup phase in every centering mode, one
ADMM step, whole trajectories from one shared alpha0, the central baseline,
the similarity metric, and checkpoints written by one package and read by
the other.

Tolerances: 1e-5 where one fp32 formula is evaluated on both sides; 1e-4
(the reference's own admm_step gate is 2e-4) on ADMM trajectories, where
the two eigensolvers' rounding feeds ten iterations of the same algebra.

Run as a script (``PYTHONPATH=src python tests/test_torch_core.py``) it
prints the paper's experiment path at its size (J=20 nodes x N=100 x M=784,
ring(20, hops=2)) in both packages on the CPU: mean similarity to central
kPCA of ADMM@30, the Fig. 4 local and Fig. 5 neighbourhood baselines, and
the top-2 deflation checks.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import admm as j_admm
from repro.core import central as j_central
from repro.core import deflation as j_deflation
from repro.core import local as j_local
from repro.core import metrics as j_metrics
from repro.core import oos as j_oos
from repro.core import solver as j_solver
from repro.core import topology as j_topology
from repro.core.kernels_math import KernelSpec as JKernelSpec
from repro.core.kernels_math import resolve_gamma as j_resolve_gamma
from repro.data import node_dataset as j_node_dataset
from repro_torch.core import (KernelSpec, RhoSchedule, admm_iteration,
                              admm_step, augmented_lagrangian, build_setup,
                              central_kpca, dense_parts, init_state,
                              local_kpca, neighborhood_kpca, oos,
                              resolve_gamma, ring, run_admm, run_admm_topk,
                              run_chunked, similarity, subspace_alignment,
                              theorem2_rho, topk_eigh)
from repro_torch.core import admm as t_admm
from repro_torch.core import solver as t_solver
from repro_torch.core.convert import setup_from_numpy
from repro_torch.core.topology import reknit
from repro_torch.data import node_dataset

CPU = torch.device("cpu")


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.fixture(scope="module")
def data():
    nodes, pooled = node_dataset(5, 16, m=24, seed=0)
    return nodes, pooled


@pytest.fixture(scope="module")
def setups(data):
    nodes, _ = data
    spec_t, spec_j = KernelSpec(), JKernelSpec()
    return (build_setup(nodes, ring(5, 1), spec_t, device=CPU),
            j_admm.build_setup(jnp.asarray(nodes), j_topology.ring(5, 1),
                               spec_j))


def test_data_and_topology_are_the_jax_packages():
    a, pa = node_dataset(4, 7, m=12, seed=3)
    b, pb = j_node_dataset(4, 7, m=12, seed=3)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pa, pb)
    for got, want in zip(ring(7, 2).neighbor_array(),
                         j_topology.ring(7, 2).neighbor_array()):
        np.testing.assert_array_equal(got, want)
    g_t, s_t = reknit(ring(7, 1), [2, 3])
    g_j, s_j = j_topology.reknit(j_topology.ring(7, 1), [2, 3])
    assert g_t.nbr == g_j.nbr and list(s_t) == list(s_j)


@pytest.mark.parametrize("n", [10, 11, 300])
def test_resolve_gamma_median_matches_jax(n):
    """An even element count (n^2 for even n) exercises the midpoint
    median, which torch.median (lower middle value) would get wrong."""
    x = np.random.default_rng(n).random((n, 8)).astype(np.float32)
    got = float(resolve_gamma(KernelSpec(), torch.as_tensor(x)))
    want = float(j_resolve_gamma(JKernelSpec(), jnp.asarray(x)))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("center", ["global", "neighborhood", "block",
                                    "none"])
def test_build_setup_matches_jax(data, center):
    nodes, _ = data
    got = build_setup(nodes, ring(5, 1), KernelSpec(), center=center,
                      device=CPU)
    want = j_admm.build_setup(jnp.asarray(nodes), j_topology.ring(5, 1),
                              JKernelSpec(), center=center)
    for f in ("kcross", "k", "lam"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=2e-6, err_msg=f)
    for f in ("src", "rsl", "mask"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)))
    assert float(got.gamma) == pytest.approx(float(want.gamma), rel=1e-6)
    # eigenvectors agree up to sign: compare the projectors V V^T
    v_t, v_j = _np(got.vec), np.asarray(want.vec)
    np.testing.assert_allclose(v_t[..., -1:] @ v_t[..., -1:].swapaxes(1, 2),
                               v_j[..., -1:] @ v_j[..., -1:].swapaxes(1, 2),
                               atol=1e-4)


def test_build_setup_without_self_slot(data):
    nodes, _ = data
    got = build_setup(nodes, ring(5, 2), KernelSpec(), include_self=False,
                      device=CPU)
    want = j_admm.build_setup(jnp.asarray(nodes), j_topology.ring(5, 2),
                              JKernelSpec(), include_self=False)
    np.testing.assert_array_equal(_np(got.mask), np.asarray(want.mask))
    np.testing.assert_allclose(_np(got.kcross), np.asarray(want.kcross),
                               rtol=1e-5, atol=2e-6)


def test_kernel_mean_stats_matches_jax(data):
    nodes, _ = data
    g = 0.3
    m_t, mu_t = t_admm.kernel_mean_stats(torch.as_tensor(nodes),
                                         KernelSpec(), torch.tensor(g))
    m_j, mu_j = j_admm.kernel_mean_stats(jnp.asarray(nodes), JKernelSpec(),
                                         jnp.asarray(g))
    np.testing.assert_allclose(_np(m_t), np.asarray(m_j), rtol=1e-6)
    assert float(mu_t) == pytest.approx(float(mu_j), rel=1e-6)


def _shared_inputs(setups):
    """The JAX setup carried into the port, so both sides step from the
    same constants and the same alpha0."""
    _, s_j = setups
    arrays = {f.name: np.asarray(getattr(s_j, f.name))
              for f in dataclasses.fields(s_j) if f.name != "include_self"}
    s_t = setup_from_numpy(arrays, include_self=s_j.include_self,
                           device=CPU)
    alpha0 = np.asarray(j_admm.initial_alpha(s_j, "local"))
    return s_t, s_j, alpha0


@pytest.mark.parametrize("project", ["ball", "sphere", "rescale"])
def test_one_admm_step_matches_jax(setups, project):
    s_t, s_j, alpha0 = _shared_inputs(setups)
    rng = np.random.default_rng(1)
    b0 = rng.normal(size=alpha0.shape + (s_j.n_slots,)).astype(np.float32)
    rho = np.asarray(j_admm._slot_rho(s_j, 100.0, 10.0))
    ops_j, comm_j = j_solver.dense_parts(s_j)
    st_j = dataclasses.replace(j_solver.init_state(jnp.asarray(alpha0),
                                                   s_j.n_slots),
                               b=jnp.asarray(b0))
    new_j, res_j = j_solver.admm_step(ops_j, comm_j, st_j, jnp.asarray(rho),
                                      project)
    ops_t, comm_t = dense_parts(s_t)
    st_t = dataclasses.replace(init_state(torch.as_tensor(alpha0),
                                          s_t.n_slots),
                               b=torch.as_tensor(b0))
    rho_t = t_admm._slot_rho(s_t, 100.0, 10.0)
    np.testing.assert_allclose(_np(rho_t), rho)
    new_t, res_t = admm_step(ops_t, comm_t, st_t, rho_t, project)
    for f in ("alpha", "b", "g", "znorm2"):
        np.testing.assert_allclose(_np(getattr(new_t, f)),
                                   np.asarray(getattr(new_j, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    assert float(res_t) == pytest.approx(float(res_j), rel=1e-4)
    assert new_t.t == int(new_j.t) == 1


def test_admm_step_slot_mask_holds_isolated_nodes(setups):
    s_t, s_j, alpha0 = _shared_inputs(setups)
    mask = np.ones((5, s_j.n_slots), np.float32)
    mask[2, 1:] = 0.0            # node 2 hears nobody but itself
    mask[3, :] = 0.0             # node 3 is isolated outright (no self slot)
    rho = np.asarray(j_admm._slot_rho(s_j, 100.0, 10.0))
    ops_j, comm_j = j_solver.dense_parts(s_j)
    new_j, _ = j_solver.admm_step(
        ops_j, comm_j, j_solver.init_state(jnp.asarray(alpha0), s_j.n_slots),
        jnp.asarray(rho), slot_mask=jnp.asarray(mask))
    ops_t, comm_t = dense_parts(s_t)
    new_t, _ = admm_step(ops_t, comm_t,
                         init_state(torch.as_tensor(alpha0), s_t.n_slots),
                         torch.as_tensor(rho),
                         slot_mask=torch.as_tensor(mask))
    np.testing.assert_allclose(_np(new_t.alpha), np.asarray(new_j.alpha),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(_np(new_t.alpha)[3], alpha0[3])


def test_run_admm_trajectory_matches_jax(setups):
    s_t, s_j, alpha0 = _shared_inputs(setups)
    r_j = j_admm.run_admm(s_j, n_iters=10, alpha0=jnp.asarray(alpha0))
    r_t = run_admm(s_t, n_iters=10, alpha0=torch.as_tensor(alpha0))
    np.testing.assert_allclose(_np(r_t.alpha_hist), np.asarray(r_j.alpha_hist),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(r_t.primal_residual),
                               np.asarray(r_j.primal_residual), rtol=1e-4,
                               atol=1e-4)
    # The Lagrangian falls from about 1e2 through zero here, so the 1e-4
    # relative gate takes an absolute floor where it crosses.
    np.testing.assert_allclose(_np(r_t.lagrangian), np.asarray(r_j.lagrangian),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(_np(r_t.rho_hist), np.asarray(r_j.rho_hist))


def test_port_setup_trajectory_matches_jax(setups):
    """Both packages end to end from their own setups (the port's eigh
    start included) stay within the trajectory tolerance."""
    s_t, s_j = setups
    r_j = j_admm.run_admm(s_j, n_iters=10)
    r_t = run_admm(s_t, n_iters=10)
    np.testing.assert_allclose(_np(r_t.alpha_hist), np.asarray(r_j.alpha_hist),
                               rtol=1e-4, atol=1e-4)


def test_run_chunked_equals_whole_run_and_jax(setups, tmp_path):
    s_t, s_j, alpha0 = _shared_inputs(setups)
    whole = run_admm(s_t, n_iters=7, alpha0=torch.as_tensor(alpha0))
    chunks = list(run_chunked(s_t, n_iters=7, chunk=3,
                              alpha0=torch.as_tensor(alpha0),
                              ckpt_dir=str(tmp_path)))
    assert [c.state.t for c in chunks] == [3, 6, 7]
    hist = torch.cat([c.alpha_hist for c in chunks])
    torch.testing.assert_close(hist, whole.alpha_hist, rtol=0, atol=0)
    j_chunks = list(j_solver.run_chunked(s_j, n_iters=7, chunk=3,
                                         alpha0=jnp.asarray(alpha0)))
    np.testing.assert_allclose(_np(chunks[-1].state.b),
                               np.asarray(j_chunks[-1].state.b),
                               rtol=1e-4, atol=1e-4)
    # the port's checkpoint resumes in the JAX package, and vice versa
    st_j = j_solver.load_state(str(tmp_path))
    assert int(st_j.t) == 7
    np.testing.assert_array_equal(np.asarray(st_j.alpha),
                                  _np(chunks[-1].state.alpha))
    jdir = tmp_path / "jax"
    j_solver.save_state(str(jdir), j_chunks[-1].state)
    st_t = t_solver.load_state(str(jdir), device=CPU)
    assert st_t.t == 7
    np.testing.assert_array_equal(_np(st_t.b),
                                  np.asarray(j_chunks[-1].state.b))


def test_run_chunked_early_stop_and_theorem2(setups):
    s_t, s_j = setups
    assert theorem2_rho(s_t) == pytest.approx(j_admm.theorem2_rho(s_j),
                                              rel=1e-4)
    chunks = list(run_chunked(s_t, n_iters=40, chunk=5, tol=1e9))
    assert len(chunks) == 1 and chunks[0].stopped
    with pytest.raises(ValueError):
        next(run_chunked(s_t, chunk=0))


def test_rho_schedule_matches_jax():
    from repro.core.rho import RhoSchedule as JRho
    for t in range(0, 40, 3):
        assert RhoSchedule().at(t) == float(JRho().at(t))


def test_refresh_policies():
    from repro_torch.core import EveryK, ResidualImprovement
    from repro_torch.core.solver import ChunkResult
    every = EveryK(2)
    assert [every.should_refresh(None) for _ in range(4)] == \
        [False, True, False, True]
    pol = ResidualImprovement(0.5)

    def chunk(r):
        return ChunkResult(None, None, None, torch.tensor([r]), None)

    assert [pol.should_refresh(chunk(r)) for r in (4.0, 3.0, 1.9, 1.5)] == \
        [True, False, True, False]


def test_central_and_similarity_match_jax(data):
    nodes, pooled = data
    spec_t, spec_j = KernelSpec(), JKernelSpec()
    a_t, lam_t, k_t = central_kpca(pooled, spec_t, 2, device=CPU)
    a_j, lam_j, k_j = j_central.central_kpca(jnp.asarray(pooled), spec_j, 2)
    np.testing.assert_allclose(_np(lam_t), np.asarray(lam_j), rtol=1e-5)
    np.testing.assert_allclose(_np(k_t), np.asarray(k_j), atol=2e-6)
    for c in range(2):   # eigenvector sign is arbitrary
        np.testing.assert_allclose(np.abs(_np(a_t[:, c])),
                                   np.abs(np.asarray(a_j[:, c])), atol=1e-4)
    s_t = similarity(torch.as_tensor(np.ones(16, np.float32)),
                     torch.as_tensor(nodes[1]), a_t[:, 0],
                     torch.as_tensor(pooled), spec_t)
    s_j = j_metrics.similarity(jnp.ones(16), jnp.asarray(nodes[1]),
                               jnp.asarray(_np(a_t[:, 0])),
                               jnp.asarray(pooled), spec_j)
    assert float(s_t) == pytest.approx(float(s_j), abs=1e-5)


def test_fitted_checkpoints_cross_load(data, tmp_path):
    nodes, pooled = data
    alpha = np.random.default_rng(2).normal(size=(5, 16)).astype(np.float32)
    m_t = oos.from_decentralized(nodes, alpha, KernelSpec(), device=CPU)
    m_j = j_oos.from_decentralized(jnp.asarray(nodes), jnp.asarray(alpha),
                                   JKernelSpec())
    q = pooled[:7]
    p_j = np.asarray(j_oos.project(m_j, jnp.asarray(q)))
    np.testing.assert_allclose(_np(oos.project(m_t, torch.as_tensor(q))),
                               p_j, rtol=1e-5, atol=1e-5)
    # JAX writes, the port reads — and the other way round
    j_oos.save_fitted(str(tmp_path / "j"), m_j)
    from_j = oos.load_fitted(str(tmp_path / "j"), device=CPU)
    np.testing.assert_allclose(_np(oos.project(from_j, torch.as_tensor(q))),
                               p_j, rtol=1e-5, atol=1e-5)
    oos.save_fitted(str(tmp_path / "t"), m_t)
    from_t = j_oos.load_fitted(str(tmp_path / "t"))
    np.testing.assert_allclose(np.asarray(j_oos.project(from_t,
                                                        jnp.asarray(q))),
                               p_j, rtol=1e-5, atol=1e-5)
    assert from_t.spec == JKernelSpec()


def test_compress_and_refresh_match_jax(data):
    nodes, pooled = data
    alpha = np.random.default_rng(3).normal(size=(5, 16)).astype(np.float32)
    m_t = oos.from_decentralized(nodes, alpha, KernelSpec(), device=CPU)
    m_j = j_oos.from_decentralized(jnp.asarray(nodes), jnp.asarray(alpha),
                                   JKernelSpec())
    c_t, e_t = oos.compress(m_t, 30, seed=1)
    c_j, e_j = j_oos.compress(m_j, 30, seed=1)
    q = pooled[:9]
    np.testing.assert_allclose(_np(oos.project(c_t, torch.as_tensor(q))),
                               np.asarray(j_oos.project(c_j, jnp.asarray(q))),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(_np(e_t), np.asarray(e_j), atol=1e-3)
    new = alpha[::-1].copy()
    r_t = oos.refresh_coefficients(m_t, torch.as_tensor(new))
    r_j = j_oos.refresh_coefficients(m_j, jnp.asarray(new))
    np.testing.assert_allclose(_np(r_t.bias), np.asarray(r_j.bias),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="refreshed"):
        oos.refresh_coefficients(c_t, torch.as_tensor(new))


def test_convert_carries_jax_leaves(data, setups):
    """JAX FittedKpca and AdmmState leaves, as numpy, become the port's
    dataclasses and behave the same."""
    from repro_torch.core.convert import (FITTED_LEAVES, fitted_from_numpy,
                                          state_from_numpy)
    nodes, pooled = data
    alpha = np.random.default_rng(5).normal(size=(5, 16)).astype(np.float32)
    m_j = j_oos.from_decentralized(jnp.asarray(nodes), jnp.asarray(alpha),
                                   JKernelSpec())
    m_t = fitted_from_numpy({k: np.asarray(getattr(m_j, k))
                             for k in FITTED_LEAVES}, KernelSpec(),
                            device=CPU)
    q = pooled[:6]
    np.testing.assert_allclose(_np(oos.project(m_t, torch.as_tensor(q))),
                               np.asarray(j_oos.project(m_j, jnp.asarray(q))),
                               rtol=1e-5, atol=1e-5)
    _, s_j, alpha0 = _shared_inputs(setups)
    st_j = next(j_solver.run_chunked(s_j, n_iters=2, chunk=2,
                                     alpha0=jnp.asarray(alpha0))).state
    st_t = state_from_numpy({f.name: np.asarray(getattr(st_j, f.name))
                             for f in dataclasses.fields(st_j)}, device=CPU)
    assert st_t.t == 2
    np.testing.assert_array_equal(_np(st_t.b), np.asarray(st_j.b))


@pytest.mark.parametrize("project", ["ball", "sphere"])
def test_admm_iteration_matches_jax(setups, project):
    s_t, s_j, alpha0 = _shared_inputs(setups)
    b0 = np.random.default_rng(4).normal(
        size=alpha0.shape + (s_j.n_slots,)).astype(np.float32)
    want = j_admm.admm_iteration(s_j, jnp.asarray(alpha0), jnp.asarray(b0),
                                 100.0, 10.0, project)
    got = admm_iteration(s_t, torch.as_tensor(alpha0), torch.as_tensor(b0),
                         100.0, 10.0, project)
    for name, g_t, w_j in zip(("alpha", "b", "g", "znorm2"), got, want):
        np.testing.assert_allclose(_np(g_t), np.asarray(w_j), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_augmented_lagrangian_matches_jax(setups):
    s_t, s_j, alpha0 = _shared_inputs(setups)
    rng = np.random.default_rng(6)
    b0, g0 = (rng.normal(size=alpha0.shape + (s_j.n_slots,))
              .astype(np.float32) for _ in range(2))
    want = float(j_admm.augmented_lagrangian(
        s_j, jnp.asarray(alpha0), jnp.asarray(b0), jnp.asarray(g0), 100.0,
        10.0))
    got = float(augmented_lagrangian(
        s_t, torch.as_tensor(alpha0), torch.as_tensor(b0),
        torch.as_tensor(g0), 100.0, 10.0))
    assert got == pytest.approx(want, rel=1e-4)


def test_topk_eigh_batched_and_2d():
    from repro.core.kernels_math import topk_eigh as j_topk_eigh
    a = np.random.default_rng(8).normal(size=(3, 7, 7)).astype(np.float32)
    sym = a + a.swapaxes(1, 2)
    lam_b, vec_b = topk_eigh(torch.as_tensor(sym), 2)
    assert lam_b.shape == (3, 2) and vec_b.shape == (3, 7, 2)
    for i in range(3):
        lam, vec = topk_eigh(torch.as_tensor(sym[i]), 2)
        torch.testing.assert_close(lam_b[i], lam, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(vec_b[i].abs(), vec.abs(), rtol=1e-5,
                                   atol=1e-5)
        lam_j, vec_j = j_topk_eigh(jnp.asarray(sym[i]), 2)
        np.testing.assert_allclose(_np(lam), np.asarray(lam_j), rtol=1e-5)
        np.testing.assert_allclose(np.abs(_np(vec)), np.abs(np.asarray(vec_j)),
                                   atol=1e-4)


def _assert_close_up_to_sign(got, want, atol):
    """Columns (last axis) of ``got`` against ``want``, each column's sign
    taken from its largest entry (eigenvector sign is arbitrary)."""
    got, want = _np(got), np.asarray(want)
    flat_g = got.reshape(-1, got.shape[-2], got.shape[-1])
    flat_w = want.reshape(flat_g.shape)
    for g_m, w_m in zip(flat_g, flat_w):
        for c in range(g_m.shape[1]):
            i = int(np.argmax(np.abs(w_m[:, c])))
            sign = np.sign(g_m[i, c]) * np.sign(w_m[i, c])
            np.testing.assert_allclose(sign * g_m[:, c], w_m[:, c], atol=atol)


@pytest.mark.parametrize("gamma", [0.05, None])
def test_local_kpca_matches_jax(data, gamma):
    """Fig. 4's baseline: one kPCA per node (gamma=None: each node's own
    median bandwidth, as under the JAX package's vmap)."""
    nodes, _ = data
    got = local_kpca(nodes, KernelSpec(), 2, gamma=gamma, device=CPU)
    want = j_local.local_kpca(jnp.asarray(nodes), JKernelSpec(), 2,
                              gamma=None if gamma is None
                              else jnp.asarray(gamma))
    assert got.shape == (5, 16, 2)
    _assert_close_up_to_sign(got, want, atol=1e-4)


def test_neighborhood_kpca_matches_jax(data):
    """Fig. 5's baseline: kPCA on each node's neighbourhood data."""
    nodes, _ = data
    got = neighborhood_kpca(nodes, ring(5, 1), KernelSpec(), 2, gamma=0.05,
                            device=CPU)
    want = j_local.neighborhood_kpca(jnp.asarray(nodes), j_topology.ring(5, 1),
                                     JKernelSpec(), 2, gamma=jnp.asarray(0.05))
    assert len(got) == len(want) == 5
    for (a_t, x_t), (a_j, x_j) in zip(got, want):
        np.testing.assert_array_equal(_np(x_t), np.asarray(x_j))
        _assert_close_up_to_sign(a_t, a_j, atol=1e-4)


def test_subspace_alignment_matches_jax(data):
    nodes, pooled = data
    rng = np.random.default_rng(9)
    a_n = rng.normal(size=(16, 2)).astype(np.float32)
    a_p = rng.normal(size=(80, 3)).astype(np.float32)
    got = subspace_alignment(torch.as_tensor(a_n), torch.as_tensor(nodes[2]),
                             torch.as_tensor(a_p), torch.as_tensor(pooled),
                             KernelSpec(), gamma=torch.tensor(0.05))
    want = j_metrics.subspace_alignment(
        jnp.asarray(a_n), jnp.asarray(nodes[2]), jnp.asarray(a_p),
        jnp.asarray(pooled), JKernelSpec(), gamma=jnp.asarray(0.05))
    assert float(got) == pytest.approx(float(want), abs=1e-5)


def _topk_checks(core, nodes, pooled, setup, alphas, alpha_gt, stack, gamma):
    """(first component's mean similarity to central 1, mean alignment of
    the 2-D subspace inside central top-3, second's similarity to central
    1) in one package (``core``: its similarity/subspace_alignment)."""
    j = nodes.shape[0]

    def msim(a, comp):
        return float(np.mean([float(core.similarity(
            a[i], nodes[i], alpha_gt[:, comp], pooled, core.KernelSpec(),
            gamma=gamma)) for i in range(j)]))

    align = float(np.mean([float(core.subspace_alignment(
        stack([alphas[0][i], alphas[1][i]]), nodes[i], alpha_gt[:, :3],
        pooled, core.KernelSpec(), gamma=gamma)) for i in range(j)]))
    return msim(alphas[0], 0), align, msim(alphas[1], 0)


def test_run_admm_topk_matches_jax():
    """Top-2 by deflation on tests/test_deflation.py's fixture, in both
    packages from their own setups: the same similarity, alignment and
    cross-similarity, each inside test_deflation's limits."""
    import repro.core as j_core
    import repro_torch.core as t_core
    nodes, pooled = node_dataset(8, 80, m=32, seed=2)
    s_j = j_admm.build_setup(jnp.asarray(nodes), j_topology.ring(8, 2),
                             JKernelSpec())
    gt_j, _, _ = j_central.central_kpca(jnp.asarray(pooled), JKernelSpec(), 4,
                                        gamma=s_j.gamma)
    want = _topk_checks(j_core, jnp.asarray(nodes), jnp.asarray(pooled), s_j,
                        j_deflation.run_admm_topk(s_j, k=2, n_iters=40), gt_j,
                        lambda a: jnp.stack(a, axis=1), s_j.gamma)
    s_t = build_setup(nodes, ring(8, 2), KernelSpec(), device=CPU)
    gt_t, _, _ = central_kpca(pooled, KernelSpec(), 4, gamma=s_t.gamma,
                              device=CPU)
    alphas = run_admm_topk(s_t, k=2, n_iters=40)
    assert len(alphas) == 2 and alphas[1].shape == (8, 80)
    got = _topk_checks(t_core, torch.as_tensor(nodes),
                       torch.as_tensor(pooled), s_t, alphas, gt_t,
                       lambda a: torch.stack(a, dim=1), s_t.gamma)
    assert got[0] > 0.9 and got[1] > 0.85 and got[2] < 0.5, got
    np.testing.assert_allclose(got, want, atol=5e-3)
    k = s_t.k
    num = torch.einsum("jn,jnm,jm->j", alphas[0], k, alphas[1])
    d1 = torch.einsum("jn,jnm,jm->j", alphas[0], k, alphas[0])
    d2 = torch.einsum("jn,jnm,jm->j", alphas[1], k, alphas[1])
    assert float((num / torch.sqrt(d1 * d2 + 1e-12)).abs().max()) < 0.25


def _paper_report() -> dict:
    """The paper's experiment path at its size, in both packages on the
    CPU, each from its own setup (median bandwidth, global centering,
    30 iterations of the paper's rho schedule)."""
    import time
    import repro.core as j_core
    import repro_torch.core as t_core
    nodes, pooled = node_dataset(20, 100, m=784, seed=0)
    out = {}
    for name, core, make_ring, topk, asarray, stack, kw in (
            ("jax", j_core, j_topology.ring, j_deflation.run_admm_topk,
             jnp.asarray, lambda a: jnp.stack(a, axis=1), {}),
            ("port", t_core, ring, run_admm_topk, torch.as_tensor,
             lambda a: torch.stack(a, dim=1), {"device": CPU})):
        t0 = time.perf_counter()
        spec, graph = core.KernelSpec(), make_ring(20, hops=2)
        setup = core.build_setup(asarray(nodes), graph, spec, **kw)
        x, p = asarray(nodes), asarray(pooled)
        gt, _, _ = core.central_kpca(p, spec, 3, gamma=setup.gamma, **kw)

        def msim(alphas, xs, comp=0):
            return float(np.mean([float(core.similarity(
                alphas[i], xs[i], gt[:, comp], p, spec, gamma=setup.gamma))
                for i in range(len(xs))]))

        admm30 = msim(core.run_admm(setup, n_iters=30).alpha, x)
        loc = core.local_kpca(x, spec, gamma=setup.gamma, **kw)
        nb = core.neighborhood_kpca(x, graph, spec, gamma=setup.gamma, **kw)
        top = topk(setup, k=2, n_iters=30)
        s1, align, cross = _topk_checks(core, x, p, setup, top, gt, stack,
                                        setup.gamma)
        out[name] = dict(
            admm30=admm30, local=msim(loc[..., 0], x),
            neighborhood=msim([a[:, 0] for a, _ in nb], [xc for _, xc in nb]),
            topk_first=s1, topk_alignment=align, topk_second_vs_first=cross,
            seconds=time.perf_counter() - t0)
    return out


if __name__ == "__main__":
    import json
    print(json.dumps(_paper_report(), indent=1))
