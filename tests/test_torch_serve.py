"""The port's serving slice on the CPU: the batched engine against
``oos.project`` and against the JAX package's engine, the whole slice (fit
-> consensus -> package -> checkpoint -> compress -> serve) against the JAX
package on the same seeded numpy inputs, the import boundary (no JAX, no
``repro``), and entry points refusing to run on the CPU unasked.

Tolerances: 1e-6 where one fp32 formula meets itself batched differently;
1e-4 across the packages after ten ADMM iterations (the trajectory gate of
tests/test_torch_core.py), 1e-5 on a single projection.
"""

import ast
import concurrent.futures
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import admm as j_admm
from repro.core import central as j_central
from repro.core import metrics as j_metrics
from repro.core import oos as j_oos
from repro.core import topology as j_topology
from repro.core.kernels_math import KernelSpec as JKernelSpec
from repro.serve import KpcaEngine as JKpcaEngine
from repro.serve import KpcaServeConfig as JKpcaServeConfig
from repro_torch.core import (KernelSpec, build_setup, central_kpca,
                              local_kpca, neighborhood_kpca, oos, ring,
                              run_admm, similarity)
from repro_torch.data import kpca_dataset, node_dataset
from repro_torch.serve import KpcaEngine, KpcaServeConfig, ModelHandle

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SIZES = (3, 17, 1, 40, 9)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.fixture(scope="module")
def fitted():
    nodes, _ = node_dataset(5, 16, m=24, seed=0)
    alpha = np.random.default_rng(4).normal(size=(5, 16)).astype(np.float32)
    return (oos.from_decentralized(nodes, alpha, KernelSpec(), device=CPU),
            j_oos.from_decentralized(jnp.asarray(nodes), jnp.asarray(alpha),
                                     JKernelSpec()))


def _requests(m=24):
    return [kpca_dataset(q, m=m, seed=100 + q) for q in SIZES]


def test_engine_equals_project_per_request(fitted):
    model, _ = fitted
    engine = KpcaEngine(model, KpcaServeConfig(max_batch=16, min_bucket=4),
                        device=CPU)
    reqs = _requests()
    outs = engine.project_many(reqs)
    for req, out in zip(reqs, outs):
        assert out.shape == (req.shape[0], 1)
        want = _np(oos.project(model, torch.as_tensor(req)))
        np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)
    st = engine.stats
    assert (st.n_requests, st.n_queries, st.n_flushes) == (5, 70, 1)
    # 70 rows in 16-row slabs: 4 full slabs and a 6-row tail in an 8 bucket
    assert st.n_padded == 2
    assert [r.model_version for r in st.per_request] == [0] * 5


def test_engine_matches_jax_engine(fitted):
    model, j_model = fitted
    reqs = _requests()
    got = KpcaEngine(model, KpcaServeConfig(max_batch=16, min_bucket=4),
                     device=CPU).project_many(reqs)
    want = JKpcaEngine(j_model, JKpcaServeConfig(max_batch=16, min_bucket=4,
                                                 warmup=False)
                       ).project_many(reqs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)


def test_engine_submit_flush_and_publish(fitted):
    model, _ = fitted
    handle = ModelHandle(model)
    engine = KpcaEngine(handle, KpcaServeConfig(max_batch=8, min_bucket=8),
                        device=CPU)
    reqs = _requests()
    futs = [engine.submit(r) for r in reqs[:2]]
    assert not futs[0].done()
    with pytest.raises(concurrent.futures.TimeoutError):
        futs[0].result(timeout=0.01)
    assert engine.flush().keys() == {f.request_id for f in futs}
    assert all(f.done() for f in futs)
    assert engine.flush() == {}
    refreshed = oos.refresh_coefficients(model, -model.coefs)
    assert handle.publish(refreshed) == 1
    flipped = engine.project_many(reqs[:2])
    for fut, out, req in zip(futs, flipped, reqs):
        np.testing.assert_allclose(
            out, _np(oos.project(refreshed, torch.as_tensor(req))),
            rtol=1e-6, atol=1e-6)
        assert fut.result().shape == out.shape
    assert engine.stats.per_request[-1].model_version == 1
    with pytest.raises(ValueError, match="request must be"):
        engine.submit(np.zeros((2, 5), np.float32))


def test_whole_slice_matches_jax(tmp_path):
    """node data -> setup (global centering) -> Alg. 1 -> similarity to
    central kPCA -> FittedKpca -> checkpoint -> compression -> engine, in
    both packages from the same numpy data, each from its own setup."""
    nodes, pooled = node_dataset(5, 16, m=24, seed=0)
    spec_t, spec_j = KernelSpec(), JKernelSpec()
    s_t = build_setup(nodes, ring(5, 1), spec_t, device=CPU)
    s_j = j_admm.build_setup(jnp.asarray(nodes), j_topology.ring(5, 1),
                             spec_j)
    r_t = run_admm(s_t, n_iters=10)
    r_j = j_admm.run_admm(s_j, n_iters=10)
    np.testing.assert_allclose(_np(r_t.alpha), np.asarray(r_j.alpha),
                               rtol=1e-4, atol=1e-4)
    a_t, _, _ = central_kpca(pooled, spec_t, 1, gamma=s_t.gamma, device=CPU)
    a_j, _, _ = j_central.central_kpca(jnp.asarray(pooled), spec_j, 1,
                                       gamma=s_j.gamma)
    got = float(similarity(r_t.alpha[4], s_t.x[4], a_t[:, 0],
                           torch.as_tensor(pooled), spec_t, gamma=s_t.gamma))
    want = float(j_metrics.similarity(r_j.alpha[4], s_j.x[4], a_j[:, 0],
                                      jnp.asarray(pooled), spec_j,
                                      gamma=s_j.gamma))
    assert got == pytest.approx(want, abs=1e-4)

    m_t = oos.from_decentralized(nodes, r_t.alpha, spec_t, gamma=s_t.gamma,
                                 device=CPU)
    m_j = j_oos.from_decentralized(jnp.asarray(nodes), r_j.alpha, spec_j,
                                   gamma=s_j.gamma)
    oos.save_fitted(str(tmp_path), m_t)
    loaded = oos.load_fitted(str(tmp_path), device=CPU)
    c_t, e_t = oos.compress(loaded, 40, seed=0)
    c_j, e_j = j_oos.compress(m_j, 40, seed=0)
    np.testing.assert_allclose(_np(e_t), np.asarray(e_j), atol=1e-3)
    reqs = _requests()
    for t_model, j_model in ((loaded, m_j), (c_t, c_j)):
        got = KpcaEngine(t_model, KpcaServeConfig(max_batch=16, min_bucket=4),
                         device=CPU).project_many(reqs)
        want = np.asarray(j_oos.project(j_model,
                                        jnp.asarray(np.concatenate(reqs))))
        np.testing.assert_allclose(np.concatenate(got), want, rtol=1e-3,
                                   atol=1e-4)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("root", ["src/repro_torch", "chip_smoke.py"])
def test_port_sources_import_neither_jax_nor_repro(root):
    paths = [ROOT / root] if root.endswith(".py") \
        else sorted((ROOT / root).rglob("*.py"))
    assert paths
    for path in paths:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_port_imports_with_jax_blocked():
    """Every module of the port (and chip_smoke.py) imports in a process
    where ``import jax`` fails, and none of them pulls in ``repro``."""
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "repro")
       and sys.modules[k] is not None]
assert not bad, bad
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


@pytest.mark.parametrize("entry", ["build_setup", "central_kpca",
                                   "fit_central", "from_dual",
                                   "from_decentralized", "load_fitted",
                                   "engine", "local_kpca",
                                   "neighborhood_kpca"])
def test_entry_points_refuse_to_run_without_a_card(entry, monkeypatch,
                                                   fitted, tmp_path):
    """With no CUDA device and no explicit device="cpu", an entry point
    raises instead of quietly running on the CPU."""
    oos.save_fitted(str(tmp_path), fitted[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nodes, pooled = node_dataset(3, 4, m=6, seed=0)
    spec = KernelSpec()
    calls = {
        "build_setup": lambda: build_setup(nodes, ring(3, 1), spec),
        "central_kpca": lambda: central_kpca(pooled, spec),
        "fit_central": lambda: oos.fit_central(pooled, spec),
        "from_dual": lambda: oos.from_dual(pooled, np.ones(12), spec),
        "from_decentralized": lambda: oos.from_decentralized(
            nodes, np.ones((3, 4)), spec),
        "load_fitted": lambda: oos.load_fitted(str(tmp_path)),
        "engine": lambda: KpcaEngine(fitted[0]),
        "local_kpca": lambda: local_kpca(nodes, spec),
        "neighborhood_kpca": lambda: neighborhood_kpca(nodes, ring(3, 1),
                                                       spec),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(alone, tmp_path):
    """chip_smoke.py exits non-zero with no ok line where torch sees no
    card, from the checkout and copied alone into an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the smoke would run")
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("sizes,max_batch,min_bucket",
                         [((3, 17, 1, 40, 9), 16, 4), ((128, 200), 128, 8),
                          ((0, 5, 0), 8, 8)])
def test_batching_matches_jax(sizes, max_batch, min_bucket):
    """Buckets and head-to-tail slabs are the JAX package's
    (``iter_slabs``); ``pack_slabs``'s slabs and plan are the JAX
    package's, and the plan re-assembles every request."""
    from repro.serve import batching as j_batching
    from repro_torch.serve import batching
    buckets = batching.pow2_buckets(min_bucket, max_batch)
    assert buckets == j_batching.pow2_buckets(min_bucket, max_batch)
    assert [batching.bucket_for(buckets, q) for q in range(1, 300, 7)] == \
        [j_batching.bucket_for(buckets, q) for q in range(1, 300, 7)]
    reqs = [np.full((q, 3), i, np.float32) for i, q in enumerate(sizes)]
    mine = [batching.Request(i, r, len(r), None, 0.0)
            for i, r in enumerate(reqs)]
    theirs = [j_batching.Request(i, r, len(r), None, 0.0)
              for i, r in enumerate(reqs)]
    for (s_t, k_t, o_t), (s_j, k_j, o_j) in zip(
            batching.iter_slabs(mine, max_batch, buckets),
            j_batching.iter_slabs(theirs, max_batch, buckets)):
        np.testing.assert_array_equal(s_t, s_j)
        assert k_t == k_j
        np.testing.assert_array_equal(o_t, o_j)
    slabs, plan, frames = batching.pack_slabs(mine, max_batch, buckets)
    j_slabs, j_plan, _ = j_batching.pack_slabs(theirs, max_batch, buckets,
                                               None)
    assert plan == j_plan and not frames
    for (s_t, k_t, z_t), (s_j, k_j, z_j) in zip(slabs, j_slabs):
        np.testing.assert_array_equal(s_t, s_j)
        assert (k_t, z_t) == (k_j, z_j)
    for e, segs in zip(mine, plan):
        rows = [slabs[si][0][row:row + m] for si, row, _off, m in segs]
        got = np.concatenate(rows) if rows else np.zeros((0, 3), np.float32)
        np.testing.assert_array_equal(got, e.payload)


def test_kpca_project_matches_jax():
    from repro_torch.core import kpca_project
    nodes, pooled = node_dataset(3, 10, m=12, seed=2)
    alpha = np.random.default_rng(6).normal(size=30).astype(np.float32)
    q = kpca_dataset(7, m=12, seed=9)
    got = kpca_project(torch.as_tensor(q), torch.as_tensor(pooled),
                       torch.as_tensor(alpha), KernelSpec())
    want = j_central.kpca_project(jnp.asarray(q), jnp.asarray(pooled),
                                  jnp.asarray(alpha), JKernelSpec())
    assert got.shape == (7,)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
