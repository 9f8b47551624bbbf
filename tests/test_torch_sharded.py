"""The port's sharded serving on the CPU, against the JAX package on the same
seeded numpy inputs (a 90 x 12 support set, C = 3, as in
tests/test_sharded_serving.py; a 48 x 10 one, C = 2, as in
tests/test_publisher.py): the sharded artifact (``shard_fitted``, per-shard
compression, ``finalize_partial_scores``, refresh, ``drop_shard``,
``gather_fitted``, checkpoints across the packages, the converter), the
partial projector, the router's policies and placement cache over lists of
CPU devices (the JAX package runs on conftest's 4 host devices), and the
engine on a sharded model.

Tolerances: 3e-4 for sharded scores against the unsharded projection (the
reference's own, tests/test_sharded_serving.py); 1e-5 for the refresh,
drop and gather paths (tests/test_publisher.py's); 2e-5 for the partial
kernel (the project kernel's gate); exact for layout and checkpoints.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.lockcheck import _ThreadingShim
from repro.core import oos as j_oos
from repro.core.kernels_math import KernelSpec as JKernelSpec
from repro.kernels.project import project_partial_op as j_partial_op
from repro.launch.mesh import make_serving_mesh as j_make_serving_mesh
from repro.serve import KpcaEngine as JKpcaEngine
from repro.serve import KpcaServeConfig as JKpcaServeConfig
from repro.serve.sharded import CrossoverTable as JCrossoverTable
from repro.serve.sharded import project_sharded as j_project_sharded
from repro_torch.core import KernelSpec, oos
from repro_torch.core.convert import (FITTED_LEAVES, SHARDED_LEAVES,
                                      fitted_from_numpy, sharded_from_numpy)
from repro_torch.kernels import partial_projector, project_partial_op
from repro_torch.launch import make_serving_mesh
from repro_torch.serve import (POLICIES, CrossoverTable, KpcaEngine,
                               KpcaServeConfig, ModelHandle, ShardedRouter,
                               measure_crossover, place_sharded_model,
                               project_sharded)

pytestmark = pytest.mark.lockcheck

CPU = torch.device("cpu")
N, M, C = 90, 12, 3
PORT_SERVE_MODULES = ("repro_torch.serve.batching",
                      "repro_torch.serve.kpca_engine",
                      "repro_torch.serve.publisher",
                      "repro_torch.serve.sharded")


@pytest.fixture(autouse=True)
def port_lock_order(lock_order_guard):
    """The lockcheck guard instruments the JAX package's serve modules;
    the same graph instruments the port's here."""
    if lock_order_guard is None:
        yield
        return
    mods = [importlib.import_module(n) for n in PORT_SERVE_MODULES]
    saved = [(m, m.threading) for m in mods]
    shim = _ThreadingShim(lock_order_guard)
    for m in mods:
        m.threading = shim
    try:
        yield
    finally:
        for m, orig in saved:
            m.threading = orig


def _rand(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _spec(j_spec):
    return KernelSpec(**dataclasses.asdict(j_spec))


def _carried(j_model):
    """A JAX FittedKpca's weights carried across to the port."""
    return fitted_from_numpy(
        {k: None if getattr(j_model, k) is None
         else np.asarray(getattr(j_model, k)) for k in FITTED_LEAVES},
        _spec(j_model.spec), CPU)


def _carried_sharded(j_sh):
    return sharded_from_numpy(
        {k: None if getattr(j_sh, k) is None
         else np.asarray(getattr(j_sh, k)) for k in SHARDED_LEAVES},
        _spec(j_sh.spec), j_sh.n_support, j_sh.shard_sizes, CPU)


def _cpus(n):
    return [CPU] * n


@pytest.fixture(scope="module")
def models():
    j_model = j_oos.fit_central(jnp.asarray(_rand((N, M), seed=0)),
                                JKernelSpec(kind="rbf", gamma=0.25),
                                n_components=C, center=True)
    return _carried(j_model), j_model


@pytest.fixture(scope="module")
def queries():
    return _rand((17, M), seed=1)


# ---- the sharded artifact -------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shard_fitted_layout_matches_jax(models, n_shards):
    """Uncompressed sharding: the same padded layout, indicator column,
    centering terms and kernel-mean slices as the JAX package (N = 90 over
    4 shards is uneven: 23/23/22/22)."""
    sh, err = oos.shard_fitted(models[0], n_shards)
    j_sh, j_err = j_oos.shard_fitted(models[1], n_shards)
    assert sh.shard_sizes == j_sh.shard_sizes
    assert sh.n_support == j_sh.n_support == N
    for k in SHARDED_LEAVES:
        np.testing.assert_array_equal(_np(getattr(sh, k)),
                                      np.asarray(getattr(j_sh, k)))
    assert not _np(err).any() and not np.asarray(j_err).any()


@pytest.mark.parametrize("n_shards,budget", [(2, 16), (4, 8), (3, N)])
def test_shard_fitted_compressed_matches_jax(models, queries, n_shards,
                                             budget):
    """Per-shard landmark compression (through gram): the same landmarks
    and the same error bound as the JAX package (1e-3, as ``compress``'s
    parity test), and the same served scores (3e-4)."""
    sh, err = oos.shard_fitted(models[0], n_shards,
                               landmarks_per_shard=budget)
    j_sh, j_err = j_oos.shard_fitted(models[1], n_shards,
                                     landmarks_per_shard=budget)
    assert sh.shard_sizes == j_sh.shard_sizes
    np.testing.assert_array_equal(_np(sh.x_support),
                                  np.asarray(j_sh.x_support))
    np.testing.assert_allclose(_np(err), np.asarray(j_err), atol=1e-3)
    assert not _np(sh.row_mean_coef).any() and sh.k_row_mean is None
    got = project_sharded(sh, torch.as_tensor(queries), policy="single")
    want = j_project_sharded(j_sh, jnp.asarray(queries), mesh=None,
                             policy="single")
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=3e-4,
                               atol=3e-4)


def test_finalize_partial_scores_matches_jax():
    parts, rmc, bias = _rand((9, C + 1), 3), _rand((C,), 4), _rand((C,), 5)
    got = oos.finalize_partial_scores(torch.as_tensor(parts),
                                      torch.as_tensor(rmc),
                                      torch.as_tensor(bias), 77)
    want = j_oos.finalize_partial_scores(jnp.asarray(parts),
                                         jnp.asarray(rmc), jnp.asarray(bias),
                                         77)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("policy", POLICIES)
def test_project_sharded_matches_jax(models, queries, n_shards, policy):
    """Every policy over n_shards CPU devices against the JAX package on
    its host-device mesh and against the unsharded projection (3e-4). dp
    needs the rows to divide: 17 rows degrade to mp, as in the JAX
    package."""
    sh, _ = oos.shard_fitted(models[0], n_shards)
    j_sh, _ = j_oos.shard_fitted(models[1], n_shards)
    q = queries[:16] if policy == "dp" else queries
    got = project_sharded(sh, torch.as_tensor(q), devices=_cpus(n_shards),
                          policy=policy)
    want = j_project_sharded(j_sh, jnp.asarray(q),
                             mesh=j_make_serving_mesh(n_shards),
                             policy=policy)
    plain = oos.project(models[0], torch.as_tensor(q))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(_np(got), _np(plain), rtol=3e-4, atol=3e-4)


def test_dp_indivisible_rows_and_no_mesh_degrade(models, queries):
    sh, _ = oos.shard_fitted(models[0], 4)
    plain = _np(oos.project(models[0], torch.as_tensor(queries)))
    for devices, policy in ((_cpus(4), "dp"), (None, "mp"), (None, "dp")):
        got = project_sharded(sh, torch.as_tensor(queries), devices=devices,
                              policy=policy)
        np.testing.assert_allclose(_np(got), plain, rtol=3e-4, atol=3e-4)
    with pytest.raises(ValueError):
        project_sharded(sh, torch.as_tensor(queries), policy="bogus")


@pytest.fixture(scope="module")
def pub_models():
    j_model = j_oos.fit_central(jnp.asarray(_rand((48, 10), seed=0)),
                                JKernelSpec(kind="rbf", gamma=0.25),
                                n_components=2, center=True)
    j_sh = j_oos.shard_fitted(j_model, 3)[0]
    return oos.shard_fitted(_carried(j_model), 3)[0], j_sh


def _same_served(got, want, xq, atol=1e-5):
    np.testing.assert_allclose(
        _np(project_sharded(got, torch.as_tensor(xq), policy="single")),
        np.asarray(j_project_sharded(want, jnp.asarray(xq), mesh=None,
                                     policy="single")),
        rtol=atol, atol=atol)


@pytest.mark.parametrize("case", ["refresh_all", "refresh_one",
                                  "drop", "drop_twice", "gather"])
def test_refresh_drop_gather_match_jax(pub_models, case):
    """The publisher-side edits of a sharded model, in both packages from
    the same coefficients: the same centering terms and layout, the same
    served scores (1e-5)."""
    sh, j_sh = pub_models
    xq = _rand((7, 10), seed=21)
    if case == "refresh_all":
        a = _rand((48, 2), seed=20)
        got = oos.refresh_coefficients(sh, a)
        want = j_oos.refresh_coefficients(j_sh, jnp.asarray(a))
    elif case == "refresh_one":
        a = _rand((sh.shard_sizes[1], 2), seed=26)
        got = oos.refresh_shard_coefficients(sh, 1, a)
        want = j_oos.refresh_shard_coefficients(j_sh, 1, jnp.asarray(a))
        np.testing.assert_array_equal(_np(got.coefs_ext[0]),
                                      _np(sh.coefs_ext[0]))
    elif case in ("drop", "drop_twice"):
        got, want = oos.drop_shard(sh, 1), j_oos.drop_shard(j_sh, 1)
        if case == "drop_twice":
            assert oos.drop_shard(got, 1) is got
        assert got.shard_sizes == want.shard_sizes
        assert got.n_support == want.n_support == 32
    else:
        g, jg = oos.gather_fitted(sh), j_oos.gather_fitted(j_sh)
        for k in FITTED_LEAVES:
            np.testing.assert_allclose(_np(getattr(g, k)),
                                       np.asarray(getattr(jg, k)),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            _np(oos.project(g, torch.as_tensor(xq))),
            np.asarray(j_oos.project(jg, jnp.asarray(xq))),
            rtol=1e-5, atol=1e-5)
        return
    for k in ("row_mean_coef", "bias", "coefs_ext"):
        np.testing.assert_allclose(_np(getattr(got, k)),
                                   np.asarray(getattr(want, k)),
                                   rtol=1e-5, atol=1e-5)
    _same_served(got, want, xq)


@pytest.mark.parametrize("case", ["bad_shard", "bad_rows", "compressed",
                                  "last_shard"])
def test_sharded_edits_validate(pub_models, case):
    sh, _ = pub_models
    with pytest.raises(ValueError):
        if case == "bad_shard":
            oos.refresh_shard_coefficients(sh, 7, np.ones((16, 2)))
        elif case == "bad_rows":
            oos.refresh_shard_coefficients(sh, 0, np.ones((5, 2)))
        elif case == "compressed":
            csh, _ = oos.shard_fitted(oos.gather_fitted(sh), 2,
                                      landmarks_per_shard=8)
            oos.refresh_coefficients(csh, np.ones((csh.n_support, 2)))
        else:
            oos.drop_shard(oos.drop_shard(oos.drop_shard(sh, 0), 1), 2)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_sharded_checkpoint_crosses_packages(pub_models, writer, tmp_path):
    """A sharded checkpoint written by one package loads in the other,
    exactly, and serves the same scores."""
    sh, j_sh = pub_models
    if writer == "torch":
        oos.save_sharded(str(tmp_path), sh)
        back = j_oos.load_sharded(str(tmp_path))
        src, dst = sh, back
    else:
        j_oos.save_sharded(str(tmp_path), j_sh)
        back = oos.load_sharded(str(tmp_path), device=CPU)
        src, dst = j_sh, back
    assert dst.shard_sizes == src.shard_sizes
    assert dst.n_support == src.n_support
    assert dataclasses.asdict(dst.spec) == dataclasses.asdict(src.spec)
    for k in SHARDED_LEAVES:
        np.testing.assert_array_equal(_np(getattr(dst, k)),
                                      _np(getattr(src, k)))
    with pytest.raises(ValueError):
        (oos.load_fitted if writer == "jax" else j_oos.load_fitted)(
            str(tmp_path))


def test_convert_sharded_artifact(pub_models):
    """``sharded_from_numpy`` of the JAX artifact's leaves is the port's
    own ``shard_fitted`` of the same model, field for field."""
    sh, j_sh = pub_models
    conv = _carried_sharded(j_sh)
    assert (conv.shard_sizes, conv.n_support) == (sh.shard_sizes,
                                                  sh.n_support)
    for k in SHARDED_LEAVES:
        np.testing.assert_array_equal(_np(getattr(conv, k)),
                                      _np(getattr(sh, k)))
    moved = conv.to(CPU)
    assert moved.device == CPU and moved.n_shards == 3


# ---- the partial projector ------------------------------------------------

@pytest.mark.parametrize("kind", ["rbf", "linear", "poly"])
def test_partial_projector_matches_jax_kernel(kind):
    """The per-shard partial projector against the JAX package's partial
    kernel in interpret mode (2e-5), with padding rows in the indicator;
    bf16 queries widen to exactly the fp32 result of their rounded
    values."""
    j_spec = {"rbf": JKernelSpec(kind="rbf", gamma=0.3),
              "linear": JKernelSpec(kind="linear"),
              "poly": JKernelSpec(kind="poly", degree=2, scale=0.1)}[kind]
    spec = _spec(j_spec)
    xs, xq = _rand((40, 12), 6) / 3, _rand((9, 12), 7) / 3
    ext = np.concatenate([_rand((40, 2), 8), np.ones((40, 1), np.float32)],
                         axis=1)
    ext[33:, -1] = 0.0
    fn = partial_projector(spec, torch.as_tensor(xs), torch.as_tensor(ext))
    got = fn(torch.as_tensor(xq))
    want = j_partial_op(j_spec, jnp.asarray(xq), jnp.asarray(xs),
                        jnp.asarray(ext), interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_array_equal(
        _np(got), _np(project_partial_op(spec, torch.as_tensor(xq),
                                         torch.as_tensor(xs),
                                         torch.as_tensor(ext))))
    xb = torch.as_tensor(xq).bfloat16()
    np.testing.assert_array_equal(_np(fn(xb)), _np(fn(xb.float())))


# ---- routing --------------------------------------------------------------

@pytest.mark.parametrize("rows,support,shards,mesh", [
    (4096, 4096, 4, False), (4096, 4096, 1, True), (64, 512, 4, True),
    (256, 4096, 4, True), (4096, 4096, 4, True), (4097, 4096, 4, True),
    (9, 512, 4, True)])
def test_crossover_table_matches_jax(rows, support, shards, mesh):
    for ours, theirs in ((CrossoverTable(), JCrossoverTable()),
                         (CrossoverTable(table={(256, 4096): "dp",
                                                (16, 512): "dp"}),
                          JCrossoverTable(table={(256, 4096): "dp",
                                                 (16, 512): "dp"}))):
        assert ours.choose(rows, support, shards, has_mesh=mesh) == \
            theirs.choose(rows, support, shards, has_mesh=mesh)


def test_serving_mesh(monkeypatch):
    """The first n CUDA devices, or None when the host has fewer; never a
    list of CPU devices."""
    assert make_serving_mesh(1) is None or torch.cuda.is_available()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_serving_mesh(2) == [torch.device("cuda", 0),
                                    torch.device("cuda", 1)]
    assert make_serving_mesh(4) is None
    with pytest.raises(ValueError):
        make_serving_mesh(0)


def test_router_refuses_a_mesh_off_the_card():
    """On the card a shard placed on a non-CUDA device raises; so does a
    CPU engine given CUDA devices."""
    with pytest.raises(ValueError, match="all be CUDA"):
        ShardedRouter([torch.device("cuda", 0), CPU],
                      home=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="all be CUDA"):
        ShardedRouter([torch.device("cuda", 0)], home=CPU)
    with pytest.raises(ValueError):
        ShardedRouter(_cpus(2), policy="fastest")


def test_placement_paid_once_per_version_and_group(models):
    sh, _ = oos.shard_fitted(models[0], 4)
    router = ShardedRouter(_cpus(4))
    xq = torch.as_tensor(_rand((8, M), seed=2))
    router.dispatch(sh, 0, xq, "mp")
    router.dispatch(sh, 0, xq, "mp")
    assert (router.n_placements, router.n_placement_hits) == (1, 1)
    router.dispatch(sh, 0, xq, "dp")
    router.dispatch(sh, 0, xq, "single")
    assert router.n_placements == 3
    router.dispatch(sh, 1, xq, "mp")                  # a new version
    assert router.n_placements == 4
    placed = place_sharded_model(sh, _cpus(2))
    assert [len(p.shards) for p in placed] == [2, 2]
    assert [len(p.shards) for p in place_sharded_model(
        oos.drop_shard(sh, 0), _cpus(2), replicate=True)] == [3, 3]


@pytest.mark.parametrize("routing", ["auto", "mp", "dp", "single"])
def test_engine_routing_parity(models, routing):
    """The port's engine on a 4-shard model over 4 CPU devices, each
    routing, against the JAX engine on the unsharded model (3e-4); the
    forced policy is the one taken, and the router's placement was paid
    once across drains."""
    sh, _ = oos.shard_fitted(models[0], 4)
    reqs = [_rand((q, M), seed=10 + q) for q in (3, 11, 26, 32)]
    want = JKpcaEngine(models[1], JKpcaServeConfig(
        max_batch=32, min_bucket=8, warmup=False)).project_many(reqs)
    eng = KpcaEngine(sh, KpcaServeConfig(max_batch=32, min_bucket=8,
                                         routing=routing),
                     device=CPU, mesh=_cpus(4))
    for _ in range(2):
        got = eng.project_many(reqs)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=3e-4,
                                       atol=3e-4)
    if routing != "auto":
        for p in POLICIES:
            n = getattr(eng.stats, f"n_routed_{p}")
            assert (n > 0) == (p == routing), eng.stats.routing_summary()
    assert eng.router.n_placements == 1
    assert eng.router.n_placement_hits > 0


@pytest.mark.parametrize("routing", ["auto", "mp", "dp"])
def test_warmup_covers_sharded_policies(models, routing):
    sh, _ = oos.shard_fitted(models[0], 4)
    eng = KpcaEngine(sh, KpcaServeConfig(max_batch=32, min_bucket=8,
                                         routing=routing),
                     device=CPU, mesh=_cpus(4))
    assert eng.warmup() == 3
    eng.start()
    try:
        futs = [eng.submit(_rand((q, M), seed=q)) for q in (5, 16, 32)]
        for f in futs:
            f.result(timeout=30.0)
    finally:
        eng.close()
    assert eng.stats.n_compiles == 0
    assert eng.router.n_placements == 1


def test_engine_refuses_mesh_or_routing_for_a_plain_model(models):
    with pytest.raises(ValueError):
        KpcaEngine(models[0], device=CPU, mesh=_cpus(2))
    with pytest.raises(ValueError):
        KpcaEngine(models[0], KpcaServeConfig(routing="mp"), device=CPU)


def test_handle_pins_kind_and_shard_count(pub_models):
    sh, _ = pub_models
    h = ModelHandle(sh)
    with pytest.raises(ValueError):
        h.publish(oos.shard_fitted(oos.gather_fitted(sh), 2)[0])
    with pytest.raises(TypeError):
        h.publish(oos.gather_fitted(sh))
    assert h.refresh(np.ones((48, 2), np.float32)) == 1
    assert h.refresh_shard(0, np.ones((16, 2), np.float32)) == 2


def test_measure_crossover_feasible_policies(models):
    sh, _ = oos.shard_fitted(models[0], 4)
    t = measure_crossover(sh, devices=_cpus(4), row_buckets=(8, 16), reps=1)
    assert set(t.table) == {(8, 128), (16, 128)}
    assert all(p in POLICIES for p in t.table.values())
    t1 = measure_crossover(sh, devices=None, row_buckets=(8,), reps=1)
    assert t1.table == {(8, 128): "single"}
