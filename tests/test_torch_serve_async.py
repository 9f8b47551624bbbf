"""The port's asynchronous serving stack on the CPU, against the JAX
package's on the same seeded numpy inputs (48 x 12 support, C = 2, as in
tests/test_async_engine.py): the background flusher and its triggers,
admission control, deadlines and retries with the fault hooks, warmup, the
staging arena, bf16 query slabs, the publisher glue, and the batching
pieces themselves.

Tolerances: bitwise where one engine meets itself on the same slab shapes
(async vs sync on aligned slabs); 1e-6 against the port's own unbatched
projection; 1e-5 against the JAX package (2e-5 for bf16 slabs, the
project kernel's gate). Every test runs under the ``lockcheck`` marker:
the JAX package's serve locks and the port's are instrumented and a
recorded lock-order cycle fails the test.
"""

import concurrent.futures
import dataclasses
import importlib
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.lockcheck import _ThreadingShim
from repro.core import oos as j_oos
from repro.core import solver as j_solver
from repro.core.kernels_math import KernelSpec as JKernelSpec
from repro.serve import KpcaEngine as JKpcaEngine
from repro.serve import KpcaServeConfig as JKpcaServeConfig
from repro.serve import batching as j_batching
from repro_torch.core import KernelSpec, build_setup, oos, ring, solver
from repro_torch.core.convert import FITTED_LEAVES, fitted_from_numpy
from repro_torch.data import node_dataset
from repro_torch.faults import DeadlineExceededError, ShardLostError
from repro_torch.obs import metrics
from repro_torch.serve import (BackgroundPublisher, KpcaEngine,
                               KpcaServeConfig, ModelHandle, QueueFullError,
                               ShedError, batching, project_sharded,
                               stream_chunks)

pytestmark = pytest.mark.lockcheck

CPU = torch.device("cpu")
WAIT = 30.0
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


def _carried(j_model):
    """The JAX model's weights carried across (eigenvector signs are the
    solver's choice, so both packages serve the same model this way)."""
    return fitted_from_numpy(
        {k: None if getattr(j_model, k) is None
         else np.asarray(getattr(j_model, k)) for k in FITTED_LEAVES},
        KernelSpec(**dataclasses.asdict(j_model.spec)), CPU)


@pytest.fixture(scope="module")
def models():
    j_model = j_oos.fit_central(jnp.asarray(_rand((48, 12), seed=0)),
                                JKernelSpec(kind="rbf", gamma=0.25),
                                n_components=2, center=True)
    return _carried(j_model), j_model


@pytest.fixture
def engine(models):
    """Engine factory that closes every engine it made."""
    made = []

    def make(cfg, **kw):
        eng = KpcaEngine(kw.pop("model", models[0]), cfg, device=CPU, **kw)
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.close(drain=False)


def _project(model, x):
    return oos.project(model, torch.as_tensor(x)).numpy()


def _submit_from_threads(eng, reqs, n_threads):
    futs = [None] * len(reqs)

    def submitter(idx):
        for i in idx:
            futs[i] = eng.submit(reqs[i])

    threads = [threading.Thread(target=submitter,
                                args=(range(t, len(reqs), n_threads),))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    return futs


def test_async_bitwise_vs_sync_and_matches_jax(models, engine):
    """Aligned requests (one full slab each) from three submitter threads:
    the flusher's scores are bitwise the synchronous engine's on each
    request alone, and within 1e-5 of the JAX engine's."""
    cfg = KpcaServeConfig(max_batch=16, min_bucket=16, flush_max_wait_s=0.002)
    eng = engine(cfg).start()
    sync = engine(cfg)
    reqs = [_rand((16, 12), seed=100 + i) for i in range(12)]
    futs = _submit_from_threads(eng, reqs, 3)
    got = [f.result(timeout=WAIT) for f in futs]
    want_j = JKpcaEngine(models[1], JKpcaServeConfig(
        max_batch=16, min_bucket=16, warmup=False)).project_many(reqs)
    for r, g, wj in zip(reqs, got, want_j):
        np.testing.assert_array_equal(g, sync.project_many([r])[0])
        np.testing.assert_allclose(g, np.asarray(wj), rtol=1e-5, atol=1e-5)
    assert eng.stats.n_compiles == 0 and eng.stats.n_requests == 12


def test_mixed_sizes_concurrent_vs_oracle(models, engine):
    eng = engine(KpcaServeConfig(max_batch=16, min_bucket=4,
                                 flush_max_wait_s=0.002)).start()
    sizes = [1, 3, 5, 17, 31, 33, 2, 8, 0]
    reqs = [_rand((q, 12), seed=200 + q) for q in sizes]
    futs = _submit_from_threads(eng, reqs, len(reqs))
    for r, f in zip(reqs, futs):
        out = f.result(timeout=WAIT)
        assert out.shape == (r.shape[0], 2)
        np.testing.assert_allclose(out, _project(models[0], r), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(
            out, np.asarray(j_oos.project(models[1], jnp.asarray(r))),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("trigger", ["deadline", "size", "eager"])
def test_flush_triggers(engine, trigger):
    """deadline: a lone small request flushes within flush_max_wait_s;
    size: a full slab flushes at once under a 60 s deadline; eager: an
    idle flusher drains any queued work at once (same 60 s deadline)."""
    cfg = {"deadline": KpcaServeConfig(max_batch=128, min_bucket=8,
                                       flush_max_wait_s=0.01,
                                       flush_eager=False),
           "size": KpcaServeConfig(max_batch=8, min_bucket=8,
                                   flush_max_wait_s=60.0, flush_eager=False),
           "eager": KpcaServeConfig(max_batch=128, min_bucket=8,
                                    flush_max_wait_s=60.0)}[trigger]
    eng = engine(cfg).start()
    rows = 4 if trigger == "size" else 3
    futs = [eng.submit(_rand((rows, 12), seed=2 + i))
            for i in range(2 if trigger == "size" else 1)]
    for f in futs:
        assert f.result(timeout=WAIT).shape == (rows, 2)
    assert eng.stats.per_request[-1].queue_wait_s < WAIT


@pytest.mark.parametrize("case", ["reject", "shed", "oversize"])
def test_admission_matches_jax(models, case):
    """The same submit sequence through both packages' engines: the same
    refusals, the same shed futures, the same counters."""
    policy = "reject" if case == "reject" else "shed"
    factor = 2 if case == "reject" else 1
    sizes = {"reject": (10, 6, 1), "shed": (6, 5), "oversize": (2, 9)}[case]
    outcomes = []
    for eng in (KpcaEngine(models[0], KpcaServeConfig(
            max_batch=8, min_bucket=8, queue_factor=factor,
            admission=policy), device=CPU),
            JKpcaEngine(models[1], JKpcaServeConfig(
                max_batch=8, min_bucket=8, queue_factor=factor,
                admission=policy, warmup=False))):
        err = {KpcaEngine: (QueueFullError, ShedError),
               JKpcaEngine: (j_batching.QueueFullError,
                             j_batching.ShedError)}[type(eng)]
        futs, refused = [], []
        for i, q in enumerate(sizes):
            try:
                futs.append(eng.submit(_rand((q, 12), seed=8 + i)))
            except err[0]:
                refused.append(i)
        eng.flush()
        shed = []
        for i, f in enumerate(futs):
            try:
                f.result(timeout=0)
            except err[1]:
                shed.append(i)
        outcomes.append((refused, shed, eng.stats.n_rejected,
                         eng.stats.n_shed, eng.stats.n_requests))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][2] + outcomes[0][3] == 1


def test_queue_factor_validation(models):
    with pytest.raises(ValueError):
        KpcaEngine(models[0], KpcaServeConfig(max_batch=8, queue_factor=0),
                   device=CPU)
    with pytest.raises(ValueError):
        KpcaEngine(models[0], KpcaServeConfig(query_dtype=torch.float16),
                   device=CPU)


@pytest.mark.parametrize("case", ["context_drains", "close_cancels",
                                  "restart"])
def test_lifecycle(models, engine, case):
    if case == "context_drains":
        eng = engine(KpcaServeConfig(max_batch=64, min_bucket=8,
                                     flush_max_wait_s=30.0,
                                     flush_eager=False))
        with eng:
            assert eng.running
            fut = eng.submit(_rand((5, 12), seed=3))
        assert not eng.running
        assert fut.result(timeout=0).shape == (5, 2)
    elif case == "close_cancels":
        eng = engine(KpcaServeConfig(max_batch=64, min_bucket=8))
        fut = eng.submit(_rand((5, 12), seed=4))
        eng.close(drain=False)
        assert fut.cancelled()
    else:
        eng = engine(KpcaServeConfig(max_batch=8, min_bucket=8,
                                     flush_max_wait_s=0.005))
        assert eng.start() is eng.start()
        eng.close()
        assert not eng.running
        eng.start()
        assert eng.submit(_rand((2, 12), seed=5)).result(
            timeout=WAIT).shape == (2, 2)


def test_failed_async_batch_fails_only_its_futures(engine):
    eng = engine(KpcaServeConfig(max_batch=8, min_bucket=8,
                                 flush_max_wait_s=0.005))
    run_slab = eng._run_slab
    armed = [True]

    def maybe_boom(mdl, version, slab):
        if armed[0]:
            armed[0] = False
            raise RuntimeError("injected")
        return run_slab(mdl, version, slab)

    eng._run_slab = maybe_boom
    eng.start()
    bad = eng.submit(_rand((3, 12), seed=6))
    with pytest.raises(RuntimeError, match="injected"):
        bad.result(timeout=WAIT)
    assert eng.submit(_rand((3, 12), seed=7)).result(
        timeout=WAIT).shape == (3, 2)
    assert eng._arena.stats()["live_runs"] == 0    # the failed rows freed


@pytest.mark.parametrize("case", ["healed", "backoff", "exhausted",
                                  "deadline"])
def test_retries_and_deadlines_match_jax(models, case):
    """``inject_fault`` fails the first attempt(s); with ``max_retries``
    the drain retries (at once when ``on_fault`` heals, else after the
    backoff); exhausted retries restore the queue and raise; requests past
    ``request_deadline_s`` fail with ``DeadlineExceededError``. Both
    packages give the same counters and the same scores."""
    results = []
    for pkg in ("torch", "jax"):
        fails = [1 if case in ("healed", "backoff") else 5]
        healed = []

        def inject(model, fails=fails):
            if fails[0] > 0:
                fails[0] -= 1
                raise ShardLostError(0, "injected")

        def on_fault(exc, handle, healed=healed):
            healed.append(type(exc).__name__)
            return case == "healed"

        kw = dict(max_batch=8, min_bucket=8, retry_backoff_s=0.001,
                  max_retries=0 if case == "exhausted" else 1,
                  request_deadline_s=0.02 if case == "deadline" else None)
        if pkg == "torch":
            eng = KpcaEngine(models[0], KpcaServeConfig(**kw), device=CPU,
                             inject_fault=None if case == "deadline"
                             else inject, on_fault=on_fault)
        else:
            eng = JKpcaEngine(models[1], JKpcaServeConfig(warmup=False, **kw),
                              inject_fault=None if case == "deadline"
                              else inject, on_fault=on_fault)
        x = _rand((5, 12), seed=9)
        fut = eng.submit(x)
        if case == "deadline":
            threading.Event().wait(0.05)         # let the deadline pass
            assert eng.flush() == {}
            with pytest.raises(Exception) as info:
                fut.result(timeout=0)
            results.append((type(info.value).__name__,
                            eng.stats.n_deadline_expired))
            continue
        if case == "exhausted":
            with pytest.raises(Exception, match="injected"):
                eng.flush()
            assert not fut.done() and len(eng._queue) == 1   # restored
            fails[0] = 0
            eng.flush()
        else:
            eng.flush()
        results.append((np.asarray(fut.result(timeout=0)),
                        eng.stats.n_retries, healed))
    if case == "deadline":
        assert results[0] == results[1] == ("DeadlineExceededError", 1)
        assert issubclass(DeadlineExceededError, RuntimeError)
        return
    (got, n_t, h_t), (want, n_j, h_j) = results
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (n_t, h_t) == (n_j, h_j)
    assert n_t == (0 if case == "exhausted" else 1)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_warmup_leaves_no_compiles(engine, dtype):
    eng = engine(KpcaServeConfig(max_batch=32, min_bucket=8,
                                 query_dtype=dtype))
    assert eng.warmup() == 3                     # buckets 8, 16, 32
    assert eng.warmup() == 0                     # idempotent
    eng.start()
    futs = [eng.submit(_rand((q, 12), seed=q)) for q in (1, 9, 20, 40)]
    for f in futs:
        f.result(timeout=WAIT)
    assert eng.stats.n_compiles == 0
    assert eng.stats.n_warmup_compiles == 3


def test_bf16_slabs_match_jax_bf16_engine(models):
    """bf16 query slabs (rounded to nearest even on the host) against the
    JAX engine with ``query_dtype=jnp.bfloat16`` through its projection
    kernel (interpret mode: the queries widened, norms and products in
    fp32), at 2e-5; and against the port's fp32 engine fed the
    bf16-rounded queries (1e-6: on the CPU the plain version meets
    itself)."""
    reqs = [_rand((q, 12), seed=40 + q) for q in (1, 7, 16, 29)]
    cfg = dict(max_batch=16, min_bucket=4)
    got = KpcaEngine(models[0], KpcaServeConfig(
        query_dtype=torch.bfloat16, **cfg), device=CPU).project_many(reqs)
    want = JKpcaEngine(models[1], JKpcaServeConfig(
        query_dtype=jnp.bfloat16, use_pallas=True, interpret=True,
        warmup=False, **cfg)).project_many(reqs)
    rounded = [torch.as_tensor(r).bfloat16().float().numpy() for r in reqs]
    fp32 = KpcaEngine(models[0], KpcaServeConfig(**cfg),
                      device=CPU).project_many(rounded)
    for g, w, f in zip(got, want, fp32):
        np.testing.assert_allclose(g, np.asarray(w), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(g, f, rtol=1e-6, atol=1e-6)


def test_bf16_rounding_is_nearest_even():
    """The engine's host cast is ml_dtypes' (the JAX package's) rounding,
    and PyTorch's: ties to even, overflow to inf, signed zeros, subnormals,
    quiet NaNs."""
    eng = KpcaEngine(_carried(j_oos.fit_central(
        jnp.asarray(_rand((20, 12), seed=0)), JKernelSpec(), center=True)),
        KpcaServeConfig(query_dtype=torch.bfloat16), device=CPU)
    x = np.concatenate([_rand((64, 12), seed=1) * 100,
                        np.float32([[1 + 2 ** -8, 1 + 3 * 2 ** -8, -0.0,
                                     np.inf, -np.inf, 3.4e38, 1e-40,
                                     -1e-45, np.nan, -np.nan, 65504.0,
                                     -(1 + 2 ** -8)]])])
    ours = eng._bf16_host(torch.from_numpy(x)).float().numpy()
    theirs = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                        .astype(jnp.float32))
    np.testing.assert_array_equal(ours, theirs)
    assert np.isnan(ours[-1, 8]) and np.isnan(ours[-1, 9])


def test_arena_staging_matches_jax(models):
    """Submit-time staging and zero-copy packing: the same slabs served as
    arena slices, the same pad rows and ring fallbacks as the JAX engine,
    and every staged row back in the ring after the drain."""
    sizes = [(3, 5, 8), (16,), (40, 30, 1), (2,) * 9]
    stats = []
    for eng in (KpcaEngine(models[0], KpcaServeConfig(
            max_batch=16, min_bucket=4, arena_factor=2), device=CPU),
            JKpcaEngine(models[1], JKpcaServeConfig(
                max_batch=16, min_bucket=4, arena_factor=2,
                warmup=False))):
        for group in sizes:
            eng.project_many([_rand((q, 12), seed=q) for q in group])
        st = eng.stats
        stats.append((st.n_zero_copy_slabs, st.n_padded,
                      st.n_arena_fallback, eng._arena.stats()["live_runs"]))
    assert stats[0] == stats[1]
    assert stats[0][0] > 0 and stats[0][3] == 0


@pytest.mark.parametrize("pinned", [False])
def test_arena_host_memory(pinned):
    """The CPU engine's arena is plain memory (page-locking needs CUDA;
    the card's engine pins it, tests/test_torch_gpu.py)."""
    arena = batching.SlabArena(12, 32, pin=pinned)
    assert arena.buf.shape == (32, 12) and not arena.pinned
    assert not torch.from_numpy(arena.buf).is_pinned()


def test_version_consistency_under_shard_publishes(models):
    """Requests racing per-shard publishes each see exactly one version:
    bitwise the single-device sharded projection of the version its stats
    name."""
    sharded, _ = oos.shard_fitted(models[0], 3)
    handle = ModelHandle(sharded)
    eng = KpcaEngine(handle, KpcaServeConfig(max_batch=16, min_bucket=16,
                                             flush_max_wait_s=0.002),
                     device=CPU)
    versions = [sharded]
    xq = _rand((16, 12), seed=15)
    futs = []
    rng = np.random.default_rng(16)
    try:
        eng.start()
        for i in range(10):
            futs.append(eng.submit(xq))
            shard = i % 3
            handle.refresh_shard(shard, rng.normal(
                size=(sharded.shard_sizes[shard], 2)).astype(np.float32))
            versions.append(handle.current())
        results = [f.result(timeout=WAIT) for f in futs]
    finally:
        eng.close(drain=False)
    by_rid = {s.request_id: s for s in eng.stats.per_request}
    assert len(by_rid) == len(futs)
    for f, got in zip(futs, results):
        v = by_rid[f.request_id].model_version
        want = project_sharded(versions[v], torch.as_tensor(xq),
                               policy="single").numpy()
        np.testing.assert_array_equal(got, want)


def test_engine_metric_names_match_jax(models):
    """The engine and the router publish under the JAX package's metric
    names."""
    from repro.obs import metrics as j_metrics
    KpcaEngine(oos.shard_fitted(models[0], 2)[0], KpcaServeConfig(),
               device=CPU)
    JKpcaEngine(j_oos.shard_fitted(models[1], 2)[0],
                JKpcaServeConfig(warmup=False))
    ours, theirs = ({(m["name"], m["kind"]) for m in snap["metrics"]
                     if m["name"].startswith("serve_")}
                    for snap in (metrics.snapshot(), j_metrics.snapshot()))
    assert len(ours) >= 16 and ours <= theirs


# ---- publisher glue -------------------------------------------------------

@pytest.mark.parametrize("case", ["refresh", "coalesce", "error", "close"])
def test_background_publisher(models, case):
    model = models[0]
    h = ModelHandle(model)
    alphas = [_rand((48, 2), seed=30 + i) for i in range(12)]
    if case == "refresh":
        with BackgroundPublisher(h) as pub:
            pub.refresh(alphas[0])
            pub.drain(timeout=WAIT)
            assert h.version == 1
        np.testing.assert_allclose(h.current().coefs.numpy(), alphas[0],
                                   rtol=1e-6, atol=1e-6)
        assert pub.n_published == 1
    elif case == "coalesce":
        with BackgroundPublisher(h) as pub:
            for a in alphas:
                pub.refresh(a)
            pub.drain(timeout=WAIT)
        assert pub.n_published + pub.n_coalesced == 12
        assert h.version == pub.n_published
        np.testing.assert_allclose(h.current().coefs.numpy(), alphas[-1],
                                   rtol=1e-6, atol=1e-6)
    elif case == "error":
        pub = BackgroundPublisher(h)
        pub.refresh(np.ones((7, 2), np.float32))   # wrong support size
        with pytest.raises(ValueError):
            pub.drain(timeout=WAIT)
        pub.refresh(alphas[1])
        pub.drain(timeout=WAIT)
        assert h.version == 1
        pub.close()
        with pytest.raises(RuntimeError):
            pub.refresh(alphas[1])
    else:
        pub = BackgroundPublisher(h)
        pub.refresh(alphas[2])
        pub.close()
        assert h.version == 1
        pub.close()


@pytest.mark.parametrize("cadence", [{"every": 2}, {"policy": "residual"},
                                     {"publisher": True}])
def test_stream_chunks_matches_jax(cadence):
    """The driver's chunks republished under a cadence, in both packages
    from the same data and alpha0: the same number of publishes and the
    same final served coefficients (1e-4, the trajectory gate)."""
    from repro.core import admm as j_admm
    from repro.core import topology as j_topology
    from repro.serve import BackgroundPublisher as JBackgroundPublisher
    from repro.serve import ModelHandle as JModelHandle
    from repro.serve import stream_chunks as j_stream_chunks
    nodes, _ = node_dataset(6, 10, m=8, seed=3)
    spec_t, spec_j = KernelSpec(), JKernelSpec()
    s_t = build_setup(nodes, ring(6, 1), spec_t, device=CPU)
    s_j = j_admm.build_setup(jnp.asarray(nodes), j_topology.ring(6, 1),
                             spec_j)
    a0 = np.asarray(j_admm.initial_alpha(s_j, "local"))
    kw = {k: v for k, v in cadence.items() if k != "publisher"}
    h_t = ModelHandle(oos.from_decentralized(nodes, a0, spec_t,
                                             gamma=s_t.gamma, device=CPU))
    h_j = JModelHandle(j_oos.from_decentralized(
        jnp.asarray(nodes), jnp.asarray(a0), spec_j, gamma=s_j.gamma))
    chunks_t = solver.run_chunked(s_t, n_iters=12, chunk=3,
                                  alpha0=torch.as_tensor(a0))
    chunks_j = j_solver.run_chunked(s_j, n_iters=12, chunk=3,
                                    alpha0=jnp.asarray(a0))
    if "publisher" in cadence:
        with BackgroundPublisher(h_t) as p_t, \
                JBackgroundPublisher(h_j) as p_j:
            stream_chunks(chunks_t, h_t, publisher=p_t)
            j_stream_chunks(chunks_j, h_j, publisher=p_j)
    else:
        stream_chunks(chunks_t, h_t, **kw)
        j_stream_chunks(chunks_j, h_j, **kw)
    if "publisher" not in cadence:
        assert h_t.version == h_j.version >= 1
    np.testing.assert_allclose(h_t.current().coefs.numpy(),
                               np.asarray(h_j.current().coefs),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("spec", [None, 3, "residual", "callable", "bad"])
def test_resolve_refresh_policy_matches_jax(spec):
    residuals = [1.0, 0.95, 0.8, 0.79, 0.5, 0.49, 0.1]
    if spec == "bad":
        for resolve in (solver.resolve_refresh_policy,
                        j_solver.resolve_refresh_policy):
            with pytest.raises(ValueError):
                resolve("sometimes")
        return
    fired = []
    for pkg in (solver, j_solver):
        arg = (lambda c: float(c.primal_residual[-1]) < 0.6) \
            if spec == "callable" else spec
        pol = pkg.resolve_refresh_policy(arg)
        fired.append([pol.should_refresh(pkg.ChunkResult(
            state=None, alpha_hist=None, lagrangian=None,
            primal_residual=np.asarray([r], np.float32), rho_hist=None))
            for r in residuals])
    assert fired[0] == fired[1]


# ---- batching pieces ------------------------------------------------------

def test_request_queue_matches_jax():
    """Admission, depth, take, restore and the drain trigger, step by step
    in both packages' queues."""
    logs = []
    for mod in (batching, j_batching):
        q = mod.RequestQueue(max_queries=10, policy="shed",
                             slot_futures=True)
        log = []
        for n in (4, 3, 5, 11):
            try:
                _, shed = q.put(None, n)
                log.append(("put", n, len(shed), q.depth))
            except mod.QueueFullError:
                log.append(("full", n, q.depth))
        taken = q.take(1)
        log.append(("take", [e.n for e in taken], q.depth, len(q)))
        q.restore(taken)
        log.append(("restore", q.depth, q.n_shed, q.n_rejected,
                    q.depth_peak))
        stop = threading.Event()
        log.append(("work", q.wait_for_work(1, 0.0, stop)))
        log.append(("drain", [e.n for e in q.drain()], q.depth))
        stop.set()
        log.append(("stopped", q.wait_for_work(1, 1.0, stop)))
        logs.append(log)
    assert logs[0] == logs[1]


@pytest.mark.parametrize("state", [(None, 0), (4, 10), (0, 20), (12, 5),
                                   (6, 6), (3, 30)])
def test_arena_ring_geometry_matches_jax(state):
    head, tail = state
    for n in (1, 3, 6, 12, 40):
        assert batching.SlabArena._find_run(n, 32, head, tail) == \
            j_batching.SlabArena._find_run(n, 32, head, tail)


def test_slot_future_surface():
    """cancel / set_exception / set_result / bind on the port's
    SlotFuture, as the JAX package's behaves."""
    out = []
    for mod in (batching, j_batching):
        cond = threading.Condition()
        a, b, c = (mod.SlotFuture(i, 1, cond) for i in range(3))
        log = [a.cancel(), a.cancelled(), a.done()]
        b.set_exception(KeyError("x"))
        log += [type(b.exception(timeout=0)).__name__, b.done()]
        slots = mod.FlushSlots()
        slots.results = ["r0"]
        mod.SlotFuture.bind([(c, 0)], slots)
        log += [c.done(), c.cancel()]
        slots.event.set()
        log += [c.result(timeout=0), c.done(), c.running()]
        with pytest.raises(concurrent.futures.CancelledError):
            a.result(timeout=0)
        out.append(log)
    assert out[0] == out[1]


def test_stats_summaries_match_jax():
    st, jst = batching.EngineStats(), j_batching.EngineStats()
    assert st.latency_percentiles() == jst.latency_percentiles()
    for i, lat in enumerate(np.random.default_rng(0).exponential(1e-3, 50)):
        st.per_request.append(batching.RequestStats(i, 1, float(lat)))
        jst.per_request.append(j_batching.RequestStats(i, 1, float(lat)))
    st.n_routed_mp, jst.n_routed_mp = 3, 3
    st.n_routed_single, jst.n_routed_single = 1, 1
    assert st.latency_percentiles((50, 90, 99)) == \
        jst.latency_percentiles((50, 90, 99))
    assert st.routing_summary() == jst.routing_summary() == "mp:3,single:1"
    for s in (5e-5, 2.5e-3, 3.0):
        assert batching.format_latency(s) == j_batching.format_latency(s)


@pytest.mark.parametrize("rows", [3, 20])
def test_refused_submit_releases_its_staged_rows(models, engine, rows):
    """A submit that admission control refuses (over the queue's bound, or
    larger than the whole queue) hands its staged rows back to the arena
    (the ring is empty once the admitted request is served) and is counted
    once, by the queue and by the engine."""
    eng = engine(KpcaServeConfig(max_batch=8, min_bucket=8, queue_factor=1,
                                 admission="reject"))
    x = _rand((6, 12), seed=3)
    fut = eng.submit(x)
    with pytest.raises(QueueFullError):
        eng.submit(_rand((rows, 12), seed=4))
    assert eng._queue.n_rejected == eng.stats.n_rejected == 1
    eng.flush()
    np.testing.assert_allclose(fut.result(timeout=0), _project(models[0], x),
                               atol=1e-6)
    assert eng._arena.stats()["live_runs"] == 0


def test_stress_many_submitters_small_arena(models, engine):
    """More submitter threads than cores against the started engine with a
    one-slab staging ring that wraps constantly and a short interpreter
    switch interval: every request gets exactly its own scores (a staged
    row overwritten before its slab was served, or a lost result, would
    break this) and every request is counted once."""
    import os
    import sys
    n_threads = 2 * (os.cpu_count() or 4)
    eng = engine(KpcaServeConfig(max_batch=16, min_bucket=4, arena_factor=1,
                                 flush_max_wait_s=0.001)).start()
    reqs = [_rand((1 + i % 23, 12), seed=700 + i) for i in range(160)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        futs = _submit_from_threads(eng, reqs, n_threads)
        outs = [f.result(timeout=WAIT) for f in futs]
    finally:
        sys.setswitchinterval(old)
    for r, out in zip(reqs, outs):
        np.testing.assert_allclose(out, _project(models[0], r), rtol=1e-6,
                                   atol=1e-6)
    eng.close()
    assert eng.stats.n_requests == len(reqs)
    assert eng.stats.n_queries == sum(r.shape[0] for r in reqs)
    assert eng._arena.stats()["live_runs"] == 0
