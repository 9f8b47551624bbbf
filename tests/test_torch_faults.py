"""The port's fault layer on the CPU, against the JAX package on the same
seeded numpy inputs: fault plans and their link masks, ``FaultyComm``, the
fault-tolerant fit (dropout recovery, link loss, stragglers, the state
shrink) and fault-injected serving (shard loss, transient faults, request
deadlines, publisher crashes) — the twins of tests/test_fault_injection.py
(all but the SPMD case) and tests/test_fault_tolerance.py::TestNodeFailure.

Tolerances: plans, link masks and the state shrink are exact; masked and
dropout trajectories from one shared alpha0 (both packages stepping from
the JAX package's setup constants) agree per iteration at 2e-4, the
reference's admm_step gate; similarities to central kPCA at 1e-3; served
scores after a shard loss at 1e-5 (tests/test_publisher.py's drop
tolerance). The serving cases run under the ``lockcheck`` marker, with the
port's serve modules and ``faults.serving`` instrumented.
"""

import dataclasses
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.chaos import hammer_submit, settle
from helpers.lockcheck import _ThreadingShim
from repro import faults as j_faults
from repro.core import admm as j_admm
from repro.core import oos as j_oos
from repro.core import solver as j_solver
from repro.core import topology as j_topology
from repro.core.kernels_math import KernelSpec as JKernelSpec
from repro.obs.comm import CommLedger as JCommLedger
from repro_torch.core import (KernelSpec, build_setup, central_kpca,
                              init_state, oos, run_admm, run_chunked,
                              similarity)
from repro_torch.core import solver as t_solver
from repro_torch.core.convert import setup_from_numpy, state_from_numpy
from repro_torch.core.topology import reknit, ring
from repro_torch.data import kpca_dataset, node_dataset
from repro_torch.faults import (CrashingHandle, DeadlineExceededError,
                                FaultError, FaultPlan, FaultTolerantRun,
                                FaultyComm, InjectedCrashError, LinkFault,
                                NodeDropout, PublisherCrash, ShardLoss,
                                ShardLossInjector, ShardLostError,
                                ShardRebalancer, StragglerStall, link_delay,
                                shrink_state, transient_faults)
from repro_torch.faults import driver as t_driver
from repro_torch.faults.plan import ring_slot_tables
from repro_torch.obs import CommLedger, trace
from repro_torch.serve import KpcaEngine, KpcaServeConfig, ModelHandle
from repro_torch.serve.publisher import BackgroundPublisher

CPU = torch.device("cpu")
SPEC = KernelSpec(kind="rbf")
J_SPEC = JKernelSpec(kind="rbf")
WAIT = 30.0
TRAJ_TOL = 2e-4
PORT_SERVE_MODULES = ("repro_torch.serve.batching",
                      "repro_torch.serve.kpca_engine",
                      "repro_torch.serve.publisher",
                      "repro_torch.serve.sharded",
                      "repro_torch.faults.serving")


@pytest.fixture(autouse=True)
def _no_global_tracer():
    yield
    trace.disable()


@pytest.fixture(autouse=True)
def port_lock_order(lock_order_guard):
    """The lockcheck guard instruments the JAX package's serve modules;
    the same graph instruments the port's and its serving fault hooks."""
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


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _j_plan(plan: FaultPlan):
    """The same plan in the JAX package's classes."""
    return j_faults.FaultPlan.from_dict(plan.to_dict())


def run_to_end(run):
    return list(run.chunks())


def survivor_similarities(run, spec=SPEC):
    """Per-survivor similarity of the run's final alpha against the
    survivor-pooled central solution under the run's pinned gamma (the
    port's twin of tests/helpers/chaos.survivor_similarities)."""
    x = run.x_nodes
    pooled = x.reshape(-1, x.shape[-1])
    ag, _, _ = central_kpca(pooled, spec, 1, gamma=run.gamma,
                            device=x.device)
    return [float(similarity(run.state.alpha[j], x[j], ag[:, 0], pooled,
                             spec, gamma=run.gamma))
            for j in range(x.shape[0])]


def _shared_build_setup(x_nodes, graph, spec, center="global",
                        include_self=True, gamma=None, device="cpu", **_):
    """``build_setup`` through the JAX package, carried into the port: both
    packages then step from the same setup constants, before and after a
    re-knit (the port's own setup is held to the JAX one in
    tests/test_torch_core.py)."""
    s_j = j_admm.build_setup(jnp.asarray(_np(x_nodes)), graph, J_SPEC,
                             center=center, include_self=include_self,
                             gamma=gamma)
    arrays = {f.name: np.asarray(getattr(s_j, f.name))
              for f in dataclasses.fields(s_j) if f.name != "include_self"}
    return setup_from_numpy(arrays, include_self=include_self, device=device)


# ---------------------------------------------------------------------------
# fault plans


class TestFaultPlan:
    @pytest.mark.parametrize("seed", [0, 7, 8])
    def test_random_is_deterministic_and_the_jax_packages(self, seed):
        kw = dict(n_nodes=12, n_iters=40, n_dropouts=2, n_link_faults=3,
                  n_stragglers=1)
        a = FaultPlan.random(seed, **kw)
        assert a == FaultPlan.random(seed, **kw)
        assert a != FaultPlan.random(seed + 1, **kw)
        assert a.to_dict() == j_faults.FaultPlan.random(seed, **kw).to_dict()

    def test_random_respects_survivor_floor_and_protection(self):
        plan = FaultPlan.random(3, n_nodes=6, n_dropouts=3, n_iters=20,
                                protect=[0, 1])
        dropped = {d.node for d in plan.dropouts}
        assert len(dropped) == 3 and not dropped & {0, 1}
        with pytest.raises(ValueError):
            FaultPlan.random(0, n_nodes=4, n_dropouts=3, n_iters=10)

    def test_dict_round_trip_across_packages(self):
        plan = FaultPlan(
            seed=5,
            dropouts=(NodeDropout(t=3, node=1),),
            links=(LinkFault(t0=2, t1=6, u=0, v=2, directed=True),),
            stragglers=(StragglerStall(t0=1, t1=4, node=3),),
            shard_losses=(ShardLoss(at_dispatch=2, shard=1),),
            publisher_crashes=(PublisherCrash(at_job=0),))
        assert FaultPlan.from_dict(plan.to_dict()) == plan
        assert FaultPlan.from_dict(json.loads(json.dumps(plan.to_dict()))) \
            == plan
        j_plan = _j_plan(plan)
        assert j_plan.to_dict() == plan.to_dict()
        assert j_plan.dropout_schedule() == plan.dropout_schedule()
        assert j_plan.dead_after(3) == plan.dead_after(3)
        for t0, t1 in ((0, 1), (0, 2), (4, 9), (6, 9)):
            assert j_plan.has_link_faults(t0, t1) == \
                plan.has_link_faults(t0, t1)

    def test_link_delay_is_censoring_window(self):
        lf = link_delay(4, 3, u=1, v=2)
        assert (lf.t0, lf.t1) == (4, 7) and not lf.directed

    def test_link_mask_censors_receiver_side_slots(self):
        setup = build_setup(node_dataset(6, 8, m=4, seed=0)[0], ring(6, 1),
                            SPEC, device=CPU)
        src, mask = _np(setup.src), _np(setup.mask)
        plan = FaultPlan(links=(LinkFault(t0=2, t1=4, u=0, v=1,
                                          directed=True),))
        lm = plan.link_mask(src, mask, 0, 5)
        assert lm.shape == (5, 6, src.shape[1])
        slot01 = np.nonzero(src[0, 1:] == 1)[0] + 1
        assert slot01.size == 1
        assert (lm[2:4, 0, slot01] == 0.0).all()
        assert (lm[:2, 0, slot01] == 1.0).all() and lm[4, 0, slot01] == 1.0
        slot10 = np.nonzero(src[1, 1:] == 0)[0] + 1
        assert (lm[:, 1, slot10] == 1.0).all()
        assert (lm[:, :, 0] == 1.0).all()

    def test_straggler_censors_all_incident_links_both_ways(self):
        setup = build_setup(node_dataset(6, 8, m=4, seed=0)[0], ring(6, 1),
                            SPEC, device=CPU)
        src = _np(setup.src)
        plan = FaultPlan(stragglers=(StragglerStall(t0=1, t1=3, node=2),))
        lm = plan.link_mask(src, _np(setup.mask), 0, 4)
        for u in (1, 3):
            s_in = np.nonzero(src[u, 1:] == 2)[0] + 1
            assert (lm[1:3, u, s_in] == 0.0).all()
            s_out = np.nonzero(src[2, 1:] == u)[0] + 1
            assert (lm[1:3, 2, s_out] == 0.0).all()
        assert (lm[0] == 1.0).all() and (lm[3] == 1.0).all()

    @pytest.mark.parametrize("dead", [(), (3,), (3, 7)])
    def test_link_mask_is_the_jax_packages(self, dead):
        """A plan of link loss, a delay, a directed loss and a straggler
        compiled over ring(12, 2), before and after a re-knit (rows
        re-indexed, the plan still in original ids)."""
        plan = FaultPlan(
            seed=3, links=(LinkFault(t0=5, t1=12, u=0, v=2),
                           link_delay(8, 4, u=10, v=11),
                           LinkFault(t0=1, t1=30, u=4, v=5, directed=True)),
            stragglers=(StragglerStall(t0=10, t1=14, node=6),))
        graph, ids = ring(12, 2), np.arange(12)
        if dead:
            graph, surv = reknit(graph, list(dead))
            ids = ids[surv]
        setup = build_setup(node_dataset(graph.n_nodes, 4, m=3, seed=0)[0],
                            graph, SPEC, device=CPU)
        args = (_np(setup.src), _np(setup.mask), 0, 40)
        got = plan.link_mask(*args, node_ids=ids)
        want = _j_plan(plan).link_mask(*args, node_ids=ids)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)

    def test_ring_slot_tables_are_the_jax_packages(self):
        from repro.faults.plan import ring_slot_tables as j_tables
        for got, want in zip(ring_slot_tables(8, 2), j_tables(8, 2)):
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# transport censoring


class TestFaultyComm:
    def test_exchange_zeroes_masked_slots_and_delegates(self):
        src = torch.as_tensor([[0, 1, 2], [1, 2, 0], [2, 0, 1]])
        rsl = torch.zeros((3, 3), dtype=torch.int64)
        led = CommLedger()
        base = t_solver.DenseComm(src, rsl, ledger=led, wire_entries=6)
        cols = torch.arange(36, dtype=torch.float32).reshape(3, 3, 4)
        mask = torch.as_tensor([[1.0, 0.0, 1.0], [1.0, 1.0, 1.0],
                                [1.0, 1.0, 0.0]])
        fc = FaultyComm(base, mask)
        out = _np(fc.exchange(cols))
        ref = _np(base.exchange(cols))
        assert (out[0, 1] == 0.0).all() and (out[2, 2] == 0.0).all()
        keep = _np(mask).astype(bool)
        assert (out[keep] == ref[keep]).all()
        ones = torch.ones_like(mask)
        assert (_np(FaultyComm(base, ones).exchange(cols)) == ref).all()
        assert fc.ledger is led and FaultyComm(t_solver.DenseComm(
            src, rsl), ones).ledger is None
        assert led.setup.bytes == 3 * 6 * 4 * 4   # outside an iteration
        assert float(fc.all_sum(cols)) == float(cols.sum())
        assert float(fc.all_max(cols)) == 35.0
        assert fc.local(len) is len

    def test_matches_jax_faulty_comm(self):
        src = np.array([[0, 1, 2], [1, 2, 0], [2, 0, 1]], np.int64)
        rsl = np.array([[0, 2, 1], [0, 2, 1], [0, 2, 1]], np.int64)
        cols = np.random.default_rng(0).normal(size=(3, 3, 5)) \
            .astype(np.float32)
        mask = np.array([[1, 0, 1], [1, 1, 0], [1, 1, 1]], np.float32)
        got = FaultyComm(t_solver.DenseComm(torch.as_tensor(src),
                                            torch.as_tensor(rsl)),
                         torch.as_tensor(mask)).exchange(torch.as_tensor(cols))
        want = j_faults.FaultyComm(j_solver.DenseComm(src, rsl),
                                   jnp.asarray(mask)).exchange(
            jnp.asarray(cols))
        np.testing.assert_array_equal(_np(got), np.asarray(want))


# ---------------------------------------------------------------------------
# solver-side recovery (the headline)


HEADLINE_PLAN = FaultPlan(seed=7, dropouts=(NodeDropout(t=15, node=3),
                                            NodeDropout(t=15, node=7)))
# the slice's plan (dropouts, link loss, a link delay, a straggler), on the
# headline's 12 nodes
SLICE_PLAN_12 = FaultPlan(
    seed=3, dropouts=(NodeDropout(t=15, node=3), NodeDropout(t=15, node=7)),
    links=(LinkFault(t0=5, t1=12, u=0, v=2), link_delay(8, 4, u=10, v=11)),
    stragglers=(StragglerStall(t0=10, t1=14, node=6),))


def _headline_run(chunk=5, n_iters=40, plan=HEADLINE_PLAN, **kw):
    nodes, _ = node_dataset(12, 40, m=24, seed=4)
    return FaultTolerantRun(nodes, ring(12, hops=2), SPEC, plan,
                            n_iters=n_iters, chunk=chunk, device=CPU, **kw)


class TestAdmmDropoutRecovery:
    def test_mid_admm_dropout_recovers_without_refit(self):
        run = _headline_run()
        chunks = run_to_end(run)
        assert run.state.t == 40
        assert run.n_reknits == 1
        assert sorted(run.node_ids) == [0, 1, 2, 4, 5, 6, 8, 9, 10, 11]
        assert tuple(run.state.alpha.shape) == (10, 40)
        assert [e.kind for e in run.events] == ["dropout"]
        sims = survivor_similarities(run)
        assert np.mean(sims) >= 0.95, sims
        assert np.min(sims) >= 0.95, sims
        assert sum(int(c.alpha_hist.shape[0]) for c in chunks) == 40

    def test_same_seed_same_trajectory_bitwise(self):
        a = _headline_run()
        run_to_end(a)
        b = _headline_run()
        run_to_end(b)
        assert torch.equal(a.state.alpha, b.state.alpha)
        assert torch.equal(a.state.b, b.state.b)

    def test_chunk_size_does_not_change_detection_point(self):
        a = _headline_run(chunk=5, n_iters=20)
        run_to_end(a)
        b = _headline_run(chunk=7, n_iters=20)
        run_to_end(b)
        assert torch.equal(a.state.alpha, b.state.alpha)

    def test_recovery_emits_counters_and_spans(self):
        counters = (t_driver._M_INJECTED_DROPOUT, t_driver._M_REKNIT)
        assert counters[0].labels == (("kind", "dropout"),)
        before = [c.value for c in counters]
        t = trace.enable()
        run = _headline_run(n_iters=16)        # one iter past the dropout
        run_to_end(run)
        names = [e[1] for e in t.events()]
        assert "fault.injected" in names
        assert "fault.recovery" in names
        assert {"solver.step", "solver.rho2"} <= set(names)
        assert [c.value for c in counters] == [v + 1 for v in before]

    def test_dropout_outside_run_rejected(self):
        nodes, _ = node_dataset(4, 8, m=4, seed=0)
        plan = FaultPlan(dropouts=(NodeDropout(t=30, node=1),))
        with pytest.raises(ValueError):
            FaultTolerantRun(nodes, ring(4, 1), SPEC, plan, n_iters=10,
                             device=CPU)

    @pytest.mark.parametrize("plan", [HEADLINE_PLAN, SLICE_PLAN_12],
                             ids=["dropouts", "slice_plan"])
    def test_matches_jax_from_shared_alpha0(self, plan, monkeypatch):
        """Both packages' FaultTolerantRun from one alpha0 and the same
        setup constants before and after the re-knit: the same chunks,
        survivors, events and ledger, and the same trajectory per
        iteration at 2e-4."""
        monkeypatch.setattr(t_driver, "build_setup", _shared_build_setup)
        nodes, _ = node_dataset(12, 40, m=24, seed=4)
        led_t, led_j = CommLedger(), JCommLedger()
        run_t = _headline_run(chunk=10, plan=plan, ledger=led_t)
        run_j = j_faults.FaultTolerantRun(
            jnp.asarray(nodes), j_topology.ring(12, hops=2), J_SPEC,
            _j_plan(plan), n_iters=40, chunk=10, ledger=led_j)
        alpha0 = np.asarray(j_admm.initial_alpha(run_j.setup, "local"))
        run_j.state = j_solver.init_state(jnp.asarray(alpha0), 5)
        run_t.state = init_state(torch.as_tensor(alpha0), 5)
        chunks_j, chunks_t = run_to_end(run_j), run_to_end(run_t)
        assert [int(c.state.t) for c in chunks_j] == \
            [c.state.t for c in chunks_t]
        for cj, ct in zip(chunks_j, chunks_t):
            np.testing.assert_allclose(_np(ct.alpha_hist),
                                       np.asarray(cj.alpha_hist),
                                       rtol=TRAJ_TOL, atol=TRAJ_TOL)
            assert (ct.comm_bytes, ct.comm_messages) == \
                (cj.comm_bytes, cj.comm_messages)
        assert list(run_t.node_ids) == list(run_j.node_ids)
        assert [(e.kind, e.t, e.detail) for e in run_t.events] == \
            [(e.kind, e.t, e.detail) for e in run_j.events]
        assert led_t.snapshot() == led_j.snapshot()
        np.testing.assert_allclose(_np(run_t.state.b),
                                   np.asarray(run_j.state.b),
                                   rtol=TRAJ_TOL, atol=TRAJ_TOL)

    def test_port_setups_match_jax_similarity(self):
        """Each package on its own setups and its own init="local" warm
        start: the survivors' similarity to central kPCA agrees."""
        run_t = _headline_run(plan=SLICE_PLAN_12)
        run_to_end(run_t)
        nodes, _ = node_dataset(12, 40, m=24, seed=4)
        run_j = j_faults.FaultTolerantRun(
            jnp.asarray(nodes), j_topology.ring(12, hops=2), J_SPEC,
            _j_plan(SLICE_PLAN_12), n_iters=40, chunk=5)
        run_to_end(run_j)
        from helpers.chaos import survivor_similarities as j_sims
        np.testing.assert_allclose(survivor_similarities(run_t),
                                   j_sims(run_j, J_SPEC), atol=1e-3)


class TestLinkFaultDegradation:
    def test_link_loss_window_still_converges(self):
        nodes, _ = node_dataset(12, 40, m=24, seed=4)
        plan = FaultPlan(seed=3,
                         links=(LinkFault(t0=5, t1=12, u=0, v=2),
                                link_delay(8, 4, u=3, v=5)),
                         stragglers=(StragglerStall(t0=10, t1=14, node=6),))
        run = FaultTolerantRun(nodes, ring(12, hops=2), SPEC, plan,
                               n_iters=40, chunk=8, device=CPU)
        run_to_end(run)
        assert run.n_reknits == 0
        assert [e.kind for e in run.events] == ["link", "link", "straggler"]
        sims = survivor_similarities(run)
        assert np.mean(sims) >= 0.95, sims

    def test_censored_run_differs_from_clean_then_matches_itself(self):
        nodes, _ = node_dataset(6, 16, m=8, seed=1)
        plan = FaultPlan(links=(LinkFault(t0=2, t1=9, u=0, v=1),))
        kw = dict(n_iters=12, chunk=4, device=CPU)
        faulty = FaultTolerantRun(nodes, ring(6, 1), SPEC, plan, **kw)
        run_to_end(faulty)
        again = FaultTolerantRun(nodes, ring(6, 1), SPEC, plan, **kw)
        run_to_end(again)
        clean = FaultTolerantRun(nodes, ring(6, 1), SPEC, FaultPlan(), **kw)
        run_to_end(clean)
        a, b, c = (r.state.alpha for r in (faulty, again, clean))
        assert torch.equal(a, b)
        assert not torch.allclose(a, c)

    @pytest.mark.parametrize("chunk", [4, 5])
    def test_masked_run_chunked_matches_jax_per_iteration(self, chunk):
        """tests/test_fault_injection.py's dense/SPMD fixture, dense side:
        the port's masked run_chunked replays the JAX package's per
        iteration from one alpha0 on the same setup constants."""
        nodes, _ = node_dataset(4, 12, 8, seed=0)
        plan = FaultPlan(links=(LinkFault(t0=3, t1=6, u=0, v=1),
                                LinkFault(t0=5, t1=8, u=2, v=3,
                                          directed=True)),
                         stragglers=(StragglerStall(t0=9, t1=11, node=2),))
        s_j = j_admm.build_setup(jnp.asarray(nodes), j_topology.ring(4, 1),
                                 J_SPEC)
        s_t = _shared_build_setup(nodes, ring(4, 1), SPEC)
        lm = plan.link_mask(_np(s_t.src), _np(s_t.mask), 0, 12)
        np.testing.assert_array_equal(lm, _j_plan(plan).link_mask(
            np.asarray(s_j.src), np.asarray(s_j.mask), 0, 12))
        alpha0 = np.random.default_rng(0).normal(size=(4, 12)) \
            .astype(np.float32)
        j_hist = np.concatenate([np.asarray(c.alpha_hist) for c in
                                 j_solver.run_chunked(
                                     s_j, n_iters=12, chunk=4,
                                     alpha0=jnp.asarray(alpha0),
                                     link_mask=lm)])
        chunks = list(run_chunked(s_t, n_iters=12, chunk=chunk,
                                  alpha0=torch.as_tensor(alpha0),
                                  link_mask=lm))
        t_hist = torch.cat([c.alpha_hist for c in chunks])
        np.testing.assert_allclose(_np(t_hist), j_hist, rtol=TRAJ_TOL,
                                   atol=TRAJ_TOL)
        unmasked = torch.cat([c.alpha_hist for c in run_chunked(
            s_t, n_iters=12, chunk=chunk, alpha0=torch.as_tensor(alpha0))])
        assert torch.equal(unmasked[:3], t_hist[:3])   # mask opens at t=3
        assert not torch.allclose(unmasked[3], t_hist[3])

    def test_link_mask_shape_checked(self):
        setup = build_setup(node_dataset(4, 6, m=4, seed=0)[0], ring(4, 1),
                            SPEC, device=CPU)
        with pytest.raises(ValueError, match="link_mask shape"):
            next(run_chunked(setup, n_iters=6, chunk=3,
                             link_mask=np.ones((5, 4, 3), np.float32)))


class TestShrinkState:
    def _live_state(self):
        nodes, _ = node_dataset(6, 10, m=6, seed=2)
        graph = ring(6, hops=1)
        setup = build_setup(nodes, graph, SPEC, device=CPU)
        alpha0 = np.random.default_rng(1).normal(size=(6, 10)) \
            .astype(np.float32)
        state = init_state(torch.as_tensor(alpha0), setup.n_slots)
        for res in run_chunked(setup, n_iters=4, chunk=4, state=state):
            state = res.state
        return graph, state

    def test_surviving_edges_carry_duals_new_edges_start_cold(self):
        graph, state = self._live_state()
        new_graph, surv = reknit(graph, [2])
        shrunk = shrink_state(state, graph, new_graph, surv)
        assert shrunk.alpha.shape[0] == 5
        assert shrunk.t == state.t
        assert (_np(shrunk.rho) == 0.0).all()
        b_old, b_new = _np(state.b), _np(shrunk.b)
        old_ids, _, old_mask = graph.neighbor_array()
        new_ids, _, new_mask = new_graph.neighbor_array()
        surv = [int(v) for v in surv]
        for nj, o in enumerate(surv):
            assert (b_new[nj, :, 0] == b_old[o, :, 0]).all()
            old_slot = {int(old_ids[o, d]): d + 1
                        for d in range(old_ids.shape[1]) if old_mask[o, d]}
            for d in range(new_ids.shape[1]):
                if not new_mask[nj, d]:
                    continue
                l_orig = surv[int(new_ids[nj, d])]
                col = b_new[nj, :, d + 1]
                if l_orig in old_slot:
                    assert (col == b_old[o, :, old_slot[l_orig]]).all()
                else:
                    assert (col == 0.0).all()

    @pytest.mark.parametrize("dead", [[2], [1, 4], [0, 1, 2]])
    def test_matches_jax_shrink_bitwise(self, dead):
        graph, state = self._live_state()
        new_graph, surv = reknit(graph, dead)
        got = shrink_state(state, graph, new_graph, surv)
        j_old = j_topology.ring(6, 1)
        j_new, j_surv = j_topology.reknit(j_old, dead)
        j_state = j_solver.AdmmState(
            alpha=jnp.asarray(_np(state.alpha)), b=jnp.asarray(_np(state.b)),
            g=jnp.asarray(_np(state.g)), znorm2=jnp.asarray(_np(state.znorm2)),
            t=jnp.asarray(state.t, jnp.int32), rho=jnp.asarray(_np(state.rho)))
        want = j_faults.shrink_state(j_state, j_old, j_new, j_surv)
        for name in ("alpha", "b", "g", "znorm2", "rho"):
            np.testing.assert_array_equal(_np(getattr(got, name)),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
        assert got.t == int(want.t)

    def test_checkpointed_state_shrinks_identically(self, tmp_path):
        nodes, _ = node_dataset(6, 10, m=6, seed=2)
        graph = ring(6, hops=1)
        setup = build_setup(nodes, graph, SPEC, device=CPU)
        state = None
        for res in run_chunked(setup, n_iters=4, chunk=4, seed=0,
                               ckpt_dir=str(tmp_path)):
            state = res.state
        restored = t_solver.load_state(str(tmp_path), device=CPU)
        new_graph, surv = reknit(graph, [1, 4])
        live = shrink_state(state, graph, new_graph, surv)
        cold = shrink_state(restored, graph, new_graph, surv)
        for name in ("alpha", "b", "g", "znorm2", "rho"):
            assert torch.equal(getattr(live, name), getattr(cold, name)), \
                name
        assert live.t == cold.t


# ---------------------------------------------------------------------------
# node failure (tests/test_fault_tolerance.py::TestNodeFailure)


class TestNodeFailure:
    def test_reknit_converges_on_survivors_like_jax(self):
        nodes, _ = node_dataset(12, 40, m=24, seed=4)
        g2, survivors = reknit(ring(12, hops=2), [3, 7])
        nodes2 = nodes[survivors]
        pooled2 = nodes2.reshape(-1, nodes2.shape[-1])
        setup = build_setup(nodes2, g2, SPEC, device=CPU)
        ag, _, _ = central_kpca(pooled2, SPEC, 1, gamma=setup.gamma,
                                device=CPU)
        res = run_admm(setup, n_iters=40)
        sims = [float(similarity(res.alpha[j], torch.as_tensor(nodes2[j]),
                                 ag[:, 0], torch.as_tensor(pooled2), SPEC,
                                 gamma=setup.gamma))
                for j in range(len(survivors))]
        assert np.mean(sims) > 0.85, sims
        from repro.core import central as j_central
        from repro.core import metrics as j_metrics
        j_g2, j_surv = j_topology.reknit(j_topology.ring(12, 2), [3, 7])
        assert list(j_surv) == list(survivors)
        s_j = j_admm.build_setup(jnp.asarray(nodes2), j_g2, J_SPEC)
        ag_j, _, _ = j_central.central_kpca(jnp.asarray(pooled2), J_SPEC, 1,
                                            gamma=s_j.gamma)
        res_j = j_admm.run_admm(s_j, n_iters=40)
        sims_j = [float(j_metrics.similarity(
            res_j.alpha[j], jnp.asarray(nodes2[j]), ag_j[:, 0],
            jnp.asarray(pooled2), J_SPEC, gamma=s_j.gamma))
            for j in range(len(survivors))]
        np.testing.assert_allclose(sims, sims_j, atol=1e-3)


# ---------------------------------------------------------------------------
# the slice as a whole, at its full width


def test_slice_plan_at_full_width_matches_jax():
    """The fault-tolerant fit at the paper's width (J=20 x N=100 x M=784,
    ring(20, 2), 40 iterations in chunks of 10) under two dropouts, link
    loss, a link delay and a straggler, with a ledger, in both packages on
    the CPU, each from its own setups and warm start: the same survivors,
    events and ledger, and the same survivor similarity to central kPCA."""
    nodes, _ = node_dataset(20, 100, m=784, seed=0)

    def plan(pkg):
        return pkg.FaultPlan(
            seed=3, dropouts=(pkg.NodeDropout(t=15, node=3),
                              pkg.NodeDropout(t=15, node=7)),
            links=(pkg.LinkFault(t0=5, t1=12, u=0, v=2),
                   pkg.link_delay(8, 4, u=10, v=12)),
            stragglers=(pkg.StragglerStall(t0=10, t1=14, node=16),))

    import repro_torch.faults as t_faults
    led_t, led_j = CommLedger(), JCommLedger()
    run_t = FaultTolerantRun(nodes, ring(20, hops=2), SPEC, plan(t_faults),
                             n_iters=40, chunk=10, ledger=led_t, device=CPU)
    run_to_end(run_t)
    run_j = j_faults.FaultTolerantRun(
        jnp.asarray(nodes), j_topology.ring(20, hops=2), J_SPEC,
        plan(j_faults), n_iters=40, chunk=10, ledger=led_j)
    run_to_end(run_j)
    assert run_t.state.t == int(run_j.state.t) == 40
    assert run_t.n_reknits == run_j.n_reknits == 1
    assert list(run_t.node_ids) == list(run_j.node_ids) == \
        [j for j in range(20) if j not in (3, 7)]
    assert [e.kind for e in run_t.events] == [e.kind for e in run_j.events] \
        == ["link", "link", "straggler", "dropout"]
    assert led_t.snapshot() == led_j.snapshot()
    tot = led_t.totals()
    assert (tot.bytes, tot.messages, led_t.iterations) == (3072000, 7680, 40)
    from helpers.chaos import survivor_similarities as j_sims
    sims_t, sims_j = survivor_similarities(run_t), j_sims(run_j, J_SPEC)
    assert np.mean(sims_t) >= 0.99 and np.min(sims_t) >= 0.95, sims_t
    np.testing.assert_allclose(sims_t, sims_j, atol=1e-3)


# ---------------------------------------------------------------------------
# serving-side recovery


def _sharded(n_train=96, m=12, n_shards=4, n_components=2, seed=0):
    """(sharded model, its source FittedKpca) on RBF data, on the CPU (the
    port's twin of tests/helpers/chaos.make_sharded_handle)."""
    x = kpca_dataset(n_train, m=m, seed=seed)
    model = oos.fit_central(x, SPEC, n_components=n_components, center=True,
                            device=CPU)
    sharded, _ = oos.shard_fitted(model, n_shards)
    return sharded, model


@pytest.mark.lockcheck
class TestServingShardLoss:
    def _scenario(self):
        sharded, _ = _sharded()
        plan = FaultPlan(seed=0,
                         shard_losses=(ShardLoss(at_dispatch=0, shard=1),))
        injector = ShardLossInjector(plan)
        rebalancer = ShardRebalancer()
        handle = ModelHandle(sharded)
        cfg = KpcaServeConfig(max_batch=16, min_bucket=8,
                              flush_max_wait_s=0.001,
                              max_retries=4, retry_backoff_s=0.005,
                              request_deadline_s=WAIT)
        eng = KpcaEngine(handle, cfg, device=CPU, inject_fault=injector,
                         on_fault=rebalancer)
        return eng, handle, injector, rebalancer

    def test_shard_loss_under_load_zero_hangs_one_publish(self, tmp_path):
        tracer = trace.enable()
        eng, handle, injector, rebalancer = self._scenario()
        v0 = handle.version

        def make_query(tid, i):
            rng = np.random.default_rng(100 * tid + i)
            return rng.normal(size=(int(rng.integers(1, 9)), 12)) \
                .astype(np.float32)

        with eng:
            futures = hammer_submit(eng, n_threads=3, requests_each=8,
                                    make_query=make_query)
            results, errors = settle(futures, timeout_s=WAIT)
        assert len(results) + len(errors) == 24
        assert all(isinstance(e, FaultError) for e in errors), errors
        assert results, "recovery should let most requests succeed"
        assert rebalancer.n_rebalances == 1
        assert handle.version == v0 + 1
        assert injector.n_raised >= 1
        assert handle.current().shard_sizes[1] == 0
        survivor = oos.gather_fitted(handle.current())
        xq = np.random.default_rng(9).normal(size=(5, 12)).astype(np.float32)
        out = eng.project_many([xq])[0]
        np.testing.assert_allclose(
            out, _np(oos.project(survivor, torch.as_tensor(xq))), atol=1e-5)
        # the survivor model is the JAX package's drop_shard of the same
        # model: its scores agree
        x = kpca_dataset(96, m=12, seed=0)
        j_model = j_oos.fit_central(jnp.asarray(x), J_SPEC, n_components=2,
                                    center=True)
        j_sharded, _ = j_oos.shard_fitted(j_model, 4)
        j_survivor = j_oos.gather_fitted(j_oos.drop_shard(j_sharded, 1))
        np.testing.assert_allclose(
            out, np.asarray(j_oos.project(j_survivor, jnp.asarray(xq))),
            atol=1e-5)
        path = tmp_path / "chaos_trace.json"
        tracer.export(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        recov = [e for e in events if e["name"] == "fault.recovery"]
        assert len(recov) == 1 and recov[0]["ph"] == "X"
        assert recov[0]["args"]["kind"] == "shard_loss"
        assert any(e["name"] == "fault.injected" for e in events)
        assert any(e["name"] == "serve.retry" for e in events)

    def test_rebalance_is_exactly_once_across_concurrent_retries(self):
        import threading
        sharded, _ = _sharded()
        handle = ModelHandle(sharded)
        rebalancer = ShardRebalancer()
        exc = ShardLostError(2)
        n_handled = []
        lk = threading.Lock()
        barrier = threading.Barrier(4)

        def racer():
            barrier.wait()
            handled = rebalancer(exc, handle)
            with lk:
                n_handled.append(handled)

        threads = [threading.Thread(target=racer) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert n_handled == [True] * 4
        assert rebalancer.n_rebalances == 1
        assert handle.current().shard_sizes[2] == 0

    def test_injector_ignores_unsharded_models_and_other_faults(self):
        _, model = _sharded()
        injector = ShardLossInjector(FaultPlan(
            shard_losses=(ShardLoss(at_dispatch=0, shard=1),)))
        injector(model)                      # FittedKpca: nothing to lose
        assert injector.dispatches == 1 and injector.n_raised == 0
        handle = ModelHandle(model)
        assert ShardRebalancer()(ShardLostError(0), handle) is False
        assert ShardRebalancer()(ValueError("x"), handle) is False


@pytest.mark.lockcheck
class TestRetryAndDeadline:
    def _engine(self, **cfg):
        sharded, _ = _sharded()
        kw = dict(max_batch=16, min_bucket=8)
        inject = cfg.pop("inject_fault", None)
        return KpcaEngine(ModelHandle(sharded), KpcaServeConfig(**kw, **cfg),
                          device=CPU, inject_fault=inject)

    def test_transient_fault_heals_within_retry_budget(self):
        eng = self._engine(max_retries=3, retry_backoff_s=0.001,
                           inject_fault=transient_faults(2))
        xq = np.random.default_rng(0).normal(size=(4, 12)).astype(np.float32)
        fut = eng.submit(xq)
        out = eng.flush()
        assert fut.result(timeout=WAIT).shape == (4, 2)
        assert out and eng.stats.n_retries == 2

    def test_retries_exhausted_raises_typed_error(self):
        eng = self._engine(max_retries=1, retry_backoff_s=0.001,
                           inject_fault=transient_faults(10))
        eng.submit(np.zeros((2, 12), np.float32))
        with pytest.raises(InjectedCrashError):
            eng.flush()

    def test_max_retries_zero_keeps_fail_fast_contract(self):
        eng = self._engine(inject_fault=transient_faults(1))
        eng.submit(np.zeros((2, 12), np.float32))
        with pytest.raises(InjectedCrashError):
            eng.flush()
        assert eng.stats.n_retries == 0
        assert eng.flush()

    def test_expired_requests_fail_typed_not_served_late(self):
        eng = self._engine(request_deadline_s=0.0)
        fut = eng.submit(np.zeros((3, 12), np.float32))
        out = eng.flush()
        assert out == {}
        with pytest.raises(DeadlineExceededError):
            fut.result(timeout=0)
        assert eng.stats.n_deadline_expired == 1

    def test_async_faulted_batch_resolves_every_future(self):
        eng = self._engine(flush_max_wait_s=0.001, max_retries=1,
                           retry_backoff_s=0.001,
                           inject_fault=transient_faults(1000))
        with eng:
            futures = hammer_submit(
                eng, n_threads=2, requests_each=4,
                make_query=lambda tid, i: np.zeros((2, 12), np.float32))
            results, errors = settle(futures, timeout_s=WAIT)
        assert len(errors) == 8 and not results
        assert all(isinstance(e, InjectedCrashError) for e in errors)

    def test_custom_exception_factory(self):
        inject = transient_faults(1, lambda: ShardLostError(3))
        with pytest.raises(ShardLostError):
            inject(None)
        inject(None)                          # the budget is spent


@pytest.mark.lockcheck
class TestPublisherCrash:
    def test_background_publisher_survives_crashed_job(self):
        _, model = _sharded()
        plan = FaultPlan(publisher_crashes=(PublisherCrash(at_job=0),))
        crashing = CrashingHandle(ModelHandle(model), plan)
        with BackgroundPublisher(crashing) as pub:
            pub.refresh(model.coefs)
            with pytest.raises(InjectedCrashError):
                pub.drain(timeout=WAIT)
            pub.refresh(model.coefs)
            pub.drain(timeout=WAIT)
        assert crashing.n_crashes == 1
        assert crashing.version == 1

    def test_engine_serves_stale_model_through_crash(self):
        sharded, _ = _sharded()
        plan = FaultPlan(publisher_crashes=(PublisherCrash(at_job=0),))
        crashing = CrashingHandle(ModelHandle(sharded), plan)
        eng = KpcaEngine(ModelHandle(sharded),
                         KpcaServeConfig(max_batch=16, min_bucket=8),
                         device=CPU)
        xq = np.random.default_rng(1).normal(size=(4, 12)).astype(np.float32)
        before = eng.project_many([xq])[0]
        with pytest.raises(InjectedCrashError):
            crashing.publish(oos.drop_shard(sharded, 0))
        after = eng.project_many([xq])[0]
        np.testing.assert_array_equal(before, after)

    def test_refresh_shard_job_crashes_then_passes_through(self):
        sharded, _ = _sharded()
        plan = FaultPlan(publisher_crashes=(PublisherCrash(at_job=0),))
        crashing = CrashingHandle(ModelHandle(sharded), plan)
        alpha = sharded.coefs_ext[1, :sharded.shard_sizes[1], :-1]
        with pytest.raises(InjectedCrashError):
            crashing.refresh_shard(1, alpha)
        assert crashing.refresh_shard(1, 2.0 * alpha) == 1
        assert crashing.current().shard_sizes == sharded.shard_sizes


def test_state_from_numpy_round_trip_keeps_shrink():
    """A JAX-side state carried into the port shrinks as the JAX one
    does (the converter keeps t an int)."""
    rng = np.random.default_rng(3)
    arrays = dict(alpha=rng.normal(size=(5, 4)), b=rng.normal(size=(5, 4, 3)),
                  g=rng.normal(size=(5, 4, 3)), znorm2=rng.random(5),
                  rho=rng.random((5, 3)), t=np.int32(9))
    st = state_from_numpy(arrays, device=CPU)
    g_old = ring(5, 1)
    g_new, surv = reknit(g_old, [0])
    shrunk = shrink_state(st, g_old, g_new, surv)
    assert shrunk.t == 9 and tuple(shrunk.b.shape) == (4, 4, 3)
