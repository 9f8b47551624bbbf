"""The port's ring fit (``repro_torch.core.dkpca``, ``RingComm``) on the CPU
over gloo, against the JAX package on the same seeded numpy inputs.

The ranks are separate processes (``python -c`` children that import this
module for ``rank_main``), started once per world size for the whole file:
world 4 (J=4, one node a rank; J=8, two nodes a rank) and world 8 (J=8, one
node a rank). They meet at a ``file://`` store under the test's temporary
directory, so parallel pytest workers never share a port, and each child
is waited on with a timeout. Every rank writes its gathered result; the
checks run here. The module imports the JAX package only inside the
functions that compute references, so the children never load JAX.

Cases and tolerances:
  (a) J=4, N=12, M=8, hops=1 against the JAX package's SPMD
      ``dkpca_distributed`` on the 4 host devices, modes "exact" and
      "rescale": alpha, alpha_hist and B at 2e-4 absolute (plus, under
      "rescale", the JAX package's own SPMD-vs-dense gap, and 2e-4 to its
      dense run); the ledger equal;
  (b) the same under tests/test_fault_injection.py's link plan: against
      the JAX SPMD output and against the port's dense ``run_chunked``
      under the dense mask, at 2e-4;
  (c) resume 6 + 8 iterations through ``save_state``/``load_state``
      against 14 in one call, at 1e-5 * scale + 1e-6;
  (d) the default init="local" against the port's dense ``run_admm``, at
      5e-3 * scale + 1e-4;
  (e) bf16 messages against the JAX package's ``jnp.bfloat16`` run,
      within twice the JAX package's own bf16-vs-fp32 gap (measured: see
      BF16_FACTOR);
  (f) tests/helpers/check_dkpca_distributed.py's three modes at J=8, N=16,
      M=12, hops=2, in layouts 8 x 1 and 4 x 2, against the JAX package's
      dense ``run_admm``, at 5e-3 * scale + 1e-4;
  (g) the ledger equal to tests/test_obs.py's analytic per-node count in
      both layouts;
  (h) a CUDA request without a card raises, a group whose backend does not
      suit the tensors raises, and so does a ring that does not split
      evenly over the ranks.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import KernelSpec, solver
from repro_torch.data import node_dataset
from repro_torch.faults import FaultPlan, LinkFault
from repro_torch.faults.plan import ring_slot_tables
from repro_torch.obs import CommLedger

SRC = Path(__file__).resolve().parents[1] / "src"
TESTS = Path(__file__).resolve().parent
SPEC = KernelSpec(kind="rbf")
TRAJ_TOL = 2e-4
# bf16 messages: the two packages round fp32 payloads that differ in their
# last bits (setup summation order) to bf16, so a payload near a rounding
# boundary lands one bf16 ulp (2^-8 relative) apart, and the trajectories
# part by about as much as bf16 moves either from fp32. Measured on case
# (e): the port's bf16 run is 1.78e-2 from the JAX package's, whose own
# bf16-vs-fp32 gap is 1.42e-2; the gate is twice that gap.
BF16_FACTOR = 2.0
RANK_TIMEOUT_S = 240
# (J, N, M, hops) of the two problems, and their seeded alpha0
SMALL = (4, 12, 8, 1)
MID = (8, 16, 12, 2)
MODES = {"exact": ("global", "ball"), "pallas": ("global", "ball"),
         "rescale": ("none", "rescale")}
LAYOUTS = {"8x1": 8, "4x2": 4}


def problem(shape, seed):
    j, n, m, _ = shape
    nodes, _ = node_dataset(j, n, m, seed=0)
    alpha0 = np.random.default_rng(seed).normal(size=(j, n))
    return nodes, alpha0.astype(np.float32)


def link_plan():
    """tests/test_fault_injection.py's link plan on ring(4, 1)."""
    return FaultPlan(links=(LinkFault(t0=3, t1=6, u=0, v=1),
                            LinkFault(t0=5, t1=8, u=2, v=3, directed=True)))


# ---------------------------------------------------------------------------
# the ranks


def _runs(world):
    """{name: dkpca_distributed keyword arguments} a world runs."""
    runs = {}
    if world == 4:
        nodes, a0 = problem(SMALL, 0)
        base = dict(x_nodes=nodes, hops=1, spec=SPEC, n_iters=12,
                    alpha0=a0)
        for mode in ("exact", "rescale"):
            center, project = MODES[mode]
            runs[f"a_{mode}"] = dict(base, center=center, project=project)
        src, mask = ring_slot_tables(4, 1)
        runs["b_masked"] = dict(base, link_mask=link_plan().link_mask(
            src, mask, 0, 12))
        runs["c_full"] = dict(base, n_iters=14)
        runs["c_part1"] = dict(base, n_iters=6)
        runs["d_local"] = dict(base, n_iters=6, alpha0=None)
        runs["e_bf16"] = dict(base, message_dtype=torch.bfloat16)
    nodes8, a8 = problem(MID, 1)
    for mode, (center, project) in MODES.items():
        runs[f"f_{mode}"] = dict(x_nodes=nodes8, hops=2, spec=SPEC,
                                 center=center, project=project, n_iters=10,
                                 alpha0=a8)
    return runs


def _save(out: Path, name: str, rank: int, res, ledger=None):
    np.savez(out / f"{name}.r{rank}.npz",
             **{k: getattr(res, k).numpy() for k in
                ("alpha", "alpha_hist", "primal_residual", "znorm2_hist",
                 "b")})
    if ledger is not None and rank == 0:
        (out / f"{name}.ledger.json").write_text(
            json.dumps(ledger.snapshot()))


def rank_main(rank: int, world: int, store: str, out: str) -> None:
    """One rank of a world: join the gloo group, run every case of the
    world, write each gathered result (and rank 0 the ledgers)."""
    import torch.distributed as dist
    from repro_torch.core import dkpca_distributed, load_state, save_state
    from repro_torch.launch import make_process_group
    out = Path(out)
    group, dev = make_process_group("cpu", rank=rank, world_size=world,
                                    local_rank=0,
                                    init_method=f"file://{store}")
    try:
        for name, kw in _runs(world).items():
            led = CommLedger()
            res = dkpca_distributed(**kw, group=group, ledger=led,
                                    device=dev)
            _save(out, name, rank, res, led)
            if name == "c_part1":
                # round-trip the restart state through a checkpoint, as a
                # preemption would, and run the remaining 8 iterations
                ckpt = out / "ckpt"
                if rank == 0:
                    save_state(str(ckpt), solver.AdmmState(
                        alpha=res.alpha, b=res.b, g=torch.zeros_like(res.b),
                        znorm2=res.znorm2_hist[-1], t=6,
                        rho=torch.zeros(res.b.shape[:1] + res.b.shape[2:])))
                dist.barrier()
                back = load_state(str(ckpt), device="cpu")
                res2 = dkpca_distributed(
                    **dict(kw, n_iters=8, alpha0=back.alpha, b0=back.b,
                           t0=back.t), group=group, device=dev)
                _save(out, "c_part2", rank, res2)
        _transport_checks(group, dev, world, out, rank)
        # a ring that does not split evenly over the ranks
        try:
            dkpca_distributed(node_dataset(world + 2, 4, 3, seed=0)[0],
                              hops=1, n_iters=1, group=group, device=dev)
            verdict = "no error"
        except ValueError as e:
            verdict = str(e)
        (out / f"uneven.r{rank}.txt").write_text(verdict)
    finally:
        dist.destroy_process_group()


def _transport_checks(group, dev, world: int, out: Path, rank: int):
    """RingComm alone on a ring of 2 nodes a rank, hops=2: the exchange
    against its definition on the global columns (fp32 exactly; bf16 as
    the rounded columns, the self slot exact), and the collectives."""
    from repro_torch.core import RingComm
    j, offsets, rev = 2 * world, [-2, -1, 1, 2], [4, 3, 2, 1]
    cols = torch.randn((j, 5, 3), generator=torch.Generator().manual_seed(5))
    comms = {dt: RingComm(j, offsets, rev, group=group, device=dev,
                          message_dtype=dt) for dt in (None, torch.bfloat16)}
    lo, ln = comms[None].first_node, comms[None].n_local
    want = torch.stack([torch.stack(
        [cols[m, 0]] + [cols[(m + o) % j, r] for o, r in zip(offsets, rev)])
        for m in range(lo, lo + ln)])
    want16 = want.bfloat16().float()
    want16[:, 0] = want[:, 0]
    ids = torch.arange(lo, lo + ln, dtype=torch.float32)
    verdict = dict(
        fp32=torch.equal(comms[None].exchange(cols[lo:lo + ln]), want),
        bf16=torch.equal(comms[torch.bfloat16].exchange(cols[lo:lo + ln]),
                         want16),
        all_sum=float(comms[None].all_sum(ids)) == j * (j - 1) / 2,
        all_max=float(comms[None].all_max(ids)) == j - 1)
    (out / f"transport.r{rank}.json").write_text(json.dumps(verdict))
    # all_sum: the ring's sum of J values spanning six decades, and the
    # same sum by a world-1 ring (a one-rank subgroup, all J nodes local)
    import torch.distributed as dist
    vals = torch.randn((j,), generator=torch.Generator().manual_seed(6)) \
        * 10.0 ** torch.linspace(-3, 3, j)
    ring_sum = comms[None].all_sum(vals[lo:lo + ln])
    alone, _ = dist.new_subgroups(group_size=1)
    one_sum = RingComm(j, offsets, rev, group=alone, device=dev).all_sum(vals)
    (out / f"allsum.r{rank}.json").write_text(json.dumps(dict(
        ring=float(ring_sum).hex(), world1=float(one_sum).hex(),
        torch_sum=float(torch.sum(vals)).hex())))


def _spawn(world: int, root: Path) -> Path:
    out = root / f"world{world}"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), str(TESTS)]), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    code = ("import sys; from test_torch_dkpca import rank_main; "
            "rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], "
            "sys.argv[4])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world),
         str(root / f"store{world}"), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return out, procs


def _join(procs) -> None:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds run at once, every case inside them; returns
    {world: output directory}."""
    root = tmp_path_factory.mktemp("ring")
    started = {w: _spawn(w, root) for w in (4, 8)}
    for _, procs in started.values():
        _join(procs)
    return {w: out for w, (out, _) in started.items()}


def _load(out: Path, name: str, rank: int = 0) -> dict:
    with np.load(out / f"{name}.r{rank}.npz") as z:
        return dict(z)


def _ledger(out: Path, name: str) -> dict:
    return json.loads((out / f"{name}.ledger.json").read_text())


def _gate(got, want):
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err < 5e-3 * scale + 1e-4, (err, scale)


# ---------------------------------------------------------------------------
# references


def _jax_spmd(**kw):
    """The JAX package's SPMD fit of the SMALL problem on 4 host devices."""
    import jax
    import jax.numpy as jnp
    from repro.core.dkpca import dkpca_distributed as j_dkpca
    from repro.core.kernels_math import KernelSpec as JKernelSpec
    from repro.launch.mesh import make_mesh
    from repro.obs.comm import CommLedger as JCommLedger
    if jax.device_count() < 4:
        pytest.fail("the JAX reference needs 4 host devices "
                    "(tests/conftest.py provides them)")
    nodes, a0 = problem(SMALL, 0)
    led = JCommLedger()
    out = j_dkpca(jnp.asarray(nodes), make_mesh((4,), ("data",)),
                  axis_names=("data",), hops=1, spec=JKernelSpec(kind="rbf"),
                  n_iters=12, alpha0=jnp.asarray(a0), ledger=led, **kw)
    return {k: np.asarray(getattr(out, k)) for k in
            ("alpha", "alpha_hist", "b")}, led.snapshot()


def _jax_dense(mode, shape=MID, seed=1, n_iters=10):
    """The JAX package's dense run_admm (the reference of
    tests/helpers/check_dkpca_distributed.py): its alpha history."""
    import jax.numpy as jnp
    from repro.core import KernelSpec as JKernelSpec
    from repro.core import build_setup, run_admm
    from repro.core.topology import ring
    center, project = MODES[mode]
    nodes, a0 = problem(shape, seed)
    setup = build_setup(jnp.asarray(nodes), ring(shape[0], hops=shape[3]),
                        JKernelSpec(kind="rbf"), center=center)
    return np.asarray(run_admm(setup, n_iters=n_iters,
                               alpha0=jnp.asarray(a0),
                               project=project).alpha_hist)


# ---------------------------------------------------------------------------
# (a), (b), (e): against the JAX package's SPMD fit


@pytest.mark.parametrize("mode", ["exact", "rescale"])
def test_ring_matches_jax_spmd(runs, mode):
    """alpha, alpha_hist and B at 2e-4 against the JAX package's SPMD fit.
    Under "rescale" the JAX package's own two transports disagree by more
    than that (its SPMD and dense trajectories: 2.4e-4 here), so the port
    is held at 2e-4 to the dense reference and, against the SPMD one, at
    2e-4 plus that measured gap."""
    center, project = MODES[mode]
    want, _ = _jax_spmd(center=center, project=project)
    dense = _jax_dense(mode, SMALL, 0, 12)
    got = _load(runs[4], f"a_{mode}")
    np.testing.assert_allclose(got["alpha_hist"], dense, rtol=0,
                               atol=TRAJ_TOL)
    slack = float(np.abs(want["alpha_hist"] - dense).max()) \
        if mode == "rescale" else 0.0
    for key in ("alpha", "alpha_hist", "b"):
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=TRAJ_TOL + slack, err_msg=key)


def test_ring_ledger_is_the_jax_packages(runs):
    _, want = _jax_spmd(center="global", project="ball")
    assert _ledger(runs[4], "a_exact") == want


def test_masked_ring_matches_jax_spmd(runs):
    from repro.faults import FaultPlan as JFaultPlan
    from repro.faults.plan import ring_slot_tables as j_tables
    src, mask = j_tables(4, 1)
    lm = JFaultPlan.from_dict(link_plan().to_dict()).link_mask(
        src, mask, 0, 12)
    want, _ = _jax_spmd(center="global", link_mask=lm)
    got = _load(runs[4], "b_masked")
    np.testing.assert_allclose(got["alpha"], want["alpha"], rtol=0,
                               atol=TRAJ_TOL)
    np.testing.assert_allclose(got["alpha_hist"], want["alpha_hist"],
                               rtol=0, atol=TRAJ_TOL)


def test_masked_ring_matches_dense_port(runs):
    from repro_torch.core import build_setup, init_state, ring, run_chunked
    nodes, a0 = problem(SMALL, 0)
    setup = build_setup(nodes, ring(4, 1), SPEC, device="cpu")
    lm_dense = link_plan().link_mask(setup.src.numpy(), setup.mask.numpy(),
                                     0, 12)
    state = init_state(torch.as_tensor(a0), setup.n_slots)
    for res in run_chunked(setup, n_iters=12, chunk=4, state=state,
                           link_mask=lm_dense):
        state = res.state
    got = _load(runs[4], "b_masked")
    np.testing.assert_allclose(got["alpha"], state.alpha.numpy(), rtol=0,
                               atol=TRAJ_TOL)
    # the mask bit: the censored run differs from the clean one
    assert not np.allclose(got["alpha"], _load(runs[4], "a_exact")["alpha"])


def test_bf16_messages_match_jax(runs):
    """bf16 messages in both packages: the same run within BF16_FACTOR
    times the JAX package's own bf16-vs-fp32 gap on this case."""
    import jax.numpy as jnp
    want, _ = _jax_spmd(center="global", message_dtype=jnp.bfloat16)
    fp32, _ = _jax_spmd(center="global")
    effect = float(np.abs(want["alpha_hist"] - fp32["alpha_hist"]).max())
    got = _load(runs[4], "e_bf16")
    assert np.isfinite(got["alpha_hist"]).all()
    np.testing.assert_allclose(got["alpha_hist"], want["alpha_hist"],
                               rtol=0, atol=BF16_FACTOR * effect)
    assert _ledger(runs[4], "e_bf16")["per_iter"]["bytes"] \
        == 3 * 2 * 12 * 2          # half the fp32 bytes
    # and the wire's rounding shows: bf16 is not the fp32 run
    assert not np.array_equal(got["alpha"],
                              _load(runs[4], "a_exact")["alpha"])


# ---------------------------------------------------------------------------
# (c), (d): resume and the default init


def test_resume_through_checkpoint_matches_one_call(runs):
    full = _load(runs[4], "c_full")
    resumed = _load(runs[4], "c_part2")
    scale = max(float(np.abs(full["alpha"]).max()), 1e-6)
    assert np.abs(full["alpha"] - resumed["alpha"]).max() \
        < 1e-5 * scale + 1e-6
    np.testing.assert_allclose(resumed["alpha_hist"][-1],
                               full["alpha_hist"][-1], rtol=1e-5, atol=1e-5)


def test_default_init_matches_dense_port(runs):
    from repro_torch.core import build_setup, ring, run_admm
    nodes, _ = problem(SMALL, 0)
    setup = build_setup(nodes, ring(4, 1), SPEC, device="cpu")
    want = run_admm(setup, n_iters=6).alpha.numpy()
    _gate(_load(runs[4], "d_local")["alpha"], want)


# ---------------------------------------------------------------------------
# (f), (g): check_dkpca_distributed's modes in two layouts, and the ledger


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_modes_match_jax_dense(runs, mode, layout):
    got = _load(runs[LAYOUTS[layout]], f"f_{mode}")["alpha"]
    assert np.isfinite(got).all()
    _gate(got, _jax_dense(mode)[-1])


def test_pallas_mode_is_the_exact_run(runs):
    """The JAX package's use_pallas has no counterpart: the port's Grams
    always go through gram_op (the plain version on the CPU)."""
    for world in LAYOUTS.values():
        assert np.array_equal(_load(runs[world], "f_pallas")["alpha"],
                              _load(runs[world], "f_exact")["alpha"])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_ledger_matches_analytic_count(runs, mode, layout):
    """tests/test_obs.py's per-node count: each iteration ships one fp32
    N-vector to each of the 2*hops neighbours three times, plus the
    residual's all-reduce (and rescale's max); the setup ships X to the
    neighbours, J rotations of X in the centring sweep, one all-reduce
    and the row means to the neighbours."""
    j, n, m, hops = MID
    led = _ledger(runs[LAYOUTS[layout]], f"f_{mode}")
    glob = MODES[mode][0] == "global"
    assert led["per_iter"] == dict(
        bytes=3 * 2 * hops * n * 4, messages=3 * 2 * hops,
        collectives=1 + (mode == "rescale"),
        collective_bytes=4 * (1 + (mode == "rescale")))
    assert led["setup"] == dict(
        bytes=2 * hops * n * m * 4 + glob * (j * n * m * 4
                                             + 2 * hops * n * 4),
        messages=2 * hops + glob * (j + 2 * hops),
        collectives=int(glob), collective_bytes=4 * glob)
    assert led["iterations"] == 10


def test_ledger_is_the_same_in_both_layouts(runs):
    for mode in MODES:
        assert _ledger(runs[8], f"f_{mode}") == _ledger(runs[4], f"f_{mode}")


def test_every_rank_gathers_the_same_result(runs):
    for world, out in runs.items():
        for name in ("f_exact", "f_rescale"):
            first = _load(out, name)
            for r in range(1, world):
                other = _load(out, name, r)
                assert all(np.array_equal(first[k], other[k])
                           for k in first), (world, name, r)


def test_the_layouts_agree(runs):
    for mode in MODES:
        np.testing.assert_allclose(_load(runs[8], f"f_{mode}")["alpha"],
                                   _load(runs[4], f"f_{mode}")["alpha"],
                                   rtol=0, atol=TRAJ_TOL)


# ---------------------------------------------------------------------------
# (h): refusals


def test_ring_transport_matches_its_definition(runs):
    for world, out in runs.items():
        for r in range(world):
            verdict = json.loads((out / f"transport.r{r}.json").read_text())
            assert all(verdict.values()), (world, r, verdict)


def test_all_sum_is_the_world1_bits(runs):
    """RingComm.all_sum over 4 and 8 gloo ranks (one and two nodes a rank)
    gives every rank the bits of a world-1 ring's sum of the same values:
    both sum the J values gathered in global node order with one
    torch.sum, which is the bits of torch.sum over those values."""
    for world, out in runs.items():
        for r in range(world):
            got = json.loads((out / f"allsum.r{r}.json").read_text())
            assert got["ring"] == got["world1"], (world, r, got)
            vals = torch.randn((2 * world,), generator=torch.Generator()
                               .manual_seed(6)) \
                * 10.0 ** torch.linspace(-3, 3, 2 * world)
            assert got["world1"] == float(torch.sum(vals)).hex(), \
                (world, r, got)


@pytest.mark.parametrize("op", ["sym_apply", "kcross_apply", "znorm2",
                                "res_part"])
def test_ring_row_forms_are_batch_invariant(op):
    """The solver's products in the form the ring runs them (rows=True):
    within fp32 rounding of the batched products the dense transport runs,
    and each node's result the same bits computed alone as in a batch of
    J (on the CPU; scripts/ring_batch_bits.py checks the card)."""
    from repro_torch.core.solver import (_kcross_apply, _res_part,
                                         _sym_apply, _znorm2)
    j, n, s = 5, 24, 3
    g = torch.Generator().manual_seed(3)
    vec = torch.linalg.qr(torch.randn((j, n, n), generator=g))[0]
    kcross = torch.randn((j, s, s, n, n), generator=g)
    c = torch.randn((j, s, n), generator=g)
    fn, args = {"sym_apply": (_sym_apply, (vec, torch.rand((j, n),
                                                           generator=g),
                                           torch.randn((j, n, s),
                                                       generator=g))),
                "kcross_apply": (_kcross_apply, (kcross, c)),
                "znorm2": (_znorm2, (c, torch.randn((j, s, n),
                                                    generator=g))),
                "res_part": (_res_part, ((torch.rand((j, s), generator=g)
                                          > 0.3).float(),
                                         torch.randn((j, n, s),
                                                     generator=g)))}[op]
    want, got = fn(*args), fn(*args, rows=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    alone = torch.cat([fn(*(a[i:i + 1] for a in args), rows=True)
                       for i in range(j)])
    assert torch.equal(alone, got)


def test_uneven_split_raises(runs):
    for world, out in runs.items():
        for r in range(world):
            verdict = (out / f"uneven.r{r}.txt").read_text()
            assert "do not split evenly" in verdict, verdict


def test_cuda_without_a_card_raises(monkeypatch):
    from repro_torch.core import dkpca_distributed
    from repro_torch.launch import make_process_group
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nodes, _ = problem(SMALL, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dkpca_distributed(nodes, hops=1, n_iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_process_group("cuda", rank=0, world_size=1)


@pytest.mark.parametrize("backend,device", [("nccl", "cpu"),
                                            ("gloo", "cuda")])
def test_backend_that_does_not_suit_the_tensors_raises(backend, device):
    with pytest.raises(ValueError, match="cannot carry"):
        solver.check_backend(backend, torch.device(device))
