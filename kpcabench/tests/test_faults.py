"""Each fault a cell can have, planted underneath the timed path in a run
on the CPU (``--dry-run``: everything but the look for a chip), has to
turn ``correct`` false; the sound run stays true."""

import dataclasses
import json

import pytest
import torch

from kpcabench import run as bench_run
from kpcabench.runners import ring_fit

SEED = 2 ** 31 + 77


def result(capsys, workload, seconds=1.0):
    assert bench_run.main(["--workload", workload, "--seed", str(SEED),
                           "--seconds", str(seconds), "--trace", "0",
                           "--dry-run"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["fit-j80", "serve-j80-bulk",
                                      "serve-j20-bulk", "fit-j20"])
def test_sound_runs_are_correct(capsys, workload):
    out = result(capsys, workload)
    assert out["correct"] is True and out["dry_run"] is True
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"] == {}


def test_step_that_returns_its_state_unchanged(capsys, monkeypatch):
    from repro_torch.core import solver

    def frozen(ops, comm, state, rho_slots, project="ball", slot_mask=None):
        return dataclasses.replace(state, t=state.t + 1), torch.zeros(())
    monkeypatch.setattr(solver, "admm_step", frozen)
    out = result(capsys, "fit-j80")
    assert out["correct"] is False
    assert out["checks"]["alpha"]["value"] > out["checks"]["alpha"]["limit"]


def test_half_the_nodes_left_out_of_the_step(capsys, monkeypatch):
    """The step updates the first half of the nodes and returns the rest
    as they came in."""
    from repro_torch.core import solver
    real = solver.admm_step

    def half(ops, comm, state, rho_slots, project="ball", slot_mask=None):
        new, res = real(ops, comm, state, rho_slots, project, slot_mask)
        h = state.alpha.shape[0] // 2
        alpha, b = new.alpha.clone(), new.b.clone()
        alpha[h:], b[h:] = state.alpha[h:], state.b[h:]
        return dataclasses.replace(new, alpha=alpha, b=b), res
    monkeypatch.setattr(solver, "admm_step", half)
    assert result(capsys, "fit-j80")["correct"] is False


def test_fit_answer_altered_where_it_is_produced(capsys, monkeypatch):
    from repro_torch.core import admm
    real = admm.run_admm

    def altered(*a, **k):
        res = real(*a, **k)
        res.alpha[0, 0] += 0.05 * torch.max(torch.abs(res.alpha))
        return res
    import repro_torch.core as core
    monkeypatch.setattr(core, "run_admm", altered)
    assert result(capsys, "fit-j80")["correct"] is False


@pytest.mark.parametrize("workload", ["serve-j80-bulk", "serve-j20-bulk"])
def test_score_altered_where_it_is_produced(capsys, monkeypatch, workload):
    from repro_torch.kernels.project import ops
    real = ops.project_reference
    monkeypatch.setattr(ops, "project_reference",
                        lambda *a, **k: real(*a, **k) + 1e-2)
    assert result(capsys, workload)["correct"] is False


def test_half_the_slab_left_out(capsys, monkeypatch):
    from repro_torch.kernels.project import ops
    real = ops.project_reference

    def half(spec, xq, *a, **k):
        out = real(spec, xq, *a, **k)
        out[out.shape[0] // 2:] = 0.0
        return out
    monkeypatch.setattr(ops, "project_reference", half)
    assert result(capsys, "serve-j80-bulk")["correct"] is False


def rank_without_exchange(*args):
    """A ring rank whose iterations leave out the exchange between ranks:
    every node hears its own columns."""
    from repro_torch.core import solver
    solver.RingComm.exchange = lambda self, cols: cols
    ring_fit.rank_main(*args)


def test_exchange_between_chips_left_out(capsys, monkeypatch):
    monkeypatch.setattr(ring_fit, "RANK_TARGET", rank_without_exchange)
    out = result(capsys, "ring-j80-4card", seconds=0.5)
    assert out["correct"] is False


def test_sound_ring_is_correct(capsys):
    assert result(capsys, "ring-j80-4card", seconds=0.5)["correct"] is True
