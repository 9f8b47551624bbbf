"""The training cell run on the CPU at the port's smoke configuration
(``--dry-run``: everything but the look for a chip), sound and with each
fault a training cell can have planted under the timed path: a step that
returns its state unchanged, half of the batch left out (the mean taken
over the rest), the loss altered where it is produced, the probe skipped
or its answers altered. Each fault turns ``correct`` false, by the number
named. About 20 s alone."""

import json

import pytest
import torch

from kpcabench import run as bench_run

SEED = 2 ** 31 + 91
CELL = "train-zamba2-1.2b"


def result(capsys, seconds=0.3, trace=0):
    assert bench_run.main(["--workload", CELL, "--seed", str(SEED),
                           "--seconds", str(seconds), "--trace", str(trace),
                           "--dry-run"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def failed(out) -> set:
    return {k for k, v in out["checks"].items()
            if v["value"] is None or v["value"] > v["limit"]}


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(capsys, trace):
    out = result(capsys, trace=trace)
    assert out["correct"] is True and out["dry_run"] is True
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == {"loss", "grad", "grad_norm", "update",
                                  "probe"}
    assert out["counters"]["probes"] >= 1


def test_step_that_returns_its_state_unchanged(capsys, monkeypatch):
    from repro_torch.train import loop

    def frozen(cfg, params, grads, state, gnorm=None):
        state["step"] = state["step"] + 1
        return {"grad_norm": gnorm, "lr": cfg.lr}
    monkeypatch.setattr(loop, "adamw_update_", frozen)
    out = result(capsys)
    assert out["correct"] is False
    assert {"grad", "update"} <= failed(out)
    assert out["checks"]["update"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(capsys, monkeypatch):
    from repro_torch.models import hybrid
    real = hybrid.hybrid_lm_loss

    def half(params, cfg, batch, **kw):
        rows = batch["tokens"].shape[0] // 2
        return real(params, cfg, {k: v[:rows] for k, v in batch.items()},
                    **kw)
    monkeypatch.setattr(hybrid, "hybrid_lm_loss", half)
    out = result(capsys)
    assert out["correct"] is False and "grad_norm" in failed(out)


def test_loss_altered_where_it_is_produced(capsys, monkeypatch):
    from repro_torch.models import hybrid
    real = hybrid.hybrid_lm_loss

    def altered(*a, **kw):
        loss, metrics = real(*a, **kw)
        return loss * 1.01, dict(metrics, loss=metrics["loss"] * 1.01)
    monkeypatch.setattr(hybrid, "hybrid_lm_loss", altered)
    out = result(capsys)
    assert out["correct"] is False and "loss" in failed(out)


def test_probe_skipped(capsys, monkeypatch):
    import repro_torch.train as train
    monkeypatch.setattr(train, "activation_probe",
                        lambda *a, **k: {"skipped": True})
    out = result(capsys)
    assert out["correct"] is False
    assert out["checks"]["probe"]["value"] is None


def test_probe_alpha_altered_where_it_is_produced(capsys, monkeypatch):
    from repro_torch.train import probes
    real = probes.run_admm

    def altered(*a, **k):
        res = real(*a, **k)
        res.alpha[0, 0] += 0.05 * torch.max(torch.abs(res.alpha))
        return res
    monkeypatch.setattr(probes, "run_admm", altered)
    out = result(capsys)
    assert out["correct"] is False and failed(out) == {"probe"}
