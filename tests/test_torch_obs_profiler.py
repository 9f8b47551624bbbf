"""The port's span tracer under ``torch.profiler``: while the profiler
records, an enabled tracer opens every span of the fit path
(``build_setup`` -> ``run_admm`` -> ``oos.from_decentralized``) as a
``record_function`` range, so the profiler's host timeline holds it beside
the operations it encloses; the ring buffer still records it; outside a
profile no range opens; off, the tracer stays the no-op singleton and the
profiler sees none of the names; and tracing changes no number of the
fit."""

import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import KernelSpec, build_setup, oos, ring, run_admm
from repro_torch.obs import trace

ITERS = 3
SETUP_SPANS = ("setup.build", "setup.tables", "setup.gamma", "setup.gram",
               "setup.mean_stats", "setup.center", "setup.eigh")
SOLVER_SPANS = ("solver.run", "solver.iter", "solver.lagrangian")
PACKAGE_SPANS = ("package.build", "package.mean_stats")
FIT_SPANS = SETUP_SPANS + SOLVER_SPANS + PACKAGE_SPANS
# spans a fit opens: one each, but ITERS of the loop's
PER_FIT = {**{n: 1 for n in FIT_SPANS}, "solver.iter": ITERS,
           "solver.lagrangian": ITERS}


@pytest.fixture(autouse=True)
def _no_global_tracer():
    trace.disable()
    yield
    trace.disable()


def fit():
    """A tiny fit on the CPU: J = 4 nodes of N = 8 rows, M = 16."""
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(4, 8, 16)),
                        dtype=torch.float32)
    spec = KernelSpec()
    setup = build_setup(x, ring(4, 1), spec, device="cpu")
    res = run_admm(setup, n_iters=ITERS)
    model = oos.from_decentralized(x, res.alpha, spec, gamma=setup.gamma,
                                   device="cpu")
    return res, model


def profiled_fit(tracing: bool):
    """(fit's result, the profiler's events, the tracer or None)."""
    tracer = trace.enable() if tracing else None
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = fit()
    finally:
        trace.disable()
    return out, prof.events(), tracer


def annotations(events) -> list:
    return [e for e in events if e.is_user_annotation]


def test_every_fit_span_is_a_profiler_annotation():
    _, events, _ = profiled_fit(True)
    counts = Counter(e.name for e in annotations(events))
    assert {n: counts[n] for n in FIT_SPANS} == PER_FIT
    assert counts["solver.iter"] == ITERS


def test_setup_eigh_encloses_the_eigensolve():
    _, events, _ = profiled_fit(True)
    (eigh,) = [e for e in annotations(events) if e.name == "setup.eigh"]
    inner = [e for e in events if e.name == "aten::_linalg_eigh"]
    assert inner
    for e in inner:
        assert eigh.time_range.start <= e.time_range.start
        assert e.time_range.end <= eigh.time_range.end


def test_spans_nest_setup_then_solver_then_package():
    _, events, _ = profiled_fit(True)
    spans = {e.name: e.time_range for e in annotations(events)
             if e.name in ("setup.build", "solver.run", "package.build")}
    assert spans["setup.build"].end <= spans["solver.run"].start
    assert spans["solver.run"].end <= spans["package.build"].start
    for e in annotations(events):
        outer = e.name.split(".")[0]
        if outer in ("setup", "package") and not e.name.endswith(".build"):
            box = spans[f"{outer}.build"]
            assert box.start <= e.time_range.start <= e.time_range.end \
                <= box.end, e.name


def test_the_ring_buffer_still_records_every_span():
    _, events, tracer = profiled_fit(True)
    ring_counts = Counter(e[1] for e in tracer.events())
    assert {n: ring_counts[n] for n in FIT_SPANS} == PER_FIT
    assert tracer.to_chrome()["traceEvents"]


def test_instant_and_complete_stay_in_the_ring_buffer():
    tracer = trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.instant("probe.instant")
        trace.complete("probe.complete", 1e-3)
        with trace.span("probe.span", k=1):
            pass
    names = {e.name for e in annotations(prof.events())}
    assert "probe.span" in names
    assert not {"probe.instant", "probe.complete"} & names
    assert [e[1] for e in tracer.events()] == [
        "probe.instant", "probe.complete", "probe.span"]


def test_a_raising_body_closes_the_range_and_records_the_span():
    tracer = trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(RuntimeError):
            with trace.span("probe.raises"):
                raise RuntimeError("boom")
        with trace.span("probe.after"):
            pass
    got = [e for e in annotations(prof.events())
           if e.name.startswith("probe.")]
    assert [e.name for e in got] == ["probe.raises", "probe.after"]
    assert got[0].time_range.end <= got[1].time_range.start
    assert [e[1] for e in tracer.events()] == ["probe.raises", "probe.after"]


def test_off_the_tracer_is_the_noop_and_the_profiler_sees_no_span():
    assert trace.span("x") is trace.NOOP_SPAN  # repro-lint: disable=span-not-closed
    _, events, _ = profiled_fit(False)
    assert not {e.name for e in annotations(events)} & set(FIT_SPANS)


def test_a_range_opens_only_while_the_profiler_records():
    tracer = trace.enable()
    with trace.span("probe.before") as sp:
        assert sp._range is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("probe.inside") as sp:
            assert sp._range is not None
    with trace.span("probe.after") as sp:
        assert sp._range is None
    names = {e.name for e in annotations(prof.events())}
    assert "probe.inside" in names
    assert not {"probe.before", "probe.after"} & names
    assert [e[1] for e in tracer.events()] == [
        "probe.before", "probe.inside", "probe.after"]


def test_tracing_changes_no_number_of_the_fit():
    (res0, m0), _, _ = profiled_fit(False)
    (res1, m1), _, _ = profiled_fit(True)
    for a, b in ((res0.alpha, res1.alpha), (res0.alpha_hist, res1.alpha_hist),
                 (res0.lagrangian, res1.lagrangian),
                 (res0.primal_residual, res1.primal_residual),
                 (m0.coefs, m1.coefs), (m0.row_mean_coef, m1.row_mean_coef),
                 (m0.bias, m1.bias), (m0.k_row_mean, m1.k_row_mean)):
        assert torch.equal(a, b)


def test_the_tracer_alone_imports_no_torch():
    """trace.py is stdlib-only: loaded by path in a fresh interpreter,
    enabled and used, it leaves torch unimported."""
    path = Path(trace.__file__)
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('t', {str(path)!r})\n"
        "t = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(t)\n"
        "assert t.span('x') is t.NOOP_SPAN\n"
        "tr = t.enable()\n"
        "with t.span('x'):\n"
        "    pass\n"
        "assert [e[1] for e in tr.events()] == ['x']\n"
        "assert 'torch' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
