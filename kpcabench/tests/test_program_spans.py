"""The program spans' record of a trace: attribution of device operations
by launch, the idle split, what no span claims, the launches read from the
profiler's raw results, and the readers; a trace without program spans
gives no record."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from kpcabench import common, program_spans, tracing
from kpcabench.tests.test_tracing import timeline

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def ev(name, a, b, dev=CPU, user=False, id=0):
    return SimpleNamespace(name=name, device_type=dev, is_user_annotation=user,
                           id=id, time_range=SimpleNamespace(start=a, end=b))


def span(name, a, b):
    return ev(name, a, b, user=True)


def program_timeline():
    """A 1000 us window: the benchmark's setup (0-400) and solver
    (400-1000) spans around the program's; device operations with
    correlation ids 101-107.

    busy: 105-350 (gram 105-150 launched in setup.gram, which closed at
    100; the eigensolve 150-350), 460-470, 500-560, 650-660, 720-740,
    992-998."""
    return [
        ev("kpcabench.window", 0, 1000, user=True),
        ev("kpcabench.setup", 0, 400, user=True),
        ev("kpcabench.solver", 400, 1000, user=True),
        span("setup.build", 10, 390),
        span("setup.gram", 20, 100),
        span("setup.eigh", 120, 380),
        span("solver.run", 410, 990),
        span("solver.iter", 420, 590),
        span("solver.inner", 430, 450),
        span("solver.lagrangian", 600, 700),
        ev("aten::empty", 25, 30),
        ev("cudaLaunchKernel", 40, 45, id=101),
        ev("aten::_linalg_eigh", 125, 375),
        ev("cudaLaunchKernel", 130, 135, id=102),
        ev("aten::index", 432, 448),
        ev("cudaLaunchKernel", 440, 442, id=103),
        ev("cudaLaunchKernel", 455, 458, id=104),
        ev("aten::bmm", 602, 606),
        ev("cudaLaunchKernel", 603, 606, id=105),
        ev("cudaLaunchKernel", 992, 993, id=107),
        ev("gram_mma_kernel", 105, 150, CUDA, id=101),
        ev("syevbj_batch", 150, 350, CUDA, id=102),
        ev("index_kernel", 460, 470, CUDA, id=103),
        ev("admm_step_kernel", 500, 560, CUDA, id=104),
        ev("bmm_kernel", 650, 660, CUDA, id=105),
        ev("Memcpy DtoH", 720, 740, CUDA, id=106),
        ev("late_kernel", 992, 998, CUDA, id=107),
        ev("setup.eigh", 150, 350, CUDA, user=True),    # GPU annotation
    ]


# When each runtime call began, by correlation id (``launches``): 106's
# call is not in the trace, and 107's lies outside every program span.
LAUNCHED = {101: 40, 102: 130, 103: 440, 104: 455, 105: 603, 107: 992}


def record(events):
    return program_spans.program(events, LAUNCHED)


def rec(n=1, host=0.0, device=0.0, calls=0, idle=0.0):
    return dict(n=n, host_s=pytest.approx(host * 1e-6),
                device_s=pytest.approx(device * 1e-6), calls=calls,
                idle_s=pytest.approx(idle * 1e-6))


def test_program_record_attributes_by_launch():
    d = record(program_timeline())
    assert d["program"] == {
        "setup.build": rec(host=380),
        "setup.gram": rec(host=80, device=45, calls=1, idle=105),
        "setup.eigh": rec(host=260, device=200, calls=1),
        "solver.run": rec(host=580, idle=252),
        "solver.iter": rec(host=170, device=60, calls=1, idle=30),
        "solver.inner": rec(host=20, device=10, calls=1),
        "solver.lagrangian": rec(host=100, device=10, calls=1, idle=150),
    }
    assert d["unattributed_s"] == pytest.approx(26e-6)


@pytest.mark.parametrize("shift", [-100, 500])
def test_attribution_by_launch_needs_no_device_clock(shift):
    """Device times shifted against the host's (a trace whose clocks sit
    apart): every operation still counts whole, by its launch."""
    events = program_timeline()
    for e in events:
        if e.device_type == CUDA:
            e.time_range.start += shift
            e.time_range.end += shift
    d = record(events)
    plain = record(program_timeline())
    for name, r in plain["program"].items():
        assert d["program"][name]["device_s"] == pytest.approx(
            r["device_s"]), name
        assert d["program"][name]["calls"] == r["calls"], name
    assert d["unattributed_s"] == pytest.approx(26e-6)


def test_idle_split_and_what_no_span_claims():
    """The spans' idle seconds and the unclaimed ones make up the idle
    time of the benchmark's digest; so do the device seconds its ops."""
    d = record(program_timeline())
    dig = tracing.digest(program_timeline())
    idle = sum(r["idle_s"] for r in d["program"].values())
    assert d["unattributed_idle_s"] == pytest.approx(112e-6)
    assert idle + d["unattributed_idle_s"] == pytest.approx(
        dig["window_s"] - dig["busy_s"])
    device = sum(r["device_s"] for r in d["program"].values())
    assert device + d["unattributed_s"] == pytest.approx(
        sum(sec for _, sec in dig["ops"].values()))


def test_idle_intervals_of_the_window():
    assert program_spans._idle((0, 100), [(10, 20), (15, 30), (50, 60),
                                          (-5, 2), (95, 120)]) == [
        (2, 10), (30, 50), (60, 95)]
    assert program_spans._idle((0, 10), []) == [(0, 10)]


def test_a_trace_without_program_spans_gives_no_record():
    assert program_spans.program(timeline(), LAUNCHED) == {}


class Raw:
    """One event of the profiler's raw results."""

    def __init__(self, dev, name, cid, link, start_us):
        self._v = (dev, name, cid, link, int(start_us * 1e3) + 7_000)

    def device_type(self):
        return self._v[0]

    def name(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[2]

    def linked_correlation_id(self):
        return self._v[3]

    def start_ns(self):
        return self._v[4]


def test_launches_from_the_raw_results():
    """A device operation's launch is the runtime or driver call with its
    correlation id, linked to an operation above it or not (a launch
    through ctypes); a CPU operation whose id repeats a call's is no
    launch."""
    raw = [Raw(CPU, "aten::index", 11, 0, 20),
           Raw(CPU, "cudaLaunchKernel", 101, 11, 40),
           Raw(CPU, "aten::bmm", 102, 0, 430),              # id repeated
           Raw(CPU, "cudaMemcpyAsync", 102, 13, 440),
           Raw(CPU, "cudaLaunchKernel", 104, 0, 455),       # ctypes
           Raw(CPU, "cuLaunchKernel", 105, 0, 600),         # driver call
           Raw(CPU, "aten::add", 106, 0, 700),
           Raw(CUDA, "k", 101, 11, 105), Raw(CUDA, "Memcpy", 102, 13, 460),
           Raw(CUDA, "k", 104, 0, 500), Raw(CUDA, "k", 105, 0, 650),
           Raw(CUDA, "k", 106, 0, 720)]
    res = SimpleNamespace(trace_start_ns=lambda: 7_000, events=lambda: raw)
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=res))
    assert program_spans.launches(prof) == {101: 40.0, 102: 440.0,
                                            104: 455.0, 105: 600.0}


def test_innermost_interval():
    ivs = [(0, 10, "a"), (2, 3, "b"), (5, 8, "c"), (5, 6, "d")]
    assert program_spans._innermost(ivs, [9, 2.5, 4, 5, 7, 11, 6]) == [
        "a", "b", "a", "d", "c", None, "d"]


def ctx(digest):
    c = common.load_cell("fit-j80")
    return SimpleNamespace(cell=c, config=c.config, traffic=c.traffic,
                           digest=digest, counters={}, chips=c.chips)


def with_record(events):
    d = tracing.digest(events)
    d.update(record(events))
    return d


def test_readers():
    c = ctx(with_record(program_timeline()))
    read = {k: f(c) for k, f in program_spans.READINGS.items()}
    assert read == {"setup.eigh_ms": pytest.approx(0.2),
                    "setup.idle_ms": pytest.approx(0.105),
                    "solver.idle_ms": pytest.approx(0.432),
                    "solver.iter_calls": pytest.approx(1 / 30)}


@pytest.mark.parametrize("name", sorted(program_spans.READINGS))
def test_readers_read_nothing_without_program_spans(name):
    read = program_spans.READINGS[name]
    assert read(ctx(None)) is None
    assert read(ctx(tracing.digest(timeline()))) is None
    assert read(ctx(with_record(timeline()))) is None


def test_a_cpu_fit_gives_a_record_of_its_spans():
    """On the CPU: a tiny fit of the cell's program, the tracer on and the
    profiler recording, gives a record of every span a fit opens, and the
    idle split covers the window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import KernelSpec, build_setup, oos, ring, run_admm
    from repro_torch.obs import trace
    x = torch.randn(4, 8, 16, generator=torch.Generator().manual_seed(0))
    spec = KernelSpec()
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(tracing.WINDOW):
                with tracing.span("setup"):
                    setup = build_setup(x, ring(4, 1), spec, device="cpu")
                with tracing.span("solver"):
                    res = run_admm(setup, n_iters=3)
                with tracing.span("package"):
                    oos.from_decentralized(x, res.alpha, spec,
                                           gamma=setup.gamma, device="cpu")
    finally:
        trace.disable()
    events = prof.events()
    d = program_spans.program(events, program_spans.launches(prof))
    dig = tracing.digest(events)
    assert {k: r["n"] for k, r in d["program"].items()} == {
        "setup.build": 1, "setup.tables": 1, "setup.gamma": 1,
        "setup.gram": 1, "setup.mean_stats": 1, "setup.center": 1,
        "setup.eigh": 1, "solver.run": 1, "solver.iter": 3,
        "solver.lagrangian": 3, "package.build": 1,
        "package.mean_stats": 1}
    idle = sum(r["idle_s"] for r in d["program"].values())
    assert idle + d["unattributed_idle_s"] == pytest.approx(
        dig["window_s"] - dig["busy_s"])
