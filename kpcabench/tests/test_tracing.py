"""The trace digest on a made-up timeline, and the per-layer readers on
made-up digests: what each reads, and that each reads nothing where the
run holds nothing."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from kpcabench import common, tracing
from kpcabench.work import admm_step, gram, project

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def ev(name, a, b, dev=CPU, user=False):
    return SimpleNamespace(name=name, device_type=dev, is_user_annotation=user,
                           time_range=SimpleNamespace(start=a, end=b))


def timeline():
    """A 1000 us window: a setup span (0-400 us) and a solver span
    (400-1000 us); device work 100-300 (gram), 250-350 (copy, overlapping),
    500-600 (admm_step), 700-720 (nccl); a GPU annotation (ignored)."""
    return [
        ev("kpcabench.window", 0, 1000, user=True),
        ev("kpcabench.setup", 0, 400, user=True),
        ev("kpcabench.solver", 400, 1000, user=True),
        ev("aten::linalg_eigh", 50, 350),
        ev("cudaStreamSynchronize", 360, 399),
        ev("aten::mm", 420, 900),
        ev("void gram_mma_kernel<128>(float*)", 100, 300, CUDA),
        ev("Memcpy HtoD (Pinned -> Device)", 250, 350, CUDA),
        ev("admm_step_kernel", 500, 600, CUDA),
        ev("ncclDevKernel_SendRecv", 700, 720, CUDA),
        ev("kpcabench.solver", 400, 1000, CUDA, user=True),
    ]


def test_digest():
    d = tracing.digest(timeline())
    assert d["window_s"] == pytest.approx(1e-3)
    assert d["busy_s"] == pytest.approx(370e-6)      # 100-350, 500-600, 700-720
    assert d["spans"]["setup"] == pytest.approx(
        dict(n=1, host_s=400e-6, busy_s=250e-6, calls=2))
    assert d["spans"]["solver"]["calls"] == 2
    assert d["spans"]["solver"]["busy_s"] == pytest.approx(120e-6)
    assert tracing.op_seconds(d, "gram") == pytest.approx(200e-6)
    assert tracing.op_seconds(d, "admm_step") == pytest.approx(100e-6)
    gaps = dict((k, v) for k, v in d["gaps"])
    assert sum(gaps.values()) == pytest.approx(1e-3 - 370e-6)
    assert gaps["setup: aten::linalg_eigh"] == pytest.approx(100e-6)
    assert gaps["solver: aten::mm"] == pytest.approx((150 + 100 + 280) * 1e-6)
    bd = tracing.breakdown(d)
    assert bd["device_ops"][0] == ["gram: void gram_mma_kernel<128>(float*)",
                                   pytest.approx(200e-6)]
    assert len(bd["idle_gaps"]) <= 10


def ctx(digest, cell="fit-j80", **counters):
    c = common.load_cell(cell)
    return SimpleNamespace(cell=c, config=c.config, traffic=c.traffic,
                           digest=digest, counters=counters, chips=c.chips)


def test_fit_readers():
    d = tracing.digest(timeline())
    c = ctx(d)
    read = lambda m: common.reader(m)(c)   # noqa: E731
    assert read("setup.ms") == pytest.approx(0.4)
    assert read("solver.ms") == pytest.approx(0.6)
    assert read("solver.calls_per_iter") == pytest.approx(2 / 30)
    assert read("device.idle_pct.fit") == pytest.approx(63.0)
    ops, nbytes = gram.fit(c.config)
    assert read("gram_roofline") == pytest.approx(
        100 * ops / 495e12 / 200e-6)
    ops, nbytes = admm_step.fit(c.config)
    assert read("admm_step_roofline") == pytest.approx(
        100 * nbytes / 3.35e12 / 100e-6)
    assert read("fit.wall_s") is None        # no untraced window ran
    assert common.reader("fit.wall_s")(ctx(d, fit_wall_s=0.04)) == 0.04


def test_serve_readers():
    d = tracing.digest(timeline())
    c = ctx(d, "serve-j80-bulk", rows=4096, project_launches=4,
            support_rows=8000, queue_wait_p95_ms=3.5)
    read = lambda m: common.reader(m)(c)   # noqa: E731
    assert read("serve.rows_per_slab") == 1024
    assert read("serve.queue_wait_p95_ms") == 3.5
    assert read("serve.h2d_pct") == pytest.approx(100 * 100 / 370)
    ops, _ = project.rows(4096, 8000, 784, 1)
    assert read("mfu.serve") == pytest.approx(100 * ops / (1e-3 * 495e12))
    assert read("project_roofline") is None       # no project kernel ran


def test_ring_readers():
    events = timeline()
    for e in events:
        if e.name == "kpcabench.setup":
            e.name = "kpcabench.ring"
    c = ctx(tracing.digest(events), "ring-j80-4card", fits=1, world=4)
    assert common.reader("ring.nccl_pct")(c) == pytest.approx(100 * 20 / 370)
    assert common.reader("mfu.ring")(c) > 0


BOTH = common.with_staged(common.benchmark())


@pytest.mark.parametrize("metric", BOTH["per_layer"], ids=lambda m: m["name"])
def test_readers_read_nothing_without_a_trace(metric):
    assert common.reader(metric["name"])(
        ctx(None, metric["workloads"][0])) is None


def test_train_readers():
    """Two traced steps (0-400 and 400-1000 us) and a probe (800-950) in
    them: the steps' and the probe's host time, the steps' device calls,
    the idle share and the step's share of the bf16 peak."""
    from kpcabench.work import lm_hybrid
    events = [
        ev("kpcabench.window", 0, 1000, user=True),
        ev("kpcabench.train.step", 0, 400, user=True),
        ev("kpcabench.train.step", 400, 800, user=True),
        ev("kpcabench.probe", 800, 950, user=True),
        ev("gemm", 100, 300, CUDA),
        ev("gemm", 500, 700, CUDA),
        ev("elementwise", 710, 720, CUDA),
        ev("gram_mma_kernel", 850, 900, CUDA),
    ]
    c = ctx(tracing.digest(events), "train-zamba2-1.2b")
    read = lambda m: common.reader(m)(c)   # noqa: E731
    assert read("train.step_ms") == pytest.approx(0.4)
    assert read("probe.ms") == pytest.approx(0.15)
    assert read("train.calls_per_step") == pytest.approx(1.5)
    assert read("device.idle_pct.train") == pytest.approx(54.0)
    ops = 2 * lm_hybrid.step_ops(c.config, c.traffic["batch"],
                                 c.traffic["seq"])
    assert read("mfu.train") == pytest.approx(100 * ops / (1e-3 * 989e12))


def profile_both_ways(device):
    """One small profiled window (two spans of products and a host loop
    between them) digested from ``prof.events()`` and from the raw
    results: (tracing's digest, raw_trace's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from kpcabench import raw_trace
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    x = torch.randn(256, 256, device=device)
    with profile(activities=acts) as prof:
        with record_function(tracing.WINDOW):
            for name in ("train.step", "probe"):
                with tracing.span(name):
                    for _ in range(4):
                        x = torch.tanh(x @ x)
                    float(x.sum())
    return (tracing.digest(prof.events()),
            raw_trace.digest(prof.profiler.kineto_results))


def same(a, b) -> bool:
    """Equal digests: the same keys and names, numbers to 1e-9."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return b == pytest.approx(a, rel=1e-9, abs=1e-12)
    return a == b


def test_raw_results_digest_as_the_events_do():
    """The training cell's reader of the raw results and the fit cells'
    reader of ``prof.events()`` give one digest of one trace."""
    by_events, by_raw = profile_both_ways("cpu")
    assert by_events["spans"].keys() == {"train.step", "probe"}
    assert by_events["gaps"] and same(by_raw, by_events)


@pytest.mark.gpu
def test_raw_results_digest_as_the_events_do_on_the_card():
    """The same with the card's kernels in the trace."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the profiler traces the card)")
    by_events, by_raw = profile_both_ways("cuda")
    assert by_events["busy_s"] > 0 and by_events["ops"]
    assert same(by_raw, by_events)
