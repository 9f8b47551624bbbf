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
