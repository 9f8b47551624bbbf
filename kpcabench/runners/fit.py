"""Back-to-back decentralized fits on one device.

One fit is the port's own path: ``core.admm.build_setup`` (the node Grams
in one gram launch, global centring, the batched eigensolve) ->
``core.admm.run_admm`` (the iterations over the dense transport, each
with its fused ``admm_step`` launch) -> ``core.oos.from_decentralized``
(the served model's centring statistics), ending in a synchronisation.
Every fit of a run takes a dataset that no earlier fit used, drawn at
set-up into a pool on the device (a window that outlasts the pool starts
over at its first dataset and counts those fits in ``reused``), and
starts from an ``alpha0`` the benchmark draws (eigenvector signs are the eigensolver's own, so the
program's default warm start would differ between libraries).

The fit is bound by the host's launches, and the host's speed changes by
half again for seconds at a time, so the wall time a fit takes swings
between runs by more than any bound holds. An untraced run therefore
traces its window for device activity alone and reports the device's
busy seconds a fit (``fit_device_s``); a traced run first times an
untraced window of the same length for the wall seconds a fit (the
per-layer ``fit.wall_s``), then traces ``trace_fits`` fits in full.

The traffic mix's keys: ``pool`` (datasets drawn at set-up; the first is
the warm-up fit's), ``data`` overrides of the configuration's generator
settings. The cell's: ``sample`` (fits compared with the reference),
``trace_fits`` (fits in a traced run's window).
"""

from __future__ import annotations

import contextlib
import time

import torch

from .. import checks, data, raw_trace, reference
from ..common import sample
from ..tracing import profiled, span
from . import Outcome


def program(cfg: dict):
    """The port's fit as a function of (dataset, alpha0, phase spans):
    returns the outputs that are compared (alpha, the packaged model's
    row-mean coefficient and bias)."""
    from repro_torch.core import KernelSpec, RhoSchedule, build_setup, oos
    from repro_torch.core import ring, run_admm
    graph = ring(cfg["nodes"], hops=cfg["hops"])
    spec = KernelSpec(kind=cfg["kernel"])
    rho2 = RhoSchedule(tuple(cfg["rho2"]["boundaries"]),
                       tuple(float(v) for v in cfg["rho2"]["values"]))

    def fit(x, a0, phase):
        with phase("setup"):
            setup = build_setup(x, graph, spec, center=cfg["center"],
                                device=x.device)
        with phase("solver"):
            res = run_admm(setup, n_iters=cfg["iterations"],
                           rho1=cfg["rho1"], rho2=rho2, alpha0=a0)
        with phase("package"):
            model = oos.from_decentralized(x, res.alpha, spec,
                                           gamma=setup.gamma, device=x.device)
        return res.alpha, model.row_mean_coef, model.bias
    return fit


def make_inputs(cfg: dict, traffic: dict, seed: int, device):
    """(pool of datasets (P, J, N, M), their alpha0 (P, J, N)) from the
    seed, on ``device``."""
    gen = data.generator(seed, device)
    pool = data.fit_pool(gen, traffic["pool"], cfg["nodes"],
                         cfg["samples_per_node"], cfg["features"],
                         cfg["data"], device)
    a0 = data.alpha0(gen, traffic["pool"], cfg["nodes"],
                     cfg["samples_per_node"], device)
    return pool, a0


def sync_of(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def synced(sync):
    """Phases of a traced fit: benchmark spans that synchronise before
    they close, so a device operation belongs to the span it started in."""
    @contextlib.contextmanager
    def phase(name):
        with span(name):
            yield
            sync()
    return phase


def no_phase(name):
    return contextlib.nullcontext()


def fresh(n: int, pool: int) -> int:
    """The dataset of the window's n-th fit: 1, 2, ... (0 is the warm-up
    fit's); past the pool's end the window starts over at 1 (a run
    counts those fits in ``reused``)."""
    return 1 + n % (pool - 1)


def window(fit, pool, a0, outputs: dict, seconds: float, sync):
    """Back-to-back fits, each synchronised, until ``seconds`` have passed
    at the end of one. Returns (fits, seconds)."""
    n = 0
    t0 = time.perf_counter()
    while True:
        i = fresh(n, pool.shape[0])
        outputs[i] = fit(pool[i], a0[i], no_phase)
        sync()
        n += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return n, elapsed


def compare(cfg, pool, a0, outputs: dict, picks) -> dict:
    """The worst of each number over the picked fits, each against the
    reference worked out from the fit's own dataset and alpha0."""
    readings = []
    for i in picks:
        ref = reference.fit(pool[i], a0[i], cfg, reference.EXACT)
        alpha, rmc, bias = outputs[i]
        readings.append(checks.fit_numbers(alpha, rmc, bias, ref))
    return checks.worst(readings)


def run(cell, seed: int, seconds: float, trace: bool, device) -> Outcome:
    cfg, traffic, spec = cell.config, cell.traffic, cell.spec
    sync = sync_of(device)
    on_card = torch.device(device).type == "cuda"
    t_start = time.perf_counter()
    fit = program(cfg)
    pool, a0 = make_inputs(cfg, traffic, seed, device)
    pool_size = pool.shape[0]
    sync()
    t_inputs = time.perf_counter()
    fit(pool[0], a0[0], no_phase)               # warm-up: every shape once
    sync()
    setup_end = time.perf_counter()
    stages = dict(program_and_inputs_s=t_inputs - t_start,
                  warm_fit_s=setup_end - t_inputs)
    outputs = {}
    digest = None
    end_to_end, counters = {}, {}
    if trace:
        fits, elapsed = window(fit, pool, a0, outputs, seconds, sync)
        counters["fit_wall_s"] = elapsed / fits
        phase = synced(sync)

        def traced():
            for i in range(1, 1 + spec["trace_fits"]):
                outputs[i] = fit(pool[i], a0[i], phase)
        _, digest = profiled(traced, sync)
        fits += spec["trace_fits"]
    elif on_card:
        # The tracer starts after set-up's clock has stopped and before the
        # window's starts: it is the benchmark's, not the program's.
        (fits, elapsed), busy = raw_trace.device_seconds(
            lambda: window(fit, pool, a0, outputs, seconds, sync), sync)
        end_to_end["fit_device_s"] = busy / fits
        counters["fit_wall_s"] = elapsed / fits
    else:
        fits, elapsed = window(fit, pool, a0, outputs, seconds, sync)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    picks = [sorted(outputs)[k]
             for k in sample(len(outputs), spec["sample"], seed, 1)]
    keep = {i: (pool[i].clone(), a0[i].clone()) for i in picks}
    del pool, a0
    if on_card:
        torch.cuda.empty_cache()
    found = compare(cfg, {i: v[0] for i, v in keep.items()},
                    {i: v[1] for i, v in keep.items()}, outputs, picks)
    return Outcome(
        setup_end=setup_end, end_to_end=end_to_end,
        attempted=fits, failed=0, checks=found, memory_peak_bytes=peak,
        counters=dict(counters, fits=fits,
                      reused=max(0, fits - (pool_size - 1)),
                      setup_stages=stages),
        digest=digest,
        busy_s=digest["busy_s"] if digest else None,
        window_s=digest["window_s"] if digest else None)


__all__ = ["compare", "make_inputs", "program", "run", "sync_of", "synced",
           "window"]
