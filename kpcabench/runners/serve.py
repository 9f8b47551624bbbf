"""Scoring requests against a started ``serve.KpcaEngine``.

The model is the port's own packaging, ``core.oos.from_dual``, of support
rows and dual coefficients the benchmark draws (``data.serve_inputs``:
J*N rows of the configuration). Requests are cut from a pool of query
rows made from the seed, copied to the host, as clients send them; their
sizes come from a fixed grid (the same multiset for every seed, in an
order the seed shuffles), so every seed asks the same work.

The traffic mix's keys: ``loop`` ("closed": ``clients`` clients, each
sending its next request when its last one is answered; "open":
``rate`` requests a second, Poisson arrivals drawn from the seed, each
timed from when it was due), ``min_rows``/``max_rows`` (log-uniform
sizes), ``requests`` (the grid's length), ``pool_rows``, ``max_batch``
and ``min_bucket`` (the engine's slab widths), ``arena_factor`` (the
engine's pinned staging ring, in slabs: sized to hold every row the
clients can have outstanding, so no request falls back to an unpinned
copy), ``warm_seconds`` (traffic
sent at set-up, after the engine's own warm-up of its buckets). The
cell's: ``sample`` (requests compared with the reference),
``trace_seconds`` (a traced run's window).
"""

from __future__ import annotations

import collections
import math
import queue
import threading
import time

import numpy as np
import torch

from .. import checks, data, reference
from ..common import sample
from ..tracing import profiled
from . import Outcome
from .fit import sync_of

RESULT_TIMEOUT_S = 60.0


def sizes(traffic: dict) -> np.ndarray:
    """The grid of request sizes: ``requests`` quantiles of the
    log-uniform distribution on [min_rows, max_rows], rounded."""
    k = traffic["requests"]
    lo, hi = math.log(traffic["min_rows"]), math.log(traffic["max_rows"])
    q = (np.arange(k) + 0.5) / k
    return np.rint(np.exp(lo + q * (hi - lo))).astype(np.int64)


def requests(traffic: dict, seed: int) -> list:
    """[(offset, rows)]: the grid in the seed's order, each request a run
    of rows of the pool at an offset drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 2])
    q = rng.permutation(sizes(traffic))
    starts = rng.integers(0, traffic["pool_rows"] - q + 1)
    return list(zip(starts.tolist(), q.tolist()))


class Record:
    """One answered request: its index in the list, when it was sent (or
    due), when its answer was in hand, the answer, the engine's id."""

    __slots__ = ("index", "sent", "done", "scores", "rid")

    def __init__(self, index, sent, done, scores, rid):
        self.index, self.sent, self.done, self.scores, self.rid = \
            index, sent, done, scores, rid


def closed_loop(engine, reqs, pool, clients: int, seconds: float,
                first: int = 0):
    """``clients`` closed-loop clients for ``seconds``, each sending its
    next request when its last one is answered: client c sends requests
    ``first + c``, ``first + c + clients``, ... (cycling the list). One
    thread plays them all (a second load thread in this process would take
    the interpreter from the engine's own threads): it keeps each client's
    request outstanding and waits for the oldest, which a FIFO engine
    answers first. Returns (t0, t_end, records, errors)."""
    records, errors = [], []
    pending = collections.deque()
    t0 = time.perf_counter()
    t_end = t0 + seconds

    def send(c, k):
        i = k % len(reqs)
        off, q = reqs[i]
        sent = time.perf_counter()
        try:
            pending.append((c, k, i, sent, engine.submit(pool[off:off + q])))
        except Exception as e:              # counted as failed, not raised
            errors.append(repr(e))

    for c in range(clients):
        send(c, first + c)
    while pending:
        c, k, i, sent, fut = pending.popleft()
        try:
            got = fut.result(timeout=RESULT_TIMEOUT_S)
            records.append(Record(i, sent, time.perf_counter(), got,
                                  fut.request_id))
        except Exception as e:
            errors.append(repr(e))
        if time.perf_counter() < t_end:
            send(c, k + clients)
    return t0, t_end, records, errors


def open_loop(engine, reqs, pool, rate: float, seconds: float, seed: int):
    """Requests at Poisson arrivals of ``rate`` a second for ``seconds``,
    each timed from when it was due; one thread sends, one collects the
    answers in order. Returns (t0, t_end, records, errors, lateness
    seconds of each send)."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 3])
    gaps = rng.exponential(1.0 / rate, size=int(rate * seconds * 2) + 16)
    due = np.cumsum(gaps)
    due = due[due < seconds]
    pending = queue.Queue()
    records, errors, late = [], [], []
    t0 = time.perf_counter()
    t_end = t0 + seconds

    def sender():
        for k, d in enumerate(due):
            wait = t0 + d - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            i = k % len(reqs)
            off, q = reqs[i]
            now = time.perf_counter()
            late.append(now - (t0 + d))
            try:
                pending.put((i, t0 + d, engine.submit(pool[off:off + q])))
            except Exception as e:
                errors.append(repr(e))
        pending.put(None)

    def collector():
        while True:
            item = pending.get()
            if item is None:
                return
            i, sent, fut = item
            try:
                got = fut.result(timeout=RESULT_TIMEOUT_S)
            except Exception as e:
                errors.append(repr(e))
                continue
            records.append(Record(i, sent, time.perf_counter(), got,
                                  fut.request_id))

    threads = [threading.Thread(target=f, daemon=True)
               for f in (sender, collector)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(seconds + 2 * RESULT_TIMEOUT_S)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("the open loop's threads did not finish")
    return t0, t_end, records, errors, late


def drive(engine, reqs, pool, traffic, seconds, seed, first=0):
    if traffic["loop"] == "closed":
        return closed_loop(engine, reqs, pool, traffic["clients"], seconds,
                           first) + ([],)
    return open_loop(engine, reqs, pool, traffic["rate"], seconds, seed)


def run(cell, seed: int, seconds: float, trace: bool, device) -> Outcome:
    from repro_torch.core import KernelSpec, oos
    from repro_torch.kernels.project.project import project_tiles
    from repro_torch.serve import KpcaEngine, KpcaServeConfig
    cfg, traffic, spec = cell.config, cell.traffic, cell.spec
    sync = sync_of(device)
    t_start = time.perf_counter()
    support_rows = cfg["nodes"] * cfg["samples_per_node"]
    gen = data.generator(seed, device)
    support, coefs, qpool = data.serve_inputs(
        gen, support_rows, traffic["pool_rows"], cfg["features"],
        cfg["data"], device)
    model = oos.from_dual(support, coefs, KernelSpec(kind=cfg["kernel"]),
                          center=True, device=device)
    pool = qpool.cpu().numpy()
    reqs = requests(traffic, seed)
    t_inputs = time.perf_counter()
    engine = KpcaEngine(model, KpcaServeConfig(
        max_batch=traffic["max_batch"], min_bucket=traffic["min_bucket"],
        arena_factor=traffic["arena_factor"]), device=device)
    engine.start()                      # warms every bucket once
    t_engine = time.perf_counter()
    try:
        drive(engine, reqs, pool, traffic, traffic["warm_seconds"], seed + 1,
              first=len(reqs) // 2)
        sync()
        setup_end = time.perf_counter()
        stages = dict(model_and_inputs_s=t_inputs - t_start,
                      engine_warmup_s=t_engine - t_inputs,
                      warm_traffic_s=setup_end - t_engine)
        launches0 = project_tiles.launches
        fallback0 = engine.stats.n_arena_fallback
        cpu0 = time.process_time()
        digest = None
        if trace:
            run_out, digest = profiled(
                lambda: drive(engine, reqs, pool, traffic,
                              spec["trace_seconds"], seed), sync)
        else:
            run_out = drive(engine, reqs, pool, traffic, seconds, seed)
        t0, t_end, records, errors, late = run_out
        cpu_s = time.process_time() - cpu0
        launches = project_tiles.launches - launches0
        fallback = engine.stats.n_arena_fallback - fallback0
        mine = {r.rid for r in records}
        waits = [s.queue_wait_s for s in list(engine.stats.per_request)
                 if s.request_id in mine]
    finally:
        engine.close()
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(device).type == "cuda" else 0
    done = [r for r in records if r.done <= t_end]
    window = t_end - t0
    rows = sum(reqs[r.index][1] for r in done)
    lat = [1e3 * (r.done - r.sent) for r in done]
    e2e = dict(serve_rows_per_s=rows / window,
               serve_p95_ms=float(np.percentile(lat, 95)) if lat else None)
    found = compare(cfg, support, coefs, qpool, reqs, records,
                    spec["sample"], seed)
    del model, support, qpool
    counters = dict(rows=sum(reqs[r.index][1] for r in records),
                    requests=len(records),
                    project_launches=launches, arena_fallback=fallback,
                    host_cpu_s=cpu_s, setup_stages=stages,
                    support_rows=support_rows,
                    queue_wait_p95_ms=1e3 * float(np.percentile(waits, 95))
                    if waits else None,
                    lateness_p95_ms=1e3 * float(np.percentile(late, 95))
                    if late else None)
    return Outcome(
        setup_end=setup_end, end_to_end=e2e,
        attempted=len(records) + len(errors), failed=len(errors),
        checks=found, memory_peak_bytes=peak, counters=counters,
        digest=digest, busy_s=digest["busy_s"] if digest else None,
        window_s=digest["window_s"] if digest else None)


def compare(cfg, support, coefs, qpool, reqs, records, k, seed) -> dict:
    """The worst ``scores`` number over a sample of the answered requests
    drawn from the seed, the largest answered request among them."""
    if not records:
        return dict(scores=None)
    picks = set(sample(len(records), k, seed, 4))
    picks.add(max(range(len(records)),
                  key=lambda n: reqs[records[n].index][1]))
    ref = reference.served_model(support, coefs, reference.EXACT)
    readings = []
    for n in sorted(picks):
        off, q = reqs[records[n].index]
        want, size = reference.scores(ref, qpool[off:off + q])
        readings.append(checks.score_numbers(records[n].scores, want, size))
    return checks.worst(readings)


__all__ = ["closed_loop", "compare", "open_loop", "requests", "run",
           "sizes"]
