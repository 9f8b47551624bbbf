"""Async kPCA serving launcher of the port: concurrent submitters against
the futures-based engine, with optional admission control (port of
``repro.launch.serve_kpca``: the same flags and the same printed lines,
and on the card one more, the launches of the hand-written kernels).

    PYTHONPATH=src python -m repro_torch.launch.serve_kpca --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve_kpca \
        --n-train 512 --submitters 4 --requests 64 --queue-factor 2

Fits a synthetic central model, starts the background flusher, then
hammers ``submit`` from several threads (one live ``refresh`` in the
middle) and reports throughput, batching efficiency, queue waits, and (with
--queue-factor) how many requests admission control refused. Runs on the
card unless ``REPRO_PLATFORM=cpu`` (``repro_torch.launch.env``).
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from ..core import oos
from ..core.kernels_math import KernelSpec
from ..data import kpca_dataset
from ..device import resolve_device
from ..faults import FaultError, transient_faults
from ..obs.cli import add_obs_args, obs_session
from ..serve import KpcaEngine, KpcaServeConfig, ModelHandle, QueueFullError
from ..serve.batching import format_latency
from .env import device_from_environ


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_obs_args(ap)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny dims for a fast sanity run")
    ap.add_argument("--n-train", type=int, default=512)
    ap.add_argument("--m", type=int, default=64)
    ap.add_argument("--components", type=int, default=2)
    ap.add_argument("--max-batch", type=int, default=128)
    ap.add_argument("--submitters", type=int, default=4)
    ap.add_argument("--requests", type=int, default=64,
                    help="requests per submitter thread")
    ap.add_argument("--max-q", type=int, default=32,
                    help="max rows per request (sizes are uniform 1..max-q)")
    ap.add_argument("--queue-factor", type=int, default=None,
                    help="admission bound = max_batch * k rows (None: off)")
    ap.add_argument("--admission", default="reject",
                    choices=["reject", "shed"])
    ap.add_argument("--flush-wait-ms", type=float, default=2.0)
    ap.add_argument("--inject-faults", type=int, default=0, metavar="N",
                    help="fault-injection demo: fail the first N engine "
                         "dispatches with InjectedCrashError and let the "
                         "retry path heal them (docs/FAULT_TOLERANCE.md)")
    ap.add_argument("--max-retries", type=int, default=None,
                    help="serve retries per drain (default: 0, or 3 when "
                         "--inject-faults is on)")
    ap.add_argument("--request-deadline-ms", type=float, default=None,
                    help="per-request submit->serve budget; expired "
                         "requests fail with DeadlineExceededError")
    args = ap.parse_args(argv)
    if args.smoke:
        args.n_train, args.m, args.requests = 128, 16, 16
    try:
        device = resolve_device(device_from_environ())
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"serve_kpca: {e}") from None
    with obs_session(args):
        _run(args, device)


def _run(args, device):
    x = kpca_dataset(args.n_train, m=args.m, seed=0)
    model = oos.fit_central(x, KernelSpec(kind="rbf"),
                            n_components=args.components, center=True,
                            device=device)
    retries = args.max_retries if args.max_retries is not None \
        else (3 if args.inject_faults else 0)
    cfg = KpcaServeConfig(max_batch=args.max_batch,
                          queue_factor=args.queue_factor,
                          admission=args.admission,
                          flush_max_wait_s=args.flush_wait_ms / 1e3,
                          max_retries=retries,
                          retry_backoff_s=0.005,
                          request_deadline_s=(
                              args.request_deadline_ms / 1e3
                              if args.request_deadline_ms is not None
                              else None))
    handle = ModelHandle(model)
    inject = (transient_faults(args.inject_faults)
              if args.inject_faults else None)
    eng = KpcaEngine(handle, cfg, device=device, inject_fault=inject)
    # warm every bucket through a fault-free twin so injected faults hit
    # the measured run, not the warm-up
    warm = KpcaEngine(handle, cfg, device=device)
    for b in cfg.buckets():
        warm.project_many([np.zeros((b, args.m), np.float32)])
    eng.stats = type(eng.stats)()

    # No lock: each submitter thread writes ONLY its own slot (index tid),
    # and the main thread reads after join() — per-slot thread affinity.
    rejected = [0] * args.submitters
    futures = [[] for _ in range(args.submitters)]

    def submitter(tid: int):
        rng = np.random.default_rng(tid)
        for _ in range(args.requests):
            q = int(rng.integers(1, args.max_q + 1))
            xq = rng.normal(size=(q, args.m)).astype(np.float32)
            try:
                futures[tid].append(eng.submit(xq))
            except QueueFullError:
                rejected[tid] += 1

    t0 = time.perf_counter()
    with eng:                                      # flusher thread runs here
        threads = [threading.Thread(target=submitter, args=(i,))
                   for i in range(args.submitters)]
        for t in threads:
            t.start()
        # One live publish while submitters hammer: same coefficients, so
        # scores are unchanged, but the refresh -> atomic-swap path runs
        # under real load (in-flight flushes finish on the old version,
        # the next drain picks up the new one).
        version = handle.refresh(model.coefs)
        for t in threads:
            t.join()
        done, faulted = [], 0
        for fs in futures:
            for f in fs:
                try:
                    done.append(f.result(timeout=60.0))
                except FaultError:             # typed, never a hang
                    faulted += 1
    dt = time.perf_counter() - t0

    st = eng.stats
    p50, p99 = st.latency_percentiles()
    waits = [r.queue_wait_s for r in st.per_request] or [0.0]
    print(f"served {st.n_queries} queries / {st.n_requests} requests "
          f"({len(done)} futures) in {dt:.2f}s "
          f"-> {st.n_queries / max(dt, 1e-9):.0f} q/s wall")
    print(f"flushes={st.n_flushes} compiles={st.n_compiles} "
          f"pad_rows={st.n_padded} "
          f"pad_frac={st.n_padded / max(st.n_queries + st.n_padded, 1):.2f} "
          f"model_version={version}")
    print(f"compute p50={format_latency(p50)} p99={format_latency(p99)}  "
          f"queue-wait p50={format_latency(np.percentile(waits, 50))} "
          f"p99={format_latency(np.percentile(waits, 99))}")
    if args.queue_factor is not None:
        print(f"admission: bound={cfg.queue_capacity()} rows "
              f"policy={args.admission} rejected={sum(rejected)} "
              f"shed={st.n_shed}")
    if args.inject_faults or args.request_deadline_ms is not None:
        print(f"faults: injected={args.inject_faults} "
              f"retries={st.n_retries} "
              f"deadline_expired={st.n_deadline_expired} "
              f"faulted_futures={faulted}")
    if device.type == "cuda":
        # the hand-written kernels this process launched (fit, warm-up and
        # the served stream); the CPU runs their plain versions instead
        from ..kernels import (admm_local_update, center_tiles, gram_tiles,
                               project_tiles)
        print(f"launches: gram={gram_tiles.launches} "
              f"project={project_tiles.launches} "
              f"center={center_tiles.launches} "
              f"admm_step={admm_local_update.launches}")


if __name__ == "__main__":
    main()
