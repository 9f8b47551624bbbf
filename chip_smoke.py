#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA card and nvcc. Phases, each printing one JSON line:

  device   card name, count, and nvidia-smi's name + power limit;
  build    nvcc build of every kernel source (src/repro_torch/kernels/csrc),
           and the count of wgmma (HGMMA) instructions per kernel function
           (gram's and project's must hold some);
  kernels  each hand-written kernel against its plain PyTorch version on the
           card at the main path's shapes: max abs error, kernel / plain /
           library times per call (CUDA events over back-to-back calls,
           host launch cost included; for gram and center, every launch of
           the op), the kernels' own device time (a torch.profiler trace),
           and the least time the card could take (bytes over 3.35 TB/s, or
           operations over 67 TFLOP/s fp32, or for gram and project 3 x TF32
           products over 495 TFLOP/s, a self-Gram counting n(n+1)/2 pairs);
           gram and project are also held to fp32 grade (within 2x the plain
           version's error against float64);
  fit      the paper's Fig. 3/5 configuration: J=20 nodes x N=100 samples x
           M=784, ring(20, hops=2), global centering, 30 ADMM iterations,
           central kPCA on the pooled 2000 x 784; similarity at 1/10/30;
  serve    from_decentralized -> save/load -> compress(500), then the batched
           engine answers 3/17/64/128/200-row requests on both models; each
           request is held against the plain projection on the card;
  baselines  the paper's Fig. 4 and Fig. 5 baselines on the same data:
           local_kpca (one kPCA per node) and neighborhood_kpca (one per
           500-sample neighbourhood), mean similarity to central kPCA beside
           the ADMM's at iteration 30; the paper's ordering ADMM@30 >
           neighbourhood > local is checked;
  topk     run_admm_topk(k=2, n_iters=30) at the same size: the first
           component's similarity, the 2-D subspace's alignment inside the
           central top-3, the second component's similarity to central
           component 1 (tests/test_deflation.py's limits); then the C = 2
           model and its 500-landmark compression served through the engine,
           each request held against the plain projection;
  breakdown  setup, ADMM, central kPCA, baselines and top-k once more, warm:
           wall time, then device time, device calls, idle share and top
           kernels from a torch.profiler trace;
  serve_stream  sustained serving on both models: 4096 requests of 1-256
           rows (log-uniform) in drains of 32, timed and then traced over
           the whole stream: queries/s, drain latency p50/p99, device time
           (all of it, and the project kernels'), idle share; every score
           held against the plain projection.

Each path (fit and serve; baselines; top-k) is driven with every kernel's
launch count zeroed just before it and read just after; a kernel the path
must run and never launched fails the run (the kernels, breakdown and
stream phases count nowhere). The summary's ``launches`` is the fit and
serve path's. The last lines are the kernels summary object, the
nvidia-smi line, and
``{"ok": true, "device": {...}}``. A failed check is reported and the run
goes on, so one run shows every phase; it then exits non-zero before the
summary. An exception (a failed build, a launch error) ends the run at
once, as does a missing CUDA device or a missing repository beside the
script. It imports nothing of JAX or of the JAX package.
"""

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_FP32_FLOPS = 67e12        # H100 SXM, fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12       # H100 SXM, dense TF32 on the tensor cores
PEAK_BYTES = 3.35e12           # H100 SXM HBM3
TOL = 2e-4                     # kernel vs plain and engine vs plain
SPLIT_KERNEL = "tf32_split_kernel"   # the 3xTF32 split gram, project share
TOLERANCE = ("|kernel - plain| <= 2e-4 * max(1, |plain|): absolute for the "
             "kernel values and scores (all below 1 here), relative for the "
             "raw kernel row-sums of project_partial_op (several hundred "
             "here)")
SIM30_MIN = 0.99
STREAM_REQUESTS = 4096         # sustained serving: requests per stream
STREAM_PER_DRAIN = 32          # requests submitted between two flushes
STREAM_POOL = 8192             # query rows the stream's requests are cut from


class SmokeFailure(RuntimeError):
    pass


FAILURES = []


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    """Record a failed check and go on, so one run shows every phase; the
    run fails before the summary if any check failed."""
    if not cond:
        FAILURES.append(msg)
        print(f"chip_smoke: check failed: {msg}", file=sys.stderr, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def event_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls, timed
    with CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(torch, fn, iters: int = 10) -> dict:
    """Milliseconds per call that the card spent in each device kernel or
    copy, from a ``torch.profiler`` trace of ``iters`` calls (no host launch
    overhead)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / iters / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0}


def device_ms(torch, fn, kernels, iters: int = 10):
    """Mean milliseconds per call that the card spent in the named kernels;
    None where the trace holds no device time."""
    total = sum(ms for key, ms in device_kernels(torch, fn, iters).items()
                if any(k in key for k in kernels))
    return total or None


def errors(got, want) -> dict:
    """Max absolute error, and the error scaled by max(1, |plain|) that the
    tolerance is stated on."""
    import torch
    diff = (got - want).abs()
    return dict(max_abs_err=float(diff.max()), max_scaled_err=float(
        (diff / torch.clamp(want.abs(), min=1.0)).max()))


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def hgmma_by_function(sass: str) -> dict:
    """wgmma (HGMMA) instructions per kernel function of ``cuobjdump -sass``
    output, by demangled name where c++filt is at hand."""
    counts, func = {}, None
    for ln in sass.splitlines():
        if "Function : " in ln:
            func = ln.split("Function : ", 1)[1].strip()
            counts[func] = 0
        elif func is not None and "HGMMA" in ln:
            counts[func] += 1
    try:
        names = subprocess.run(["c++filt"], input="\n".join(counts),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
    except OSError:
        names = []
    if len(names) != len(counts):
        names = list(counts)
    return dict(zip(names, counts.values()))


def gram_record(spec, x, g, label, y=None):
    """What ``gram_op`` launches on the card (split passes and the
    tensor-core kernel) for a (Z, n, m) batch x against y (Z, k, m), or
    against x itself (y=None: symmetric tiles, K must equal K^T exactly)."""
    import torch
    from repro_torch.kernels import gram_reference, gram_tiles

    def run():
        return gram_tiles(spec, x, y, g)

    got = run()
    want = gram_reference(spec, x, y, gamma=g)
    torch.cuda.synchronize()
    cross = y is not None
    yy = y if cross else x
    (z, n, m), k = x.shape, yy.shape[1]
    if not cross:
        check(torch.equal(got, got.mT), f"gram {label}: self-Gram not "
                                        f"exactly symmetric")
    pairs = z * n * k if cross else z * n * (n + 1) // 2
    nbytes = 4 * (z * n * m + cross * z * k * m + z * n * k + 1)
    b_ms, b_by = bound(flops=3 * 2 * pairs * m, nbytes=nbytes,
                       peak=PEAK_TF32_FLOPS)
    kern = device_kernels(torch, run)
    # fp32 grade: the kernel within 2x the plain fp32 version's error, both
    # against a float64 Gram of the same inputs
    exact = gram_reference(spec, x.double(), None if y is None
                           else y.double(), gamma=g.double())
    fp64_err = float((got.double() - exact).abs().max())
    fp64_err_plain = float((want.double() - exact).abs().max())
    check(fp64_err <= 2.0 * fp64_err_plain,
          f"gram {label}: error against float64 {fp64_err:.3g} > 2 x the "
          f"plain version's {fp64_err_plain:.3g}")
    return dict(
        shape=label, **errors(got, want),
        fp64_err=fp64_err, fp64_err_plain=fp64_err_plain,
        ms=event_ms(torch, run, 20),
        device_ms=sum(v for key, v in kern.items()
                      if "gram_" in key or SPLIT_KERNEL in key),
        device_kernels={key[:80]: v for key, v in kern.items()},
        plain_ms=event_ms(torch, lambda: gram_reference(spec, x, y, gamma=g),
                          20),
        library_ms=event_ms(torch, lambda: torch.exp(
            torch.cdist(x, yy).square_().mul_(-g)), 20),
        matmul_ms=event_ms(torch, lambda: torch.matmul(x, yy.transpose(1, 2)),
                           20),
        bound_ms=b_ms, bound_by=b_by,
        bound_fp32_ms=bound(flops=z * n * k * (2 * m + 4), nbytes=nbytes)[0])


def project_record(spec, model, xq):
    """The projection kernel serving ``model`` to the (B, M) batch xq, with
    the model's own coefficients and centering terms."""
    import torch
    from repro_torch.core import oos
    from repro_torch.kernels import project_reference
    (b, m), (l, c) = xq.shape, model.coefs.shape
    project = oos.projector(model)

    def run():
        return project(xq)

    def plain():
        return project_reference(spec, xq, model.x_support, model.coefs,
                                 model.row_mean_coef, model.bias, model.gamma)

    got, want = run(), plain()
    torch.cuda.synchronize()
    # fp32 grade: the kernel within 2x the plain fp32 version's error, both
    # against a float64 projection of the same inputs
    exact = project_reference(spec, *(None if t is None else t.double()
                                      for t in (xq, model.x_support,
                                                model.coefs,
                                                model.row_mean_coef,
                                                model.bias, model.gamma)))
    fp64_err = float((got.double() - exact).abs().max())
    fp64_err_plain = float((want.double() - exact).abs().max())
    check(fp64_err <= 2.0 * fp64_err_plain,
          f"project B{b}xL{l}: error against float64 {fp64_err:.3g} > 2 x "
          f"the plain version's {fp64_err_plain:.3g}")
    kern = device_kernels(torch, run)
    nbytes = 4 * (b * m + l * m + l * (c + 1) + l + b * c + 2 * c)
    # the route taken: 3 TF32 products per fp32 one on the tensor cores
    b_ms, b_by = bound(flops=3 * 2 * b * l * m, nbytes=nbytes,
                       peak=PEAK_TF32_FLOPS)
    return dict(
        shape=f"B{b}xL{l}xM{m}xC{c}", **errors(got, want),
        fp64_err=fp64_err, fp64_err_plain=fp64_err_plain,
        ms=event_ms(torch, run, 200),
        device_ms=sum(v for key, v in kern.items()
                      if "project_" in key or SPLIT_KERNEL in key),
        device_kernels={key[:80]: v for key, v in kern.items()},
        plain_ms=event_ms(torch, plain, 200),
        library_ms=None,
        matmul_ms=event_ms(torch, lambda: torch.matmul(
            xq, model.x_support.T), 200),
        bound_ms=b_ms, bound_by=b_by,
        bound_fp32_ms=bound(flops=b * l * (2 * m + 4) + 2 * b * l * (c + 1),
                            nbytes=nbytes)[0])


def center_record(k, label):
    """The centering op on k (..., n, m) at its own strides, means
    included, timed as the kernel (all of its launches); the device kernels
    of one op's trace are listed, and must all be centering kernels."""
    import torch
    from repro_torch.kernels import center_op, center_reference

    def run():
        return center_op(k)

    got = run()
    want = center_reference(k)
    torch.cuda.synchronize()
    *lead, n, m = k.shape
    z = math.prod(lead)
    b_ms, b_by = bound(flops=3 * z * n * m,
                       nbytes=4 * (2 * z * n * m))
    kern = device_kernels(torch, run)
    check(all("center_" in key for key in kern),
          f"center {label}: the op launched other kernels: {sorted(kern)}")
    ms = event_ms(torch, run, 20)
    return dict(
        shape=label, contiguous=k.is_contiguous(), **errors(got, want),
        ms=ms, op_ms=ms, device_ms=sum(kern.values()),
        device_kernels={key[:80]: v for key, v in kern.items()},
        plain_ms=event_ms(torch, lambda: center_reference(k), 20),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


def admm_record(setup, label):
    """The fused local update on the operands the solver hands it at
    iteration 6 of the fit (the eigenvectors, node Grams and inverse
    denominators of the setup, the live duals and z projections of five
    iterations, the schedule's rho)."""
    import torch
    from repro_torch.core import dense_parts, init_state, initial_alpha
    from repro_torch.core.rho import RhoSchedule
    from repro_torch.core.solver import (admm_step, inverse_denominators,
                                         slot_rho)
    from repro_torch.kernels import (admm_local_update,
                                     admm_local_update_reference)
    ops, comm = dense_parts(setup)
    state = init_state(initial_alpha(setup), setup.n_slots)
    for t in range(5):
        state, _ = admm_step(ops, comm, state,
                             slot_rho(ops.mask, 100.0, RhoSchedule().at(t)))
    j, n, s = ops.k.shape[0], ops.k.shape[1], ops.mask.shape[1]
    rho = slot_rho(ops.mask, 100.0, RhoSchedule().at(5))
    inv = inverse_denominators(ops.lam, torch.sum(rho, dim=1))
    ins = (ops.vec, inv[..., None].contiguous(), ops.k,
           state.b * ops.mask[:, None, :], state.g,
           rho[:, None, :].contiguous())

    def run():
        return admm_local_update(*ins)

    got, want = run(), admm_local_update_reference(*ins)
    torch.cuda.synchronize()
    errs = [errors(a, w) for a, w in zip(got, want)]
    b_ms, b_by = bound(flops=j * (6 * n * n + n + 5 * n * s),
                       nbytes=4 * (2 * j * n * n + 3 * j * n + 3 * j * n * s
                                   + j * s))
    return dict(
        shape=label, max_abs_err=max(e["max_abs_err"] for e in errs),
        max_scaled_err=max(e["max_scaled_err"] for e in errs),
        ms=event_ms(torch, run, 100),
        device_ms=device_ms(torch, run, ("admm_step_kernel",)),
        plain_ms=event_ms(torch, lambda: admm_local_update_reference(*ins),
                          100),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


def phase_kernels(dev, spec, nodes, pooled, gamma):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    from repro_torch.core import build_setup, oos, ring
    from repro_torch.core.kernels_math import gram
    from repro_torch.data import kpca_dataset
    from repro_torch.kernels import (project_partial_op,
                                     project_partial_reference)
    g = torch.as_tensor(gamma, dtype=torch.float32, device=dev).reshape(())
    ids, _, _ = ring(20, 2).neighbor_array()
    src = torch.as_tensor([[j, *ids[j]] for j in range(20)], device=dev)
    # the setup phase's batch: every node's 5 slots of 100 samples stacked
    slots = torch.as_tensor(nodes, device=dev)[src].reshape(20, 500, 784)
    pooled_t = torch.as_tensor(pooled, device=dev)
    # cross Grams: one node's block against the pooled set (similarity),
    # and 500 landmarks against it (compress)
    marks = pooled_t[torch.as_tensor(oos.landmark_schedule(2000)[:500],
                                     device=dev)]
    records = {"gram": [
        gram_record(spec, slots.contiguous(), g, "20x500x500x784"),
        gram_record(spec, pooled_t[None].contiguous(), g, "2000x2000x784"),
        gram_record(spec, pooled_t[None, :100].contiguous(), g,
                    "100x2000x784", y=pooled_t[None].contiguous()),
        gram_record(spec, marks[None].contiguous(), g, "500x2000x784",
                    y=pooled_t[None].contiguous())]}

    # project: the served models' real coefficients and centering terms (a
    # central fit on the pooled data, and its 500-landmark compression)
    full = oos.fit_central(pooled_t, spec, gamma=g, device=dev)
    small, _ = oos.compress(full, 500, seed=0)
    queries = torch.as_tensor(kpca_dataset(128, m=784, seed=7), device=dev)
    records["project"] = [project_record(spec, model, queries[:b])
                          for model in (small, full) for b in (8, 128)]
    # project_partial_op: raw partials with an indicator column (rows past
    # 1500 play a shard's padding)
    ext = torch.cat([full.coefs, torch.ones((2000, 1), device=dev)], dim=1)
    ext[1500:, -1] = 0.0
    got = project_partial_op(spec, queries, full.x_support, ext,
                             gamma=full.gamma)
    want = project_partial_reference(spec, queries, full.x_support, ext,
                                     gamma=full.gamma)
    torch.cuda.synchronize()
    records["partial"] = [dict(shape="B128xL2000xM784xC1",
                               **errors(got, want))]

    # centering on real Grams: central kPCA's (and the similarity metric's)
    # pooled 2000 x 2000, the setup's 20 x 500 x 500 slot Grams as one
    # contiguous batch and as the strided (J, S, S, N, N) block view that
    # center="block" centres, local_kpca's 20 x 100 x 100 batch and one
    # neighbourhood's 500 x 500
    k_slots = gram(spec, slots.contiguous(), gamma=g)
    records["center"] = [
        center_record(gram(spec, pooled_t, gamma=g), "2000x2000"),
        center_record(k_slots, "20x500x500"),
        center_record(k_slots.reshape(20, 5, 100, 5, 100)
                      .permute(0, 1, 3, 2, 4), "20x5x5x100x100 strided"),
        center_record(gram(spec, torch.as_tensor(nodes, device=dev),
                           gamma=g), "20x100x100"),
        center_record(k_slots[0], "500x500")]
    # the fused update on the fit's own setup
    setup = build_setup(nodes, ring(20, hops=2), spec, center="global",
                        gamma=g, device=dev)
    records["admm_step"] = [admm_record(setup, "J20xN100xS5")]
    emit("kernels", tolerance=TOLERANCE, records=records)
    for name, recs in records.items():
        worst = max(r["max_scaled_err"] for r in recs)
        check(worst <= TOL, f"{name} kernel disagrees with its plain version:"
                            f" max |err| / max(1, |plain|) {worst:.3g} > {TOL}")
    return records


def mean_similarity(alphas, x_nodes, pooled, alpha_gt, spec, gamma):
    """Mean and least similarity to central kPCA over the nodes (alphas[j]
    a direction on the data x_nodes[j])."""
    from repro_torch.core import similarity
    sims = [float(similarity(alphas[j], x_nodes[j], alpha_gt, pooled, spec,
                             gamma=gamma))
            for j in range(len(x_nodes))]
    return sum(sims) / len(sims), min(sims)


def launch_counters() -> dict:
    from repro_torch.kernels import (admm_local_update, center_tiles,
                                     gram_tiles, project_tiles)
    return {"gram": gram_tiles, "project": project_tiles,
            "center": center_tiles, "admm_step": admm_local_update}


def zero_launches() -> None:
    import torch
    torch.cuda.synchronize()
    for wrapper in launch_counters().values():
        wrapper.launches = 0


def read_launches(path: str, needed) -> dict:
    """Every kernel's launches since ``zero_launches``; a kernel in
    ``needed`` that never launched on this path fails the run."""
    counts = {name: w.launches for name, w in launch_counters().items()}
    missing = [name for name in needed if counts[name] == 0]
    check(not missing, f"{path}: kernel(s) {missing} never launched: "
                       f"{counts}")
    return counts


def serve_requests(dev, models, requests, label) -> dict:
    """Every request through the batched engine on each model, each held
    against the plain projection on the card."""
    import torch
    from repro_torch.kernels import project_reference
    from repro_torch.serve import KpcaEngine, KpcaServeConfig
    out = {}
    for name, mdl in models:
        engine = KpcaEngine(mdl, KpcaServeConfig(max_batch=128,
                                                 min_bucket=8), device=dev)
        t0 = time.perf_counter()
        outs = engine.project_many(requests)
        wall = time.perf_counter() - t0
        errs = []
        for req, got in zip(requests, outs):
            want = project_reference(
                mdl.spec, torch.as_tensor(req, device=dev), mdl.x_support,
                mdl.coefs, mdl.row_mean_coef, mdl.bias, mdl.gamma)
            check(got.shape == (req.shape[0], mdl.n_components),
                  f"{label} ({name}): bad shape {got.shape}")
            errs.append(float(abs(got - want.cpu().numpy()).max()))
        rows = sum(r.shape[0] for r in requests)
        out[name] = dict(support=mdl.n_support,
                         components=mdl.n_components, max_abs_err=max(errs),
                         queries=rows, wall_s=wall,
                         queries_per_s_wall=rows / wall,
                         queries_per_s_device=engine.stats.queries_per_s,
                         padded_rows=engine.stats.n_padded)
        check(max(errs) <= TOL, f"{label} engine ({name}) disagrees with the"
                                f" plain projection: {max(errs):.3g} > {TOL}")
    return out


def phase_baselines(dev, spec, setup, alpha_gt, admm30) -> dict:
    """Fig. 4 and Fig. 5 baselines on the fit's data and bandwidth, beside
    the ADMM's similarity at iteration 30."""
    import torch
    from repro_torch.core import local_kpca, neighborhood_kpca, ring
    x_nodes = setup.x
    pooled = x_nodes.reshape(-1, x_nodes.shape[-1])
    zero_launches()
    t0 = time.perf_counter()
    loc = local_kpca(x_nodes, spec, gamma=setup.gamma, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    nb = neighborhood_kpca(x_nodes, ring(20, hops=2), spec,
                           gamma=setup.gamma, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    local = mean_similarity(loc[..., 0], x_nodes, pooled, alpha_gt, spec,
                            setup.gamma)
    nei = mean_similarity([a[:, 0] for a, _ in nb], [xc for _, xc in nb],
                          pooled, alpha_gt, spec, setup.gamma)
    counts = read_launches("baselines", ("gram", "center"))
    emit("baselines", similarity_mean=dict(
        admm_30=admm30[0], neighborhood=nei[0], local=local[0]),
         similarity_min=dict(admm_30=admm30[1], neighborhood=nei[1],
                             local=local[1]),
         local_s=t1 - t0, neighborhood_s=t2 - t1, launches=counts)
    check(admm30[0] > nei[0] > local[0],
          f"baseline ordering ADMM@30 > neighbourhood > local fails: "
          f"{admm30[0]:.5f}, {nei[0]:.5f}, {local[0]:.5f}")
    return counts


def phase_topk(dev, spec, setup, nodes, requests) -> dict:
    """Top-2 by deflation at the fit's size, held to tests/test_deflation.py's
    limits, then packaged as a C = 2 model and served."""
    import torch
    from repro_torch.core import (central_kpca, oos, run_admm_topk,
                                  subspace_alignment)
    x_nodes = setup.x
    pooled = x_nodes.reshape(-1, x_nodes.shape[-1])
    zero_launches()
    t0 = time.perf_counter()
    alphas = run_admm_topk(setup, k=2, n_iters=30)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gt, lam3, _ = central_kpca(pooled, spec, 3, gamma=setup.gamma,
                               device=dev)
    first = mean_similarity(alphas[0], x_nodes, pooled, gt[:, 0], spec,
                            setup.gamma)
    second = mean_similarity(alphas[1], x_nodes, pooled, gt[:, 0], spec,
                             setup.gamma)
    align = [float(subspace_alignment(
        torch.stack([alphas[0][j], alphas[1][j]], dim=1), x_nodes[j],
        gt[:, :3], pooled, spec, gamma=setup.gamma))
        for j in range(x_nodes.shape[0])]
    model = oos.from_decentralized(nodes, alphas, spec, gamma=setup.gamma,
                                   device=dev)
    compressed, rel_err = oos.compress(model, 500, seed=0)
    served = serve_requests(dev, (("full", model),
                                  ("compressed", compressed)), requests,
                            "topk")
    counts = read_launches("topk", ("gram", "project", "center",
                                    "admm_step"))
    emit("topk", k=2, iterations=30, topk_s=t1 - t0,
         first_similarity_mean=first[0], first_similarity_min=first[1],
         alignment_mean=sum(align) / len(align), alignment_min=min(align),
         second_vs_first_mean=second[0],
         central_lambda=[float(v) for v in lam3],
         compress_rel_err=[float(v) for v in rel_err], models=served,
         launches=counts)
    check(first[0] >= SIM30_MIN, f"top-k first component similarity "
                                 f"{first[0]:.4f} < {SIM30_MIN}")
    check(sum(align) / len(align) > 0.85,
          f"top-k alignment {sum(align) / len(align):.4f} <= 0.85")
    check(second[0] < 0.5, f"top-k second component similarity to central "
                           f"component 1 {second[0]:.4f} >= 0.5")
    return counts


def timed_and_traced(torch, fn, calls_by_kernel: bool = False,
                     kernels_of: tuple = ()):
    """One warm run of ``fn``, one on the host clock, then one under
    ``torch.profiler``. Returns (the timed run's result, its wall seconds,
    and the traced run's device time, its count of device calls — kernel
    launches and copies —, the card's idle share of the untraced wall time,
    and the five kernels that took the most device time; with
    ``calls_by_kernel``, every device kernel's and copy's call count; with
    ``kernels_of``, the device seconds of the kernels whose name holds one
    of its strings, under the first one's name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted(((e.device_time_total, e.key, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kernels) / 1e6
    trace = dict(
        device_s=busy if kernels else None,
        device_calls=sum(k[2] for k in kernels),
        idle_share=1.0 - busy / wall if kernels else None,
        top=[dict(kernel=key[:70], calls=n, ms=us / 1e3)
             for us, key, n in kernels[:5]])
    if kernels_of:
        trace[f"{kernels_of[0]}device_s"] = sum(
            us for us, key, _ in kernels
            if any(k in key for k in kernels_of)) / 1e6
    if calls_by_kernel:
        trace["calls_by_kernel"] = [
            dict(kernel=key[:90], calls=n)
            for n, key in sorted(((n, key) for _, key, n in kernels),
                                 reverse=True)]
    return out, wall, trace


def phase_breakdown(torch, fn, calls_by_kernel: bool = False) -> dict:
    """A phase's warm wall time, device time, idle share and top kernels."""
    _, wall, trace = timed_and_traced(torch, fn, calls_by_kernel)
    return dict(wall_s=wall, **trace)


def stream_requests(n_requests: int, seed: int = 11):
    """A served stream: ``n_requests`` (Q, 784) requests, Q log-uniform in
    [1, 256] (single queries to two full slabs), cut from one pool of
    queries made in bulk."""
    import numpy as np
    from repro_torch.data import kpca_dataset
    rng = np.random.default_rng(seed)
    sizes = np.rint(np.exp(rng.uniform(0.0, np.log(256.0), n_requests)))
    sizes = sizes.astype(np.int64).clip(1, 256)
    pool = kpca_dataset(STREAM_POOL, m=784, seed=seed)
    starts = rng.integers(0, STREAM_POOL - sizes + 1)
    return [pool[s0:s0 + q] for s0, q in zip(starts, sizes)]


def drain_stream(engine, requests, per_drain: int):
    """Submit the stream ``per_drain`` requests at a time and flush each
    group: returns every request's scores and each drain's wall seconds
    (submit to results; in the synchronous engine that is each of its
    requests' latency)."""
    outs, drains = [], []
    for i in range(0, len(requests), per_drain):
        t0 = time.perf_counter()
        futs = [engine.submit(x) for x in requests[i:i + per_drain]]
        engine.flush()
        outs.extend(f.result() for f in futs)
        drains.append(time.perf_counter() - t0)
    return outs, drains


def phase_serve_stream(dev, models) -> None:
    """Sustained serving: STREAM_REQUESTS mixed-size requests in drains of
    STREAM_PER_DRAIN, per model; steady-state wall time, drain latency,
    device time and idle share over the whole stream, every score held
    against the plain projection on the card."""
    import numpy as np
    import torch
    from repro_torch.kernels import project_reference
    from repro_torch.serve import KpcaEngine, KpcaServeConfig
    requests = stream_requests(STREAM_REQUESTS)
    rows = sum(x.shape[0] for x in requests)
    flat = np.concatenate(requests)
    out = {}
    from repro_torch.kernels import project_tiles
    for name, mdl in models:
        engine = KpcaEngine(mdl, KpcaServeConfig(max_batch=128,
                                                 min_bucket=8), device=dev)
        before = project_tiles.launches
        (scores, drains), wall, trace = timed_and_traced(
            torch, lambda: drain_stream(engine, requests, STREAM_PER_DRAIN),
            kernels_of=("project_", SPLIT_KERNEL))
        # timed_and_traced drains the stream three times (warm, timed,
        # traced); the launches of one pass
        project_launches = (project_tiles.launches - before) // 3
        got = np.concatenate(scores)
        err = 0.0
        for i in range(0, rows, 16384):
            want = project_reference(
                mdl.spec, torch.as_tensor(flat[i:i + 16384], device=dev),
                mdl.x_support, mdl.coefs, mdl.row_mean_coef, mdl.bias,
                mdl.gamma).cpu().numpy()
            err = max(err, float(np.abs(got[i:i + 16384] - want).max()))
        check(got.shape == (rows, mdl.n_components) and err <= TOL,
              f"stream ({name}) disagrees with the plain projection: "
              f"{err:.3g} > {TOL}")
        stats = engine.stats
        drain_ms = np.asarray(drains) * 1e3
        out[name] = dict(
            support=mdl.n_support, max_abs_err=err, wall_s=wall,
            queries_per_s=rows / wall, requests_per_s=len(requests) / wall,
            drain_ms_p50=float(np.percentile(drain_ms, 50)),
            drain_ms_p99=float(np.percentile(drain_ms, 99)),
            drain_ms_max=float(drain_ms.max()),
            padded_share=stats.n_padded / (stats.n_queries + stats.n_padded),
            project_launches=project_launches, **trace)
    emit("serve_stream", requests=len(requests), rows=rows,
         drains=-(-len(requests) // STREAM_PER_DRAIN),
         per_drain=STREAM_PER_DRAIN, max_batch=128, min_bucket=8,
         models=out)


def warm_start_split(vec, lam, x_nodes, alpha_gt, spec, gamma) -> int:
    """Nodes whose init="local" warm start v1/sqrt(lam1) points against the
    central component, counted on the smaller side (the global sign is
    arbitrary; only a split between nodes slows the consensus)."""
    import torch
    from repro_torch.core.kernels_math import center_gram_global, gram
    pooled = x_nodes.reshape(-1, x_nodes.shape[-1])
    k_g = gram(spec, pooled, gamma=gamma)
    neg = 0
    for j in range(x_nodes.shape[0]):
        a0 = vec[j, :, -1] / torch.sqrt(lam[j, -1])
        k_jx = gram(spec, x_nodes[j], pooled, gamma=gamma)
        kc = center_gram_global(k_jx, k_jx, k_g, k_g)
        neg += int(float(a0 @ kc @ alpha_gt) < 0)
    return min(neg, x_nodes.shape[0] - neg)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch sees no CUDA device")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SmokeFailure(f"no src/repro_torch beside {Path(__file__).name}:"
                           f" run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda")

    # -- device --------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    emit("device", kind=kind, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- build ---------------------------------------------------------------
    from repro_torch.kernels import _build
    info = _build.build(force=True)
    _build.load_library()
    usage = [ln.split("info    : ", 1)[-1] for ln in info.log.splitlines()
             if "Used" in ln or "spill" in ln]
    # gram and project must run on the tensor cores: wgmma is HGMMA in SASS
    sass = subprocess.run(
        [str(Path(_build.nvcc_path()).parent / "cuobjdump"), "-sass",
         str(info.path)], capture_output=True, text=True, timeout=120).stdout
    hgmma = hgmma_by_function(sass)
    emit("build", seconds=info.seconds, library=str(info.path.relative_to(
        ROOT)), sources=[str(p.relative_to(ROOT)) for p in _build.sources()],
        ptxas=usage, hgmma_instructions=sum(hgmma.values()),
        hgmma_by_function=hgmma)
    for kernel in ("gram_mma_kernel", "project_partials_kernel"):
        check(any(kernel in f and n > 0 for f, n in hgmma.items()),
              f"no wgmma (HGMMA) instruction in {kernel}")

    from repro_torch.core import (KernelSpec, build_setup, central_kpca,
                                  local_kpca, neighborhood_kpca, oos, ring,
                                  run_admm, run_admm_topk)
    from repro_torch.core.kernels_math import resolve_gamma
    from repro_torch.data import kpca_dataset, node_dataset
    spec = KernelSpec(kind="rbf")
    nodes, pooled = node_dataset(20, 100, m=784, seed=0)

    # -- kernels -------------------------------------------------------------
    gamma = resolve_gamma(spec, torch.as_tensor(pooled, device=dev))
    records = phase_kernels(dev, spec, nodes, pooled, gamma)

    # -- main path: fit, then serve (launch counts zeroed just before) -------
    zero_launches()
    t0 = time.perf_counter()
    setup = build_setup(nodes, ring(20, hops=2), spec, center="global",
                        device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = run_admm(setup, n_iters=30)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    alpha_gt, lam_gt, _ = central_kpca(pooled, spec, 1, gamma=setup.gamma,
                                       device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    x_nodes = setup.x
    pooled_t = x_nodes.reshape(2000, 784)
    sims = {}
    for it in (1, 10, 30):
        sims[it] = mean_similarity(res.alpha_hist[it - 1], x_nodes,
                                   pooled_t, alpha_gt[:, 0], spec,
                                   setup.gamma)
    # init="local" keys on the node Grams' eigenvector signs: cuSOLVER's
    # against LAPACK's on the same matrices, and how many nodes' warm starts
    # point against the central component under each (on the CPU, so no
    # kernel launch of this diagnostic counts as the main path's).
    k_cpu = setup.k.cpu()
    lam_cpu, vec_cpu = torch.linalg.eigh(k_cpu)
    agree = int(torch.sum(torch.einsum(
        "jn,jn->j", setup.vec[:, :, -1].cpu(), vec_cpu[:, :, -1]) > 0))
    split = {src: warm_start_split(vec.cpu(), lam.cpu(), x_nodes.cpu(),
                                   alpha_gt[:, 0].cpu(), spec,
                                   setup.gamma.cpu())
             for src, vec, lam in (("card", setup.vec, setup.lam),
                                   ("cpu", vec_cpu, lam_cpu))}
    check(bool(torch.isfinite(res.alpha_hist).all()), "non-finite alpha")
    emit("fit", nodes=20, per_node=100, features=784, neighbors=4,
         iterations=30, gamma=float(setup.gamma),
         similarity_mean={str(k): v[0] for k, v in sims.items()},
         similarity_min={str(k): v[1] for k, v in sims.items()},
         primal_residual_30=float(res.primal_residual[-1]),
         central_lambda1=float(lam_gt[0]),
         eigh_top_sign_agrees_with_cpu=f"{agree}/20",
         warm_starts_against_the_rest=split,
         setup_s=t1 - t0, admm_s=t2 - t1, central_s=t3 - t2)
    check(sims[30][0] >= SIM30_MIN,
          f"similarity@30 {sims[30][0]:.4f} < {SIM30_MIN}")

    model = oos.from_decentralized(nodes, res.alpha, spec,
                                   gamma=setup.gamma, device=dev)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt:
        oos.save_fitted(ckpt, model)
        loaded = oos.load_fitted(ckpt, device=dev)
    check(torch.equal(loaded.coefs, model.coefs)
          and torch.equal(loaded.x_support, model.x_support),
          "save_fitted/load_fitted round trip changed the model")
    compressed, rel_err = oos.compress(loaded, 500, seed=0)
    sizes = (3, 17, 64, 128, 200)
    requests = [kpca_dataset(q, m=784, seed=100 + q) for q in sizes]
    serve = serve_requests(dev, (("full", loaded),
                                 ("compressed", compressed)), requests,
                           "serve")
    launches = read_launches("fit and serve", ("gram", "project", "center",
                                               "admm_step"))
    emit("serve", requests=list(sizes), models=serve,
         compress_rel_err=float(rel_err[0]), launches=launches)

    # -- the paper's baselines, then top-k (each path its own counts) -------
    path_launches = {
        "fit_and_serve": launches,
        "baselines": phase_baselines(dev, spec, setup, alpha_gt[:, 0],
                                     sims[30]),
        "topk": phase_topk(dev, spec, setup, nodes, requests)}
    check("jax" not in sys.modules and not any(
        k == "repro" or k.startswith("repro.") for k in sys.modules),
        "the JAX package was imported")

    # -- where the time goes: each phase once more, warm, timed and then
    # traced (after the launch counts were read, so none of this counts) -----
    emit("breakdown", **{name: phase_breakdown(torch, fn, name == "admm")
                         for name, fn in {
        "setup": lambda: build_setup(nodes, ring(20, hops=2), spec,
                                     center="global", device=dev),
        "admm": lambda: run_admm(setup, n_iters=30),
        "central": lambda: central_kpca(pooled, spec, 1, gamma=setup.gamma,
                                        device=dev),
        "baselines": lambda: (
            local_kpca(setup.x, spec, gamma=setup.gamma, device=dev),
            neighborhood_kpca(setup.x, ring(20, hops=2), spec,
                              gamma=setup.gamma, device=dev)),
        "topk": lambda: run_admm_topk(setup, k=2, n_iters=30),
    }.items()})
    phase_serve_stream(dev, (("full", loaded), ("compressed", compressed)))

    if FAILURES:
        raise SmokeFailure(f"{len(FAILURES)} check(s) failed: {FAILURES}")

    # -- summary -------------------------------------------------------------
    summary = []
    for name, src, replaces, idx in (
            ("gram", "src/repro_torch/kernels/csrc/gram.cu",
             "src/repro/kernels/gram/gram.py:70", 0),
            ("project", "src/repro_torch/kernels/csrc/project.cu",
             "src/repro/kernels/project/project.py:92", 3),
            ("admm_step", "src/repro_torch/kernels/csrc/admm_step.cu",
             "src/repro/kernels/admm_step/admm_step.py:50", 0),
            ("center", "src/repro_torch/kernels/csrc/center.cu",
             "src/repro/kernels/centering/centering.py:29", 0)):
        r = records[name][idx]
        summary.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name],
            launches_by_path={p: c[name] for p, c in path_launches.items()},
            max_abs_err=max(x["max_abs_err"] for x in records[name]),
            tolerance=TOL,
            ms=r["ms"], device_ms=r["device_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"],
            **({"bound_fp32_ms": r["bound_fp32_ms"],
                "matmul_ms": r["matmul_ms"]} if name in ("gram", "project")
               else {})))
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
