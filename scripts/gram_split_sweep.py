#!/usr/bin/env python3
"""The gram kernel's time on the card at the DKPCA probe's Grams, by split
count, and at the paper's fit's Grams, for this tree or another checkout.

    python3 scripts/gram_split_sweep.py
    python3 scripts/gram_split_sweep.py --splits 1,2,4,8,16
    python3 scripts/gram_split_sweep.py --fit --src /other/checkout/src

For each Gram and split count (``--splits``: the wrapper's ``split_count``
replaced by that constant for the run; 1 is the one-block-per-tile route;
without it the tree's own choice): the device time of each kernel a call
launches, from a ``torch.profiler`` trace of 20 calls (the split passes
apart from the tensor-core kernel), CUDA-event milliseconds per call over
50 calls after 5 (host launch included), the largest error against the
plain version scaled by max(1, |plain|), the error against a float64 Gram
beside the plain version's, and ``cdist`` + exp and ``matmul`` on the same
operands. The
probe's rows are seeded activations at the embeddings' scale (0.005), its
bandwidth the median heuristic's. ``--fit`` times the paper's fit's Grams
(M = 784) instead, with the tree's own choice. ``--src`` picks the
checkout whose ``repro_torch`` and kernel sources are measured, so two trees
compare in one call. Prints one JSON line per Gram and split count, then
the card's name and power limit. Needs a CUDA card.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

# (label, z, n, k, m, self-Gram): the probe's pooled and node Grams at the
# four family widths, the ring's sweep and slot Grams at a rank's and the
# world-1 ring's batch
PROBE = ([(f"96x96x{e}", 1, 96, 96, e, True) for e in (1024, 2048, 3072,
                                                        4096)]
         + [(f"3x96x96x{e}", 3, 96, 96, e, True) for e in (1024, 2048, 3072,
                                                          4096)]
         + [(f"{z}x24x24x3072 sweep", z, 24, 24, 3072, False) for z in (1, 4)]
         + [(f"{z}x72x72x3072 slots", z, 72, 72, 3072, True) for z in (1, 4)])
FIT = [("20x500x500x784", 20, 500, 500, 784, True),
       ("2000x2000x784", 1, 2000, 2000, 784, True),
       ("100x2000x784", 1, 100, 2000, 784, False),
       ("500x2000x784", 1, 500, 2000, 784, False),
       ("20x100x100x784 sweep", 20, 100, 100, 784, False)]


def event_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(torch, fn, iters: int = 20) -> dict:
    """Device milliseconds per call of each kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key[:80]] = us / iters / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--splits", default="",
                    help="comma-separated split counts (default: the "
                         "tree's own choice)")
    ap.add_argument("--fit", action="store_true",
                    help="the paper's fit's Grams instead of the probe's")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("gram_split_sweep: needs a CUDA card")
    from repro_torch.core import KernelSpec
    from repro_torch.core.kernels_math import resolve_gamma
    from repro_torch.kernels import gram_reference, gram_tiles
    from repro_torch.kernels.gram import gram as gram_mod
    own_count = getattr(gram_mod, "split_count", None)
    counts = [int(s) for s in args.splits.split(",") if s] or [None]
    if own_count is None and counts != [None]:
        raise SystemExit("gram_split_sweep: this tree's gram has no split "
                         "count")
    dev = torch.device("cuda")
    spec = KernelSpec(kind="rbf")
    gen = torch.Generator(device=dev).manual_seed(2)
    for label, z, n, k, m, sym in FIT if args.fit else PROBE:
        x = (torch.randn((z, n, m), device=dev, generator=gen)
             * 0.005).contiguous()
        y = None if sym else (torch.randn((z, k, m), device=dev,
                                          generator=gen) * 0.005).contiguous()
        g = resolve_gamma(spec, x[0])
        yy = x if sym else y
        plain = gram_reference(spec, x, y, gamma=g)
        exact = gram_reference(spec, x.double(), None if sym
                               else y.double(), gamma=g.double())
        err_plain = float((plain.double() - exact).abs().max())
        lib = dict(
            library_ms=event_ms(torch, lambda: torch.exp(torch.cdist(
                x, yy).square_().mul_(-g))),
            matmul_ms=event_ms(torch, lambda: torch.matmul(
                x, yy.transpose(1, 2))))
        for s in counts:
            if s is not None:
                gram_mod.split_count = lambda n, k, m, s=s: s

            def run():
                return gram_tiles(spec, x, y, g)

            got = run()
            torch.cuda.synchronize()
            kern = kernel_ms(torch, run)
            split_pass = sum(v for key, v in kern.items()
                             if "tf32_split_kernel" in key)
            device = sum(v for key, v in kern.items()
                         if "gram_" in key or "tf32_split_kernel" in key)
            print(json.dumps(dict(
                gram=label, src=args.src,
                splits=gram_mod.split_count(n, k, m) if own_count else None,
                ms=event_ms(torch, run), device_ms=device,
                split_pass_ms=split_pass,
                split_pass_share=split_pass / device if device else None,
                kernels=kern,
                max_scaled_err=float(((got - plain).abs() / plain.abs()
                                      .clamp(min=1.0)).max()),
                fp64_err=float((got.double() - exact).abs().max()),
                fp64_err_plain=err_plain, **lib)), flush=True)
            if own_count is not None:
                gram_mod.split_count = own_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
