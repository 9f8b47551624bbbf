#!/usr/bin/env python3
"""Where the project kernel's time goes: its device time with one part
taken out at a time.

    python3 scripts/project_ablate.py        # on a machine with the card

Each variant is a copy of ``src/repro_torch`` under ``build/ablate/<name>``
with ``csrc/project.cu`` (or, for the admm variants, ``csrc/admm_step.cu``)
edited as listed below, built there and timed in a process of its own: the
device time per call of each kernel of one projection (a ``torch.profiler``
trace of 20 calls after 5 warm ones) at B in {8, 32, 64, 128} queries
against L in {500, 2000} random support rows of M = 784, C = 1, and of one
fused ADMM update at J20 x N100 x S5. A variant computes wrong numbers by
design; only its time means anything. Prints one JSON line per variant.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROJECT = "kernels/csrc/project.cu"
ADMM = "kernels/csrc/admm_step.cu"
CHUNKING = "kernels/project/project.py"

# name -> [(file under src/repro_torch, text, replacement)]
VARIANTS = {
    "base": [],
    # the main loop's tensor-core products
    "no_mma": [(PROJECT, """\
          wgmma_tf32(part[qt], sl + 2 * kk, qh + 2 * kk, kk > 0);
          wgmma_tf32(part[qt], sh + 2 * kk, ql + 2 * kk, 1);
          wgmma_tf32(part[qt], sh + 2 * kk, qh + 2 * kk, 1);
""", "")],
    # the epilogue after the cluster barrier: K block and product with A
    "no_epilogue": [
        (PROJECT, "for (int e = tid; e < ncl * kRows; e += kThreads) {",
         "for (int e = tid; e < 0; e += kThreads) {"),
        (PROJECT, "for (int e0 = 0; e0 < ncl * cp1 * 4; e0 += kThreads) {",
         "for (int e0 = 0; e0 < 0; e0 += kThreads) {")],
    # no feature stage at all: launch, barriers, epilogue
    "no_main_loop": [(PROJECT, "nk = (rank + 1) * kt / KS - k_begin;",
                      "nk = 0;")],
    # feature slices filling a whole wave, or a quarter (another summation
    # order)
    "full_wave_slices": [(CHUNKING, "tiles * slices * 2 <= SMS // 2",
                          "tiles * slices * 2 <= SMS")],
    "quarter_wave_slices": [(CHUNKING, "tiles * slices * 2 <= SMS // 2",
                             "tiles * slices * 2 <= SMS // 4")],
    # admm_step reading V and K from device memory at every N
    "admm_unstaged": [(ADMM, "const bool staged = n <= kStagedMaxN;",
                       "const bool staged = false;")],
    # admm_step with 512 threads per node
    "admm_512": [(ADMM, "constexpr int kThreads = 1024;",
                  "constexpr int kThreads = 512;")],
}

TIMER = r"""
import json, re, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.core import KernelSpec
from repro_torch.kernels import admm_local_update, projector

def device_ms(fn):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    return {name(e.key): e.device_time_total / 20e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0}

def name(key):
    found = re.search(r"\w+_kernel", key)
    return found.group(0) if found else key[:40]

dev = torch.device("cuda")
g = torch.Generator().manual_seed(0)
out = {}
for l in (500, 2000):
    xs = (torch.rand((l, 784), generator=g) * 0.1).to(dev)
    co = (torch.randn((l, 1), generator=g) * 0.01).to(dev)
    project = projector(KernelSpec(kind="rbf", gamma=0.05), xs, co)
    for b in (8, 32, 64, 128):
        xq = (torch.rand((b, 784), generator=g) * 0.1).to(dev)
        out[f"B{b}xL{l}"] = device_ms(lambda: project(xq))
ins = [torch.randn(s, generator=g).to(dev) for s in
       ((20, 100, 100), (20, 100, 1), (20, 100, 100), (20, 100, 5),
        (20, 100, 5), (20, 1, 5))]
out["admm_J20xN100xS5"] = device_ms(lambda: admm_local_update(*ins))
print(json.dumps(out))
"""


def main() -> int:
    for name, edits in VARIANTS.items():
        d = ROOT / "build" / "ablate" / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(ROOT / "src" / "repro_torch", d / "src" / "repro_torch")
        for rel, text, repl in edits:
            f = d / "src" / "repro_torch" / rel
            src = f.read_text()
            if text not in src:
                raise SystemExit(f"{name}: {rel} no longer holds {text!r}")
            f.write_text(src.replace(text, repl))
        r = subprocess.run([sys.executable, "-c", TIMER], capture_output=True,
                           text=True, timeout=600,
                           env={**os.environ, "PYTHONPATH": str(d / "src")})
        if r.returncode != 0:
            print(json.dumps({"variant": name, "error": r.stderr[-2000:]}),
                  flush=True)
            continue
        print(json.dumps({"variant": name,
                          "device_ms": json.loads(r.stdout)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
