#!/usr/bin/env python3
"""Which side of tests/test_torch_gpu.py::test_slice_on_card_matches_cpu
varies between runs: the setup and 10 ADMM iterations of that test (6 nodes
x 40 samples x 784 features, ring(6, 1), from one shared alpha0) repeated
on the CPU (at PyTorch's default thread count and at one thread) and on the
card, each run held against the first CPU run by the test's own gate
(rtol 1e-3, atol 1e-4 on ``alpha_hist``). A last pair of runs takes the
card's ADMM from the CPU's setup moved to the card, and the CPU's ADMM from
the card's setup, to tell the setup phase from the iterations. The host's
CPU model and digests of both sides' setup and trajectory are printed, so
runs on different hosts can be compared.

The CPU side follows the host's MKL code path, which differs between
hosts. So the CPU run is repeated once more in a fresh process for each
``MKL_ENABLE_INSTRUCTIONS`` value (AVX512, AVX2, AVX, SSE4_2; MKL reads it
when it loads), from the same alpha0, and each is held against the card by
the same gate: one host then shows what other hosts' CPUs would give. Each
child runs under ``MKL_VERBOSE=1``, and the sweep names the code path MKL
took in it (MKL_VERBOSE's architecture line); an MKL without a path of its
own for a value falls back to a lower one (AVX may run the SSE4.2 path),
which that line shows. The fingerprint names the default process's path.

    PYTHONPATH=src python3 scripts/slice_repeat.py [--repeats 4]

Needs a CUDA device; prints one JSON line.
"""

import argparse
import dataclasses
import hashlib
import json
import os
import platform
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
MKL_ISAS = ("AVX512", "AVX2", "AVX", "SSE4_2")


def _moved(setup, device):
    return dataclasses.replace(setup, **{
        f.name: getattr(setup, f.name).to(device)
        for f in dataclasses.fields(setup)
        if isinstance(getattr(setup, f.name), torch.Tensor)})


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _cpu_model() -> dict:
    """The host CPU as far as the sandbox shows it, and the instruction
    set PyTorch's CPU kernels dispatch on."""
    info = {}
    try:
        for line in open("/proc/cpuinfo"):
            key, _, val = line.partition(":")
            key = key.strip()
            if key in ("vendor_id", "cpu family", "model", "model name",
                       "stepping") and key not in info:
                info[key] = val.strip()
            elif key == "flags" and "avx512f" not in info:
                info["avx512f"] = "avx512f" in val.split()
    except OSError:
        pass
    info["platform"] = platform.processor() or platform.machine()
    info["torch_cpu_capability"] = torch.backends.cpu.get_cpu_capability()
    return info


def mkl_path(stdout: str) -> str:
    """MKL's own line naming the code path it took, from the output of a
    process run under ``MKL_VERBOSE=1``, or why there is none."""
    for line in stdout.splitlines():
        if "MKL_VERBOSE" in line and "architecture" in line:
            return line.split("architecture", 1)[1].strip()[:160]
    return "no MKL_VERBOSE line (PyTorch's CPU BLAS may not be MKL)"


def _slice(device, alpha0):
    """The test's setup and 10 iterations on ``device`` from alpha0."""
    from repro_torch.core import KernelSpec, build_setup, ring, run_admm
    from repro_torch.data import node_dataset
    nodes, _ = node_dataset(6, 40, m=784, seed=0)
    s = build_setup(nodes, ring(6, 1), KernelSpec(), device=device)
    r = run_admm(s, n_iters=10, alpha0=alpha0.to(device))
    return s, r.alpha_hist.cpu()


def _cpu_child(workdir: str) -> int:
    """One CPU run in this process (its MKL path fixed at load): reads
    alpha0, writes alpha_hist and the setup's digest beside it."""
    d = Path(workdir)
    s, hist = _slice("cpu", torch.load(d / "alpha0.pt"))
    torch.save(hist, d / "alpha_hist.pt")
    (d / "setup.txt").write_text(_digest(s.k, s.lam, s.vec))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--cpu-child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.cpu_child:
        return _cpu_child(args.cpu_child)
    if not torch.cuda.is_available():
        print("slice_repeat: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import (KernelSpec, build_setup, initial_alpha,
                                  ring, run_admm)
    from repro_torch.data import node_dataset
    spec = KernelSpec()
    nodes, _ = node_dataset(6, 40, m=784, seed=0)
    cuda = torch.device("cuda")
    alpha0 = initial_alpha(build_setup(nodes, ring(6, 1), spec,
                                       device="cpu"), "local")

    def run(device):
        return _slice(device, alpha0)

    def gate(got, want):
        """Entries past the test's gate, and the largest gap."""
        bad = (got - want).abs() > 1e-4 + 1e-3 * want.abs()
        return int(bad.sum()), float((got - want).abs().max())

    default_threads = torch.get_num_threads()
    cpu = {}
    for threads in (default_threads, 1):
        torch.set_num_threads(threads)
        cpu[threads] = [run("cpu") for _ in range(args.repeats)]
    torch.set_num_threads(default_threads)
    card = [run(cuda) for _ in range(args.repeats)]
    ref_setup, ref = cpu[default_threads][0]

    def spread(runs):
        return max(float((h - runs[0][1]).abs().max()) for _, h in runs)

    out = {
        "threads_default": default_threads,
        "cpu_spread_default_threads": spread(cpu[default_threads]),
        "cpu_spread_one_thread": spread(cpu[1]),
        "cpu_one_thread_vs_default": float(
            (cpu[1][0][1] - ref).abs().max()),
        "card_spread": spread(card),
        "card_setup_spread": {
            f: max(float((getattr(s, f) - getattr(card[0][0], f))
                         .abs().max()) for s, _ in card)
            for f in ("k", "lam", "vec", "kcross")},
        "card_vs_cpu_past_gate": [gate(h, ref) for _, h in card],
        "cpu_one_thread_vs_card_past_gate": [gate(card[0][1], h)
                                             for _, h in cpu[1]],
    }
    # the setup phase against the iterations
    s_card = card[0][0]
    r = run_admm(_moved(ref_setup, cuda), n_iters=10, alpha0=alpha0.to(cuda))
    out["card_admm_from_cpu_setup_past_gate"] = gate(r.alpha_hist.cpu(), ref)
    r = run_admm(_moved(s_card, "cpu"), n_iters=10, alpha0=alpha0)
    out["cpu_admm_from_card_setup_past_gate"] = gate(r.alpha_hist, ref)
    out["setup_card_vs_cpu"] = {
        f: float((getattr(s_card, f).cpu() - getattr(ref_setup, f))
                 .abs().max()) for f in ("k", "lam", "kcross")}
    out["eigvec_sign_agreement"] = int(torch.sum(torch.einsum(
        "jnk,jnk->jk", s_card.vec.cpu(), ref_setup.vec) > 0))
    out["eigvec_count"] = int(ref_setup.vec.shape[0] * ref_setup.vec.shape[2])
    # which machine: results that repeat on one host may differ between
    # hosts (the CPU's BLAS/LAPACK code path follows its instruction set)
    out["host_cpu"] = _cpu_model()
    out["fingerprint"] = {
        "cpu_setup": _digest(ref_setup.k, ref_setup.lam, ref_setup.vec),
        "cpu_alpha_hist": _digest(ref),
        "card_setup": _digest(s_card.k, s_card.lam, s_card.vec),
        "card_alpha_hist": _digest(card[0][1]),
        "mkl_available": torch.backends.mkl.is_available()}
    # the CPU side under MKL's default and each chosen code path, in a
    # fresh process each
    sweep = {}
    (ROOT / "build").mkdir(exist_ok=True)
    for isa in (None,) + MKL_ISAS:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            torch.save(alpha0, Path(d) / "alpha0.pt")
            env = dict(os.environ, MKL_VERBOSE="1")
            if isa is not None:
                env["MKL_ENABLE_INSTRUCTIONS"] = isa
            done = subprocess.run(
                [sys.executable, __file__, "--cpu-child", d], env=env,
                capture_output=True, text=True, timeout=600)
            key = isa or "default"
            if done.returncode != 0:
                sweep[key] = {"error": done.stderr.strip()[-400:]}
                continue
            hist = torch.load(Path(d) / "alpha_hist.pt")
            sweep[key] = {
                "mkl_path": mkl_path(done.stdout),
                "cpu_setup": (Path(d) / "setup.txt").read_text(),
                "cpu_alpha_hist": _digest(hist),
                "vs_default_cpu_max_gap": float((hist - ref).abs().max()),
                "card_vs_this_cpu_past_gate": gate(card[0][1], hist)}
    out["fingerprint"]["mkl_path"] = sweep["default"].get(
        "mkl_path", "not run")
    out["mkl_sweep"] = sweep
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
