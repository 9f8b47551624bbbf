"""What every run shares: finding a cell's files by the names
``BENCHMARK.json`` gives, the per-layer readers, the check that no JAX
module is loaded, the seeded samples and the result line."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def with_staged(bench: dict) -> dict:
    """``BENCHMARK.json`` and the entries of ``staged.json`` (cells that
    run and prove correct but hold no bound yet) that it lacks; a staged
    metric that ``BENCHMARK.json`` has adds its ``workloads`` (the staged
    cells that report it) to that entry's."""
    staged = load_json(HERE / "staged.json")
    out = dict(bench)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        extra = {e["name"]: e.get("workloads", []) for e in staged[key]}
        have = {e["name"] for e in bench[key]}
        out[key] = [dict(e, workloads=e["workloads"] + [
            w for w in extra[e["name"]] if w not in e["workloads"]])
            if e["name"] in extra and "workloads" in e else e
            for e in bench[key]] + [e for e in staged[key]
                                    if e["name"] not in have]
    return out


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its files: the cell's own
    (``cells/<name>.json``), its configuration and its traffic mix, and
    the metrics ``BENCHMARK.json`` asks of it."""

    name: str
    chips: int
    spec: dict          # cells/<name>.json
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    end_to_end: list    # BENCHMARK.json's end_to_end entries it reports
    per_layer: list     # ... and its per_layer entries

    def dry(self) -> "Cell":
        """The same cell at the tiny sizes its files give under
        ``dry_run``, for a run on the CPU."""
        return dataclasses.replace(
            self, config={**self.config, **self.config.get("dry_run", {})},
            traffic={**self.traffic, **self.traffic.get("dry_run", {})},
            spec={**self.spec, **self.spec.get("dry_run", {})})


def in_cell(entry: dict, cell: str, e2e_names) -> bool:
    """Whether a metric belongs to a cell: named by its ``workloads``, or,
    without that key, moving (or being) an end-to-end metric the cell
    reports."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves", entry["name"]) in e2e_names


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, or of ``staged.json``."""
    bench = with_staged(bench or benchmark())
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"kpcabench: no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(entries)})")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if in_cell(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]),
                spec=load_json(HERE / "cells" / f"{name}.json"),
                config=config,
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer)


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "kpcabench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is jax, jaxlib, flax or the JAX package repro."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def sample(n: int, k: int, seed: int, salt: int) -> list:
    """k of range(n) (all of them where n <= k), drawn from the seed,
    sorted."""
    if n <= k:
        return list(range(n))
    rng = np.random.default_rng([int(seed) % (1 << 63), salt])
    return sorted(int(i) for i in rng.choice(n, size=k, replace=False))


def check_lines(checks: dict) -> list:
    """The compared numbers, one line each: name, value, limit."""
    return [f"kpcabench check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in checks.items()]


def verdict(checks: dict) -> bool:
    return bool(checks) and all(
        v["value"] is not None and v["value"] <= v["limit"]
        for v in checks.values())


def emit(result: dict) -> None:
    """The compared numbers as the last lines on standard error, then the
    result as the last line on standard output (``checks`` last in it)."""
    checks = result.pop("checks")
    result["checks"] = checks
    for line in check_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


__all__ = ["Cell", "FORBIDDEN", "HERE", "ROOT", "benchmark", "check_lines",
           "emit", "forbidden_modules", "in_cell", "load_cell", "load_json",
           "reader", "sample", "verdict", "with_staged"]
