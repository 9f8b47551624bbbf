"""A configuration is added by files alone: in a copy of the benchmark
(``BENCHMARK.json`` and ``kpcabench/``) whose ``BENCHMARK.json`` holds the
training cell and its metrics (moved there from ``staged.json``, as a
benchmark change would move them), a hybrid configuration cut in depth
(``overrides`` and ``reduced`` on ``n_layers``, with its published value
and the deployment it stands for), its cell and its traffic mix are added
as new files and entries, and that cell runs (``--dry-run``) and holds the
configuration rules, with no file under ``kpcabench/`` changed. About 10 s
alone."""

import json
import os
import shutil
import subprocess
import sys

from kpcabench.common import ROOT
from kpcabench.tests.test_files import config_rules

NAME, CELL, MIX = "zamba2-1.2b-4l", "train-zamba2-4l", "train-probe-short"
TRAIN = "train-zamba2-1.2b"


def promote_training(root):
    """Move the training cell, its configuration and the metrics it
    reports from the copy's ``staged.json`` into its ``BENCHMARK.json``."""
    doc = json.loads((root / "BENCHMARK.json").read_text())
    path = root / "kpcabench" / "staged.json"
    staged = json.loads(path.read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        ours = [e for e in staged[key]
                if TRAIN in (e["name"], *e.get("workloads", ()))
                or e["name"] == "zamba2-1.2b"]
        doc[key] += ours
        staged[key] = [e for e in staged[key] if e not in ours]
    (root / "BENCHMARK.json").write_text(json.dumps(doc, indent=1))
    path.write_text(json.dumps(staged, indent=1))


def add_cut_hybrid(root):
    """The new files and entries, written into the copy at ``root``."""
    bench = root / "kpcabench"
    cfg = json.loads((bench / "configs" / "zamba2-1.2b.json").read_text())
    cfg.update(name=NAME, n_layers=4, overrides={"n_layers": 4},
               published={"n_layers": 38},
               deployment="38 layers as four pipeline stages over chips of "
                          "which this one holds 4 Mamba-2 layers and the "
                          "shared block's first application")
    cfg["dry_run"].pop("n_layers", None)
    (bench / "configs" / f"{NAME}.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "train-probe.json").read_text())
    mix.update(batch=2, seq=1024)
    (bench / "traffic" / f"{MIX}.json").write_text(json.dumps(mix))
    (bench / "cells" / f"{CELL}.json").write_text(
        (bench / "cells" / "train-zamba2-1.2b.json").read_text())
    doc = json.loads((root / "BENCHMARK.json").read_text())
    entry = dict(name=NAME, source=cfg["source"],
                 file=f"kpcabench/configs/{NAME}.json",
                 reduced=["n_layers"], why="zamba2-1.2b cut to 4 layers")
    doc["configs"].append(entry)
    doc["workloads"].append(dict(name=CELL, config=NAME, traffic=MIX,
                                 chips=1, why="a cut hybrid's steps"))
    for m in doc["end_to_end"] + doc["per_layer"]:
        if TRAIN in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(doc, indent=1))
    return entry, cfg


def test_a_cut_configuration_is_added_by_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "kpcabench", tmp_path / "kpcabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    promote_training(tmp_path)
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "kpcabench").rglob("*") if p.is_file()}
    entry, cfg = add_cut_hybrid(tmp_path)
    config_rules(entry, cfg, {"train"})
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "kpcabench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())
    assert len(after) == len(before) + 3
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "kpcabench/run.py", "--workload", CELL, "--seed",
         str(2 ** 31 + 13), "--seconds", "0.3", "--trace", "0",
         "--dry-run"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["checks"]) == {"loss", "grad", "grad_norm", "update",
                                   "probe"}
