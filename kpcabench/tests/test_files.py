"""BENCHMARK.json and every file it names: parse, keys, names, units."""

import json
import re
from pathlib import Path

import pytest

from kpcabench import common
from kpcabench.runners import kind

ROOT = common.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
STAGED = json.loads((ROOT / "kpcabench" / "staged.json").read_text())
BOTH = common.with_staged(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT_MAX = 200
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["kpcabench"]
    assert len(BENCH["command"]) <= 32
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("doc", ["BENCHMARK.json", "staged.json"])
@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section, doc):
    entries = (BENCH if doc == "BENCHMARK.json" else STAGED)[section]
    names = [e["name"] for e in BOTH[section]]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer"):
            if key in e:
                assert 1 <= len(e[key]) <= TEXT_MAX and "\n" not in e[key]
        if section == "configs":
            assert 1 <= len(e["source"]) <= TEXT_MAX
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES


def test_paths_and_files():
    for p in BENCH["paths"] + [c["file"] for c in BENCH["configs"]]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    for f in (ROOT / "kpcabench").rglob("*"):
        if "__pycache__" in f.parts or f.is_dir():
            continue
        rel = f.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel


# the kinds whose cells run the paper's kPCA deployments
KPCA_KINDS = ("fit", "ring_fit", "serve")
# keys that name a width: never cut
WIDTHS = {"d_model", "d_ff", "d_inner", "ssm_state", "head_dim",
          "ssm_head_dim", "d_ff_expert", "d_ff_dense", "top_k", "features"}


def config_rules(c: dict, cfg: dict, kinds: set) -> None:
    """The rules every configuration file keeps (``c`` its entry, ``cfg``
    the file, ``kinds`` the traffic kinds of the cells that use it)."""
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg.get("deployment") and cfg.get("assumed")
    for k in c["reduced"]:
        assert k in cfg and k in cfg.get("published", {}), k
        assert k not in WIDTHS and not k.endswith(("_dim", "_rank")), k
    if kinds & set(KPCA_KINDS):
        # the paper's deployments, at the paper's sizes
        assert c["reduced"] == []
        assert cfg["features"] == 784 and cfg["samples_per_node"] == 100
        assert cfg["iterations"] == 30 and cfg["hops"] == 2
    if "arch" in cfg:
        lm_rules(c, cfg)


def lm_rules(c: dict, cfg: dict) -> None:
    """An LM configuration names a config of the port's registry, every
    width it repeats is the port's (with its overrides, which hold every
    cut), and its dry-run sizes are the port's smoke config's."""
    import dataclasses
    from repro_torch.configs import ARCH_NAMES, get_config
    assert cfg["arch"] in ARCH_NAMES
    assert set(c["reduced"]) <= set(cfg["overrides"])
    assert all(cfg["published"][k] != cfg[k] for k in c["reduced"])
    port = dataclasses.replace(get_config(cfg["arch"]), **cfg["overrides"])
    fields = {f.name for f in dataclasses.fields(port)} - {"name"}
    repeated = fields & set(cfg)
    assert {"n_layers", "d_model", "vocab", "family"} <= repeated
    for k in repeated:
        assert cfg[k] == getattr(port, k), k
    if cfg.get("dry_run", {}).get("smoke"):
        smoke = dataclasses.replace(get_config(cfg["arch"], smoke=True),
                                    **cfg["overrides"])
        dry = {**cfg, **cfg["dry_run"]}
        for k in repeated:
            assert dry[k] == getattr(smoke, k), k


def test_configs_are_used_and_uncut():
    used = {w["config"] for w in BENCH["workloads"]}
    assert {c["name"] for c in BENCH["configs"]} == used
    for c in BOTH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        kinds = {common.load_cell(w["name"]).traffic["kind"]
                 for w in BOTH["workloads"] if w["config"] == c["name"]}
        config_rules(c, cfg, kinds)


def test_end_to_end_rules():
    e2e = {m["name"]: m for m in BOTH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("w", BOTH["workloads"], ids=lambda w: w["name"])
def test_cell_files_and_metrics(w):
    assert w["chips"] in (1, 4)
    cell = common.load_cell(w["name"], BENCH)
    runner = ROOT / "kpcabench" / "runners" / f"{cell.traffic['kind']}.py"
    assert runner.is_file() and callable(kind(cell.traffic["kind"]).run)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(common.reader(m["name"]))
    assert set(cell.spec["limits"]) and all(
        v > 0 for v in cell.spec["limits"].values())


def test_runners_are_found_by_file():
    for name in ("fit", "ring_fit", "serve", "train"):
        assert kind(name).__name__ == f"kpcabench.runners.{name}"
    for name in ("nothing", "__init__", "../run", "fit.py", ""):
        with pytest.raises(SystemExit):
            kind(name)


def test_per_layer_rules():
    e2e = {m["name"] for m in BOTH["end_to_end"]}
    layers = {}
    for m in BOTH["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert {"kernels", "solver", "setup", "device"} <= set(layers)
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_time_budget():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_no_result_from_the_benchmark_alone(tmp_path):
    """In a directory that holds only BENCHMARK.json and the files under
    paths (no program), a run exits non-zero and prints no result."""
    import shutil
    import subprocess
    import sys
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "kpcabench", tmp_path / "kpcabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "kpcabench/run.py", "--workload", "fit-j80",
         "--seed", "1", "--seconds", "1", "--trace", "0", "--dry-run"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
