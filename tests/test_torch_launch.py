"""The port's launcher layer on the CPU: ``python -m
repro_torch.launch.serve_kpca`` beside the JAX package's launcher on the
same arguments, ``launch.env``'s platform mapping, and ``obs.cli``'s
flight-recording files (beside the JAX package's ``obs.cli``).

The launchers run as subprocesses with a timeout (``REPRO_PLATFORM=cpu``
for the port, ``JAX_PLATFORMS=cpu`` for the JAX package). Their submitters
draw request sizes and rows from ``default_rng(tid)`` in both, so the
served-query and request counts printed must be equal; with admission on,
rejections depend on timing, and only their sum with the served requests
is fixed.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import env as t_env

SRC = Path(__file__).resolve().parents[1] / "src"
LAUNCH_TIMEOUT_S = 180
SERVED = re.compile(r"^served (\d+) queries / (\d+) requests \((\d+) futures",
                    re.M)


def launch(module: str, *args: str, **env_over):
    """Run a launcher module; returns the finished process."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "REPRO_PLATFORM")}
    env.update(PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu", **env_over)
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT_S)


def port(*args: str):
    return launch("repro_torch.launch.serve_kpca", *args,
                  REPRO_PLATFORM="cpu")


def served(out: str):
    """(queries, requests, futures) of the launcher's "served" line."""
    m = SERVED.search(out)
    assert m, out
    return tuple(int(v) for v in m.groups())


def field(out: str, name: str) -> int:
    m = re.search(rf"\b{name}=(\d+)", out)
    assert m, (name, out)
    return int(m.group(1))


@pytest.mark.parametrize("extra", [(), ("--inject-faults", "2")],
                         ids=["clean", "faults"])
def test_serve_kpca_counts_are_the_jax_launchers(extra):
    mine = port("--smoke", *extra)
    ref = launch("repro.launch.serve_kpca", "--smoke", *extra)
    assert mine.returncode == 0, mine.stderr
    assert ref.returncode == 0, ref.stderr
    assert served(mine.stdout) == served(ref.stdout)
    assert served(mine.stdout)[1:] == (64, 64)      # 4 submitters x 16
    if extra:
        for out in (mine.stdout, ref.stdout):
            assert field(out, "retries") == 2
            assert field(out, "faulted_futures") == 0
    # the CPU runs the kernels' plain versions: no launch line
    assert "launches:" not in mine.stdout


def test_serve_kpca_admission_accounts_for_every_request():
    out = port("--smoke", "--queue-factor", "1")
    assert out.returncode == 0, out.stderr
    _, requests, futures = served(out.stdout)
    rejected = field(out.stdout, "rejected")
    assert requests + rejected == 64 and futures == requests
    assert "bound=128 rows" in out.stdout


def test_serve_kpca_writes_trace_and_metrics(tmp_path):
    trace_p, metrics_p = tmp_path / "trace.json", tmp_path / "metrics.json"
    out = port("--smoke", "--trace-out", str(trace_p), "--metrics-out",
               str(metrics_p))
    assert out.returncode == 0, out.stderr
    names = {e["name"] for e in json.loads(trace_p.read_text())[
        "traceEvents"]}
    assert {"serve.dispatch", "serve.pack", "publish.refresh"} <= names
    assert json.loads(metrics_p.read_text())


def test_serve_kpca_without_a_card_exits_with_the_device_message():
    out = launch("repro_torch.launch.serve_kpca", "--smoke",
                 CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert "served" not in out.stdout


@pytest.mark.parametrize("value,device", [
    (None, "cuda"), ("", "cuda"), ("cuda", "cuda"), ("gpu", "cuda"),
    ("GPU", "cuda"), ("cpu", "cpu"), (" cpu ", "cpu")])
def test_env_maps_repro_platform(value, device):
    environ = {} if value is None else {"REPRO_PLATFORM": value}
    assert t_env.device_from_environ(environ) == device


@pytest.mark.parametrize("value", ["tpu", "metal"])
def test_env_refuses_other_platforms(value):
    with pytest.raises(ValueError, match="REPRO_PLATFORM"):
        t_env.device_from_environ({"REPRO_PLATFORM": value})


def test_env_module_is_stdlib_only():
    """launch/env.py loaded on its own (not through the package, whose
    __init__ imports torch) pulls in no third-party module."""
    code = ("import importlib.util as u, sys; "
            "spec = u.spec_from_file_location('env', sys.argv[1]); "
            "spec.loader.exec_module(u.module_from_spec(spec)); "
            "print(sorted(m for m in ('torch', 'jax', 'numpy') "
            "if m in sys.modules))")
    out = subprocess.run(
        [sys.executable, "-c", code,
         str(SRC / "repro_torch" / "launch" / "env.py")],
        capture_output=True, text=True, timeout=LAUNCH_TIMEOUT_S)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
@pytest.mark.parametrize("raises", [False, True], ids=["ok", "raises"])
def test_obs_session_writes_both_files(tmp_path, capsys, package, raises):
    """The port's obs.cli and its twin in the JAX package: both files are
    written, on the exception path too."""
    import argparse
    import importlib
    cli = importlib.import_module(f"{package}.obs.cli")
    trace = importlib.import_module(f"{package}.obs.trace")
    ap = argparse.ArgumentParser()
    cli.add_obs_args(ap)
    args = ap.parse_args(["--trace-out", str(tmp_path / "t.json"),
                          "--metrics-out", str(tmp_path / "m.json")])

    def body():
        with cli.obs_session(args):
            with trace.span("body.work"):
                pass
            if raises:
                raise RuntimeError("boom")

    if raises:
        with pytest.raises(RuntimeError, match="boom"):
            body()
    else:
        body()
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert "body.work" in {e["name"] for e in events}
    assert isinstance(json.loads((tmp_path / "m.json").read_text()), dict)
    assert not trace.is_enabled()
    assert "wrote metrics snapshot" in capsys.readouterr().out
