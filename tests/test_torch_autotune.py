"""The port's tile autotuner on the CPU (``repro_torch.kernels.autotune``).

A twin of ``tests/test_perf_path.py::TestTileTable`` for the port's knobs
and keys, then the dispatch the wrappers resolve from a table: with no
entry, exactly the derived choices (``tile_rows``, ``support_chunking``,
``center_plan``); with one, the entry's; illegal entries rejected. Lookups
need a card's name for the key's backend field, so these tests stand a
fixed name in for ``device_backend``; the tuning itself runs only on the
card (``tests/test_torch_gpu.py``), and on a CPU tensor it raises.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.core import KernelSpec
from repro_torch.kernels import autotune
from repro_torch.kernels.centering.centering import (CenterPlan, center_plan,
                                                     dispatch_plan, plan_of,
                                                     small_fits)
from repro_torch.kernels.gram.gram import dispatch_rows, tile_rows
from repro_torch.kernels.project.project import (dispatch_slices,
                                                 support_chunking)

H100 = "cuda:NVIDIA H100 80GB HBM3"
CARD = torch.device("cuda", 0)   # a descriptor only: nothing is allocated


@pytest.fixture
def fake_card(monkeypatch):
    """Lookups keyed as on an H100; the process table and every cached
    choice reset before and after."""
    monkeypatch.setattr(autotune, "device_backend", lambda index=None: H100)
    monkeypatch.delenv(autotune.TABLE_ENV_VAR, raising=False)
    autotune.set_default_table(autotune.TileTable())
    yield
    autotune.set_default_table(None)


class TestTileTable:
    def test_round_trip(self, tmp_path):
        t = autotune.TileTable()
        key = t.put("gram", (20, 100, 100, 784), torch.float32, H100,
                    {"rows": 128}, 1.5e-4)
        path = tmp_path / "tiles.json"
        t.save(str(path))
        loaded = autotune.TileTable.load(str(path))
        assert len(loaded) == 1 and key in loaded.entries
        assert key == "gram|32x128x128x1024|float32|" + H100
        hit = loaded.lookup("gram", (20, 100, 100, 784), torch.float32, H100)
        assert hit == {"rows": 128}
        assert loaded.entries[key]["us"] == 150.0

    def test_lookup_buckets_shapes_pow2(self):
        t = autotune.TileTable()
        t.put("project", (2048, 1024), np.float32, H100, {"slices": 2},
              1e-4)
        # 2000 buckets to 2048 and 784 to 1024: the same key
        assert t.lookup("project", (2000, 784), torch.float32, H100) \
            == {"slices": 2}
        assert t.lookup("project", (4096, 784), torch.float32, H100) is None
        assert autotune.shape_bucket((3, 100, 784)) == (8, 128, 1024)

    def test_get_tiles_falls_back_to_defaults(self):
        tiles = autotune.get_tiles("gram", (1, 64, 64, 32), torch.float32,
                                   table=autotune.TileTable(), backend=H100)
        assert tiles == autotune.DEFAULT_TILES["gram"] == {}

    def test_get_tiles_prefers_table_hit(self):
        t = autotune.TileTable()
        t.put("centering", (1, 2000, 2000), torch.float32, H100,
              {"small": 0, "rows": 64}, 1e-4)
        tiles = autotune.get_tiles("centering", (1, 2000, 2000),
                                   torch.float32, table=t, backend=H100)
        assert tiles == {"small": 0, "rows": 64}

    def test_other_card_model_misses(self):
        t = autotune.TileTable()
        t.put("project", (2000, 784), torch.float32, H100, {"slices": 4},
              1e-4)
        assert t.lookup("project", (2000, 784), torch.float32,
                        "cuda:NVIDIA A100-SXM4-80GB") is None

    def test_version_mismatch_rejected(self, tmp_path):
        path = tmp_path / "bad.json"
        path.write_text('{"version": 999, "entries": {}}')
        with pytest.raises(ValueError, match="version"):
            autotune.TileTable.load(str(path))

    def test_env_var_loads_process_table(self, tmp_path, monkeypatch):
        t = autotune.TileTable()
        t.put("centering", (20, 100, 100), torch.float32, H100,
              {"small": 1}, 1e-4)
        path = tmp_path / "env_tiles.json"
        t.save(str(path))
        monkeypatch.setenv(autotune.TABLE_ENV_VAR, str(path))
        autotune.set_default_table(None)         # force a re-read
        try:
            hit = autotune.default_table().lookup(
                "centering", (20, 100, 100), torch.float32, H100)
            assert hit == {"small": 1}
        finally:
            autotune.set_default_table(None)     # don't leak into others


GRAM_SHAPES = [(1, 2000, 2000, 784, True), (20, 100, 100, 784, False),
               (20, 500, 500, 784, True), (1, 2000, 2000, 784, False),
               (4, 70, 70, 784, True), (1, 17, 9, 5, False),
               (20, 100, 2000, 784, False), (132, 128, 128, 64, False)]
SUPPORTS = [1, 63, 64, 125, 500, 1000, 2000, 4096, 20000]
CENTER_SHAPES = [(1, 2000, 2000), (20, 100, 100), (1, 100, 100),
                 (200, 100, 100), (1, 7, 5), (100, 5, 5, ), (1, 300, 2000),
                 (2000, 5, 5)]


@pytest.mark.parametrize("z,n,k,m,symmetric", GRAM_SHAPES)
def test_empty_table_gives_derived_gram_rows(fake_card, z, n, k, m,
                                             symmetric):
    assert dispatch_rows(z, n, k, m, symmetric, torch.float32, CARD) == \
        tile_rows(z, n, k, symmetric)


@pytest.mark.parametrize("l", SUPPORTS)
@pytest.mark.parametrize("op", ["project", "project_partial"])
def test_empty_table_gives_derived_slices(fake_card, op, l):
    assert dispatch_slices(op, l, 784, CARD) == support_chunking(l)[1]


@pytest.mark.parametrize("z,n,m", CENTER_SHAPES)
def test_empty_table_gives_derived_center_plan(fake_card, z, n, m):
    assert dispatch_plan(z, n, m, CARD) == center_plan(z, n, m)


def test_entries_override_and_set_default_table_clears(fake_card):
    # the ring's sweep: 64 rows derived; the table says 128
    assert dispatch_rows(20, 100, 100, 784, False, torch.float32, CARD) == 64
    assert dispatch_slices("project", 2000, 784, CARD) == 2
    assert dispatch_plan(1, 2000, 2000, CARD).rows == 118
    t = autotune.TileTable()
    t.put("gram", (20, 100, 100, 784), torch.float32, H100, {"rows": 128},
          1e-5)
    t.put("project", (2000, 784), torch.float32, H100, {"slices": 8}, 1e-5)
    t.put("centering", (1, 2000, 2000), torch.float32, H100,
          {"small": 0, "rows": 64}, 1e-5)
    autotune.set_default_table(t)
    assert dispatch_rows(20, 100, 100, 784, False, torch.float32, CARD) \
        == 128
    # the same bucket, another exact shape: the entry applies there too
    assert dispatch_rows(20, 90, 120, 700, False, torch.float32, CARD) == 128
    # a self-Gram of the cross-Gram's sizes has its own key: no entry
    assert dispatch_rows(20, 100, 100, 784, True, torch.float32, CARD) == 128
    # another dtype: its own key
    assert dispatch_rows(20, 100, 100, 784, False, torch.bfloat16, CARD) \
        == 64
    assert dispatch_slices("project", 2000, 784, CARD) == 8
    assert dispatch_slices("project_partial", 2000, 784, CARD) == 2
    assert dispatch_plan(1, 2000, 2000, CARD) == CenterPlan(
        small=False, rows=64, slabs=32, col_tiles=16)
    autotune.set_default_table(autotune.TileTable())
    assert dispatch_rows(20, 100, 100, 784, False, torch.float32, CARD) == 64
    assert dispatch_slices("project", 2000, 784, CARD) == 2
    assert dispatch_plan(1, 2000, 2000, CARD) == center_plan(1, 2000, 2000)


def test_entry_illegal_at_the_exact_shape_is_not_applied(fake_card):
    # 200 x 200 and 250 x 250 share the 256 x 256 bucket; one launch fits
    # the first in shared memory, not the second
    assert small_fits(100, 100) and not small_fits(250, 250)
    t = autotune.TileTable()
    t.put("centering", (1, 200, 200), torch.float32, H100, {"small": 1},
          1e-5)
    autotune.set_default_table(t)
    assert dispatch_plan(1, 200, 200, CARD) == CenterPlan(small=True)
    assert dispatch_plan(1, 250, 250, CARD) == center_plan(1, 250, 250)


@pytest.mark.parametrize("op,shape,knobs", [
    ("gram", (1, 2000, 784), {"rows": 64}),           # 64-row self-Gram
    ("gram", (20, 100, 100, 784), {"rows": 32}),
    ("gram", (20, 100, 100, 784), {"block_n": 128}),
    ("project", (2000, 784), {"slices": 3}),
    ("project", (2000, 784), {"slices": 16}),
    ("project", (128, 2000, 784), {"slices": 2}),     # keyed on the batch
    ("project_partial", (500, 784), {"slices": 0}),
    ("centering", (1, 2000, 2000), {"small": 1}),     # past SMALL_BYTES
    ("centering", (1, 2000, 2000), {"small": 0, "rows": 8}),   # 250 slabs
    ("centering", (1, 2000, 2000), {"small": 0, "rows": 512}),
    ("centering", (1, 100, 100), {"small": 0}),
    ("centering", (1, 100, 100), {"small": 1, "rows": 16}),
])
def test_illegal_entries_rejected(op, shape, knobs):
    with pytest.raises(ValueError):
        autotune.TileTable().put(op, shape, torch.float32, H100, knobs, 1e-5)


def test_load_rejects_knob_outside_domain(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"version": autotune.TABLE_VERSION,
                                "entries": {
        f"project|2048x1024|float32|{H100}": {"slices": 3, "us": 1.0}}}))
    with pytest.raises(ValueError, match="slices"):
        autotune.TileTable.load(str(path))


def test_project_key_ignores_the_batch(fake_card):
    key = autotune.table_key("project", (2000, 784), torch.float32, H100)
    assert key == "project|2048x1024|float32|" + H100
    t = autotune.TileTable()
    t.put("project", (2000, 784), torch.float32, H100, {"slices": 4}, 1e-5)
    autotune.set_default_table(t)
    # the dispatch has no batch argument: every bucket reads one entry
    assert dispatch_slices("project", 2000, 784, CARD) == 4
    assert autotune.project_candidates(2000, 784) == [
        {"slices": s} for s in (1, 2, 4, 8)]


def test_candidates_are_legal_and_hold_the_default():
    assert autotune.gram_candidates(1, 2000, 2000, 784, True) == [
        {"rows": 128}]
    assert autotune.gram_candidates(20, 100, 100, 784) == [
        {"rows": 64}, {"rows": 128}]
    for z, n, m in CENTER_SHAPES:
        cands = autotune.centering_candidates(z, n, m)
        derived = center_plan(z, n, m)
        plans = [plan_of(z, n, m, c) for c in cands]
        for c in cands:
            autotune.check_knobs("centering", (z, n, m), c)
        if n >= 8:
            assert derived in plans, (z, n, m)
        slabs = [p.slabs for p in plans if not p.small]
        assert len(slabs) == len(set(slabs))


@pytest.mark.parametrize("tune", ["gram", "project", "project_partial",
                                  "centering"])
def test_tuning_a_cpu_tensor_raises(tune):
    spec = KernelSpec(kind="rbf", gamma=0.5)
    x = torch.rand((64, 16))
    coefs = torch.rand((64, 2))
    call = {
        "gram": lambda: autotune.tune_gram(spec, x),
        "project": lambda: autotune.tune_project(spec, [x[:8]], x, coefs),
        "project_partial": lambda: autotune.tune_project_partial(
            spec, x[:8], x, coefs),
        "centering": lambda: autotune.tune_centering(x[:16, :16]),
    }[tune]
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_cli_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would tune on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.main(["--out", str(tmp_path / "t.json")])
    assert not (tmp_path / "t.json").exists()


def test_serving_buckets():
    assert autotune.serving_buckets(128) == [8, 16, 32, 64, 128]
    assert autotune.serving_buckets(100) == [8, 16, 32, 64, 100]
