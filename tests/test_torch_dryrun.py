"""The port's XLA-free dry-run and roofline (``repro_torch.launch.dryrun``,
``repro_torch.launch.roofline``) against the JAX package's.

  * per-card param, m, v, batch and cache bytes of every arch x applicable
    shape on both production layouts, equal to the bytes of the JAX
    package's ``abstract_params`` + ``spec_for`` (its batch and cache
    layouts, ``_batch_shardings`` and ``_cache_sharded``, read through a
    stand-in mesh with the production axis sizes: they read only
    ``mesh.shape``);
  * the port's argument bytes equal to ``memory_analysis()``'s of the JAX
    package's train and decode steps (``prepare_cell`` with
    ``make_production_mesh`` giving a (2, 2) mesh of the 4 host devices of
    ``tests/conftest.py``) for the llama3.2-3b smoke config;
  * the FLOP count of a decode step equal to a count written from the
    shapes (the JAX ``cost_analysis`` figure printed beside it, ungated:
    XLA counts elementwise work too);
  * the fake-backend step (rank 0 of a (2, 2) world over torch's ``fake``
    process group, meta tensors) against the live step on 4 gloo ranks
    (``python -c`` children on a ``file://`` store, each waited on with a
    timeout) for smoke configs: collective counts and bytes by kind equal,
    FLOPs equal (the meta paths' one-product counts against the real
    blocked and chunked loops);
  * the dkpca cell's per-node ledger (12 messages of N fp32 values and one
    collective an iteration at hops 2) and useful-FLOP formula;
  * ``analyze`` and ``to_markdown`` on a fixed record equal to the JAX
    package's when its constants are passed in.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfgs
from repro_torch.configs import SHAPES, ShapeSpec
from repro_torch.launch import dryrun, roofline

SRC = Path(__file__).resolve().parents[1] / "src"
TESTS = Path(__file__).resolve().parent
TIMEOUT_S = 300
LAYOUTS = {"16x16": ((16, 16), ("data", "model")),
           "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# live-vs-fake cases: (config, shape kind, batch, seq, overrides)
LIVE = {
    "llama_train": ("llama3.2-3b", "train", 4, 16, {}),
    "llama_prefill": ("llama3.2-3b", "prefill", 4, 32,
                      dict(attention_impl="chunked", attn_q_chunk=8,
                           attn_kv_chunk=8)),
    "llama_decode": ("llama3.2-3b", "decode", 4, 48, {}),
    "deepseek_decode": ("deepseek-v2-236b", "decode", 4, 48, {}),
    "falcon_prefill": ("falcon-mamba-7b", "prefill", 4, 32, {}),
    "zamba2_train": ("zamba2-1.2b", "train", 4, 32, {}),
}


def live_case(case):
    name, kind, b, s, over = LIVE[case]
    cfg = dataclasses.replace(tcfgs.get_config(name, smoke=True),
                              param_dtype="float32",
                              compute_dtype="float32", **over)
    return cfg, ShapeSpec(case, kind, s, b)


def rank_main(rank: int, store: str, out: str) -> None:
    """A gloo rank of the live (2, 2) world: every LIVE case's step on
    zeros, its collective counts, FLOPs and bytes (rank 0 writes them)."""
    import torch.distributed as dist
    from repro_torch.launch import make_mesh
    from repro_torch.models import build_model
    res = {}
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu", rank=rank,
                         world_size=4, local_rank=0,
                         init_method=f"file://{store}")
        for case in LIVE:
            cfg, shape = live_case(case)
            model = build_model(cfg, mesh=mesh, device="cpu")
            flops, nbytes = dryrun.run_step(model, cfg, shape, mesh)
            res[case] = dict(flops=flops,
                             collectives=dryrun.collectives_of(mesh.counts))
        if rank == 0:
            Path(out).write_text(json.dumps(res))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def fake_main(out: str) -> None:
    """The same cases on the fake (2, 2) world; the decode FLOP case on a
    (1, 1) one; the dkpca cell's ledger."""
    res = {}
    for case in LIVE:
        cfg, shape = live_case(case)
        flops, _, colls = dryrun.measure(cfg, shape, False,
                                         mesh_shape=(2, 2),
                                         axes=("data", "model"))
        res[case] = dict(flops=flops, collectives=colls)
    cfg, shape = live_case("llama_decode")
    res["flops11"] = dryrun.measure(cfg, shape, False, mesh_shape=(1, 1),
                                    axes=("data", "model"))[0]
    res["dkpca"] = dataclasses.asdict(dryrun.run_dkpca_cell(
        False, n_per_node=512, m_dim=16))
    Path(out).write_text(json.dumps(res))


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "REPRO_PLATFORM")}
    env.update(PYTHONPATH=os.pathsep.join([str(SRC), str(TESTS)]),
               OMP_NUM_THREADS="1")
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The live world and the fake run at once: their result files."""
    root = tmp_path_factory.mktemp("dryrun")
    code = ("import sys; from test_torch_dryrun import rank_main; "
            "rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(root / "store"),
         str(root / "live.json")], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", "import sys; from test_torch_dryrun import "
         "fake_main; fake_main(sys.argv[1])", str(root / "fake.json")],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True))
    try:
        for p in procs:
            log, _ = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, log[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return (json.loads((root / "live.json").read_text()),
            json.loads((root / "fake.json").read_text()))


# ---------------------------------------------------------------------------
# bytes against the JAX package's layouts


class _Stub:
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


class _Placed:
    def __init__(self, shape, dtype, spec):
        self.shape, self.dtype, self.spec = tuple(shape), dtype, tuple(spec)


def _jax_bytes(t, mesh) -> int:
    n = 1
    for d, e in zip(t.shape, t.spec):
        axes = () if e is None else (e,) if isinstance(e, str) else tuple(e)
        n *= d // math.prod(mesh.shape[a] for a in axes)
    return n * np.dtype(t.dtype).itemsize


@pytest.fixture(scope="module")
def jax_parts():
    """{(arch, shape, mesh): the JAX package's bytes by part}."""
    mp = pytest.MonkeyPatch()
    try:
        return _jax_parts(mp)
    finally:
        mp.undo()


def _jax_parts(monkeypatch_module):
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCH_NAMES, SHAPES as JSHAPES
    from repro.configs import applicable, get_config, train_batch_specs
    from repro.distributed.sharding import default_rules, spec_for
    from repro.launch import dryrun as jdry
    from repro.models import build_model as jbuild
    from repro.models.common import abstract_params
    monkeypatch_module.setattr(jdry, "NamedSharding",
                               lambda mesh, spec: spec)
    monkeypatch_module.setattr(
        jdry, "_with_sharding",
        lambda sds, spec: _Placed(sds.shape, sds.dtype, spec))
    out = {}
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        model = jbuild(cfg)
        shapes, axes = abstract_params(lambda k: model.init(k),
                                       jax.random.PRNGKey(0))
        for name, (mshape, maxes) in LAYOUTS.items():
            mesh = _Stub(mshape, maxes)
            rules = default_rules("pod" in maxes)
            params = sum(_jax_bytes(_Placed(
                v.shape, v.dtype, spec_for(v.shape, axes[k], rules, mesh)),
                mesh) for k, v in shapes.items())
            fp32 = sum(_jax_bytes(_Placed(
                v.shape, jnp.float32, spec_for(v.shape, axes[k], rules,
                                               mesh)), mesh)
                for k, v in shapes.items())
            for sname, shape in JSHAPES.items():
                if not applicable(cfg, shape)[0]:
                    continue
                parts = {"params": params}
                if shape.kind in ("train", "prefill"):
                    batch = jdry._batch_shardings(
                        train_batch_specs(cfg, shape), rules, mesh)
                    parts["batch"] = sum(_jax_bytes(t, mesh)
                                         for t in batch.values())
                if shape.kind == "train":
                    parts.update(m=fp32, v=fp32)
                if shape.kind == "decode":
                    cache = jdry._cache_sharded(jax.eval_shape(
                        lambda: model.init_cache(shape.batch, shape.seq)),
                        cfg, rules, mesh)
                    parts["cache"] = sum(_jax_bytes(t, mesh) for t in
                                         jax.tree.leaves(
                                             cache, is_leaf=lambda x:
                                             isinstance(x, _Placed)))
                out[(arch, sname, name)] = parts
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_state_bytes_match_jax_spec_for_in_every_cell(jax_parts, layout):
    mshape, maxes = LAYOUTS[layout]
    mesh = dryrun.StubMesh(mshape, maxes)
    n = 0
    for (arch, sname, lname), want in jax_parts.items():
        if lname != layout:
            continue
        cfg, shape = dryrun.resolve_cfg(arch, sname)
        got, _ = dryrun.cell_bytes(cfg, shape, mesh,
                                   dryrun.rules_for(cfg, "pod" in maxes))
        for part, b in want.items():
            assert got[part] == b, (arch, sname, layout, part, got[part], b)
        n += 1
    assert n == 33


@pytest.mark.parametrize("sname", ["train_4k", "decode_32k"])
def test_argument_bytes_match_jax_memory_analysis(monkeypatch, sname):
    import jax
    from jax.sharding import Mesh
    from repro.configs import get_config as jget
    from repro.launch import dryrun as jdry
    assert jax.device_count() == 4, jax.devices()
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    monkeypatch.setattr(jdry, "make_production_mesh",
                        lambda multi_pod=False: mesh)
    seq = 64 if sname == "train_4k" else None
    _, _, fn, args = jdry.prepare_cell("llama3.2-3b", sname, False,
                                       cfg=jget("llama3.2-3b", smoke=True),
                                       seq=seq)
    want = fn.lower(*args).compile().memory_analysis()
    got, _ = dryrun.cell_bytes(tcfgs.get_config("llama3.2-3b", smoke=True),
                               SHAPES[sname], dryrun.StubMesh(
                                   (2, 2), ("data", "model")),
                               dryrun.rules_for(tcfgs.get_config(
                                   "llama3.2-3b", smoke=True), False),
                               seq=seq)
    assert sum(got.values()) == want.argument_size_in_bytes, (
        got, want.argument_size_in_bytes)


def test_decode_flops_equal_a_count_from_the_shapes(runs):
    _, fake = runs
    cfg, shape = live_case("llama_decode")
    e, h, hk, d = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, t = shape.batch, shape.seq
    rows = -(-b // 64) * 64                 # tok_einsum's padded rows
    layer = (2 * rows * e * (h + 2 * hk) * d        # q, k, v
             + 2 * rows * h * d * e                 # wo
             + 3 * 2 * rows * e * cfg.d_ff          # the MLP
             + 2 * 2 * b * h * t * d)               # q.k and p.v
    want = cfg.n_layers * layer + 2 * rows * e * cfg.vocab
    assert fake["flops11"] == want, (fake["flops11"], want)
    # the JAX package's XLA count of the same step, beside it (no gate)
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    jcfg = dataclasses.replace(jget("llama3.2-3b", smoke=True),
                               param_dtype="float32",
                               compute_dtype="float32")
    jm = jbuild(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(0))
    cache = jm.init_cache(b, t, dtype=jnp.float32)
    ca = jax.jit(jm.decode_step).lower(
        params, cache, jnp.zeros((b, 1), jnp.int32),
        jnp.asarray(t - 1, jnp.int32)).compile().cost_analysis() or {}
    print(f"port FLOPs {want:.6g}, JAX cost_analysis "
          f"{float(ca.get('flops', 0.0)):.6g}")


@pytest.mark.parametrize("case", list(LIVE))
def test_fake_world_counts_equal_a_live_gloo_step(runs, case):
    live, fake = runs
    assert fake[case]["collectives"] == live[case]["collectives"], case
    assert fake[case]["collectives"], case
    assert fake[case]["flops"] == live[case]["flops"], case


def test_dkpca_cell_is_the_ring_ledger(runs):
    _, fake = runs
    rec = fake["dkpca"]
    assert rec["ok"], rec["error"]
    n, s = 512, 5
    assert rec["collectives"]["collective-permute"] == {
        "count": 12, "bytes": 12 * n * 4}
    assert rec["collectives"]["all-reduce"]["count"] == 1
    assert rec["n_params"] == 2 * n * n * s + 4 * s * s * n * n + 8 * n * n
    assert rec["flops_per_device"] > 0


def test_roofline_matches_jax_with_its_constants():
    from repro.launch import roofline as jroof
    recs = {
        "a|train_4k|16x16": dict(
            arch="a", shape="train_4k", mesh="16x16", ok=True,
            flops_per_device=3.1e15, bytes_accessed_per_device=2.2e12,
            collectives={"all-gather": {"count": 10, "bytes": 4.0e10},
                         "all-reduce": {"count": 3, "bytes": 1.5e9}},
            n_devices=256, n_active_params=3.2e9),
        "a|decode_32k|16x16": dict(
            arch="a", shape="decode_32k", mesh="16x16", ok=True,
            flops_per_device=2.0e11, bytes_accessed_per_device=9.0e10,
            collectives={"all-reduce": {"count": 56, "bytes": 3.0e7}},
            n_devices=256, n_active_params=3.2e9),
        "d|N512xM784|16x16": dict(
            arch="dkpca-paper", shape="N512xM784", mesh="16x16", ok=True,
            flops_per_device=2.1e7, bytes_accessed_per_device=1.0e6,
            collectives={"collective-permute": {"count": 12,
                                                "bytes": 24576}},
            n_devices=256, n_active_params=2.9e7),
        "a|prefill_32k|2x16x16": dict(
            arch="a", shape="prefill_32k", mesh="2x16x16", ok=True,
            flops_per_device=1.0e15, bytes_accessed_per_device=1.0e12,
            collectives={}, n_devices=512, n_active_params=3.2e9)}
    rates = dict(peak_flops=jroof.PEAK_FLOPS, hbm_bw=jroof.HBM_BW,
                 link_bw=jroof.LINK_BW)
    for rec in recs.values():
        assert roofline.analyze(rec, **rates) == jroof.analyze(rec)
    assert roofline.to_markdown(recs, **rates) == jroof.to_markdown(recs)
    assert roofline.to_markdown(recs, single_pod_only=False, **rates) == \
        jroof.to_markdown(recs, single_pod_only=False)
    # the port's own rates are the H100 SXM5 datasheet's
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989.4e12, 3.35e12, 450e9)
