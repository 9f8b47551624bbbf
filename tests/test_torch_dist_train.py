"""The port's data-, tensor- and expert-parallel training over a
``torch.distributed`` device mesh, on the CPU over gloo, against the JAX
package's GSPMD step and ``shard_map`` MoE on the same seeded numpy inputs.

The port's ranks are ``python -c`` children (they import this module for
``rank_main``, which loads no JAX) in worlds of 8, 4 and 1, meeting at
``file://`` stores under the test's temporary directory, each waited on
with a timeout. The JAX references run at the same time in one
subprocess with 8 host devices (``jax_main``; meshes of 4 use the first 4
devices). The weights are the port's seeded draws, written as numpy for
both sides (``jax.random`` is never reproduced), except where a case says
otherwise. Cases and tolerances:

  * tests/helpers/check_dp_train.py's dp problem (its config, its
    ``PRNGKey(0)`` weights, batch and lr 1e-2) on a (4, 2) mesh: the
    port's 8-rank step against the JAX package's single-device and (4, 2)
    sharded steps at the helper's own tolerances: loss within 1e-4, params
    at rtol 2e-3 / atol 2e-4. (On the port's seeded draws one w_gate
    element, whose gradient of about 3e-9 is below Adam's eps of 1e-8,
    moves 8.5e-4 between the JAX package's own single and sharded steps,
    past that atol: the first step's update there amplifies summation
    order); the same step on a (2, 2, 2) ("pod", "data", "model") mesh,
    batch and FSDP over ("pod", "data"), against the single-device step;
  * its moe problem on (2, 4), a virtual-expert case (2 experts over a
    model axis of 4, repl 2, on (1, 4)) and a drop case (capacity factor
    0.5 on (2, 2)): ``moe_forward`` with the mesh against the JAX
    package's, y and aux at 1e-5 * max(1, |y|) (the drop case must also
    be far from the drop-free reference);
  * loss and gradients of one step against ``jax.value_and_grad`` (loss
    at 1e-5 relative, each key's gradient at 1e-4 * max|g|): a kv-head
    fallback (8 q heads, 2 kv heads, qk-norm, over a model axis of 4), an
    indivisible batch (6 rows over a data axis of 4), the fp32
    deepseek-v2 smoke config (MLA, a dense first layer, shared and routed
    experts) on (1, 4) and the internvl2 smoke config (vision prefix, a
    loss mask whose counts differ by rank) on (2, 2) against the
    single-device step, and the fp32 mixtral smoke config (SWA, experts)
    on (2, 2) against the JAX package's (2, 2) GSPMD step (the MoE aux
    loss is each shard's, averaged); the fp32 smoke configs of the ssm,
    hybrid and audio families at (2, 2) and (4, 1), falcon-mamba and
    zamba2 at (1, 4) (falcon-mamba's layers split over "model", d_inner
    four ways; zamba2's mamba2 layers by heads, their replicated leaves'
    partial gradients summed over "model" once), and falcon-mamba with
    a d_inner of 126 at (1, 4) (4 does not divide it: each layer gathered
    whole), against the single-device JAX step (one per problem, made in
    the test process) and the port's one-process step; over a "model"
    axis of more than one rank no all-gather over "model" returns a whole
    falcon-mamba or zamba2 mamba leaf, but in that fallback;
  * train() of zamba2's fp32 smoke config at (1, 4) and (2, 2), 3 steps,
    against train() in one process: losses at 1e-5 relative, params at
    1e-4 * max(1, max|p|) (the partial sum, ``global_norm`` and AdamW);
  * one split mamba1 and mamba2 layer (the falcon-mamba and zamba2 smoke
    weights' layer 0) at (1, 4), forward and backward: ``Mesh.counts``
    kind by kind and byte for byte the design's (``models/mamba.py``), no
    whole leaf gathered, y and x's gradient within 1e-5 relative and each
    leaf's gradient (mamba2's replicated leaves summed over "model") within
    1e-4 of its max of the layer whole in one process;
  * ``spec_for`` equal to the JAX function for every leaf of the 10 full
    configs at (16, 16), (2, 16, 16), (4, 2) and (1, 1), on shape stubs;
  * ``global_norm`` on a mixed sharded and replicated tree at 1e-6
    relative, on (2, 2) and with ("pod", "data") leaves on (2, 2, 2); ``compressed_psum_grads`` given a (2, 2) mesh: the mean over
    each rank's "data" sub-group at 1e-5 (rank-2 gradients, exact for the
    compression); the serving mesh's two placements;
  * the probe's ring branch at J = 4 on (4, 1) against JAX
    ``activation_probe(mesh=)`` on 4 devices, each metric within the
    reference's SPMD gate (5e-3 * |want| + 1e-4);
  * a checkpoint the JAX package wrote restored onto (2, 2), and a
    sharded save at (2, 2) restored at (4, 1) and without a mesh: bitwise;
  * train() resumed on (4, 1) from the checkpoint it wrote on (2, 2): the
    state bitwise, the step and the data stream's position restored;
  * a (1, 1) mesh bitwise the single-device step and loop, and the
    sharded MoE dispatch bitwise the one-shard dispatch;
  * ``python -m torch.distributed.run -m repro_torch.launch.train --mesh
    2x2 --smoke`` (``REPRO_PLATFORM=cpu``) beside the JAX launcher's
    ``--mesh 2x2`` line on 4 host devices: one last line, on rank 0, and
    both lines' losses from about ln V down.
"""

import contextlib
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
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.data import TokenStream
from repro_torch.distributed import default_rules, local_shard, spec_for
from repro_torch.models import build_model

SRC = Path(__file__).resolve().parents[1] / "src"
TESTS = Path(__file__).resolve().parent
RANK_TIMEOUT_S = 360

# tests/helpers/check_dp_train.py's two problems
DP_KW = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
             tie_embeddings=True, remat="none", param_dtype="float32",
             compute_dtype="float32")
MOE_KW = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=2,
              n_kv_heads=1, d_ff=64, vocab=64, head_dim=16, n_experts=8,
              top_k=2, d_ff_expert=32, param_dtype="float32",
              compute_dtype="float32")
DP_LR = 1e-2
# MoE forward cases: (mesh, config overrides, x shape)
MOE_CASES = {
    "moe24": ((2, 4), {}, (4, 8, 32)),
    "virtual": ((1, 4), dict(n_experts=2), (4, 8, 32)),
    "drop": ((2, 2), dict(n_experts=4, capacity_factor=0.5), (4, 32, 32)),
}
# loss-and-grads cases: (mesh, config, batch rows, seq, JAX reference)
GRAD_CASES = {
    "kvfb": ((1, 4), dict(DP_KW, n_heads=8, head_dim=8, qk_norm=True,
                          remat="full"), 8, 16, "single"),
    "indiv": ((4, 1), DP_KW, 6, 16, "single"),
    "deepseek": ((1, 4), "deepseek-v2-236b", 2, 8, "single"),
    "internvl": ((2, 2), "internvl2-76b", 4, 8, "single"),
    "mixtral": ((2, 2), "mixtral-8x22b", 4, 8, "sharded"),
    # the ssm, hybrid and audio families (fp32 smoke): falcon-mamba's
    # and zamba2's mamba layers split over "model" at (2, 2) and (1, 4),
    # and falcon-mamba with a d_inner of 126, which 4 does not divide,
    # each layer gathered whole (the divisibility fallback)
    "falcon22": ((2, 2), "falcon-mamba-7b", 4, 8, "single"),
    "falcon41": ((4, 1), "falcon-mamba-7b", 4, 8, "single"),
    "falcon14": ((1, 4), "falcon-mamba-7b", 4, 8, "single"),
    "zamba22": ((2, 2), "zamba2-1.2b", 4, 8, "single"),
    "zamba41": ((4, 1), "zamba2-1.2b", 4, 8, "single"),
    "seamless22": ((2, 2), "seamless-m4t-large-v2", 4, 8, "single"),
    "seamless41": ((4, 1), "seamless-m4t-large-v2", 4, 8, "single"),
    "zamba14": ((1, 4), "zamba2-1.2b", 4, 8, "single"),
    "falcon_odd14": ((1, 4), ("falcon-mamba-7b", dict(d_inner=126)), 4, 8,
                     "single"),
}
FAMILY_CASES = [c for c in GRAD_CASES
                if c.startswith(("falcon", "zamba", "seamless"))]


def problem_of(case) -> str:
    """The weights-and-batch file of a GRAD_CASES case: a family's cases
    share their config's (one JAX reference per config), but for a case
    that overrides the config's widths."""
    kw = GRAD_CASES[case][1]
    return kw if case in FAMILY_CASES and isinstance(kw, str) else case


def family_of(case):
    """(config name, width overrides) of a family case."""
    kw = GRAD_CASES[case][1]
    return (kw, {}) if isinstance(kw, str) else kw


PROBE_KW = dict(name="t", family="dense", n_layers=2, d_model=48, n_heads=2,
                n_kv_heads=1, d_ff=96, vocab=256, head_dim=24,
                tie_embeddings=True, remat="none", param_dtype="float32",
                compute_dtype="float32")
PROBE = dict(batch=96, seq=16, samples_per_node=16, n_iters=8)


def smoke_fp32(name: str, **over) -> TArch:
    return dataclasses.replace(tcfgs.get_config(name, smoke=True),
                               param_dtype="float32",
                               compute_dtype="float32", **over)


def grad_cfg(case) -> TArch:
    kw = GRAD_CASES[case][1]
    if isinstance(kw, dict):
        return TArch(**kw)
    name, over = family_of(case)
    return smoke_fp32(name, **over)


def np_of(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save(path: Path, **trees) -> None:
    """Flat npz of several {key: array} trees: "<tree>:<key>"."""
    np.savez(path, **{f"{name}:{k}": np.asarray(v)
                      for name, tree in trees.items()
                      for k, v in tree.items()})


def load(path: Path) -> dict:
    """{tree: {key: array}} of ``save``'s file."""
    out = {}
    with np.load(path) as z:
        for k in z.files:
            name, key = k.split(":", 1)
            out.setdefault(name, {})[key] = z[k]
    return out


# ---------------------------------------------------------------------------
# the problems, written once for both sides


def make_problems(root: Path) -> None:
    """Every case's weights and inputs as numpy files under ``root``."""
    import jax
    from repro.configs.base import ArchConfig as JArch
    from repro.models import build_model as jbuild
    cfg = TArch(**DP_KW)
    # the helper's own weights (JAX's PRNGKey(0) init): with other draws an
    # element whose gradient is below Adam's eps can move past its atol
    # between the JAX package's own single-device and sharded steps
    w, _ = jbuild(JArch(**DP_KW)).init(jax.random.PRNGKey(0))
    b = TokenStream(cfg.vocab, 8, 16, seed=0, device="cpu").next_numpy()
    save(root / "dp.npz", p={k: np.asarray(v) for k, v in w.items()}, b=b)
    from repro_torch.models.common import ParamCollector
    from repro_torch.models.moe import init_moe
    for i, (case, (_, over, xshape)) in enumerate(MOE_CASES.items()):
        mcfg = TArch(**dict(MOE_KW, **over))
        col = ParamCollector(torch.Generator().manual_seed(10 + i),
                             torch.float32)
        init_moe(col, mcfg, "moe")
        x = np.random.default_rng(i).normal(size=xshape).astype(np.float32)
        save(root / f"{case}.npz",
             p={k[len("moe/"):]: np_of(v) for k, v in col.params.items()},
             b={"x": x})
    for i, case in enumerate(GRAD_CASES):
        if (root / f"{problem_of(case)}.npz").exists():
            continue
        gcfg = grad_cfg(case)
        _, _, rows, seq, _ = GRAD_CASES[case]
        w, _ = build_model(gcfg, device="cpu").init(20 + i)
        b = TokenStream(gcfg.vocab, rows, seq, seed=i,
                        device="cpu").next_numpy()
        if gcfg.family == "audio":
            b["frames"] = np.random.default_rng(i).normal(0, 0.02, size=(
                rows, gcfg.enc_seq, gcfg.d_model)).astype(np.float32)
        elif gcfg.frontend != "none":
            rng = np.random.default_rng(i)
            b["frontend"] = rng.normal(0, 0.02, size=(
                rows, gcfg.frontend_seq, gcfg.d_model)).astype(np.float32)
            # a mask whose counts differ by data rank
            mask = np.ones((rows, seq), np.float32)
            mask[0, :5] = 0
            mask[rows - 1, 2:] = 0
            b["loss_mask"] = mask
        save(root / f"{problem_of(case)}.npz",
             p={k: np_of(v) for k, v in w.items()}, b=b)
    pcfg = TArch(**PROBE_KW)
    w, _ = build_model(pcfg, device="cpu").init(3)
    toks = np.random.default_rng(0).integers(
        0, pcfg.vocab, size=(PROBE["batch"], PROBE["seq"]), dtype=np.int32)
    save(root / "probe.npz", p={"embed": np_of(w["embed"])},
         b={"tokens": toks})


# ---------------------------------------------------------------------------
# the port's ranks


def _mesh(shape, store: str, rank: int, world: int,
          axes=("data", "model")):
    from repro_torch.launch import make_mesh
    return make_mesh(shape, axes, device="cpu", rank=rank,
                     world_size=world, local_rank=0,
                     init_method=f"file://{store}")


def _tensors(tree: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def _full(tree, shards):
    from repro_torch.distributed.collectives import gather_full
    return {k: np_of(gather_full(v, shards.specs[k], shards.mesh))
            for k, v in tree.items()}


def _shard(full, shards):
    return {k: local_shard(v, shards.specs[k], shards.mesh).clone()
            for k, v in full.items()}


def _moe_layout(cfg, mesh):
    """The MoE layer's layout on ``mesh``: the model's, one layer of the
    stack, keys under "moe/"."""
    from repro_torch.models import build_model
    return build_model(cfg, mesh=mesh, device="cpu").shards().sub(
        "layers", stacked=True).sub("moe")


def _moe_forward(case, root: Path, mesh):
    """The port's moe_forward of a MOE_CASES case: each rank its rows;
    returns (y gathered over the batch axes, aux)."""
    from repro_torch.distributed.collectives import all_gather
    from repro_torch.models.common import local_batch
    from repro_torch.models.moe import moe_forward
    cfg = TArch(**dict(MOE_KW, **MOE_CASES[case][1]))
    z = load(root / f"{case}.npz")
    sh = _moe_layout(cfg, mesh)
    # this rank's "model" shard of each weight, whole over the batch axes
    p = {}
    for k, v in _tensors(z["p"]).items():
        d = sh.model_dim(k)
        p[k] = v if d is None else v.chunk(sh.tp, d)[sh.mi]
    x, _ = local_batch({"tokens": torch.as_tensor(z["b"]["x"])}, mesh)
    y, aux = moe_forward(p, cfg, x["tokens"], mesh, shards=sh)
    return np_of(all_gather(y, 0, mesh, ("data",))), float(aux)


class WholeGathers:
    """Counts, while entered, the all-gathers over "model" that return a
    tensor of one of ``shapes`` (``collectives.all_gather``, which every
    gather of a weight goes through, patched)."""

    def __init__(self, shapes):
        self.hits, self.shapes = 0, {tuple(s) for s in shapes}

    def __enter__(self):
        from repro_torch.distributed import collectives
        from repro_torch.distributed.sharding import axes_of
        self._orig = orig = collectives.all_gather

        def spy(x, dim, mesh, axes):
            out = orig(x, dim, mesh, axes)
            if "model" in axes_of(axes) and tuple(out.shape) in self.shapes:
                self.hits += 1
            return out
        collectives.all_gather = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.distributed import collectives
        collectives.all_gather = self._orig


def mamba_leaves(full: dict, shards) -> list:
    """One layer's shapes of the stacked mamba leaves of ``full`` that
    ``shards`` (the whole tree's layout) splits over "model"."""
    lsh = shards.sub("layers", stacked=True)
    return [tuple(v.shape[1:]) for k, v in full.items()
            if k.startswith("layers/mamba/")
            and lsh.model_dim(k[len("layers/"):]) is not None]


def _grads(case, root: Path, mesh):
    """Loss and gradients (gathered whole) of a GRAD_CASES case, and the
    all-gathers of a whole mamba leaf split over "model"."""
    from repro_torch.train.loop import loss_and_grads, sum_replicated_grads
    cfg = grad_cfg(case)
    z = load(root / f"{problem_of(case)}.npz")
    model = build_model(cfg, mesh=mesh, device="cpu")
    sh = model.shards()
    with WholeGathers(mamba_leaves(z["p"], sh)) as spy:
        total, metrics, grads = loss_and_grads(
            model, _shard(_tensors(z["p"]), sh), _tensors(z["b"]))
    sum_replicated_grads(grads, sh)
    return dict(loss=float(metrics["loss"]), total=float(total),
                whole_leaf_gathers=spy.hits), _full(grads, sh)


# one split mamba layer, forward and backward: (batch rows, tokens a row)
LAYER_B, LAYER_L = 2, 8
SPLIT_LAYERS = ("falcon-mamba-7b", "zamba2-1.2b")


@contextlib.contextmanager
def card_products():
    """``mamba``'s bf16 products from their inputs widened to fp32, rounded
    once, as a card's bf16 GEMM accumulates in fp32 (the CPU's own bf16
    products round otherwise)."""
    from repro_torch.models import mamba
    orig = mamba.tok_einsum

    def widened(eq, x, w):
        if x.dtype != torch.bfloat16:
            return orig(eq, x, w)
        return orig(eq, x.float(), w.float()).to(torch.bfloat16)
    mamba.tok_einsum = widened
    try:
        yield
    finally:
        mamba.tok_einsum = orig


def _layer_runs(cfg, whole: dict, msh, x, dy, mesh):
    """One mamba layer, split over ``msh``'s "model" axis and whole in this
    process, forward and backward: (y, x's gradient, the leaves, the
    collectives, the all-gathers of a whole leaf) of each."""
    from repro_torch.distributed.collectives import all_reduce_
    from repro_torch.models.mamba import (MAMBA2_PARTIAL_KEYS,
                                          mamba1_forward, mamba2_forward)
    fwd = mamba1_forward if cfg.mamba_version == 1 else mamba2_forward
    runs = []
    for shards in (msh, None):
        p = {k: (v if shards is None else local_shard(
            v, msh.specs[k], mesh)).clone().requires_grad_()
            for k, v in whole.items()}
        xi = x.clone().requires_grad_()
        mesh.counts.clear()
        with WholeGathers([v.shape for k, v in whole.items()
                           if msh.model_dim(k) is not None]) as spy:
            y = fwd(p, cfg, xi, shards=shards)
            y.backward(dy)
        counts = dict(mesh.counts)
        if shards is not None and cfg.mamba_version == 2:
            for k in MAMBA2_PARTIAL_KEYS:   # the caller's sum
                all_reduce_(p[k].grad, mesh, "model")
        runs.append((y.detach(), xi.grad, p, counts, spy.hits))
    return runs


def _split_layers(root: Path, mesh) -> dict:
    """Layer 0 of the falcon-mamba and zamba2 smoke problems' weights,
    mamba1 and mamba2, split over ``mesh``'s "model" axis, forward and
    backward from seeded x and dy: per config the collectives issued, the
    all-gathers of a whole leaf, and the largest errors of y, x's
    gradient and the rank's leaf gradients (each relative to its max)
    against the layer whole in this process; for mamba2 also in bf16
    under ``card_products``, the shares of y's and x's gradient elements
    that differ from the whole layer's and whether every leaf gradient
    is the whole layer's bitwise."""
    out = {}
    rng = np.random.default_rng(3)
    for arch in SPLIT_LAYERS:
        cfg = smoke_fp32(arch)
        whole = {k[len("layers/mamba/"):]: torch.as_tensor(v[0])
                 for k, v in load(root / f"{arch}.npz")["p"].items()
                 if k.startswith("layers/mamba/")}
        msh = build_model(cfg, mesh=mesh, device="cpu").shards().sub(
            "layers", stacked=True).sub("mamba")
        x, dy = (torch.as_tensor(rng.normal(size=(
            LAYER_B, LAYER_L, cfg.d_model)).astype(np.float32))
            for _ in range(2))
        (y, gx, p, counts, hits), (y0, gx0, p0, _, _) = _layer_runs(
            cfg, whole, msh, x, dy, mesh)
        rel = lambda a, b: float((a - b).abs().max()) / max(
            float(b.abs().max()), 1e-30)
        out[arch] = dict(
            counts=counts, whole_leaf_gathers=hits, y_err=rel(y, y0),
            x_grad_err=rel(gx, gx0),
            leaf_grad_err=max(rel(p[k].grad, local_shard(
                p0[k].grad, msh.specs[k], mesh)) for k in p))
        if cfg.mamba_version == 2:
            c16 = dataclasses.replace(cfg, param_dtype="bfloat16",
                                      compute_dtype="bfloat16")
            with card_products():
                (y, gx, p, _, _), (y0, gx0, p0, _, _) = _layer_runs(
                    c16, {k: v.bfloat16() for k, v in whole.items()}, msh,
                    x.bfloat16(), dy.bfloat16(), mesh)
            differ = lambda a, b: float((a != b).float().mean())
            out[arch]["bf16"] = dict(
                y_differ=differ(y, y0), x_grad_differ=differ(gx, gx0),
                leaf_grads_bitwise=all(torch.equal(p[k].grad, local_shard(
                    p0[k].grad, msh.specs[k], mesh)) for k in p))
    return out


def _dp_step(root: Path, mesh):
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.loop import build_train_step
    z = load(root / "dp.npz")
    model = build_model(TArch(**DP_KW), mesh=mesh, device="cpu")
    sh = model.shards()
    params = _shard(_tensors(z["p"]), sh)
    state = dict(params=params, **adamw_init(params))
    _, step = build_train_step(model, AdamWConfig(lr=DP_LR), mesh,
                               default_rules("pod" in mesh.axis_names))
    _, metrics = step(state, _tensors(z["b"]))
    return float(metrics["loss"]), _full(state["params"], sh)


def _probe(root: Path, mesh):
    from repro_torch.distributed import Shards
    from repro_torch.train import activation_probe
    z = load(root / "probe.npz")
    table = torch.as_tensor(z["p"]["embed"])
    sh = Shards(mesh, {"embed": spec_for(table.shape, ("vocab", "embed"),
                                         default_rules(False), mesh)})
    return activation_probe(
        {"embed": local_shard(table, sh.specs["embed"], mesh)},
        _tensors(z["b"]), mesh=mesh, shards=sh,
        samples_per_node=PROBE["samples_per_node"],
        n_iters=PROBE["n_iters"])


def _norm_tree(batch=("data",)):
    """A mixed tree and its specs, its batch-sharded dims over ``batch``."""
    g = torch.Generator().manual_seed(7)
    tree = {"a": torch.randn(8, 6, generator=g),       # data x model
            "b": torch.randn(4, 6, generator=g),        # model only
            "c": torch.randn(5, 3, generator=g),        # replicated
            "d": torch.randn(2, 8, 4, generator=g)}     # data on dim 1
    specs = {"a": (batch, "model"), "b": (None, "model"),
             "c": (None, None), "d": (None, batch, None)}
    return tree, specs


def _compress_grads():
    """Four ranks' gradients: a rank-2 matrix each (compression is exact on
    the mean of rank-2 matrices sharing a column space) and a vector."""
    rng = np.random.default_rng(4)
    v = rng.normal(size=(6, 2)).astype(np.float32)
    return {"w": np.einsum("wmr,nr->wmn",
                           rng.normal(size=(4, 8, 2)).astype(np.float32), v),
            "b": rng.normal(size=(4, 5)).astype(np.float32)}


def _checkpoints(root: Path, out: Path, store: str, rank: int, world: int):
    """A JAX-written checkpoint onto (2, 2); a (2, 2) save restored at
    (4, 1)."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.distributed import Shards
    specs = {"w": (("data",), "model"), "h": (None, ("data",)),
             "v": (None,), "s": ()}
    res = {}
    m22 = _mesh((2, 2), store, rank, world)
    sh = Shards(m22, specs)
    shardings = {k: (s, m22) for k, s in specs.items()}
    tree, _, _ = restore_checkpoint(str(root / "jax_ckpt"),
                                    shardings=shardings)
    res["jax_onto_22"] = _full(tree, sh)
    save_checkpoint(str(out / "ckpt22"), 5, tree, metadata={"m": 1},
                    shardings=shardings)
    m41 = _mesh((4, 1), store, rank, world)
    back, meta, step = restore_checkpoint(
        str(out / "ckpt22"), shardings={k: (s, m41) for k, s in
                                        specs.items()})
    res["22_onto_41"] = _full(back, Shards(m41, specs))
    if rank == 0:
        save(out / "ckpt.npz", **res)
        (out / "ckpt.json").write_text(json.dumps(dict(meta=meta,
                                                       step=step)))


def _train_resume(out: Path, store: str, rank: int, world: int) -> dict:
    """train() for 2 steps on (2, 2), checkpointing; then train() to step 2
    on (4, 1) from that directory (it resumes and runs no step: the state
    is the restored one) and on to step 3."""
    from repro_torch.distributed.collectives import gather_full
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, train
    cfg = TArch(**DP_KW)
    ckpt = str(out / "train_ckpt")
    stream = lambda: TokenStream(cfg.vocab, 8, 16, seed=2, device="cpu")
    tc = lambda steps: TrainConfig(steps=steps, ckpt_dir=ckpt, ckpt_every=2,
                                   log_every=0)
    full = lambda state, shards: {
        (g, k): gather_full(state[g][k], shards.specs[k], shards.mesh)
        for g in ("params", "m", "v") for k in state[g]}
    model = build_model(cfg, device="cpu")
    m22, m41 = (_mesh(s, store, rank, world) for s in ((2, 2), (4, 1)))
    a, ha = train(model, AdamWConfig(), stream(), tc(2), mesh=m22)
    saved = full(a, model.with_mesh(m22).shards())
    data = stream()
    b, hb = train(model, AdamWConfig(), data, tc(2), mesh=m41)
    back = full(b, model.with_mesh(m41).shards())
    data = stream()
    _, hc = train(model, AdamWConfig(), data, tc(3), mesh=m41)
    return dict(first=ha["loss"], resumed_steps=len(hb["loss"]),
                restored_bitwise=all(torch.equal(back[k], v)
                                     for k, v in saved.items())
                and int(b["step"]) == 2,
                continued=hc["loss"], data_step=data.step)


# train() of zamba2's fp32 smoke config over meshes where its mamba2 layers
# run split, against one process: steps, batch rows, tokens a row
ZAMBA_TRAIN_MESHES = ((1, 4), (2, 2))
ZAMBA_TRAIN = dict(steps=3, rows=4, seq=16)


def zamba_train(mesh=None):
    """train() of zamba2's fp32 smoke config for ZAMBA_TRAIN's steps (over
    ``mesh``, or in one process): (losses, the params gathered whole)."""
    from repro_torch.distributed.collectives import gather_full
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, train
    cfg = smoke_fp32("zamba2-1.2b")
    model = build_model(cfg, device="cpu")
    state, hist = train(model, AdamWConfig(), TokenStream(
        cfg.vocab, ZAMBA_TRAIN["rows"], ZAMBA_TRAIN["seq"], seed=4,
        device="cpu"), TrainConfig(steps=ZAMBA_TRAIN["steps"], log_every=0),
        mesh=mesh)
    params = state["params"]
    if mesh is not None:
        sh = model.with_mesh(mesh).shards()
        params = {k: gather_full(v, sh.specs[k], mesh)
                  for k, v in params.items()}
    return hist["loss"], {k: np_of(v) for k, v in params.items()}


def rank_main(world: int, rank: int, store: str, root: str) -> None:
    """One rank of a world: every case of the world, each on its own mesh
    of the one gloo group; rank 0 writes the results."""
    import torch.distributed as dist
    root = Path(root)
    out = root / f"world{world}"
    res = {}
    try:
        if world == 8:
            mesh = _mesh((4, 2), store, rank, world)
            res["dp_loss"], params = _dp_step(root, mesh)
            if rank == 0:
                save(out / "dp.npz", p=params)
            y, aux = _moe_forward("moe24", root, _mesh((2, 4), store, rank,
                                                       world))
            res["moe24_aux"] = aux
            if rank == 0:
                np.save(out / "moe24.npy", y)
            # the multi-pod layout: batch and FSDP over ("pod", "data")
            from repro_torch.distributed import Shards
            from repro_torch.optim import global_norm
            pod = _mesh((2, 2, 2), store, rank, world,
                        ("pod", "data", "model"))
            res["pod_loss"], params = _dp_step(root, pod)
            if rank == 0:
                save(out / "pod.npz", p=params)
            tree, specs = _norm_tree(("pod", "data"))
            res["pod_norm"] = float(global_norm(
                _shard(tree, Shards(pod, specs)), specs, pod))
        elif world == 4:
            for case in ("virtual", "drop"):
                y, aux = _moe_forward(case, root, _mesh(
                    MOE_CASES[case][0], store, rank, world))
                res[f"{case}_aux"] = aux
                if rank == 0:
                    np.save(out / f"{case}.npy", y)
            for case, (shape, *_) in GRAD_CASES.items():
                losses, grads = _grads(case, root,
                                       _mesh(shape, store, rank, world))
                res[case] = losses
                if rank == 0:
                    save(out / f"{case}.npz", g=grads)
            res["split_layers"] = _split_layers(root, _mesh(
                (1, 4), store, rank, world))
            res["probe"] = _probe(root, _mesh((4, 1), store, rank, world))
            from repro_torch.distributed import Shards
            from repro_torch.optim import global_norm
            m22 = _mesh((2, 2), store, rank, world)
            tree, specs = _norm_tree()
            res["norm"] = float(global_norm(_shard(tree, Shards(m22, specs)),
                                            specs, m22))
            _checkpoints(root, out, store, rank, world)
            res["resume"] = _train_resume(out, store, rank, world)
            for shape in ZAMBA_TRAIN_MESHES:
                name = "zamba_train{}{}".format(*shape)
                res[name], params = zamba_train(_mesh(shape, store, rank,
                                                      world))
                if rank == 0:
                    save(out / f"{name}.npz", p=params)
            # compressed_psum_grads on a mesh: the mean over its data ranks
            from repro_torch.optim import (compressed_psum_grads,
                                           init_compression_state)
            g = {k: torch.as_tensor(v[rank])
                 for k, v in _compress_grads().items()}
            state = init_compression_state(g, rank=2, seed=0)
            agg, _ = compressed_psum_grads(g, state, m22)
            np.savez(out / f"compress.r{rank}.npz",
                     **{k: np_of(v) for k, v in agg.items()})
        else:
            res.update(_world1(root, out, store))
        if rank == 0:
            (out / "res.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _world1(root: Path, out: Path, store: str) -> dict:
    """A (1, 1) mesh against no mesh: two steps through build_train_step
    (remat "full") and three through train(); bitwise."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, build_train_step, train
    cfg = dataclasses.replace(TArch(**DP_KW), remat="full")
    mesh = _mesh((1, 1), store, 0, 1)
    opt = AdamWConfig(lr=DP_LR)
    runs = {}
    for name, m in (("none", None), ("mesh", mesh)):
        model = build_model(cfg, device="cpu")
        init_fn, step = build_train_step(model, opt, m,
                                         None if m is None else
                                         default_rules(False))
        state, _ = init_fn(0)
        data = TokenStream(cfg.vocab, 8, 16, seed=0, device="cpu")
        losses = [float(step(state, data.next_batch())[1]["loss"])
                  for _ in range(2)]
        state2, hist = train(model, opt, TokenStream(cfg.vocab, 8, 16, seed=1,
                                                     device="cpu"),
                             TrainConfig(steps=3, log_every=0), mesh=m)
        runs[name] = (losses, hist["loss"], state, state2)
    a, b = runs["none"], runs["mesh"]
    same = lambda s, t: all(torch.equal(s[g][k], t[g][k])
                            for g in ("params", "m", "v") for k in s[g])
    # the sharded MoE dispatch on a (1, 1) mesh: the one-shard dispatch's
    # bits, for each MoE case's layer
    from repro_torch.models.moe import moe_forward
    moe_same = []
    for case in MOE_CASES:
        mcfg = TArch(**dict(MOE_KW, **MOE_CASES[case][1]))
        z = load(root / f"{case}.npz")
        p, x = _tensors(z["p"]), torch.as_tensor(z["b"]["x"])
        y0, aux0 = moe_forward(p, mcfg, x)
        y1, aux1 = moe_forward(p, mcfg, x, mesh,
                               shards=_moe_layout(mcfg, mesh))
        moe_same.append(torch.equal(y0, y1) and torch.equal(aux0, aux1))
    return dict(w1_losses=[a[0], b[0]], w1_train=[a[1], b[1]],
                w1_state_equal=same(a[2], b[2]) and same(a[3], b[3]),
                w1_moe_equal=moe_same)


# ---------------------------------------------------------------------------
# the JAX package's references (a subprocess with 8 host devices)


def jax_main(root: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_config as jget
    from repro.configs.base import ArchConfig as JArch
    from repro.distributed.sharding import default_rules as jrules
    from repro.distributed.sharding import spec_for as jspec
    from repro.models import build_model as jbuild
    from repro.models.moe import moe_forward as jmoe
    from repro.models.moe import moe_forward_ref as jmoe_ref
    from repro.optim import AdamWConfig as JOpt
    from repro.optim import adamw_init as jadamw_init
    from repro.train import activation_probe as jprobe
    from repro.train.loop import build_train_step as jstep
    root = Path(root)
    out = root / "jax"
    out.mkdir()
    devs = jax.devices()

    def mesh_of(shape, names=("data", "model")):
        n = int(np.prod(shape))
        return Mesh(np.asarray(devs[:n]).reshape(shape), names)

    def place(model, params, mesh):
        _, axes = model.init(jax.random.PRNGKey(0))
        rules = jrules(False)
        return {k: jax.device_put(v, NamedSharding(
            mesh, jspec(v.shape, axes[k], rules, mesh)))
            for k, v in params.items()}

    res = {}
    # dp: single device and (4, 2)
    z = load(root / "dp.npz")
    cfg = JArch(**DP_KW)
    params = {k: jnp.asarray(v) for k, v in z["p"].items()}
    batch = {k: jnp.asarray(v) for k, v in z["b"].items()}
    _, step1 = jstep(jbuild(cfg), JOpt(lr=DP_LR))
    p1 = {k: jnp.array(v) for k, v in z["p"].items()}   # donated
    s1, m1 = step1(dict(params=p1, **jadamw_init(p1)), batch)
    mesh = mesh_of((4, 2))
    model2 = jbuild(cfg, mesh=mesh)
    _, step2 = jstep(model2, JOpt(lr=DP_LR), mesh=mesh, rules=jrules(False))
    p2 = place(model2, params, mesh)
    s2, m2 = step2(dict(params=p2, **jadamw_init(p2)),
                   {k: jax.device_put(v, NamedSharding(mesh, P("data", None)))
                    for k, v in batch.items()})
    res["dp_loss"] = [float(m1["loss"]), float(m2["loss"])]
    save(out / "dp.npz", single={k: np.asarray(v)
                                 for k, v in s1["params"].items()},
         sharded={k: np.asarray(v) for k, v in s2["params"].items()})
    # MoE forward with each case's mesh
    for case, (shape, over, _) in MOE_CASES.items():
        z = load(root / f"{case}.npz")
        mcfg = JArch(**dict(MOE_KW, **over))
        p = {k: jnp.asarray(v) for k, v in z["p"].items()}
        x = jnp.asarray(z["b"]["x"])
        y, aux = jmoe(p, mcfg, x, mesh_of(shape))
        y_ref, _ = jmoe_ref(p, mcfg, x)
        res[f"{case}_aux"] = float(aux)
        np.savez(out / f"{case}.npz", y=np.asarray(y), y_ref=np.asarray(y_ref))
    # loss and grads (the families' single-device references are made in
    # the test process: family_reference)
    for case, (shape, kw, _, _, ref) in GRAD_CASES.items():
        if case in FAMILY_CASES:
            continue
        z = load(root / f"{case}.npz")
        gcfg = (dataclasses.replace(jget(kw, smoke=True),
                                    param_dtype="float32",
                                    compute_dtype="float32")
                if isinstance(kw, str) else JArch(**kw))
        params = {k: jnp.asarray(v) for k, v in z["p"].items()}
        batch = {k: jnp.asarray(v) for k, v in z["b"].items()}
        if ref == "sharded":
            mesh = mesh_of(shape)
            model = jbuild(gcfg, mesh=mesh)
            params = place(model, params, mesh)
            batch = {k: jax.device_put(v, NamedSharding(
                mesh, P("data", *([None] * (v.ndim - 1)))))
                for k, v in batch.items()}
        else:
            model = jbuild(gcfg)
        (total, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: model.loss(p, batch), has_aux=True))(params)
        res[case] = dict(loss=float(metrics["loss"]), total=float(total))
        save(out / f"{case}.npz", g={k: np.asarray(v)
                                     for k, v in grads.items()})
    # the probe's ring branch on 4 devices
    z = load(root / "probe.npz")
    res["probe"] = jprobe({"embed": jnp.asarray(z["p"]["embed"])},
                          {"tokens": jnp.asarray(z["b"]["tokens"])},
                          mesh=mesh_of((4,), ("data",)),
                          samples_per_node=PROBE["samples_per_node"],
                          n_iters=PROBE["n_iters"])
    (out / "res.json").write_text(json.dumps(res))


# ---------------------------------------------------------------------------
# launching


def _env(**over):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "REPRO_PLATFORM")}
    env.update(PYTHONPATH=os.pathsep.join([str(SRC), str(TESTS)]),
               OMP_NUM_THREADS="1", **over)
    return env


def _spawn_world(world: int, root: Path):
    (root / f"world{world}").mkdir()
    code = ("import sys; from test_torch_dist_train import rank_main; "
            "rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], "
            "sys.argv[4])")
    return [subprocess.Popen(
        [sys.executable, "-c", code, str(world), str(r),
         str(root / f"store{world}"), str(root)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


LAUNCH_ARGS = ("--smoke", "--mesh", "2x2", "--steps", "8", "--batch", "8",
               "--seq", "32")


def _spawn_launchers(root: Path):
    """The port's launcher on 4 gloo ranks under torch.distributed.run, and
    the JAX launcher on 4 host devices."""
    port = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         *LAUNCH_ARGS],
        env=_env(REPRO_PLATFORM="cpu"), cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    jax_env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jaxl = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train", *LAUNCH_ARGS],
        env=jax_env, cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return [port, jaxl]


def _join(procs) -> list:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


def _write_jax_checkpoint(root: Path) -> None:
    """A flat tree with fp32, bf16 and 0-d leaves, written by the JAX
    package's save_checkpoint (and kept as numpy for the check)."""
    import jax.numpy as jnp
    from repro.checkpoint import save_checkpoint as jsave
    rng = np.random.default_rng(5)
    tree = {"w": rng.normal(size=(8, 6)).astype(np.float32),
            "h": rng.normal(size=(3, 4)).astype(np.float32),
            "v": rng.normal(size=(5,)).astype(np.float32),
            "s": np.asarray(7, np.int32)}
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    jtree["h"] = jtree["h"].astype(jnp.bfloat16)
    jsave(str(root / "jax_ckpt"), 3, jtree)
    tree["h"] = np.asarray(jtree["h"].astype(jnp.float32))
    save(root / "ckpt.npz", t=tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world, the JAX references and both launchers at once; returns
    the root directory and the launchers' (stdout, stderr, rc)."""
    root = tmp_path_factory.mktemp("dist")
    make_problems(root)
    _write_jax_checkpoint(root)
    jax_code = ("import sys; from test_torch_dist_train import jax_main; "
                "jax_main(sys.argv[1])")
    jaxp = subprocess.Popen(
        [sys.executable, "-c", jax_code, str(root)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    worlds = {w: _spawn_world(w, root) for w in (8, 4, 1)}
    launchers = _spawn_launchers(root)
    for w, procs in worlds.items():
        for r, ((log, _), p) in enumerate(zip(_join(procs), procs)):
            assert p.returncode == 0, f"world {w} rank {r}:\n{log}"
    (jlog, _), = _join([jaxp])
    assert jaxp.returncode == 0, jlog[-4000:]
    launched = [(o, e, p.returncode)
                for (o, e), p in zip(_join(launchers), launchers)]
    return root, launched


def _res(root: Path, world) -> dict:
    sub = "jax" if world == "jax" else f"world{world}"
    return json.loads((root / sub / "res.json").read_text())


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    assert err <= tol * scale, (what, err, tol * scale)


# ---------------------------------------------------------------------------
# the tests


def test_dp_step_matches_jax_single_and_sharded(runs):
    root, _ = runs
    got, want = _res(root, 8), _res(root, "jax")
    jax_p = load(root / "jax" / "dp.npz")
    port = load(root / "world8" / "dp.npz")["p"]
    for ref, jloss in zip(("single", "sharded"), want["dp_loss"]):
        assert abs(got["dp_loss"] - jloss) < 1e-4, (ref, got, jloss)
        for k, v in jax_p[ref].items():
            np.testing.assert_allclose(port[k], v, rtol=2e-3, atol=2e-4,
                                       err_msg=f"{ref} {k}")


def test_dp_step_on_a_pod_mesh_matches_jax_single(runs):
    """(2, 2, 2) ("pod", "data", "model"): the batch and FSDP over
    ("pod", "data"), the multi-axis sub-groups, against the JAX package's
    single-device step at check_dp_train's tolerances."""
    root, _ = runs
    got = _res(root, 8)["pod_loss"]
    jloss = _res(root, "jax")["dp_loss"][0]
    assert abs(got - jloss) < 1e-4, (got, jloss)
    port = load(root / "world8" / "pod.npz")["p"]
    for k, v in load(root / "jax" / "dp.npz")["single"].items():
        np.testing.assert_allclose(port[k], v, rtol=2e-3, atol=2e-4,
                                   err_msg=k)


def test_global_norm_over_pod_and_data(runs):
    root, _ = runs
    tree, _ = _norm_tree()
    want = math.sqrt(sum(float((t.double() ** 2).sum())
                         for t in tree.values()))
    assert abs(_res(root, 8)["pod_norm"] - want) <= 1e-6 * want


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_forward_matches_jax_shard_map(runs, case):
    root, _ = runs
    world = 8 if case == "moe24" else 4
    got = np.load(root / f"world{world}" / f"{case}.npy")
    with np.load(root / "jax" / f"{case}.npz") as z:
        want, ref = z["y"], z["y_ref"]
    _close(got, want, 1e-5, case)
    assert abs(_res(root, world)[f"{case}_aux"]
               - _res(root, "jax")[f"{case}_aux"]) <= 1e-5
    if case == "drop":
        # the capacity binds: far from the drop-free loop, and the JAX
        # package dropped the same tokens
        assert float(np.abs(want - ref).max()) > 100 * float(
            np.abs(got - want).max() + 1e-9)


_FAMILY_REFS = {}


def family_reference(root: Path, case):
    """(losses, grads) of a family case's problem: the JAX package's
    single-device ``value_and_grad``, made once a problem in this process
    (beside ``jax_main``'s subprocess, whose share it would lengthen)."""
    problem = problem_of(case)
    if problem not in _FAMILY_REFS:
        import jax
        import jax.numpy as jnp
        from repro.configs import get_config as jget
        from repro.models import build_model as jbuild
        z = load(root / f"{problem}.npz")
        name, over = family_of(case)
        model = jbuild(dataclasses.replace(jget(name, smoke=True),
                                           param_dtype="float32",
                                           compute_dtype="float32", **over))
        batch = {k: jnp.asarray(v) for k, v in z["b"].items()}
        (total, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: model.loss(p, batch), has_aux=True))(
            {k: jnp.asarray(v) for k, v in z["p"].items()})
        _FAMILY_REFS[problem] = (
            dict(loss=float(metrics["loss"]), total=float(total)),
            {k: np.asarray(v) for k, v in grads.items()})
    return _FAMILY_REFS[problem]


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_loss_and_grads_match_jax(runs, case):
    root, _ = runs
    got = _res(root, 4)[case]
    if case in FAMILY_CASES:
        want, jg = family_reference(root, case)
    else:
        want = _res(root, "jax")[case]
        jg = load(root / "jax" / f"{case}.npz")["g"]
    for k in ("loss", "total"):
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got, want)
    g = load(root / "world4" / f"{case}.npz")["g"]
    assert set(g) == set(jg)
    for k, v in jg.items():
        scale = max(float(np.abs(v).max()), 1e-30)
        err = float(np.abs(g[k] - v).max())
        assert err <= 1e-4 * scale, (case, k, err, scale)


@pytest.mark.parametrize("case", FAMILY_CASES)
def test_family_grads_match_one_process(runs, case):
    """The ssm, hybrid and audio families' step over the mesh against the
    port's own step in one process on the same weights and batch: loss at
    1e-5 relative, each key's gradient at 1e-4 * max|g|."""
    from repro_torch.train.loop import loss_and_grads
    root, _ = runs
    z = load(root / f"{problem_of(case)}.npz")
    cfg = grad_cfg(case)
    total, metrics, grads = loss_and_grads(
        build_model(cfg, device="cpu"), _tensors(z["p"]), _tensors(z["b"]))
    got = _res(root, 4)[case]
    assert abs(got["loss"] - float(metrics["loss"])) <= \
        1e-5 * abs(float(metrics["loss"])), (got, float(metrics["loss"]))
    g = load(root / "world4" / f"{case}.npz")["g"]
    for k, v in grads.items():
        v = np_of(v)
        scale = max(float(np.abs(v).max()), 1e-30)
        err = float(np.abs(g[k] - v).max())
        assert err <= 1e-4 * scale, (case, k, err, scale)


@pytest.mark.parametrize("case", FAMILY_CASES)
def test_mamba_leaves_gathered_whole_only_in_the_fallback(runs, case):
    """Over a "model" axis of more than one rank falcon-mamba's and
    zamba2's mamba layers run split and no all-gather returns a whole
    mamba leaf split over "model", but where 4 does not divide d_inner
    (the divisibility fallback)."""
    root, _ = runs
    hits = _res(root, 4)[case]["whole_leaf_gathers"]
    if case == "falcon_odd14":
        assert hits > 0, (case, hits)
    elif GRAD_CASES[case][0][1] > 1:
        assert hits == 0, (case, hits)


def split_layer_collectives(cfg, tokens: int, tp: int, nbytes: int = 4):
    """``Mesh.counts`` of one mamba layer split over ``tp`` "model" ranks,
    forward and backward, for ``tokens`` token rows of fp32 (the design
    in ``models/mamba.py``'s docstring)."""
    e, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    if cfg.mamba_version == 1:
        cols = 2 * di
        # forward: w_x's sum, "g"; backward: w_x's sum again, "f" on x
        rows = [cfg.dt_rank + 2 * n, e] * 2
        leaves = []
    else:
        nh = di // cfg.ssm_head_dim
        cols = 2 * di + 2 * n + nh
        # forward: the norm's sum of squares, "g"; backward: the norm's
        # sum, "f" on x and on B and C (the replicated leaves' partial
        # gradients the caller sums)
        rows = [1, e, 1, e, 2 * n]
    return {"all_gather": 1, "all_gather_bytes": tokens * cols * nbytes,
            "reduce_scatter": 1,
            "reduce_scatter_bytes": tokens * cols // tp * nbytes,
            "all_reduce": len(rows),
            "all_reduce_bytes": tokens * sum(rows) * nbytes}


@pytest.mark.parametrize("arch", SPLIT_LAYERS)
def test_split_mamba_layer_collectives(runs, arch):
    """One split mamba1 and mamba2 layer at (1, 4), forward and backward:
    the collectives of the design, kind by kind and byte for byte, no
    whole leaf gathered, and the layer's values and gradients those of the
    whole layer in one process (1e-5 relative; leaf gradients as the
    family cases', 1e-4 of each leaf's max)."""
    root, _ = runs
    got = _res(root, 4)["split_layers"][arch]
    assert got["counts"] == split_layer_collectives(
        smoke_fp32(arch), LAYER_B * LAYER_L, 4), got["counts"]
    assert got["whole_leaf_gathers"] == 0
    assert got["y_err"] <= 1e-5 and got["x_grad_err"] <= 1e-5, got
    assert got["leaf_grad_err"] <= 1e-4, got


def test_split_mamba2_layer_rounds_as_one_device(runs):
    """The split mamba2 layer in bf16 at (1, 4) rounds where one device
    does (the sums over the ranks in fp32, rounded once): with bf16
    products accumulated in fp32, as a card's are, y and x's gradient are
    the whole layer's but for flips of fp32 summation order (under 1 % of
    their elements; summing bf16 partials parts most of them) and every
    leaf gradient is the whole layer's bitwise."""
    root, _ = runs
    got = _res(root, 4)["split_layers"]["zamba2-1.2b"]["bf16"]
    assert got["y_differ"] < 1e-2 and got["x_grad_differ"] < 1e-2, got
    assert got["leaf_grads_bitwise"], got


def test_probe_ring_branch_matches_jax(runs):
    root, _ = runs
    got, want = _res(root, 4)["probe"], _res(root, "jax")["probe"]
    assert not got["skipped"] and not want["skipped"]
    for k in ("consensus_residual", "participation_mean",
              "participation_cv"):
        assert abs(got[k] - want[k]) <= 5e-3 * abs(want[k]) + 1e-4, \
            (k, got, want)


def test_global_norm_on_a_mixed_tree(runs):
    root, _ = runs
    tree, _ = _norm_tree()
    want = math.sqrt(sum(float((t.double() ** 2).sum())
                         for t in tree.values()))
    assert abs(_res(root, 4)["norm"] - want) <= 1e-6 * want


def test_jax_checkpoint_onto_a_mesh_and_elastic_round_trip(runs):
    from repro_torch.checkpoint import restore_checkpoint
    root, _ = runs
    want = load(root / "ckpt.npz")["t"]
    got = load(root / "world4" / "ckpt.npz")
    for name in ("jax_onto_22", "22_onto_41"):
        assert set(got[name]) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[name][k], v, err_msg=name)
    meta = json.loads((root / "world4" / "ckpt.json").read_text())
    assert meta == dict(meta={"m": 1}, step=5)
    # and back on one device, no mesh
    tree, _, step = restore_checkpoint(str(root / "world4" / "ckpt22"))
    assert step == 5 and tree["h"].dtype == torch.bfloat16
    for k, v in want.items():
        np.testing.assert_array_equal(
            np.asarray(torch.as_tensor(tree[k]).float()), v)


def test_compressed_mean_over_a_mesh_data_axis(runs):
    """compressed_psum_grads given a (2, 2) mesh averages over the ranks of
    each rank's "data" sub-group (ranks m and 2 + m), not the world."""
    root, _ = runs
    grads = _compress_grads()
    for rank in range(4):
        peers = [rank % 2, 2 + rank % 2]
        with np.load(root / "world4" / f"compress.r{rank}.npz") as z:
            for k, v in grads.items():
                _close(z[k], v[peers].mean(0), 1e-5, (rank, k))


def test_serving_mesh_placements():
    from repro_torch.launch import mesh_shardings, replicate_on_mesh
    devs = [torch.device("cpu")] * 2
    rows, rep = mesh_shardings(devs)
    t = torch.arange(12.0).reshape(4, 3)
    parts = rows(t)
    assert len(parts) == 2 and torch.equal(torch.cat(parts), t)
    assert all(torch.equal(c, t) for c in rep(t))
    with pytest.raises(ValueError):
        rows(torch.zeros(3, 2))
    tree = replicate_on_mesh({"a": t}, devs)
    assert len(tree["a"]) == 2 and torch.equal(tree["a"][1], t)


def test_train_resumes_at_another_mesh(runs):
    """A checkpoint train() wrote on (2, 2) resumes train() on (4, 1): the
    restored state is the saved one bit for bit, the loop starts at step 2
    and the data stream at its saved position."""
    root, _ = runs
    res = _res(root, 4)["resume"]
    assert len(res["first"]) == 2 and res["resumed_steps"] == 0
    assert res["restored_bitwise"]
    assert len(res["continued"]) == 1 and math.isfinite(res["continued"][0])
    assert res["data_step"] == 3


@pytest.mark.parametrize("shape", ZAMBA_TRAIN_MESHES)
def test_zamba2_split_train_matches_one_process(runs, shape):
    """train() of zamba2's fp32 smoke config with its mamba2 layers split
    over "model" (the replicated leaves' partial gradients summed once a
    step, the global norm, AdamW) against the port's train() in one
    process: losses at 1e-5 relative, params after the steps at 1e-4 x
    max(1, max|p|) of each leaf."""
    root, _ = runs
    name = "zamba_train{}{}".format(*shape)
    want_loss, want = zamba_train()
    got_loss = _res(root, 4)[name]
    assert len(got_loss) == ZAMBA_TRAIN["steps"]
    for g, w in zip(got_loss, want_loss):
        assert abs(g - w) <= 1e-5 * abs(w), (got_loss, want_loss)
    got = load(root / "world4" / f"{name}.npz")["p"]
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k], v, 1e-4, k)


def test_a_one_rank_mesh_is_the_single_device_step(runs):
    root, _ = runs
    res = _res(root, 1)
    assert res["w1_losses"][0] == res["w1_losses"][1]
    assert res["w1_train"][0] == res["w1_train"][1]
    assert res["w1_state_equal"]
    assert res["w1_moe_equal"] == [True] * len(MOE_CASES)


def _last_line(out: str) -> str:
    lines = [ln for ln in out.splitlines() if ln.startswith("final loss: ")]
    assert len(lines) == 1, out
    return lines[0]


def test_launcher_on_a_2x2_mesh_beside_jax(runs):
    _, launched = runs
    vocab = tcfgs.get_config("llama3.2-3b", smoke=True).vocab
    for (out, err, rc), who in zip(launched, ("port", "jax")):
        assert rc == 0, (who, err[-3000:])
        last = _last_line(out)
        assert out.strip().splitlines()[-1] == last
        assert "straggler flags: " in last
        final = float(last.split("final loss: ")[1].split()[0])
        first = float(last.split("(first: ")[1].split(")")[0])
        assert abs(first - math.log(vocab)) < 2.5, (who, first)
        assert final < first, (who, final, first)


# ---------------------------------------------------------------------------
# the sharding rules (no ranks)


class _Stub:
    def __init__(self, shape: dict, coords=None):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.coords = coords


def test_local_shards_tile_the_tensor_and_have_shard_shape():
    """Every device's ``local_shard`` of a (pod, data, model)-split tensor
    has ``shard_shape`` and the shards put back in row-major device order
    are the tensor (a ("pod", "data") dim split pod-major)."""
    import itertools
    from repro_torch.distributed import shard_shape
    shape = {"pod": 2, "data": 2, "model": 2}
    spec = (("pod", "data"), None, "model")
    full = torch.arange(8 * 3 * 4).reshape(8, 3, 4)
    rows = []
    for p, d in itertools.product(range(2), range(2)):
        cols = []
        for m in range(2):
            part = local_shard(full, spec, _Stub(shape, dict(
                pod=p, data=d, model=m)))
            assert tuple(part.shape) == shard_shape(full.shape, spec,
                                                    _Stub(shape))
            cols.append(part)
        rows.append(torch.cat(cols, dim=2))
    assert torch.equal(torch.cat(rows, dim=0), full)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2}, "1x1": {"data": 1, "model": 1}}


def _norm_spec(spec) -> tuple:
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


@pytest.mark.parametrize("name", tcfgs.ARCH_NAMES)
def test_spec_for_matches_jax_on_every_leaf(name):
    """Every leaf of the JAX package's abstract tree (all 10 configs), and
    the port's own meta-device tree of each: the same keys, shapes and
    axes."""
    import jax
    from repro.configs import get_config as jget
    from repro.distributed.sharding import default_rules as jrules
    from repro.distributed.sharding import spec_for as jspec
    from repro.models import build_model as jbuild
    from repro.models.common import abstract_params
    jcfg = jget(name)
    shapes, axes = abstract_params(jbuild(jcfg).init, jax.random.PRNGKey(0))
    pshapes, paxes = build_model(tcfgs.get_config(name),
                                 device="meta").init(None)
    assert paxes == axes
    port = {k: tuple(v.shape) for k, v in pshapes.items()}
    assert port == {k: tuple(v.shape) for k, v in shapes.items()}
    for mesh_name, shape in MESHES.items():
        stub = _Stub(shape)
        multi = "pod" in shape
        for k, v in shapes.items():
            want = _norm_spec(jspec(v.shape, axes[k], jrules(multi), stub))
            got = spec_for(v.shape, axes[k], default_rules(multi), stub)
            assert _norm_spec(got) == want, (name, mesh_name, k)
