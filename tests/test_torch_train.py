"""The port's LM training half against the JAX package's, on the CPU.

Every case feeds the same seeded numpy inputs, and where weights are
needed the JAX package's own ``model.init(PRNGKey(0))`` weights converted
by ``params_from_jax``, through both packages (``jax.random`` is never
reproduced). TF32 is off in this process (``repro_torch`` switches it off
on import). Tolerances, each stated where it is used:

  * schedule: ``cosine_with_warmup`` at 1e-7 absolute (the two packages'
    fp32 cosines differ in the last bit at a few steps);
  * AdamW: params, moments and metrics at 1e-6 * max(1, |x|); the in-place
    form bitwise the functional one;
  * grads of ``lm_loss`` against ``jax.value_and_grad``: 1e-4 * max|g| per
    key, in fp32; remat "none", "full", "dots" bitwise;
  * the train loop resumed from a checkpoint the JAX loop wrote: losses at
    1e-4 relative, params at 1e-4 * max|p|;
  * compression: ``p q^T`` and the new error at 1e-5 * max(1, |x|); the
    4-rank gloo mean against the JAX package on 4 host devices at 1e-4 *
    max(1, |x|), and against the dense mean at relative 0.05;
  * the activation probe at 2e-4 relative.

The compressed mean runs in 4 ``python -c`` children over gloo (they
import the port only), meeting at a ``file://`` store under the test's
temporary directory, each waited on with a timeout.
"""

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jcfgs
from repro import optim as jopt
from repro.configs.base import ArchConfig as JArch
from repro.data.tokens import TokenStream as JStream
from repro.models import build_model as jbuild
from repro.train import activation_probe as jprobe
from repro.train import loop as jloop

from repro_torch import checkpoint as tckpt
from repro_torch import configs as tcfgs
from repro_torch import optim as topt
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.data import TokenStream
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import common as tcommon
from repro_torch.optim.adamw import adamw_update_
from repro_torch.train import activation_probe, loop as tloop

SRC = Path(__file__).resolve().parents[1] / "src"
DECODERS = ["llama3.2-3b", "llama3-405b", "qwen3-32b", "phi4-mini-3.8b",
            "deepseek-v2-236b", "mixtral-8x22b", "internvl2-76b"]
RANK_TIMEOUT_S = 240
WORLD = 4


def close(got, want, tol, scale=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    s = max(1.0, float(np.abs(want).max())) if scale is None else scale
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * s, (err, tol * s)


def np_of(t):
    return t.detach().float().numpy() if torch.is_tensor(t) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def tiny_kw(**over):
    """tests/test_train_loop.py's _cfg()."""
    kw = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
              tie_embeddings=True, remat="none", param_dtype="float32",
              compute_dtype="float32")
    kw.update(over)
    return kw


def fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def pair_of(jcfg, tcfg):
    """(JAX model, JAX params, port model, port params from JAX's)."""
    jm = jbuild(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu",
                         cfg=tcfg)
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def tiny():
    return pair_of(JArch(**tiny_kw()), TArch(**tiny_kw()))


# ---------------------------------------------------------------------------
# schedule


@pytest.mark.parametrize("warmup,total,min_ratio", [
    (10, 100, 0.1), (5, 60, 0.1), (1, 6, 0.1), (0, 10, 0.1), (3, 3, 0.0),
    (2, 20, 0.3)])
def test_schedule_matches_jax(warmup, total, min_ratio):
    j = jopt.cosine_with_warmup(warmup, total, min_ratio)
    t = topt.cosine_with_warmup(warmup, total, min_ratio)
    for s in range(total + 4):
        got = t(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        want = float(j(jnp.asarray(s, jnp.int32)))
        assert abs(float(got) - want) <= 1e-7, (s, float(got), want)


def test_schedule_twin():
    """tests/test_substrate.py::TestAdamW::test_schedule on the port."""
    s = topt.cosine_with_warmup(10, 100)
    assert float(s(torch.tensor(0))) == 0.0
    assert abs(float(s(torch.tensor(10))) - 1.0) < 1e-5
    assert float(s(torch.tensor(100))) <= 0.11


# ---------------------------------------------------------------------------
# AdamW

def _opt_problem(dtype, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(3, 4, 5)), "m2": rng.normal(size=(6, 7)),
              "b": rng.normal(size=(5,))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    grads = [{k: (rng.normal(size=v.shape) * 3).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    tp = {k: torch.tensor(v).to(tdt) for k, v in params.items()}
    return jp, tp, grads


OPT_CASES = {
    "clip_decay": dict(),
    "noclip_decay": dict(clip_norm=0.0),
    "clip_nodecay": dict(weight_decay=0.0),
    "noclip_nodecay": dict(clip_norm=0.0, weight_decay=0.0),
    "tight_clip": dict(clip_norm=0.5, lr=1e-2),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(case, dtype):
    kw = OPT_CASES[case]
    jcfg = jopt.AdamWConfig(schedule=jopt.cosine_with_warmup(1, 5), **kw)
    tcfg = topt.AdamWConfig(schedule=topt.cosine_with_warmup(1, 5), **kw)
    jp, tp, grads = _opt_problem(dtype)
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    for g in grads:
        jg = {k: jnp.asarray(v).astype(jp[k].dtype) for k, v in g.items()}
        tg = {k: torch.tensor(v).to(tp[k].dtype) for k, v in g.items()}
        jp, js, jm = jopt.adamw_update(jcfg, jp, jg, js)
        tp, ts, tm = topt.adamw_update(tcfg, tp, tg, ts)
        for k in tp:
            assert tp[k].dtype == (torch.bfloat16 if dtype == "bfloat16"
                                   else torch.float32)
            assert ts["m"][k].dtype == torch.float32
            close(np_of(tp[k]), np_of(jp[k]), 1e-6)
            close(np_of(ts["m"][k]), np_of(js["m"][k]), 1e-6)
            close(np_of(ts["v"][k]), np_of(js["v"][k]), 1e-6)
        for key in ("grad_norm", "lr"):
            close(float(tm[key]), float(jm[key]), 1e-6)
        assert int(ts["step"]) == int(js["step"])


@pytest.mark.parametrize("case", sorted(OPT_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_in_place_is_functional_bitwise(case, dtype, monkeypatch):
    """The loop's in-place update, a few rows at a time, gives the
    functional update's bits."""
    from repro_torch.optim import adamw as tadamw
    monkeypatch.setattr(tadamw, "SLICE_ELEMS", 12)    # several slices
    kw = OPT_CASES[case]
    cfg = topt.AdamWConfig(schedule=topt.cosine_with_warmup(1, 5), **kw)
    _, tp, grads = _opt_problem(dtype)
    fp = {k: v.clone() for k, v in tp.items()}
    fs, st = topt.adamw_init(fp), topt.adamw_init(tp)
    for g in grads:
        tg = {k: torch.tensor(v).to(tp[k].dtype) for k, v in g.items()}
        fp, fs, fm = topt.adamw_update(cfg, fp, tg, fs)
        im = adamw_update_(cfg, tp, tg, st)
        for k in tp:
            assert torch.equal(tp[k], fp[k]), k
            assert torch.equal(st["m"][k], fs["m"][k]), k
            assert torch.equal(st["v"][k], fs["v"][k]), k
        assert torch.equal(im["grad_norm"], fm["grad_norm"])
        assert torch.equal(st["step"], fs["step"])


def test_adamw_converges_quadratic():
    """tests/test_substrate.py::TestAdamW::test_converges_quadratic."""
    params = {"w": torch.tensor([5.0, -3.0])}
    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=0.0)
    state = topt.adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = topt.adamw_update(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 1e-2


def test_adamw_clipping():
    """tests/test_substrate.py::TestAdamW::test_clipping."""
    params = {"w": torch.zeros(3)}
    cfg = topt.AdamWConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0)
    state = topt.adamw_init(params)
    _, _, metrics = topt.adamw_update(cfg, params,
                                      {"w": torch.full((3,), 100.0)}, state)
    assert float(metrics["grad_norm"]) > 100


def test_global_norm_slices_agree():
    """The norm summed a slice of rows at a time, against float64."""
    rng = np.random.default_rng(3)
    tree = {"a": torch.tensor(rng.normal(size=(9, 4, 3)).astype(np.float32)),
            "b": [torch.tensor(rng.normal(size=(7,)).astype(np.float32))]}
    want = math.sqrt(sum(float((t.double() ** 2).sum())
                         for t in (tree["a"], tree["b"][0])))
    assert abs(float(topt.global_norm(tree)) - want) <= 1e-6 * want


# ---------------------------------------------------------------------------
# loss and grads


def _grads_both(jm, jp, tm, tp, jbatch, tbatch):
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jbatch), has_aux=True))(jp)
    tl, _, tg = tloop.loss_and_grads(tm, tp, tbatch)
    return float(jl), jg, float(tl), tg


def _batch(cfg_j, cfg_t, b=2, s=32):
    jb = jcfgs.concrete_train_batch(cfg_j, b, s)
    tb = tcfgs.concrete_train_batch(cfg_t, b, s, device="cpu")
    return jb, tb


def _assert_grads(jg, tg):
    assert set(jg) == set(tg)
    for k in tg:
        want = np.asarray(jg[k], np.float32)
        scale = max(float(np.abs(want).max()), 1e-30)
        close(tg[k].float().numpy(), want, 1e-4, scale=scale)


def test_tiny_grads_match_jax(tiny):
    jm, jp, tm, tp = tiny
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, size=(4, 32), dtype=np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jl, jg, tl, tg = _grads_both(
        jm, jp, tm, tp, {k: jnp.asarray(v) for k, v in batch.items()},
        {k: torch.as_tensor(v) for k, v in batch.items()})
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    _assert_grads(jg, tg)


@pytest.mark.parametrize("name", ["mixtral-8x22b", "deepseek-v2-236b",
                                  "internvl2-76b"])
def test_smoke_fp32_grads_match_jax(name):
    """MoE (SWA, 8 experts top-2), MLA with a dense first layer and shared
    experts, and the VLM prefix, in fp32 (the dense GQA decoder is the tiny
    config's case)."""
    jc = fp32(jcfgs.get_config(name, smoke=True))
    tc = fp32(tcfgs.get_config(name, smoke=True))
    jm, jp, tm, tp = pair_of(jc, tc)
    jb, tb = _batch(jc, tc)
    jl, jg, tl, tg = _grads_both(jm, jp, tm, tp, jb, tb)
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    _assert_grads(jg, tg)


@pytest.mark.parametrize("name", DECODERS)
def test_train_step(name):
    """tests/test_arch_smoke.py::test_train_step on the port's smoke
    configs (bf16): finite loss and grads, grad norm > 0, and one SGD step
    changes the loss."""
    cfg = tcfgs.get_config(name, smoke=True)
    model = build_model(cfg, device="cpu")
    params, _ = model.init(0)
    batch = tcfgs.concrete_train_batch(cfg, 2, 32, device="cpu")
    loss, _, grads = tloop.loss_and_grads(model, params, batch)
    assert np.isfinite(float(loss))
    gnorm = float(topt.global_norm(grads))
    assert np.isfinite(gnorm) and gnorm > 0, name
    params2 = {k: v - 0.1 * grads[k].to(v.dtype) for k, v in params.items()}
    loss2, _ = model.loss(params2, batch)
    assert np.isfinite(float(loss2))
    assert float(loss2) != float(loss)


@pytest.mark.parametrize("name", ["tiny", "mixtral-8x22b",
                                  "deepseek-v2-236b"])
def test_remat_modes_give_the_same_grads(name):
    """remat "none", "full" and "dots" (and deepseek's dense first layer
    under checkpoint) give the same grads, bitwise."""
    base = TArch(**tiny_kw()) if name == "tiny" \
        else tcfgs.get_config(name, smoke=True)
    params = None
    got = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        model = build_model(cfg, device="cpu")
        if params is None:
            params, _ = model.init(0)
        batch = tcfgs.concrete_train_batch(cfg, 2, 16, device="cpu")
        got[remat] = tloop.loss_and_grads(model, params, batch)
    for remat in ("full", "dots"):
        assert torch.equal(got[remat][0], got["none"][0])
        for k, g in got["none"][2].items():
            assert torch.equal(got[remat][2][k], g), (remat, k)


def test_remat_checkpoints_and_saves_what_it_should(tiny):
    """"full" recomputes every layer's forward in the backward pass, "dots"
    keeps the weight products (fewer recomputed products than "full"),
    "none" recomputes nothing: counted through the products dispatched."""
    from torch.utils._python_dispatch import TorchDispatchMode
    _, _, _, tp = tiny

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.bmm.default:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for remat in ("none", "full", "dots"):
        model = build_model(TArch(**tiny_kw(remat=remat)), device="cpu")
        batch = tcfgs.concrete_train_batch(model.cfg, 2, 16, device="cpu")
        Count.n = 0
        with Count():
            tloop.loss_and_grads(model, tp, batch)
        counts[remat] = Count.n
    assert counts["none"] < counts["dots"] < counts["full"], counts


def test_unbind_and_select_give_the_same_grads(tiny, monkeypatch):
    """Layers sliced by one unbind per stack, or by a select per layer:
    the same grads, bitwise (the card run measures their cost)."""
    jm, jp, tm, tp = tiny
    batch = tcfgs.concrete_train_batch(tm.cfg, 2, 16, device="cpu")
    _, _, want = tloop.loss_and_grads(tm, tp, batch)
    monkeypatch.setattr(tcommon, "layer_slices", lambda st: [
        {k: v[i] for k, v in st.items()}
        for i in range(tcommon.n_stacked(st))])
    _, _, got = tloop.loss_and_grads(tm, tp, batch)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_moe_dispatch_backward_matches_dense_loop():
    """moe.py's index_put_ into fresh buffers under autograd: the capacity
    dispatch's grads equal the dense expert loop's where nothing drops
    (fp32, at 1e-5 * max|g|)."""
    from repro_torch.models.common import ParamCollector
    from repro_torch.models.moe import init_moe, moe_forward, moe_forward_ref
    cfg = fp32(tcfgs.get_config("mixtral-8x22b", smoke=True))
    col = ParamCollector(torch.Generator().manual_seed(0), torch.float32)
    init_moe(col, cfg, "moe")
    p = {k[len("moe/"):]: v for k, v in col.params.items()}
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    out = {}
    for name, fn in (("dispatch", moe_forward), ("ref", moe_forward_ref)):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xx = x.clone().requires_grad_(True)
        y, aux = fn(leaves, cfg, xx)
        g = torch.autograd.grad((y ** 2).sum() + aux,
                                [xx, *leaves.values()])
        out[name] = dict(zip(["x", *leaves], g))
    for k, want in out["ref"].items():
        close(out["dispatch"][k].numpy(), want.numpy(), 1e-5,
              scale=max(float(want.abs().max()), 1e-30))


# ---------------------------------------------------------------------------
# the train loop


def _np_state(state):
    return {g: {k: np.array(np_of(v)) for k, v in state[g].items()}
            for g in ("params", "m", "v")}


def test_nan_guard_skips_in_both_packages(tiny, monkeypatch):
    """model.loss patched to return NaN for one step: params, m and v stay,
    step advances, skipped is set, in both packages."""
    jm, jp, tm, tp = tiny
    jcfg = jopt.AdamWConfig(lr=1e-2)
    tcfg = topt.AdamWConfig(lr=1e-2)
    data = JStream(vocab=256, batch=2, seq=16, seed=0)
    batches = [data.next_batch() for _ in range(2)]
    out = {}
    for side, model, params in (("jax", jm, jp), ("torch", tm, tp)):
        if side == "jax":      # the jitted step donates its state: copies
            _, step_fn = jloop.build_train_step(model, jcfg)
            params = {k: jnp.array(v, copy=True) for k, v in params.items()}
            state = dict(params=params, **jopt.adamw_init(params))
            conv = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
        else:
            _, step_fn = tloop.build_train_step(model, tcfg)
            params = {k: v.clone() for k, v in params.items()}
            state = dict(params=params, **topt.adamw_init(params))
            conv = lambda b: {k: torch.as_tensor(np.asarray(v))
                              for k, v in b.items()}
        state, m1 = step_fn(state, conv(batches[0]))
        before = _np_state(state)
        step_before = int(state["step"])
        orig = model.loss

        def bad(p, b, orig=orig):
            loss, met = orig(p, b)
            return loss * float("nan"), met

        monkeypatch.setattr(model, "loss", bad)
        if side == "jax":    # the jitted step closes over model.loss
            _, step_fn = jloop.build_train_step(model, jcfg)
        state, m2 = step_fn(state, conv(batches[1]))
        monkeypatch.setattr(model, "loss", orig)
        after = _np_state(state)
        for g in before:
            for k in before[g]:
                np.testing.assert_array_equal(after[g][k], before[g][k])
        assert int(state["step"]) == step_before + 1
        assert float(m1["skipped"]) == 0.0 and float(m2["skipped"]) == 1.0
        out[side] = float(m1["loss"])
    assert abs(out["torch"] - out["jax"]) <= 1e-4 * abs(out["jax"])


def test_resume_from_a_jax_checkpoint(tiny, tmp_path):
    """The JAX loop writes a checkpoint at step 4 and resumes to step 8;
    the port's loop resumes from the same checkpoint (params, moments,
    step and the data stream's state) and gives the same steps 5-8."""
    jm, _, _, _ = tiny
    tm = build_model(TArch(**tiny_kw()), device="cpu")
    jcfg = jopt.AdamWConfig(lr=3e-3, schedule=jopt.cosine_with_warmup(2, 8))
    tcfg = topt.AdamWConfig(lr=3e-3, schedule=topt.cosine_with_warmup(2, 8))
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jloop.train(jm, jcfg, JStream(vocab=256, batch=4, seq=32, seed=0),
                jloop.TrainConfig(steps=4, ckpt_dir=str(jdir), ckpt_every=4,
                                  log_every=0))
    shutil.copytree(jdir, tdir)
    jstate, jh = jloop.train(
        jm, jcfg, JStream(vocab=256, batch=4, seq=32, seed=0),
        jloop.TrainConfig(steps=8, ckpt_dir=str(jdir), ckpt_every=4,
                          log_every=0))
    tdata = TokenStream(vocab=256, batch=4, seq=32, seed=0, device="cpu")
    tstate, th = tloop.train(
        tm, tcfg, tdata, tloop.TrainConfig(steps=8, ckpt_dir=str(tdir),
                                           ckpt_every=4, log_every=0))
    assert len(th["loss"]) == len(jh["loss"]) == 4
    assert tdata.step == 8
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    assert int(tstate["step"]) == int(jstate["step"]) == 8
    for k, v in jstate["params"].items():
        want = np.asarray(v)
        close(np_of(tstate["params"][k]), want, 1e-4,
              scale=float(np.abs(want).max()))
    # the port's own checkpoint at step 8 restores what it trained
    flat, meta, step = tckpt.restore_checkpoint(str(tdir))
    assert step == 8 and meta["data_state"] == {"seed": 0, "step": 8}
    back = tloop._unflatten_state(flat)
    for g in ("params", "m", "v"):
        for k, v in tstate[g].items():
            assert torch.equal(back[g][k], v), (g, k)


def test_train_loop_matches_jax_from_the_same_weights(tiny, tmp_path):
    """8 steps of both loops from the JAX package's step-0 checkpoint of
    the same weights: losses at 1e-4 relative, params at 1e-4 * max|p|."""
    jm, jp, tm, _ = tiny
    jstate = {"params": jp, **jopt.adamw_init(jp)}
    jckpt.save_checkpoint(str(tmp_path / "a"), 0,
                          jloop._flatten_state(jstate),
                          metadata={"data_state": {"seed": 5, "step": 0}})
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    jcfg = jopt.AdamWConfig(lr=3e-3, schedule=jopt.cosine_with_warmup(2, 8))
    tcfg = topt.AdamWConfig(lr=3e-3, schedule=topt.cosine_with_warmup(2, 8))
    js, jh = jloop.train(jm, jcfg, JStream(vocab=256, batch=4, seq=32),
                         jloop.TrainConfig(steps=8, ckpt_dir=str(
                             tmp_path / "a"), ckpt_every=0, log_every=0))
    ts, th = tloop.train(tm, tcfg, TokenStream(vocab=256, batch=4, seq=32,
                                               device="cpu"),
                         tloop.TrainConfig(steps=8, ckpt_dir=str(
                             tmp_path / "b"), ckpt_every=0, log_every=0))
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    for k, v in js["params"].items():
        want = np.asarray(v)
        close(np_of(ts["params"][k]), want, 1e-4,
              scale=float(np.abs(want).max()))


def test_loss_decreases():
    """tests/test_train_loop.py::test_loss_decreases on the port."""
    model = build_model(TArch(**tiny_kw()), device="cpu")
    data = TokenStream(vocab=256, batch=4, seq=32, seed=0, device="cpu")
    opt = topt.AdamWConfig(lr=3e-3, schedule=topt.cosine_with_warmup(5, 60))
    _, hist = tloop.train(model, opt, data,
                          tloop.TrainConfig(steps=60, log_every=0))
    first = float(np.mean(hist["loss"][:5]))
    last = float(np.mean(hist["loss"][-5:]))
    assert last < first - 0.5, (first, last)
    assert np.isfinite(hist["loss"]).all()


def test_history_and_monitoring_fields():
    """tests/test_train_loop.py::test_history_and_monitoring_fields."""
    model = build_model(TArch(**tiny_kw()), device="cpu")
    data = TokenStream(vocab=256, batch=2, seq=16, seed=1, device="cpu")
    _, hist = tloop.train(model, topt.AdamWConfig(lr=1e-3), data,
                          tloop.TrainConfig(steps=8, log_every=0))
    assert len(hist["loss"]) == 8
    assert len(hist["step_time"]) == 8
    assert "straggler_flags" in hist


def test_init_fn_takes_a_seed_or_a_generator():
    model = build_model(TArch(**tiny_kw()), device="cpu")
    init_fn, _ = tloop.build_train_step(model, topt.AdamWConfig())
    a, axes = init_fn(3)
    b, _ = init_fn(torch.Generator().manual_seed(3))
    assert set(axes) == set(a["params"])
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k])
        assert a["m"][k].dtype == torch.float32
        assert not a["m"][k].any()
    assert int(a["step"]) == 0


def test_probe_hook_runs_in_the_loop():
    model = build_model(TArch(**tiny_kw()), device="cpu")
    data = TokenStream(vocab=256, batch=96, seq=8, seed=2, device="cpu")
    _, hist = tloop.train(
        model, topt.AdamWConfig(), data,
        tloop.TrainConfig(steps=3, probe_every=2, log_every=0),
        probe_fn=lambda st, b: activation_probe(st["params"], b, n_iters=2))
    assert [s for s, _ in hist["probe"]] == [0, 2]
    assert all(not p["skipped"] for _, p in hist["probe"])


def test_a_mesh_raises():
    """A mesh whose size differs from the world raises, before any
    process group is made (this process is a world of one)."""
    from repro_torch.launch import make_mesh, make_production_mesh
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="needs 4 processes, the world "
                                         "has 1"):
        make_mesh((2, 2), ("data", "model"), device="cpu")
    for multi, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {need} processes"):
            make_production_mesh(multi_pod=multi, device="cpu")
    assert not torch.distributed.is_initialized()


def test_straggler_monitor_twin():
    for mod in (jloop, tloop):
        mon = mod.StragglerMonitor(factor=3.0)
        flags = [mon.record(t) for t in (1, 1, 1, 1, 1, 5, 1)]
        assert flags == [False] * 5 + [True, False] and mon.flagged == 1


# ---------------------------------------------------------------------------
# checkpoints


def test_async(tmp_path):
    """tests/test_substrate.py::TestCheckpoint::test_async on the port."""
    t = tckpt.save_checkpoint_async(str(tmp_path), 3, {"x": torch.ones(4)})
    t.join(timeout=30)
    assert not t.is_alive()
    assert tckpt.latest_step(str(tmp_path)) == 3


def test_async_snapshot_is_taken_before_it_returns(tmp_path):
    x = torch.arange(6.0)
    t = tckpt.save_checkpoint_async(str(tmp_path), 1, {"x": x},
                                    metadata={"k": 2})
    x.mul_(-1)                        # training goes on in place
    t.join(timeout=30)
    assert not t.is_alive()
    out, meta, step = tckpt.restore_checkpoint(str(tmp_path))
    np.testing.assert_array_equal(out["x"], np.arange(6.0, dtype=np.float32))
    assert meta == {"k": 2} and step == 1


def test_bf16_leaves_round_trip_in_the_jax_layout(tmp_path):
    """A bf16 leaf is written as the JAX package writes it (raw bits, numpy
    V2, manifest dtype "bfloat16") and read back bitwise, by the port from
    either package's checkpoint."""
    x = torch.randn(3, 5).to(torch.bfloat16)
    tckpt.save_checkpoint(str(tmp_path / "t"), 1, {"x": x})
    jckpt.save_checkpoint(str(tmp_path / "j"), 1,
                          {"x": jnp.asarray(x.float().numpy(),
                                            jnp.bfloat16)})
    for d in ("t", "j"):
        man = json.loads((tmp_path / d / "step_00000001" / "manifest.json")
                         .read_text())
        assert man["leaves"]["x"]["dtype"] == "bfloat16"
        out, _, _ = tckpt.restore_checkpoint(str(tmp_path / d))
        assert out["x"].dtype == torch.bfloat16
        assert torch.equal(out["x"], x), d
        raw = np.load(tmp_path / d / "step_00000001" / "x.npy")
        assert raw.dtype.itemsize == 2 and raw.dtype.kind == "V"


# ---------------------------------------------------------------------------
# compression


@pytest.mark.parametrize("shape,rank", [((32, 16), 4), ((3, 8, 12), 2),
                                        ((24, 12), 1)])
def test_compress_local_matches_jax(shape, rank):
    """p q^T and the new error from the same p_prev, over 3 rounds (the
    products are sign-invariant; p and q alone may differ in sign)."""
    rng = np.random.default_rng(len(shape) + rank)
    g = rng.normal(size=shape).astype(np.float32)
    rows = int(np.prod(shape[:-1]))
    p0 = rng.normal(size=(rows, rank)).astype(np.float32)
    jerr = jnp.zeros((rows, shape[-1]))
    terr = torch.zeros((rows, shape[-1]))
    jpp, tpp = jnp.asarray(p0), torch.tensor(p0)
    for _ in range(3):
        jp_, jq, jerr = jopt.compress_local(jnp.asarray(g), jerr, jpp)
        tp_, tq, terr = topt.compress_local(torch.tensor(g), terr, tpp)
        close((tp_ @ tq.T).numpy(), np.asarray(jp_ @ jq.T), 1e-5)
        close(terr.numpy(), np.asarray(jerr), 1e-5)
        jpp, tpp = jp_, tp_


def test_compression_ratio_matches_jax():
    shapes = {"w": (128, 128), "b": (128,), "s": (3, 16, 8)}
    jp = {k: jnp.zeros(s) for k, s in shapes.items()}
    tp = {k: torch.zeros(s, device="meta") for k, s in shapes.items()}
    for r in (1, 4):
        assert topt.compression_ratio(tp, r) == jopt.compression_ratio(jp, r)
    assert topt.compression_ratio({"w": tp["w"], "b": tp["b"]}, 4) < 0.1


def test_compression_error_feedback_reduces_bias():
    """tests/test_substrate.py::TestCompression::test_error_feedback_...:
    the mean compressed update approaches the true gradient."""
    rng = np.random.default_rng(0)
    g_true = torch.tensor(rng.normal(size=(32, 16)).astype(np.float32))
    err = torch.zeros((32, 16))
    p_prev = torch.tensor(rng.normal(size=(32, 4)).astype(np.float32))
    acc = torch.zeros_like(g_true)
    for _ in range(30):
        p, q, err = topt.compress_local(g_true, err, p_prev)
        acc = acc + p @ q.T
        p_prev = p
    rel = float(torch.linalg.norm(acc / 30 - g_true)
                / torch.linalg.norm(g_true))
    assert rel < 0.15, rel


def test_compression_captures_low_rank_exactly():
    rng = np.random.default_rng(1)
    u = rng.normal(size=(24, 2)).astype(np.float32)
    v = rng.normal(size=(12, 2)).astype(np.float32)
    g = torch.tensor(u @ v.T)
    err = torch.zeros_like(g)
    p_prev = torch.tensor(rng.normal(size=(24, 4)).astype(np.float32))
    for _ in range(3):
        p, q, err = topt.compress_local(g, err, p_prev)
        p_prev = p
    assert float(torch.linalg.norm(err) / torch.linalg.norm(g)) < 1e-3


def test_init_compression_state():
    params = {"w": torch.zeros((3, 4, 5)), "b": torch.zeros(5)}
    st = topt.init_compression_state(params, rank=2, seed=7)
    assert set(st) == {"w"}
    assert st["w"]["p"].shape == (12, 2) and st["w"]["err"].shape == (12, 5)
    again = topt.init_compression_state(params, rank=2, seed=7)
    assert torch.equal(st["w"]["p"], again["w"]["p"])


ROUNDS = 4


def _compress_problem():
    """check_dp_train.py's problem on 4 workers: a shared low-rank signal
    plus per-worker factors, one 2-D parameter and one 1-D."""
    rng = np.random.default_rng(0)
    u = rng.normal(size=(WORLD, 16, 3)).astype(np.float32)
    v = rng.normal(size=(12, 3)).astype(np.float32)
    g = np.einsum("wmr,nr->wmn", u, v).astype(np.float32)
    bias = rng.normal(size=(WORLD, 12)).astype(np.float32)
    p0 = rng.normal(size=(16, 3)).astype(np.float32)
    return g, bias, p0


CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.optim import compressed_psum_grads
    rank, world, store, root, rounds = (int(sys.argv[1]), int(sys.argv[2]),
                                        sys.argv[3], sys.argv[4],
                                        int(sys.argv[5]))
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    try:
        z = np.load(root + "/problem.npz")
        grads = {"w": torch.tensor(z["g"][rank]),
                 "b": torch.tensor(z["bias"][rank])}
        state = {"w": {"p": torch.tensor(z["p0"]),
                       "err": torch.zeros(z["g"].shape[1:])}}
        outs = {}
        for i in range(rounds):
            agg, state = compressed_psum_grads(grads, state)
            outs[f"w{i}"] = agg["w"].numpy()
            outs[f"err{i}"] = state["w"]["err"].numpy()
        outs["b"] = agg["b"].numpy()
        np.savez(root + f"/out.r{rank}.npz", **outs)
    finally:
        dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def gloo_compress(tmp_path_factory):
    root = tmp_path_factory.mktemp("compress")
    g, bias, p0 = _compress_problem()
    np.savez(root / "problem.npz", g=g, bias=bias, p0=p0)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), str(WORLD),
         str(root / "store"), str(root), str(ROUNDS)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    out = []
    for r in range(WORLD):
        with np.load(root / f"out.r{r}.npz") as z:
            out.append(dict(z))
    return out


def _jax_compress():
    """The JAX package's compressed_psum_grads on 4 host devices, each
    worker keeping its own error buffer."""
    from jax.sharding import PartitionSpec as P
    from repro.distributed.compat import shard_map
    from repro.launch.mesh import make_mesh
    g, bias, p0 = _compress_problem()
    mesh = make_mesh((WORLD,), ("data",))

    def body(g_loc, b_loc, p_prev, err):
        st = {"w": {"p": p_prev, "err": err[0]}}
        out, new = jopt.compressed_psum_grads(
            {"w": g_loc[0], "b": b_loc[0]}, st, mesh)
        return out["w"], out["b"], new["w"]["p"], new["w"]["err"][None]

    f = jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(P("data", None, None), P("data", None), P(None, None),
                  P("data", None, None)),
        out_specs=(P(None, None), P(None), P(None, None),
                   P("data", None, None)),
        check_vma=False))
    p, err = jnp.asarray(p0), jnp.zeros(g.shape)
    outs = []
    for _ in range(ROUNDS):
        w, b, p, err = f(jnp.asarray(g), jnp.asarray(bias), p, err)
        outs.append((np.asarray(w), np.asarray(err)))
    return outs, np.asarray(b), g, bias


def test_compressed_mean_over_gloo_matches_jax(gloo_compress):
    assert jax.device_count() >= WORLD
    jouts, jb, g, bias = _jax_compress()
    for r, out in enumerate(gloo_compress):
        close(out["b"], bias.mean(0), 1e-6)
        close(out["b"], jb, 1e-4)
        for i, (jw, jerr) in enumerate(jouts):
            close(out[f"w{i}"], jw, 1e-4)
            close(out[f"err{i}"], jerr[r], 1e-4)
        # every rank holds the same mean
        np.testing.assert_array_equal(out[f"w{ROUNDS - 1}"],
                                      gloo_compress[0][f"w{ROUNDS - 1}"])
    dense = g.mean(0)
    approx = gloo_compress[0][f"w{ROUNDS - 1}"]
    rel = np.linalg.norm(approx - dense) / np.linalg.norm(dense)
    assert rel < 0.05, rel


# ---------------------------------------------------------------------------
# the activation probe


PROBE_KW = dict(name="t", family="dense", n_layers=2, d_model=48, n_heads=2,
                n_kv_heads=1, d_ff=96, vocab=256, head_dim=24,
                tie_embeddings=True, remat="none", param_dtype="float32",
                compute_dtype="float32")


@pytest.mark.parametrize("samples,iters", [(16, 6), (32, 8)])
def test_probe_matches_jax(samples, iters):
    """tests/test_probe.py's single-device case (and the default node
    size) on the same weights and batch: every metric at 2e-4 relative."""
    jm, jp, _, tp = pair_of(JArch(**PROBE_KW), TArch(**PROBE_KW))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, size=(96, 16), dtype=np.int32)
    want = jprobe(jp, {"tokens": jnp.asarray(toks)}, mesh=None,
                  samples_per_node=samples, n_iters=iters)
    got = activation_probe(tp, {"tokens": torch.as_tensor(toks)},
                           samples_per_node=samples, n_iters=iters)
    assert not got["skipped"] and not want["skipped"]
    for k in ("consensus_residual", "participation_mean",
              "participation_cv"):
        assert np.isfinite(got[k])
        assert abs(got[k] - want[k]) <= 2e-4 * abs(want[k]), (k, got, want)


def test_probe_skips_tiny_batches():
    """tests/test_probe.py::test_probe_skips_tiny_batches on the port."""
    cfg = TArch(name="t", family="dense", n_layers=1, d_model=16, n_heads=1,
                n_kv_heads=1, d_ff=32, vocab=64, head_dim=16,
                tie_embeddings=True, remat="none", param_dtype="float32",
                compute_dtype="float32")
    params, _ = build_model(cfg, device="cpu").init(0)
    out = activation_probe(params, {"tokens": torch.zeros((4, 8),
                                                          dtype=torch.int32)})
    assert out["skipped"]


# ---------------------------------------------------------------------------
# the launcher


def _launch(*args, **env_over):
    env = {k: v for k, v in os.environ.items() if k != "REPRO_PLATFORM"}
    env.update(PYTHONPATH=str(SRC), **env_over)
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], env=env, capture_output=True, text=True,
                          timeout=300)


def test_launcher_smoke_on_the_cpu():
    r = _launch("--smoke", "--steps", "20", REPRO_PLATFORM="cpu")
    assert r.returncode == 0, r.stderr
    last = r.stdout.strip().splitlines()[-1]
    assert last.startswith("final loss: ") and "straggler flags: " in last
    final = float(last.split("final loss: ")[1].split()[0])
    first = float(last.split("(first: ")[1].split(")")[0])
    assert abs(first - math.log(512)) < 2.5, first
    assert final < first, (final, first)


def test_launcher_without_a_card_exits_1():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    r = _launch("--smoke", "--steps", "2")
    assert r.returncode == 1
    assert "no CUDA device is available" in r.stderr
