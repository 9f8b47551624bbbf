"""The port's ssm, hybrid and audio families against the JAX package's, on
the CPU.

The same seeded numpy inputs, and the JAX package's own
``model.init(PRNGKey(0))`` weights converted by ``params_from_jax``, go
through both packages:

  * every function of ``models/mamba.py`` in fp32, at 1e-5 * max|ref| +
    1e-6: the causal conv and its decode step, mamba1's chunked forward
    (with its decode state) and decode step, the SSD scan from a given
    state, mamba2's forward and decode step, at L = 8, 12 and 20 (the
    halving chunk: 8 -> 4 at L = 12 and 20);
  * the three smoke configs (bf16, the reference's 2e-2): the loss and
    three decode steps (twins of ``tests/test_arch_smoke.py``; audio's
    after a prefill of 8 tokens, at cache_len 8 + step), each family's
    prefill (logits and states), the decode-vs-forward cache check for
    falcon and zamba2 (token by token against the chunked prefill and the
    whole-prompt decode step); logits elementwise, the decode states and
    multi-token logits as a whole (relative L2 norm, BF16_GAP: their bf16
    roundings grow with depth and through the recurrence), and the port's
    bf16 error against the fp32 run no larger than the reference's own;
  * fp32 variants: three decode steps (logits and caches at 1e-5 *
    max|ref| + 1e-6), loss and grads against ``jax.value_and_grad`` (each
    key at 1e-4 * max|g|, remat "full"), and one SGD step (the twin of
    ``test_train_step``: the next loss at 1e-4 relative);
  * the activation probe on each family's params (2e-4 relative);
  * ``DecodeEngine`` against the JAX engine on falcon and zamba2;
  * ``python -m repro_torch.launch.serve`` and ``launch.train`` (zamba2,
    ``REPRO_PLATFORM=cpu``) beside the JAX launchers.

About 60 s alone on the CPU, most of it the JAX package's compiles.
"""

import dataclasses
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import build_model as jbuild
from repro.models import mamba as jmamba
from repro.models.common import ParamCollector as JCollector
from repro.serve import DecodeEngine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro.train import activation_probe as jprobe

from repro_torch import configs as tcfgs
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import mamba as tmamba
from repro_torch.serve import DecodeEngine, ServeConfig
from repro_torch.train import activation_probe
from repro_torch.train.loop import loss_and_grads

SRC = Path(__file__).resolve().parents[1] / "src"
FAMILIES = ["falcon-mamba-7b", "zamba2-1.2b", "seamless-m4t-large-v2"]
TOL = 2e-2            # the reference's decode tolerance (bf16 compute)
B, S = 2, 32
LAUNCH_TIMEOUT_S = 360


def close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


# Two bf16 runs of these models part by more than the reference's 2e-2
# through the recurrence: after an 11-token prompt the JAX package's own
# bf16 logits lie 3.2e-2 (zamba2) to 4.3e-2 (falcon) from its fp32 run
# (relative L2 norm), the port's 2.8e-2 to 2.9e-2, and the two bf16 runs
# 2.6e-2 to 2.8e-2 from each other (scripts/family_bf16_gap.py). test_bf16_error_is_the_references
# holds the port's bf16 error to the reference's own; the bf16 checks of
# states and of multi-token logits against the JAX package are made as a
# whole at BF16_GAP.
BF16_GAP = 5e-2


def rel_gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def state_close(got, want, tol=BF16_GAP, what=""):
    """A bf16 decode state or logits as a whole: ||got - want||_2 <= tol *
    ||want||_2 (the first layer's states agree exactly; in fp32 every
    layer's agree to 2e-6, see test_fp32_decode_matches_jax)."""
    gap = rel_gap(got, want)
    assert gap <= tol, (what, gap)


def fp32_close(got, want, what=""):
    """|got - want| <= 1e-5 * max|want| + 1e-6."""
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()) + 1e-6, (what, err)


def np_tree(params):
    return {k: np.asarray(v) for k, v in params.items()}


def pair_of(jcfg, tcfg):
    jm = jbuild(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    return jm, jp, tm, params_from_jax(np_tree(jp), "cpu", cfg=tcfg)


def fp32_cfgs(name, **over):
    kw = dict(param_dtype="float32", compute_dtype="float32", **over)
    return (dataclasses.replace(jcfgs.get_config(name, smoke=True), **kw),
            dataclasses.replace(tcfgs.get_config(name, smoke=True), **kw))


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX model, JAX params, port model, port params) per smoke
    config, the port's weights converted from the JAX package's."""
    cache = {}

    def get(name):
        if name not in cache:
            jm, jp, tm, tp = pair_of(jcfgs.get_config(name, smoke=True),
                                     tcfgs.get_config(name, smoke=True))
            cache[name] = (tm.cfg, jm, jp, tm, tp)
        return cache[name]

    return get


def batches(cfg, b, s):
    jb = jcfgs.concrete_train_batch(jcfgs.get_config(cfg.name.replace(
        "-smoke", ""), smoke=True), b, s)
    tb = tcfgs.concrete_train_batch(cfg, b, s, device="cpu")
    for k in jb:
        np.testing.assert_array_equal(np.asarray(jb[k]), tb[k].numpy())
    return jb, tb


# ---------------------------------------------------------------------------
# models/mamba.py, function by function (fp32)


def mamba_params(init, cfg, seed):
    """A mamba layer's params from the JAX init, with the zero/one-initial
    leaves (a_log, dt_bias, conv_b, d) redrawn so every term is exercised:
    (JAX dict, port dict)."""
    col = JCollector(jax.random.PRNGKey(seed), jnp.float32)
    init(col, cfg, "m")
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in col.params.items():
        key = k[len("m/"):]
        v = np.asarray(v, np.float32)
        if key == "a_log":
            v = rng.uniform(-1.0, 1.5, size=v.shape).astype(np.float32)
        elif key in ("dt_bias", "conv_b"):
            v = rng.normal(0, 0.5, size=v.shape).astype(np.float32)
        elif key in ("d", "norm_w"):
            v = rng.normal(1, 0.2, size=v.shape).astype(np.float32)
        out[key] = v
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.as_tensor(v) for k, v in out.items()})


def inputs(rng, *shape, scale=1.0):
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.as_tensor(x)


@pytest.mark.parametrize("length", [8, 12, 20])
def test_causal_conv_and_its_step(length):
    rng = np.random.default_rng(length)
    jx, tx = inputs(rng, 2, length, 24)
    jw, tw = inputs(rng, 4, 24, scale=0.5)
    jb, tb = inputs(rng, 24)
    want = jmamba._causal_conv(jx, jw, jb)
    got = tmamba._causal_conv(tx, tw, tb)
    fp32_close(got, want, "conv")
    # the step from the last 3 inputs gives the conv's last position
    js, ts = jx[:, -4:-1], tx[:, -4:-1]
    jy, jst = jmamba._conv_step(js, jx[:, -1], jw, jb)
    ty, tst = tmamba._conv_step(ts, tx[:, -1], tw, tb)
    fp32_close(ty, jy, "step")
    fp32_close(tst, jst, "step state")
    fp32_close(ty, np.asarray(want)[:, -1], "step vs conv")


@pytest.mark.parametrize("length", [8, 12, 20])
def test_mamba1_forward_and_state(length):
    jc, tc = fp32_cfgs("falcon-mamba-7b")
    assert tc.ssm_chunk == 8
    jp, tp = mamba_params(jmamba.init_mamba1, jc, length)
    rng = np.random.default_rng(100 + length)
    jx, tx = inputs(rng, 2, length, tc.d_model)
    jy, jst = jmamba.mamba1_forward(jp, jc, jx, return_state=True)
    ty, tst = tmamba.mamba1_forward(tp, tc, tx, return_state=True)
    fp32_close(ty, jy, "y")
    fp32_close(tst.conv, jst.conv, "conv state")
    fp32_close(tst.ssm, jst.ssm, "ssm state")
    fp32_close(tmamba.mamba1_forward(tp, tc, tx), jy, "y without state")


def test_mamba1_decode_and_init_state():
    jc, tc = fp32_cfgs("falcon-mamba-7b")
    jp, tp = mamba_params(jmamba.init_mamba1, jc, 1)
    j0 = jmamba.mamba1_init_state(jc, 2)
    t0 = tmamba.mamba1_init_state(tc, 2, device="cpu")
    for a, b in zip(t0, j0):
        assert tuple(a.shape) == b.shape and not a.any()
        assert str(a.dtype).rsplit(".", 1)[-1] == np.dtype(b.dtype).name
    rng = np.random.default_rng(7)
    jconv, tconv = inputs(rng, *j0.conv.shape)
    jssm, tssm = inputs(rng, *j0.ssm.shape)
    jx, tx = inputs(rng, 2, 1, tc.d_model)
    jy, jst = jmamba.mamba1_decode(jp, jc, jx, jmamba.Mamba1State(jconv, jssm))
    ty, tst = tmamba.mamba1_decode(tp, tc, tx, tmamba.Mamba1State(tconv, tssm))
    fp32_close(ty, jy, "y")
    fp32_close(tst.conv, jst.conv, "conv state")
    fp32_close(tst.ssm, jst.ssm, "ssm state")


@pytest.mark.parametrize("length", [8, 12, 20])
def test_ssd_chunked_from_a_state(length):
    rng = np.random.default_rng(200 + length)
    h, hd, n = 4, 8, 6
    jx, tx = inputs(rng, 2, length, h, hd)
    jb, tb = inputs(rng, 2, length, n)
    jc, tc = inputs(rng, 2, length, n)
    dt = np.log1p(np.exp(rng.normal(size=(2, length, h)))).astype(np.float32)
    a = -np.exp(rng.normal(size=(h,))).astype(np.float32)
    jh0, th0 = inputs(rng, 2, h, hd, n)
    jy, js = jmamba._ssd_chunked(jx, jb, jc, jnp.asarray(dt), jnp.asarray(a),
                                 8, h0=jh0)
    ty, ts = tmamba._ssd_chunked(tx, tb, tc, torch.as_tensor(dt),
                                 torch.as_tensor(a), 8, h0=th0)
    fp32_close(ty, jy, "y")
    fp32_close(ts, js, "state")


@pytest.mark.parametrize("length", [8, 12, 20])
def test_mamba2_forward_and_state(length):
    jc, tc = fp32_cfgs("zamba2-1.2b")
    jp, tp = mamba_params(jmamba.init_mamba2, jc, length)
    rng = np.random.default_rng(300 + length)
    jx, tx = inputs(rng, 2, length, tc.d_model)
    jy, jst = jmamba.mamba2_forward(jp, jc, jx, return_state=True)
    ty, tst = tmamba.mamba2_forward(tp, tc, tx, return_state=True)
    fp32_close(ty, jy, "y")
    fp32_close(tst.conv, jst.conv, "conv state")
    fp32_close(tst.ssm, jst.ssm, "ssm state")


def test_mamba2_decode_and_init_state():
    jc, tc = fp32_cfgs("zamba2-1.2b")
    jp, tp = mamba_params(jmamba.init_mamba2, jc, 2)
    j0 = jmamba.mamba2_init_state(jc, 2)
    t0 = tmamba.mamba2_init_state(tc, 2, device="cpu")
    for a, b in zip(t0, j0):
        assert tuple(a.shape) == b.shape and not a.any()
    rng = np.random.default_rng(8)
    jconv, tconv = inputs(rng, *j0.conv.shape)
    jssm, tssm = inputs(rng, *j0.ssm.shape)
    jx, tx = inputs(rng, 2, 1, tc.d_model)
    jy, jst = jmamba.mamba2_decode(jp, jc, jx, jmamba.Mamba2State(jconv, jssm))
    ty, tst = tmamba.mamba2_decode(tp, tc, tx, tmamba.Mamba2State(tconv, tssm))
    fp32_close(ty, jy, "y")
    fp32_close(tst.conv, jst.conv, "conv state")
    fp32_close(tst.ssm, jst.ssm, "ssm state")


def test_ssd_grads_stay_finite_where_exp_overflows():
    """A chunk whose log-decay spans more than fp32's exp range: above the
    diagonal exp(seg) is inf; the port's masked exponent keeps the
    backward finite."""
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.normal(size=(1, 8, 2, 4)).astype(np.float32))
    bc = torch.as_tensor(rng.normal(size=(1, 8, 3)).astype(np.float32))
    dt = torch.full((1, 8, 2), 40.0, requires_grad=True)
    a = torch.full((2,), -1.0)
    y, st = tmamba._ssd_chunked(x, bc, bc, dt, a, 8)
    (y.sum() + st.sum()).backward()
    assert torch.isfinite(y).all() and torch.isfinite(dt.grad).all()


# ---------------------------------------------------------------------------
# the three families at smoke size (bf16)


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_matches_jax(pair, name):
    cfg, jm, jp, tm, tp = pair(name)
    jb, tb = batches(cfg, B, S)
    jloss, _ = jax.jit(jm.loss)(jp, jb)
    tloss, tmet = tm.loss(tp, tb)
    assert torch.isfinite(tloss)
    assert abs(float(tloss) - math.log(cfg.vocab)) < 2.5
    close(float(tloss), float(jloss))
    close(float(tmet["loss"]), float(jloss))


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_steps_match_jax(pair, name):
    cfg, jm, jp, tm, tp = pair(name)
    if cfg.family == "audio":
        jb, tb = batches(cfg, B, 8)
        jl, jcache = jm.prefill(jp, jb, 16)
        tl, tcache = tm.prefill(tp, tb, 16)
        close(tl.float().numpy(), jl)
    else:
        jcache, tcache = jm.init_cache(B, 16), tm.init_cache(B, 16)
    assert [tuple(c.shape) for c in tcache] == [c.shape for c in jcache]
    step = jax.jit(jm.decode_step)
    toks = np.zeros((B, 1), np.int32)
    for t in range(3):
        cl = 8 + t if cfg.family == "audio" else t
        jl, jcache = step(jp, jcache, jnp.asarray(toks),
                          jnp.asarray(cl, jnp.int32))
        tl, tcache = tm.decode_step(tp, tcache, torch.as_tensor(toks), cl)
        assert tl.shape == (B, cfg.vocab) and torch.isfinite(tl.float()).all()
        close(tl.float().numpy(), jl, what="logits")
        for i, (jc_, tc_) in enumerate(zip(jcache, tcache)):
            state_close(tc_.float().numpy(), jc_, what=f"cache {i}")
        toks = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)


@pytest.mark.parametrize("name", FAMILIES)
def test_fp32_decode_matches_jax(fp32_pair, name):
    """Three decode steps in fp32 (an fp32 cache): logits and every cache
    leaf at 1e-5 * max|ref| + 1e-6."""
    cfg, jm, jp, tm, tp = fp32_pair(name)
    if cfg.family == "audio":
        jb, tb = batches(cfg, B, 8)
        jcache = jm.init_cache(B, 16, dtype=jnp.float32)._replace(
            enc_out=jnp.asarray(tb["frames"].numpy()))
        tcache = tm.init_cache(B, 16, dtype=torch.float32)._replace(
            enc_out=tb["frames"])
    else:
        jcache = jm.init_cache(B, 16, dtype=jnp.float32)
        tcache = tm.init_cache(B, 16, dtype=torch.float32)
    step = jax.jit(jm.decode_step)
    toks = np.zeros((B, 1), np.int32)
    for t in range(3):
        jl, jcache = step(jp, jcache, jnp.asarray(toks),
                          jnp.asarray(t, jnp.int32))
        tl, tcache = tm.decode_step(tp, tcache, torch.as_tensor(toks), t)
        fp32_close(tl, jl, "logits")
        for i, (jc_, tc_) in enumerate(zip(jcache, tcache)):
            fp32_close(tc_, jc_, f"cache {i}")
        toks = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_matches_jax(pair, name):
    cfg, jm, jp, tm, tp = pair(name)
    jb, tb = batches(cfg, B, 12)
    jl, jcache = jm.prefill(jp, jb, 16)
    tl, tcache = tm.prefill(tp, tb, 16)
    close(tl.float().numpy(), jl, what="logits")
    assert len(tcache) == len(jcache)
    for i, (jc_, tc_) in enumerate(zip(jcache, tcache)):
        assert tuple(tc_.shape) == jc_.shape, i
        state_close(tc_.float().numpy(), jc_, what=f"cache {i}")


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_error_is_the_references(name):
    """An 11-token prompt through one decode step (token by token): in
    fp32 the port's logits and cache are the JAX package's at 1e-5 *
    max|ref| + 1e-6; in bf16 (the same weights, rounded) the port's lie
    no further from that fp32 run than 1.25 x the JAX package's own bf16
    run does, leaf by leaf (relative L2 norm)."""
    runs = {}
    for dt in ("float32", "bfloat16"):
        kw = dict(param_dtype=dt, compute_dtype=dt)
        jc = dataclasses.replace(jcfgs.get_config(name, smoke=True), **kw)
        tc = dataclasses.replace(tcfgs.get_config(name, smoke=True), **kw)
        jm, tm = jbuild(jc), build_model(tc, device="cpu")
        if dt == "float32":
            jp, _ = jm.init(jax.random.PRNGKey(0))
            jp32 = jp
        else:
            jp = {k: v.astype(jnp.bfloat16) for k, v in jp32.items()}
        tp = params_from_jax(np_tree(jp), "cpu", cfg=tc)
        toks = np.random.default_rng(0).integers(0, tc.vocab, size=(4, 11),
                                                 dtype=np.int32)
        jcache = jm.init_cache(4, 16, dtype=getattr(jnp, dt))
        tcache = tm.init_cache(4, 16, dtype=getattr(torch, dt))
        if tc.family == "audio":
            frames = np.random.default_rng(1).normal(
                0, 0.02, size=(4, 16, tc.d_model)).astype(np.float32)
            jcache = jcache._replace(enc_out=jnp.asarray(frames, dt))
            tcache = tcache._replace(enc_out=torch.as_tensor(frames).to(
                getattr(torch, dt)))
        jl, jcache = jax.jit(jm.decode_step)(jp, jcache, jnp.asarray(toks),
                                             jnp.asarray(0, jnp.int32))
        tl, tcache = tm.decode_step(tp, tcache, torch.as_tensor(toks), 0)
        runs[dt] = ([np.asarray(jl, np.float32)]
                    + [np.asarray(c, np.float32) for c in jcache],
                    [tl.float().numpy()] + [c.float().numpy() for c in tcache])
    for i, (j32, t32) in enumerate(zip(*runs["float32"])):
        fp32_close(t32, j32, f"fp32 leaf {i}")
        jb, tb = runs["bfloat16"][0][i], runs["bfloat16"][1][i]
        if not np.any(j32):
            continue
        ref_err, port_err = rel_gap(jb, j32), rel_gap(tb, j32)
        assert port_err <= 1.25 * ref_err + 1e-3, (i, port_err, ref_err)


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_decode_matches_forward(pair, name):
    """tests/test_arch_smoke.py's cache check on the port: 8 tokens fed one
    by one, against one decode step of the 8 and against the chunked
    prefill."""
    cfg, _, _, tm, tp = pair(name)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(B, 8),
                                        dtype=np.int32))
    cache = tm.init_cache(B, 16)
    for t in range(8):
        lg, cache = tm.decode_step(tp, cache, toks[:, t:t + 1], t)
    whole, _ = tm.decode_step(tp, tm.init_cache(B, 16), toks, 0)
    pre, pcache = tm.prefill(tp, {"tokens": toks}, 16)
    close(whole.float().numpy(), lg.float().numpy(), what="whole prompt")
    close(pre.float().numpy(), lg.float().numpy(), what="prefill")
    for i, (a, b) in enumerate(zip(pcache, cache)):
        state_close(a.float().numpy(), b.float().numpy(), what=f"cache {i}")


# ---------------------------------------------------------------------------
# training (fp32 variants)


@pytest.fixture(scope="module")
def fp32_pair():
    cache = {}

    def get(name):
        if name not in cache:
            jc, tc = fp32_cfgs(name, remat="full")
            cache[name] = (tc, *pair_of(jc, tc))
        return cache[name]

    return get


@pytest.fixture(scope="module")
def fp32_grads(fp32_pair):
    """Per family: (the JAX package's jitted loss of a (B, 16) batch, its
    loss and grads, the port's loss and grads, the port's batch)."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg, jm, jp, tm, tp = fp32_pair(name)
            jb, tb = batches(cfg, B, 16)
            loss_fn = jax.jit(lambda p: jm.loss(p, jb)[0])
            jloss, jg = jax.jit(jax.value_and_grad(loss_fn))(jp)
            tloss, _, tg = loss_and_grads(tm, tp, tb)
            cache[name] = (loss_fn, jloss, jg, tloss, tg, tb)
        return cache[name]

    return get


@pytest.mark.parametrize("name", FAMILIES)
def test_grads_match_jax(fp32_grads, name):
    _, jloss, jg, tloss, tg, _ = fp32_grads(name)
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(tg) == set(jg)
    for k, v in jg.items():
        v = np.asarray(v)
        scale = max(float(np.abs(v).max()), 1e-30)
        err = float(np.abs(tg[k].numpy() - v).max())
        assert err <= 1e-4 * scale, (name, k, err, scale)


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_jax(fp32_pair, fp32_grads, name):
    """tests/test_arch_smoke.py's train step: the grad norm finite and
    positive, and one SGD step (lr 0.1) changes the loss; the next loss
    against the JAX package's step at 1e-4 relative."""
    _, _, jp, tm, tp = fp32_pair(name)
    loss_fn, jloss, jg, tloss, tg, tb = fp32_grads(name)
    jloss2 = loss_fn({k: v - 0.1 * jg[k] for k, v in jp.items()})
    gnorm = math.sqrt(sum(float((g.double() ** 2).sum())
                          for g in tg.values()))
    assert math.isfinite(gnorm) and gnorm > 0
    with torch.no_grad():
        tloss2, _ = tm.loss({k: v - 0.1 * tg[k] for k, v in tp.items()}, tb)
    assert math.isfinite(float(tloss2)) and float(tloss2) != float(tloss)
    assert abs(float(tloss2) - float(jloss2)) <= 1e-4 * abs(float(jloss2))


@pytest.mark.parametrize("name", FAMILIES)
def test_probe_matches_jax(pair, name):
    cfg, _, jp, _, tp = pair(name)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, size=(96, 16),
                                             dtype=np.int32)
    want = jprobe(jp, {"tokens": jnp.asarray(toks)}, mesh=None,
                  samples_per_node=32, n_iters=8)
    got = activation_probe(tp, {"tokens": torch.as_tensor(toks)},
                           samples_per_node=32, n_iters=8)
    assert not got["skipped"] and not want["skipped"]
    for k in ("consensus_residual", "participation_mean",
              "participation_cv"):
        assert np.isfinite(got[k])
        assert abs(got[k] - want[k]) <= 2e-4 * abs(want[k]), (k, got, want)


# ---------------------------------------------------------------------------
# serving and the launchers


def _record(engine, calls):
    inner = engine._sample

    def sample(logits):
        calls.append(np.asarray(logits.float() if isinstance(
            logits, torch.Tensor) else logits, np.float32))
        return inner(logits)

    engine._sample = sample


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_decode_engine_matches_jax(pair, name):
    """tests/test_torch_lm_serve.py's engine check: each step's logits
    within 2e-2 (as a whole: the prompts' recurrent steps carry bf16
    roundings forward) and the same greedy tokens, until a near tie (a gap
    at the reference's choice under the tolerance) ends the wave's
    comparison."""
    cfg, jm, jp, tm, tp = pair(name)
    scfg = dict(max_len=32, max_new_tokens=5)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=rng.integers(4, 12)).tolist()
               for _ in range(6)]
    jeng = JEngine(jm, jp, 4, JServeConfig(**scfg))
    teng = DecodeEngine(tm, tp, 4, ServeConfig(**scfg))
    jcalls, tcalls = [], []
    _record(jeng, jcalls)
    _record(teng, tcalls)
    jout, tout = jeng.generate(prompts), teng.generate(prompts)
    assert [len(o) for o in tout] == [len(o) for o in jout]
    steps = scfg["max_new_tokens"] + 1
    assert len(tcalls) == len(jcalls) == 2 * steps
    compared = 0
    for w in range(2):
        for s in range(steps):
            jl, tl = jcalls[w * steps + s], tcalls[w * steps + s]
            state_close(tl, jl, what=f"wave {w} step {s}")
            compared += 1
            jt, tt = jl.argmax(-1), tl.argmax(-1)
            if (jt != tt).any():
                rows = np.nonzero(jt != tt)[0]
                assert (jl[rows, jt[rows]] - jl[rows, tt[rows]] <= TOL).all()
                break
    assert compared >= steps


def _spawn(module, *args, **env_over):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "REPRO_PLATFORM")}
    env.update(PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu", **env_over)
    return subprocess.Popen([sys.executable, "-m", module, *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(procs):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=LAUNCH_TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


SERVED = re.compile(r"^served (\d+) prompts, (\d+) tokens in ", re.M)


SERVE_ARGS = ("--arch", "zamba2-1.2b", "--smoke", "--prompts", "5",
              "--max-new", "4")
TRAIN_ARGS = ("--arch", "zamba2-1.2b", "--smoke", "--steps", "8", "--batch",
              "4", "--seq", "32")


@pytest.fixture(scope="module", autouse=True)
def launchers():
    """The four launchers, started with the module's first test (they run
    beside the others) and waited on where a test asks for them."""
    procs = [
        _spawn("repro_torch.launch.serve", *SERVE_ARGS, REPRO_PLATFORM="cpu"),
        _spawn("repro.launch.serve", *SERVE_ARGS),
        _spawn("repro_torch.launch.train", *TRAIN_ARGS, REPRO_PLATFORM="cpu"),
        _spawn("repro.launch.train", *TRAIN_ARGS)]
    done = []
    yield lambda: done or done.extend(_finish(procs)) or done
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def test_launchers_beside_jax_on_zamba2(launchers):
    """The port's serving and training launchers for zamba2 (smoke,
    ``REPRO_PLATFORM=cpu``) beside the JAX package's: the same served
    counts, and both training runs from about ln V down."""
    (ts, to, te), (js, jo, je), (tt, tto, tte), (jt, jto, jte) = launchers()
    assert ts == 0, te[-3000:]
    assert js == 0, je[-3000:]
    got, want = SERVED.search(to), SERVED.search(jo)
    assert got and want and got.groups() == want.groups() == ("5", "20")
    assert len(re.findall(r"^  \[\d\] \[", to, re.M)) == 4
    vocab = tcfgs.get_config("zamba2-1.2b", smoke=True).vocab
    for rc, out, err in ((tt, tto, tte), (jt, jto, jte)):
        assert rc == 0, err[-3000:]
        last = out.strip().splitlines()[-1]
        assert last.startswith("final loss: ") and "straggler flags: " in last
        final = float(last.split("final loss: ")[1].split()[0])
        first = float(last.split("(first: ")[1].split(")")[0])
        assert abs(first - math.log(vocab)) < 2.5, first
        assert final < first, (final, first)
