"""The port's LM substrate against the JAX package's, on the CPU.

Every case feeds the same seeded numpy inputs, and the JAX package's own
``model.init(PRNGKey(0))`` weights converted by ``params_from_jax``,
through both packages: the loss and three decode steps of each of the 7
decoder-family smoke configs (at 2e-2, the reference's own decode
tolerance: the configs compute in bf16), the attention implementations
(twins of ``tests/test_attention_impls.py``, in fp32 at its tolerances),
the MoE capacity dispatch against the JAX package's on a one-device mesh
(drops included), the decode-vs-forward cache check of
``tests/test_arch_smoke.py``, and the parameter trees of all 10 full
configs (every family), key for key, built on the meta device.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import attention as jatt
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro.models.common import ParamCollector as JCollector
from repro.models.common import abstract_params as jabstract
from repro.models.common import slice_layer as jslice

from repro_torch import configs as tcfgs
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import attention as tatt
from repro_torch.models import moe as tmoe
from repro_torch.models.common import abstract_params
from repro_torch.models.convert import tensor_from_numpy

DECODERS = ["llama3.2-3b", "llama3-405b", "qwen3-32b", "phi4-mini-3.8b",
            "deepseek-v2-236b", "mixtral-8x22b", "internvl2-76b"]
OTHERS = ["seamless-m4t-large-v2", "zamba2-1.2b", "falcon-mamba-7b"]
TOL = 2e-2          # the reference's decode tolerance (bf16 compute)
B, S = 2, 32


def np_params(params):
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX model, JAX params, port model, port params) per smoke
    config, the port's weights converted from the JAX package's."""
    cache = {}

    def get(name):
        if name not in cache:
            jc = jcfgs.get_config(name, smoke=True)
            jm = jbuild(jc)
            jp, _ = jm.init(jax.random.PRNGKey(0))
            tc = tcfgs.get_config(name, smoke=True)
            tm = build_model(tc, device="cpu")
            tp = params_from_jax(np_params(jp), "cpu", cfg=tc)
            cache[name] = (tc, jm, jp, tm, tp)
        return cache[name]

    return get


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("name", DECODERS)
def test_loss_matches_jax(pair, name):
    cfg, jm, jp, tm, tp = pair(name)
    jb = jcfgs.concrete_train_batch(jcfgs.get_config(name, smoke=True), B, S)
    tb = tcfgs.concrete_train_batch(cfg, B, S, device="cpu")
    for k in jb:
        np.testing.assert_array_equal(np.asarray(jb[k]), tb[k].numpy())
    jloss, jmet = jax.jit(jm.loss)(jp, jb)
    tloss, tmet = tm.loss(tp, tb)
    assert np.isfinite(float(tloss))
    close(float(tmet["loss"]), float(jmet["loss"]))
    close(float(tloss), float(jloss))
    close(float(tmet["aux_loss"]), float(jmet["aux_loss"]))


@pytest.mark.parametrize("name", DECODERS)
def test_decode_steps_match_jax(pair, name):
    cfg, jm, jp, tm, tp = pair(name)
    jcache = jm.init_cache(B, 16)
    tcache = tm.init_cache(B, 16)
    assert [tuple(c.shape) for c in tcache] == [c.shape for c in jcache]
    step = jax.jit(jm.decode_step)
    toks = np.zeros((B, 1), np.int32)
    for t in range(3):
        jl, jcache = step(jp, jcache, jnp.asarray(toks),
                          jnp.asarray(t, jnp.int32))
        tl, tcache = tm.decode_step(tp, tcache, torch.as_tensor(toks), t)
        assert tl.shape == (B, cfg.vocab)
        assert torch.isfinite(tl.float()).all()
        close(tl.float().numpy(), jl)
        for jc, tc in zip(jcache, tcache):
            close(tc.float().numpy(), jc)
        # both packages continue from the reference's tokens
        toks = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)


@pytest.mark.parametrize("name", ["llama3.2-3b", "mixtral-8x22b",
                                  "deepseek-v2-236b"])
def test_decode_matches_forward(pair, name):
    """tests/test_arch_smoke.py's cache check on the port: token-by-token
    decode logits against one prefill of the same 8 tokens."""
    cfg, _, _, tm, tp = pair(name)
    rng = np.random.default_rng(0)
    s = 8
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(B, s),
                                        dtype=np.int32))
    cache = tm.init_cache(B, 16)
    for t in range(s):
        lg, cache = tm.decode_step(tp, cache, toks[:, t:t + 1], t)
    lg_all, _ = tm.decode_step(tp, tm.init_cache(B, 16), toks, 0)
    close(lg_all.float().numpy(), lg.float().numpy())


@pytest.mark.parametrize("name", ["llama3.2-3b", "deepseek-v2-236b"])
def test_decode_is_prefill_bit_for_bit(pair, name):
    """Token products in fixed blocks (``tok_einsum``): a token's outputs
    do not depend on how many tokens share the call, so the decode logits
    are the prefill's bits, and a row alone is its row of a batch."""
    from repro_torch.models.common import TOKEN_BLOCK, tok_einsum
    cfg, _, _, tm, tp = pair(name)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(B, 8), dtype=np.int32))
    cache = tm.init_cache(B, 16)
    for t in range(8):
        lg, cache = tm.decode_step(tp, cache, toks[:, t:t + 1], t)
    lg_all, _ = tm.decode_step(tp, tm.init_cache(B, 16), toks, 0)
    assert torch.equal(lg_all, lg)
    x = torch.randn((3, TOKEN_BLOCK + 5, 48)).to(torch.bfloat16)
    w = torch.randn((48, 4, 8)).to(torch.bfloat16)
    full = tok_einsum("bse,ehd->bshd", x, w)
    assert torch.equal(tok_einsum("bse,ehd->bshd", x[1:2, 7:8], w),
                       full[1:2, 7:8])
    np.testing.assert_allclose(full.float().numpy(), torch.einsum(
        "bse,ehd->bshd", x.float(), w.float()).numpy(), rtol=2e-2,
        atol=2e-2)


def test_vlm_prefix_and_tied_embeddings(pair):
    cfg, _, _, tm, tp = pair("internvl2-76b")
    assert "lm_head" in tp and cfg.frontend_seq == 8
    batch = tcfgs.concrete_train_batch(cfg, B, S, device="cpu")
    assert batch["frontend"].shape == (B, cfg.frontend_seq, cfg.d_model)
    cfg_t, _, _, _, tp_t = pair("llama3.2-3b")
    assert cfg_t.tie_embeddings and "lm_head" not in tp_t


# ---- attention implementations (fp32, tests/test_attention_impls.py) -----

def _cfgs(**kw):
    base = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab=64, head_dim=16,
                param_dtype="float32", compute_dtype="float32")
    base.update(kw)
    return jcfgs.ArchConfig(**base), tcfgs.ArchConfig(**base)


def _qkv(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, cfg.head_dim)).astype(np.float32)
            for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)]


def _both_sdpa(jc, tc, q, k, v, window=0):
    s = q.shape[1]
    pos = np.broadcast_to(np.arange(s)[None], (q.shape[0], s)).copy()
    jb = jatt._mask_bias(jnp.asarray(pos), jnp.asarray(pos), True, window)
    tb = tatt._mask_bias(torch.as_tensor(pos), torch.as_tensor(pos), True,
                         window)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    jout = jatt.sdpa(jc, *map(jnp.asarray, (q, k, v)), jb)
    tout = tatt.sdpa(tc, *map(torch.as_tensor, (q, k, v)), tb)
    return np.asarray(jout), tout.numpy()


@pytest.mark.parametrize("s,qc,kc", [(64, 16, 16), (64, 16, 32),
                                     (128, 64, 16)])
def test_chunked_matches_einsum(s, qc, kc):
    je, te = _cfgs(attention_impl="einsum")
    jch, tch = _cfgs(attention_impl="chunked", attn_q_chunk=qc,
                     attn_kv_chunk=kc)
    q, k, v = _qkv(te, 2, s)
    j_e, t_e = _both_sdpa(je, te, q, k, v)
    j_c, t_c = _both_sdpa(jch, tch, q, k, v)
    np.testing.assert_allclose(t_c, t_e, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(t_e, j_e, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(t_c, j_c, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window", [16, 32, 48])
def test_swa_banded_matches_masked(window):
    jm_, tm_ = _cfgs(attn_kind="swa", window=window,
                     attention_impl="chunked", attn_q_chunk=16,
                     attn_kv_chunk=16)
    jb_, tb_ = (dataclasses.replace(c, swa_banded=True) for c in (jm_, tm_))
    q, k, v = _qkv(tm_, 2, 128, seed=3)
    j_m, t_m = _both_sdpa(jm_, tm_, q, k, v, window)
    j_b, t_b = _both_sdpa(jb_, tb_, q, k, v, window)
    np.testing.assert_allclose(t_b, t_m, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(t_b, j_b, rtol=2e-4, atol=2e-4)


def _layer_params(init, jc):
    col = JCollector(jax.random.PRNGKey(0), jnp.float32)
    init(col, jc)
    jp = jslice(col.params, "attn")
    return jp, {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}


def test_mla_absorbed_decode_matches_forward():
    jc, tc = _cfgs(attn_kind="mla", n_kv_heads=4, q_lora_rank=32,
                   kv_lora_rank=24, qk_nope_dim=16, qk_rope_dim=8,
                   v_head_dim=16, head_dim=24)
    jp, tp = _layer_params(jatt.init_mla, jc)
    rng = np.random.default_rng(1)
    b, s = 2, 12
    x = (rng.normal(size=(b, s, tc.d_model)) * 0.3).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).copy()
    t_full = tatt.mla_forward(tp, tc, torch.as_tensor(x),
                              torch.as_tensor(pos))
    j_full = jatt.mla_forward(jp, jc, jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(t_full.numpy(), np.asarray(j_full),
                               rtol=2e-4, atol=2e-4)
    cache = tatt.MLACache(torch.zeros((b, 16, tc.kv_lora_rank)),
                          torch.zeros((b, 16, tc.qk_rope_dim)))
    outs = []
    for t in range(s):
        o, cache = tatt.mla_decode(tp, tc, torch.as_tensor(x[:, t:t + 1]),
                                   torch.full((b, 1), t), cache, t)
        outs.append(o[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               t_full.numpy(), rtol=5e-3, atol=5e-3)


def test_swa_ring_buffer_decode():
    jc, tc = _cfgs(attn_kind="swa", window=8, attention_impl="einsum")
    jp, tp = _layer_params(jatt.init_gqa, jc)
    rng = np.random.default_rng(2)
    b, s = 1, 20
    x = (rng.normal(size=(b, s, tc.d_model)) * 0.3).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).copy()
    t_full, _ = tatt.gqa_forward(tp, tc, torch.as_tensor(x),
                                 torch.as_tensor(pos), causal=True)
    j_full, _ = jatt.gqa_forward(jp, jc, jnp.asarray(x), jnp.asarray(pos),
                                 causal=True)
    np.testing.assert_allclose(t_full.numpy(), np.asarray(j_full),
                               rtol=2e-4, atol=2e-4)
    shape = (b, tc.window, tc.n_kv_heads, tc.head_dim)
    cache = tatt.KVCache(torch.zeros(shape), torch.zeros(shape))
    jcache = jatt.KVCache(jnp.zeros(shape), jnp.zeros(shape))
    outs = []
    for t in range(s):
        xt = x[:, t:t + 1]
        o, cache = tatt.gqa_forward(tp, tc, torch.as_tensor(xt),
                                    torch.full((b, 1), t), causal=True,
                                    cache=cache, cache_len=t)
        jo, jcache = jatt.gqa_forward(jp, jc, jnp.asarray(xt),
                                      jnp.full((b, 1), t), causal=True,
                                      cache=jcache,
                                      cache_len=jnp.asarray(t, jnp.int32))
        np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k),
                                   rtol=2e-4, atol=2e-4)
        outs.append(o[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               t_full.numpy(), rtol=5e-3, atol=5e-3)


def test_swa_prefill_longer_than_the_ring():
    """A prompt longer than the window: the last ``window`` keys stored at
    slots pos % window, as in the JAX package."""
    jc, tc = _cfgs(attn_kind="swa", window=8, attention_impl="einsum")
    jp, tp = _layer_params(jatt.init_gqa, jc)
    x = (np.random.default_rng(4).normal(size=(2, 13, tc.d_model)) * 0.3
         ).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 16)[None], (2, 13)).copy()
    shape = (2, tc.window, tc.n_kv_heads, tc.head_dim)
    t_out, t_c = tatt.gqa_forward(
        tp, tc, torch.as_tensor(x), torch.as_tensor(pos), cache=tatt.KVCache(
            torch.zeros(shape), torch.zeros(shape)), cache_len=3)
    j_out, j_c = jatt.gqa_forward(
        jp, jc, jnp.asarray(x), jnp.asarray(pos), cache=jatt.KVCache(
            jnp.zeros(shape), jnp.zeros(shape)),
        cache_len=jnp.asarray(3, jnp.int32))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(t_c.v.numpy(), np.asarray(j_c.v), rtol=2e-4,
                               atol=2e-4)


# ---- MoE ---------------------------------------------------------------

def _moe_pair(**kw):
    jc, tc = _cfgs(family="moe", n_experts=4, top_k=2, d_ff_expert=32, **kw)
    col = JCollector(jax.random.PRNGKey(1), jnp.float32)
    jmoe.init_moe(col, jc)
    jp = jslice(col.params, "moe")
    return jc, tc, jp, {k: tensor_from_numpy(np.asarray(v))
                        for k, v in jp.items()}


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_capacity_dispatch_matches_jax(shared):
    """The capacity-bounded dispatch at a shape that drops tokens (T*k =
    128 > 8E, C = 16 at capacity factor 0.5), against the JAX package's
    shard_map dispatch on a one-device mesh: the same tokens are
    dropped."""
    jc, tc, jp, tp = _moe_pair(n_shared_experts=shared, capacity_factor=0.5)
    x = np.random.default_rng(5).normal(size=(2, 32, 64)).astype(np.float32)
    assert tmoe._capacity(64, tc) == 16
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    jy, jaux = jmoe.moe_forward(jp, jc, jnp.asarray(x), mesh)
    ty, taux = tmoe.moe_forward(tp, tc, torch.as_tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    # drops are real here: the drop-free reference differs
    ref, _ = tmoe.moe_forward_ref(tp, tc, torch.as_tensor(x))
    assert not torch.allclose(ty, ref, atol=1e-3)


def test_moe_dispatch_is_drop_free_at_decode_shapes():
    jc, tc, jp, tp = _moe_pair(n_shared_experts=1)
    x = torch.as_tensor(np.random.default_rng(6).normal(size=(4, 1, 64))
                        .astype(np.float32))
    y, _ = tmoe.moe_forward(tp, tc, x)
    ref, _ = tmoe.moe_forward_ref(tp, tc, x)
    jref, _ = jmoe.moe_forward_ref(jp, jc, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), rtol=1e-5,
                               atol=1e-6)


def test_top_k_breaks_ties_like_jax():
    v = np.array([[0.1, 0.3, 0.3, 0.2, 0.3], [0.5, 0.5, 0.5, 0.5, 0.5]],
                 np.float32)
    jw, jids = jax.lax.top_k(jnp.asarray(v), 3)
    tw, tids = tmoe.top_k(torch.as_tensor(v), 3)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


# ---- parameter trees of the full configs (meta device) -------------------

@pytest.mark.parametrize("name", DECODERS + OTHERS)
def test_full_config_matches_jax(name):
    jc, tc = jcfgs.get_config(name), tcfgs.get_config(name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.n_params() == jc.n_params()
    assert tc.active_params() == jc.active_params()
    assert build_model(tc, device="cpu").device.type == "cpu"
    jshapes, jaxes = jabstract(jbuild(jc).init, jax.random.PRNGKey(0))
    tparams, taxes = abstract_params(build_model(tc, device="meta").init)
    assert sorted(tparams) == sorted(jshapes)
    for k, t in tparams.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(jshapes[k].shape), k
        assert str(t.dtype).rsplit(".", 1)[-1] == \
            np.dtype(jshapes[k].dtype).name, k
        assert taxes[k] == tuple(jaxes[k]), k
    assert sum(t.numel() for t in tparams.values()) == sum(
        int(np.prod(s.shape)) for s in jshapes.values())


def test_converter_rejects_missing_extra_and_misshapen_keys(pair):
    cfg, _, jp, _, _ = pair("llama3.2-3b")
    nps = np_params(jp)
    with pytest.raises(KeyError, match="missing"):
        params_from_jax({k: v for k, v in nps.items() if k != "embed"},
                        "cpu", cfg=cfg)
    with pytest.raises(KeyError, match="extra"):
        params_from_jax(dict(nps, bogus=np.zeros(3, np.float32)), "cpu",
                        cfg=cfg)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(dict(nps, final_norm=np.zeros(3, np.float32)),
                        "cpu", cfg=cfg)
    out = params_from_jax(nps, "cpu", cfg=cfg)
    assert out["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["embed"].float().numpy(),
                                  nps["embed"].astype(np.float32))
    assert params_from_jax(nps, "cpu", torch.float32,
                           cfg=cfg)["embed"].dtype == torch.float32


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(tcfgs.get_config("llama3.2-3b", smoke=True))
