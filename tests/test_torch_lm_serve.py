"""The port's LM serving path against the JAX package's, on the CPU:
``left_pad_pack`` (the cases of ``tests/test_batching.py``), ``DecodeEngine``
against the JAX engine on the same converted weights and prompts,
``TokenStream`` against the JAX stream, and ``python -m
repro_torch.launch.serve --smoke`` beside the JAX launcher.

The engines compare step by step: each step's logits within 2e-2 (the
reference's decode tolerance) and the same greedy tokens, except where the
two packages' bf16 logits differ by less than that tolerance at the
reference's choice (a near tie): the wave's later steps then decode other
tokens and are not compared.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.data.tokens import TokenStream as JTokenStream
from repro.models import build_model as jbuild
from repro.serve import DecodeEngine as JEngine
from repro.serve import ServeConfig as JServeConfig

from repro_torch import configs as tcfgs
from repro_torch.data import TokenStream
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve import DecodeEngine, ServeConfig, left_pad_pack

SRC = Path(__file__).resolve().parents[1] / "src"
TOL = 2e-2
LAUNCH_TIMEOUT_S = 180
SERVED = re.compile(r"^served (\d+) prompts, (\d+) tokens in ", re.M)


def test_left_pad_pack():
    toks, plen = left_pad_pack([[1, 2, 3], [7]], slots=4)
    assert plen == 3 and toks.shape == (4, 3) and toks.dtype == np.int32
    assert toks[0].tolist() == [1, 2, 3]
    assert toks[1].tolist() == [0, 0, 7]   # right-aligned
    assert not toks[2:].any()              # idle slots all-pad
    with pytest.raises(ValueError):
        left_pad_pack([], slots=2)
    with pytest.raises(ValueError):
        left_pad_pack([[1], [2], [3]], slots=2)


def test_left_pad_pack_matches_jax():
    from repro.serve.batching import left_pad_pack as jpack
    prompts = [[5, 6], [], [1, 2, 3, 4], [9]]
    got, want = left_pad_pack(prompts, 4, pad_id=3), jpack(prompts, 4, 3)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def _record(engine, calls):
    """Wrap an engine's sampler to keep each step's logits (float32)."""
    inner = engine._sample

    def sample(logits):
        calls.append(np.asarray(logits.float() if isinstance(
            logits, torch.Tensor) else logits, np.float32))
        return inner(logits)

    engine._sample = sample


def _prompts(vocab, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=rng.integers(4, 12)).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("name", ["llama3.2-3b", "mixtral-8x22b"])
def test_decode_engine_matches_jax(name):
    jc, tc = jcfgs.get_config(name, smoke=True), \
        tcfgs.get_config(name, smoke=True)
    jm = jbuild(jc)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tc, device="cpu")
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu",
                         cfg=tc)
    scfg = dict(max_len=32, max_new_tokens=6)
    slots = 4
    prompts = _prompts(tc.vocab)
    jeng = JEngine(jm, jp, slots, JServeConfig(**scfg))
    teng = DecodeEngine(tm, tp, slots, ServeConfig(**scfg))
    jcalls, tcalls = [], []
    _record(jeng, jcalls)
    _record(teng, tcalls)
    jout = jeng.generate(prompts)
    tout = teng.generate(prompts)
    assert [len(o) for o in tout] == [len(o) for o in jout]
    assert all(0 <= t < tc.vocab for o in tout for t in o)
    # waves of `slots` prompts: a sample after the prefill and after each
    # of the max_new_tokens decode steps (the last one unused)
    steps = scfg["max_new_tokens"] + 1
    assert len(tcalls) == len(jcalls) == steps * -(-len(prompts) // slots)
    compared = 0
    for w in range(len(jcalls) // steps):
        for s in range(steps):
            jl, tl = jcalls[w * steps + s], tcalls[w * steps + s]
            np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
            compared += 1
            jt, tt = jl.argmax(-1), tl.argmax(-1)
            if (jt != tt).any():
                rows = np.nonzero(jt != tt)[0]
                gap = jl[rows, jt[rows]] - jl[rows, tt[rows]]
                assert (gap <= TOL).all(), (w, s, gap)
                break
    assert compared >= steps
    agree = sum(a == b for a, b in zip(tout, jout))
    print(f"{name}: {agree}/{len(prompts)} prompts decode the same tokens")


def test_engine_sampling_is_seeded_and_in_range():
    cfg = tcfgs.get_config("llama3.2-3b", smoke=True)
    model = build_model(cfg, device="cpu")
    params, _ = model.init(0)
    prompts = _prompts(cfg.vocab, n=5)
    runs = [DecodeEngine(model, params, 2, ServeConfig(
        max_len=24, max_new_tokens=5, temperature=1.0, seed=seed)
    ).generate(prompts) for seed in (7, 7, 8)]
    assert runs[0] == runs[1] != runs[2]
    assert all(len(o) == 5 and all(0 <= t < cfg.vocab for t in o)
               for o in runs[0])


def test_engine_stops_at_eos_and_max_len():
    cfg = tcfgs.get_config("llama3.2-3b", smoke=True)
    model = build_model(cfg, device="cpu")
    params, _ = model.init(0)
    prompts = _prompts(cfg.vocab, n=2)
    first = DecodeEngine(model, params, 2, ServeConfig(
        max_len=64, max_new_tokens=8)).generate(prompts)
    eos = first[0][2]
    stopped = DecodeEngine(model, params, 2, ServeConfig(
        max_len=64, max_new_tokens=8, eos_id=eos)).generate(prompts)
    assert stopped[0] == first[0][:first[0].index(eos) + 1]
    plen = max(len(p) for p in prompts)
    short = DecodeEngine(model, params, 2, ServeConfig(
        max_len=plen + 3, max_new_tokens=8)).generate(prompts)
    assert [len(o) for o in short] == [3, 3]


def test_token_stream_matches_jax():
    mine = TokenStream(vocab=512, batch=3, seq=16, seed=5, device="cpu")
    ref = JTokenStream(vocab=512, batch=3, seq=16, seed=5)
    for _ in range(2):
        got, want = mine.next_batch(), ref.next_batch()
        for k in want:
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    state = mine.state()
    nxt = mine.next_numpy()
    mine.restore(state)
    np.testing.assert_array_equal(mine.next_numpy()["tokens"],
                                  nxt["tokens"])


def launch(module, *args, **env_over):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "REPRO_PLATFORM")}
    env.update(PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu", **env_over)
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT_S)


def test_serve_launcher_counts_are_the_jax_launchers():
    args = ("--arch", "mixtral-8x22b", "--smoke", "--prompts", "6",
            "--max-new", "5")
    mine = launch("repro_torch.launch.serve", *args, REPRO_PLATFORM="cpu")
    ref = launch("repro.launch.serve", *args)
    assert mine.returncode == 0, mine.stderr
    assert ref.returncode == 0, ref.stderr
    got, want = SERVED.search(mine.stdout), SERVED.search(ref.stdout)
    assert got and want, (mine.stdout, ref.stdout)
    assert got.groups() == want.groups() == ("6", "30")
    # the same lines: four "[i] [...]" token lists after the served line
    assert len(re.findall(r"^  \[\d\] \[", mine.stdout, re.M)) == 4


def test_serve_launcher_without_a_card_exits():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the launcher would use it")
    out = launch("repro_torch.launch.serve", "--smoke")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
