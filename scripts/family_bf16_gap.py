#!/usr/bin/env python3
"""How far two bf16 computations of the mamba families part, in the JAX
package and in the port, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/family_bf16_gap.py

For falcon-mamba-7b's and zamba2-1.2b's smoke configs made deep (64 and 38
layers, d_model 256, d_inner 512, vocab 2048; random weights from the JAX
package's ``PRNGKey(0)`` init, converted by ``params_from_jax``) it prints
one JSON line each with:

  * ``prefill_vs_decode``: the largest difference between the last-token
    logits of ``prefill`` (the chunked scan) and of 8 tokens fed one by
    one through ``decode_step``, in bf16, for each package (the
    decode-against-prefill check of ``tests/test_arch_smoke.py``, whose
    gate is 2e-2), and each bf16 path's relative L2 distance from the
    JAX package's fp32 prefill of the same weights widened, with the
    decode's over the prefill's (the ratio ``chip_smoke.py``'s
    ``lm_families`` holds at full width to 1.25);
  * ``bf16_vs_fp32``: at the configs' smoke size, an 11-token prompt
    through one decode step, the relative L2 distance of each package's
    bf16 logits from the JAX package's fp32 logits of the same weights
    (rounded to bf16 for the bf16 runs), and of the two bf16 runs from
    each other.

About a minute. Imports both packages (a measurement, like the parity
tests); the port itself imports no JAX.
"""

import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

DEEP = {"falcon-mamba-7b": dict(n_layers=64, d_model=256, vocab=2048,
                                d_inner=512, dt_rank=16, ssm_state=16,
                                ssm_chunk=64),
        "zamba2-1.2b": dict(n_layers=38, d_model=256, vocab=2048,
                            d_inner=512, ssm_state=32, ssm_head_dim=64,
                            n_heads=4, n_kv_heads=4, head_dim=64, d_ff=512,
                            ssm_chunk=64, attn_every=6)}


def pair(name, **over):
    import jax
    import numpy as np
    from repro import configs as jcfgs
    from repro.models import build_model as jbuild
    from repro_torch import configs as tcfgs
    from repro_torch.models import build_model, params_from_jax
    jc = dataclasses.replace(jcfgs.get_config(name, smoke=True), **over)
    tc = dataclasses.replace(tcfgs.get_config(name, smoke=True), **over)
    jm = jbuild(jc)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tc, device="cpu")
    return jm, jp, tm, params_from_jax({k: np.asarray(v)
                                        for k, v in jp.items()}, "cpu",
                                       cfg=tc)


def as_np(a):
    import numpy as np
    import torch
    return a.double().numpy() if torch.is_tensor(a) else \
        np.asarray(a, np.float64)


def last_logits(jm, jp, tm, tp, toks):
    """(JAX prefill, JAX decode, port prefill, port decode) last-token
    logits of ``toks`` (B, 8), float64 on the host: ``prefill`` against the
    8 tokens fed one by one through ``decode_step``."""
    import jax
    import jax.numpy as jnp
    import torch
    jpre, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 16)
    cache, step = jm.init_cache(2, 16), jax.jit(jm.decode_step)
    for t in range(8):
        jl, cache = step(jp, cache, jnp.asarray(toks[:, t:t + 1]),
                         jnp.asarray(t, jnp.int32))
    tpre, _ = tm.prefill(tp, {"tokens": torch.as_tensor(toks)}, 16)
    cache = tm.init_cache(2, 16)
    for t in range(8):
        tl, cache = tm.decode_step(tp, cache, torch.as_tensor(
            toks[:, t:t + 1]), t)
    return as_np(jpre), as_np(jl), as_np(tpre), as_np(tl)


def prefill_vs_decode(name) -> dict:
    import jax.numpy as jnp
    import numpy as np
    from repro.models import build_model as jbuild
    from repro_torch.models import build_model, params_from_jax
    jm, jp, tm, tp = pair(name, **DEEP[name])
    toks = np.random.default_rng(0).integers(
        0, DEEP[name]["vocab"], size=(2, 8)).astype(np.int32)
    jpre, jl, tpre, tl = last_logits(jm, jp, tm, tp, toks)
    # the same weights widened to fp32: the oracle both bf16 paths round
    kw = dict(param_dtype="float32", compute_dtype="float32")
    jp32 = {k: v.astype(jnp.float32) for k, v in jp.items()}
    tc32 = dataclasses.replace(tm.cfg, **kw)
    o = last_logits(jbuild(dataclasses.replace(jm.cfg, **kw)), jp32,
                    build_model(tc32, device="cpu"), params_from_jax(
                        {k: np.asarray(v) for k, v in jp32.items()}, "cpu",
                        cfg=tc32), toks)[0]
    rel = lambda a: float(np.linalg.norm(a - o) / np.linalg.norm(o))
    return dict(jax=float(np.abs(jpre - jl).max()),
                port=float(np.abs(tpre - tl).max()),
                max_abs_logit=float(np.abs(jl).max()),
                jax_prefill_vs_fp32=rel(jpre), jax_decode_vs_fp32=rel(jl),
                port_prefill_vs_fp32=rel(tpre), port_decode_vs_fp32=rel(tl),
                jax_decode_over_prefill=rel(jl) / rel(jpre),
                port_decode_over_prefill=rel(tl) / rel(tpre))


def bf16_vs_fp32(name) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    runs, w32 = {}, None
    for dt in ("float32", "bfloat16"):
        jm, jp, tm, _ = pair(name, param_dtype=dt, compute_dtype=dt)
        if w32 is None:
            w32 = jp
        jp = {k: v.astype(getattr(jnp, dt)) for k, v in w32.items()}
        from repro_torch.models import params_from_jax
        tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                             "cpu", cfg=tm.cfg)
        toks = np.random.default_rng(0).integers(
            0, tm.cfg.vocab, size=(4, 11)).astype(np.int32)
        jl, _ = jax.jit(jm.decode_step)(
            jp, jm.init_cache(4, 32, dtype=getattr(jnp, dt)),
            jnp.asarray(toks), jnp.asarray(0, jnp.int32))
        tl, _ = tm.decode_step(tp, tm.init_cache(
            4, 32, dtype=getattr(torch, dt)), torch.as_tensor(toks), 0)
        runs[dt] = (as_np(jl), as_np(tl))
    ref = runs["float32"][0]
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    return dict(fp32_port_vs_jax=rel(runs["float32"][1], ref),
                jax_bf16_vs_fp32=rel(runs["bfloat16"][0], ref),
                port_bf16_vs_fp32=rel(runs["bfloat16"][1], ref),
                port_bf16_vs_jax_bf16=rel(runs["bfloat16"][1],
                                          runs["bfloat16"][0]))


def main() -> int:
    for name in DEEP:
        print(json.dumps(dict(config=name, deep=DEEP[name],
                              prefill_vs_decode=prefill_vs_decode(name),
                              bf16_vs_fp32=bf16_vs_fp32(name))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
