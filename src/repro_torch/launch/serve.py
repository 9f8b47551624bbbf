"""LM serving launcher of the port: batched greedy/temperature decode in
fixed-slot waves (port of ``repro.launch.serve``: the same flags and the
same printed lines).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b
    REPRO_PLATFORM=cpu PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mixtral-8x22b --smoke --prompts 8 --max-new 16

Draws the model's weights from a seeded ``torch.Generator`` on the device
(random, as the JAX launcher's are) and prompts of 4-11 tokens from
``default_rng(0)``, as the JAX launcher does. Runs on the card unless
``REPRO_PLATFORM=cpu`` (``repro_torch.launch.env``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import get_config
from ..device import resolve_device
from ..models import build_model
from ..serve import DecodeEngine, ServeConfig
from .env import device_from_environ


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args(argv)
    try:
        device = resolve_device(device_from_environ())
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"serve: {e}") from None

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=device)
    params, _ = model.init(0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=rng.integers(4, 12)).tolist()
               for _ in range(args.prompts)]
    engine = DecodeEngine(model, params, args.slots,
                          ServeConfig(max_len=64,
                                      max_new_tokens=args.max_new,
                                      temperature=args.temperature))
    t0 = time.perf_counter()
    outs = engine.generate(prompts)
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in outs)
    print(f"served {len(prompts)} prompts, {total} tokens "
          f"in {dt:.2f}s ({total / dt:.1f} tok/s)")
    for i, o in enumerate(outs[:4]):
        print(f"  [{i}] {o}")


if __name__ == "__main__":
    main()
