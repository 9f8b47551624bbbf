#!/usr/bin/env python3
"""How far fp32 computations of falcon-mamba-7b's decode that differ only
in their order of operations land from each other, on one card.

    PYTHONPATH=src python3 scripts/falcon_split_gap.py            # card
    PYTHONPATH=src python3 scripts/falcon_split_gap.py --smoke --device cpu

The run is `chip_smoke.py --phase lm_decode_dist`'s falcon run: bf16
weights from seed 0, a 4 x 1024 prompt, 32 greedy steps (their tokens fed
to every fp32 run), then the bf16 weights widened to fp32 and three fp32
runs fed those tokens:

  plain    the one-card code;
  rechunk  the scan's chunk halved (the lm_decode_dist gate's second
           card run);
  split4   the one-card code with the products a (1, 4) mesh splits done
           as the mesh does them: w_in, w_dt and the logits head in 4
           column blocks, w_x and w_out in 4 row blocks whose partial
           products are summed (the column-parallel mamba1 and the
           vocab-parallel head, on one card, without a collective).

Prints one JSON line: each run's max abs distance from plain, and plain's
max |logit|. If split4 lands as far from plain as the four-card mesh did,
the mesh's fp32 gap is its order of operations, amplified.
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.models import build_model, common, lm, mamba  # noqa: E402

PROMPT, BATCH, STEPS, SPLIT = 1024, 4, 32, 4


def split_einsum(orig):
    """``tok_einsum`` with the products a (1, 4) mesh splits done in its
    blocks."""
    def run(eq, x, w):
        if eq in ("ble,ei->bli", "blr,ri->bli", "bse,ev->bsv"):
            return torch.cat([orig(eq, x, part)
                              for part in w.chunk(SPLIT, dim=1)], dim=-1)
        if eq in ("bli,ir->blr", "bli,ie->ble"):
            out = None
            for xs, ws in zip(x.chunk(SPLIT, dim=-1), w.chunk(SPLIT, dim=0)):
                part = orig(eq, xs, ws)
                out = part if out is None else out + part
            return out
        return orig(eq, x, w)
    return run


def greedy(model, params, tokens, feed=None, dtype=None):
    kw = {} if dtype is None else {"dtype": dtype}
    logits, cache = model.prefill(params, {"tokens": tokens}, 2 * PROMPT,
                                  **kw)
    outs, fed = [logits.float().cpu()], []
    for i in range(STEPS):
        tok = torch.argmax(logits.float(), -1) if feed is None \
            else feed[i].to(logits.device)
        fed.append(tok)
        logits, cache = model.decode_step(params, cache, tok[:, None].to(
            torch.int32), PROMPT + i)
        outs.append(logits.float().cpu())
    return torch.stack(outs), torch.stack(fed)


def main(argv=None) -> int:
    global PROMPT, STEPS
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config, 40 tokens, 4 steps")
    args = ap.parse_args(argv)
    cfg = configs.get_config("falcon-mamba-7b", smoke=args.smoke)
    if args.smoke:
        PROMPT, STEPS = 40, 4
    dev = torch.device(args.device)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=(
        BATCH, PROMPT), dtype=np.int32), device=dev)
    with torch.no_grad():
        params, _ = build_model(cfg, device=dev).init(0)
        _, feed = greedy(build_model(cfg, device=dev), params, tokens)
        wide = {k: v.float() for k, v in params.items()}
        del params
        c32 = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
        runs = {}
        for name, c in (("plain", c32), ("rechunk", dataclasses.replace(
                c32, ssm_chunk=c32.ssm_chunk // 2)), ("split4", c32)):
            saved = (mamba.tok_einsum, lm.tok_einsum)
            if name == "split4":
                mamba.tok_einsum = split_einsum(common.tok_einsum)
                lm.tok_einsum = split_einsum(common.tok_einsum)
            try:
                runs[name], _ = greedy(build_model(c, device=dev), wide,
                                       tokens, feed=feed,
                                       dtype=torch.float32)
            finally:
                mamba.tok_einsum, lm.tok_einsum = saved
    plain = runs["plain"]
    out = {name: float((r - plain).abs().max()) for name, r in runs.items()
           if name != "plain"}
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "cpu"
    print(json.dumps(dict(script="falcon_split_gap", device=device,
                          prompt=PROMPT, steps=STEPS,
                          max_abs_logit=float(plain.abs().max()),
                          max_abs_from_plain=out)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
