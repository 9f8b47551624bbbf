"""Roofline derivation from dry-run artifacts (counterpart of
``repro.launch.roofline``), for the NVIDIA H100 SXM5.

Three terms per (arch x shape x mesh) cell, in seconds per step:

    compute    = FLOPs_per_card / PEAK_FLOPS          (989.4 TF/s dense bf16)
    memory     = bytes_per_card / HBM_BW               (3.35 TB/s HBM3)
    collective = collective_bytes_per_card / LINK_BW   (450 GB/s NVLink 4)

The three constants are the H100 SXM5's datasheet figures, not
measurements: dense (no sparsity) bf16 tensor-core peak, HBM3 bandwidth,
and NVLink 4's 900 GB/s a card counted one direction. The dry-run
(``repro_torch.launch.dryrun``) gives FLOPs (``FlopCounterMode`` over the
rank's step), bytes (each op's operands and result once, unfused: an
upper bound) and collective bytes (each collective's output, counted by
``Mesh.counts``) per card.

The production layouts are a (16, 16) mesh of 256 cards and (2, 16, 16)
of 512: a 16 x 16 mesh spans 32 nodes of eight cards, and there the
network cards (NICs), not NVLink, carry the traffic between nodes. No
term for them is added here: the collective term reads every byte at the
NVLink rate, a lower bound on its time.

MODEL_FLOPS = 6*N_active*D for train steps (fwd+bwd), 2*N_active*D for
prefill/decode forward passes, D = tokens processed per step. The ratio
MODEL_FLOPS / (FLOPs * cards) measures how much counted compute is
"useful" (remat recompute, padded token blocks, the SSD's chunk terms and
capacity dispatch show up here)."""

from __future__ import annotations

import argparse
import json
from typing import Dict

PEAK_FLOPS = 989.4e12      # H100 SXM5 datasheet: dense bf16 per card
HBM_BW = 3.35e12           # H100 SXM5 datasheet: HBM3 bytes/s per card
LINK_BW = 450e9            # H100 SXM5 datasheet: NVLink 4, one direction


def model_flops(rec: Dict, shape_name: str, batch: int, seq: int) -> float:
    n_act = rec["n_active_params"]
    if shape_name.startswith("train"):
        return 6.0 * n_act * batch * seq
    if shape_name.startswith("prefill"):
        return 2.0 * n_act * batch * seq
    # decode: one token per sequence per step
    return 2.0 * n_act * batch


SHAPE_DIMS = {
    "train_4k": (256, 4096),
    "prefill_32k": (32, 32768),
    "decode_32k": (128, 1),      # tokens per step
    "long_500k": (1, 1),
}


def analyze(rec: Dict, peak_flops: float = PEAK_FLOPS,
            hbm_bw: float = HBM_BW, link_bw: float = LINK_BW) -> Dict:
    """The three terms of one dry-run record, its dominant one, useful
    FLOPs and roofline fraction; the rates default to the H100's."""
    shape = rec["shape"]
    if shape in SHAPE_DIMS:
        batch, seq = SHAPE_DIMS[shape]
    else:
        # dkpca-paper cell: n_active_params carries the ANALYTIC useful
        # flops per node (= per card) for one ADMM iteration
        batch, seq = None, None
    compute_s = rec["flops_per_device"] / peak_flops
    memory_s = rec["bytes_accessed_per_device"] / hbm_bw
    coll_bytes = sum(v["bytes"] for v in rec["collectives"].values())
    collective_s = coll_bytes / link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    if batch is None:
        mf = rec["n_active_params"] * max(rec["n_devices"], 1)
    else:
        mf = model_flops(rec, shape, batch, seq)
    hlo_total = rec["flops_per_device"] * max(rec["n_devices"], 1)
    useful = mf / hlo_total if hlo_total else 0.0
    # roofline fraction: ideal compute time of *useful* flops over the
    # dominant actual term — the score to hillclimb.
    ideal_s = mf / (peak_flops * max(rec["n_devices"], 1))
    frac = ideal_s / max(terms[dominant], 1e-30)
    return {
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
        "model_flops": mf, "useful_flops_ratio": useful,
        "roofline_fraction": frac,
        "collective_bytes_per_device": coll_bytes,
    }


def to_markdown(results: Dict[str, Dict], single_pod_only=True,
                **rates) -> str:
    rows = []
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | useful FLOPs | roofline frac |")
    sep = "|" + "---|" * 9
    rows.append(hdr)
    rows.append(sep)
    for key, rec in sorted(results.items()):
        if not rec.get("ok"):
            continue
        if single_pod_only and rec["mesh"] != "16x16":
            continue
        a = analyze(rec, **rates)
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} "
            f"| {a['compute_s']:.3f} | {a['memory_s']:.3f} "
            f"| {a['collective_s']:.3f} | **{a['dominant']}** "
            f"| {a['useful_flops_ratio']:.2f} "
            f"| {a['roofline_fraction']:.3f} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="build/dryrun/dryrun.json")
    ap.add_argument("--out", default="build/dryrun/roofline.json")
    ap.add_argument("--markdown", default="build/dryrun/roofline.md")
    args = ap.parse_args(argv)
    with open(args.dryrun) as f:
        results = json.load(f)
    out = {}
    for key, rec in results.items():
        if rec.get("ok"):
            out[key] = dict(rec, **analyze(rec))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    md = to_markdown(results, single_pod_only=True)
    with open(args.markdown, "w") as f:
        f.write(md + "\n")
    print(md)


if __name__ == "__main__":
    main()
