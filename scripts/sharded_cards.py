#!/usr/bin/env python3
"""The sharded router across real cards: the consensus-sized model (2000 x
784, a central fit on chip_smoke.py's pooled data) in 4 shards, served
through the started engine over a mesh of every card of the host (one
process), routing "mp" (shards spread over the cards, partials summed on
the first), "dp" (query rows split over the cards) and "auto"; every
request within 3e-4 of the unsharded plain projection (the reference's
sharded tolerance), and ``project_sharded`` the same. Prints one JSON line.

    PYTHONPATH=src python3 scripts/sharded_cards.py [--requests 1024]

Needs at least two CUDA devices.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=1024)
    args = ap.parse_args()
    import numpy as np
    import torch
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        print("sharded_cards: needs two or more CUDA devices",
              file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.core import KernelSpec, oos
    from repro_torch.data import node_dataset
    from repro_torch.kernels import prepare_support, project_reference
    from repro_torch.launch import make_serving_mesh
    from repro_torch.serve import KpcaEngine, KpcaServeConfig, project_sharded
    home = torch.device("cuda", 0)
    _, pooled = node_dataset(20, 100, m=784, seed=0)
    full = oos.fit_central(pooled, KernelSpec(kind="rbf"), device=home)
    sharded, _ = oos.shard_fitted(full, 4)
    mesh = make_serving_mesh(min(4, n_cards))
    requests = chip_smoke.stream_requests(args.requests, seed=13)
    flat = np.concatenate(requests)
    want = project_reference(full.spec, torch.as_tensor(flat, device=home),
                             full.x_support, full.coefs, full.row_mean_coef,
                             full.bias, full.gamma).cpu().numpy()
    out = {"cards": n_cards, "mesh": [str(d) for d in mesh or []],
           "names": [torch.cuda.get_device_name(i) for i in range(n_cards)]}
    ok = True
    for routing in ("auto", "mp", "dp"):
        eng = KpcaEngine(sharded, KpcaServeConfig(routing=routing),
                         device=home, mesh=mesh)
        with eng:
            s0 = prepare_support.launches
            t0 = time.perf_counter()
            run = chip_smoke.run_async(eng, requests)
            wall = time.perf_counter() - t0
            splits = prepare_support.launches - s0
        err = float(np.abs(np.concatenate(run["outs"]) - want).max())
        placed = eng.router._placed
        out[routing] = dict(
            max_abs_err=err, routed=eng.stats.routing_summary(),
            queries_per_s=flat.shape[0] / wall,
            steady_support_splits=splits,
            placement_hits=eng.router.n_placement_hits,
            devices_placed={g: [str(p.device) for p in v[1]]
                            for g, v in placed.items()})
        ok = ok and err <= 3e-4 and splits == 0
    xq = torch.as_tensor(flat[:512], device=home)
    for policy in ("mp", "dp"):
        got = project_sharded(sharded, xq, devices=mesh, policy=policy)
        err = float(np.abs(got.cpu().numpy() - want[:512]).max())
        out[f"project_sharded_{policy}"] = err
        ok = ok and err <= 3e-4
    out["ok"] = ok
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
