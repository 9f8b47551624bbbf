"""Training launcher of the port (port of ``repro.launch.train``: the same
flags and the same last line).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --steps 6 --batch 4 --seq 128
    REPRO_PLATFORM=cpu PYTHONPATH=src python -m repro_torch.launch.train \
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Draws the model's weights from a seeded ``torch.Generator`` on the device
and its tokens from ``TokenStream``, trains with AdamW under a cosine
schedule (warmup steps // 20), and prints ``final loss: ... (first: ...);
straggler flags: ...``. Runs on the card unless ``REPRO_PLATFORM=cpu``
(``repro_torch.launch.env``).

``--mesh DxM`` trains data- and tensor-parallel over a (data=D, model=M)
mesh, one process per card (NCCL; gloo on the CPU), started by
``torchrun``, which sets RANK, WORLD_SIZE, LOCAL_RANK and the meeting
point; rank 0 alone prints the last line:

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --arch llama3.2-3b --mesh 2x2 \
        --steps 6 --batch 4 --seq 128
"""

from __future__ import annotations

import argparse
import logging

import torch.distributed as dist

from ..configs import get_config
from ..data.tokens import TokenStream
from ..device import resolve_device
from ..models import build_model
from ..obs import trace
from ..obs.cli import add_obs_args, obs_session
from ..optim import AdamWConfig, cosine_with_warmup
from ..train import TrainConfig, activation_probe, train
from .env import device_from_environ
from .mesh import make_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_obs_args(ap)
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--probe-every", type=int, default=0)
    ap.add_argument("--mesh", default=None,
                    help="e.g. '4x2' => (data=4, model=2), one process "
                         "per card under torchrun")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    try:
        device = resolve_device(device_from_environ())
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"train: {e}") from None
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    cfg = get_config(args.arch, smoke=args.smoke)
    mesh = None
    if args.mesh:
        dims = tuple(int(x) for x in args.mesh.split("x"))
        mesh = make_mesh(dims, ("data", "model")[: len(dims)], device=device)
        device = mesh.device
    try:
        history = _run(args, cfg, device, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    if history is not None:
        print(f"final loss: {history['loss'][-1]:.4f} "
              f"(first: {history['loss'][0]:.4f}); "
              f"straggler flags: {history['straggler_flags']}")


def _run(args, cfg, device, mesh):
    """Train; returns the history on the rank that prints (rank 0, or the
    one process without a mesh), else None."""
    model = build_model(cfg, mesh=mesh, device=device)
    data = TokenStream(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                       seed=args.seed, device=str(device))
    opt = AdamWConfig(lr=args.lr,
                      schedule=cosine_with_warmup(args.steps // 20,
                                                  args.steps))
    tcfg = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, seed=args.seed,
                       probe_every=args.probe_every)
    probe = (lambda state, batch: activation_probe(
        state["params"], batch, mesh=mesh,
        shards=model.shards())) if args.probe_every else None
    with obs_session(args):
        with trace.span("train.run", arch=args.arch, steps=args.steps):
            _, history = train(model, opt, data, tcfg, mesh=mesh,
                               probe_fn=probe)
    return history if mesh is None or dist.get_rank() == 0 else None


if __name__ == "__main__":
    main()
