"""Training loop of the port (counterpart of ``repro.train.loop``): the
step with its NaN guard, checkpoint and restart, straggler monitoring, and
the DKPCA activation probe as an optional hook.

The JAX step is jitted and donates its state; here ``step_fn`` updates the
state's tensors in place (``optim.adamw_update_``), which is what lets
llama3.2-3b train on one 80 GB card, and returns the same dict.

Over a device mesh (``mesh``, a ``repro_torch.distributed.Mesh``; one
process per device, every process calling with the same arguments) the
step computes what the JAX package's GSPMD step computes: params, m and v
are each rank's shards under ``rules`` (``distributed.sharding``), every
rank is fed the global batch and runs its rows of it, the gradients of the
leaves that are not split over the batch axes are summed over them (the
FSDP reduce-scatter sums the others), those of the leaves replicated over
"model" of which each rank's work used its part (``Shards.partial``: the
hybrid's split mamba2 layers') over "model", the grad norm is the global
one (each such leaf counted once), so every rank applies the same update
to a replicated leaf, and
the NaN guard reads the global loss and norm, the same on every rank.
Checkpoints are written whole by rank 0 (the JAX package's
mesh-independent form) and restored onto any mesh, or none.

Checkpoints hold the state under the JAX package's leaf names
(``params::<key>``, ``m::<key>``, ``v::<key>``, ``step::step``) and the data
stream's state in the metadata, so a checkpoint either loop wrote resumes
in the other.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..device import DeviceLike
from ..distributed.collectives import MODEL, all_reduce_
from ..distributed.sharding import axes_of, local_shard
from ..optim import AdamWConfig, adamw_init, global_norm
from ..optim.adamw import adamw_update_, learning_rate

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    probe_every: int = 0          # 0 = off; DKPCA activation probe period
    straggler_factor: float = 3.0
    seed: int = 0


def loss_and_grads(model, params, batch):
    """(total loss, metrics, grads by key) of ``model.loss``; a parameter
    the loss does not reach gets zero grads, as ``jax.grad`` gives."""
    leaves = list(params.values())
    for p in leaves:
        p.requires_grad_(True)
    try:
        total, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    return total.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _sum_flat(grads, keys, mesh, axes) -> None:
    """Sum over ``axes``, in place of ``grads``, the gradients of ``keys``:
    one all-reduce per dtype, of those leaves flattened together."""
    for dt in dict.fromkeys(grads[k].dtype for k in keys):
        ks = [k for k in keys if grads[k].dtype == dt]
        flat = all_reduce_(torch.cat([grads[k].reshape(-1) for k in ks]),
                           mesh, axes)
        for k, part in zip(ks, flat.split([grads[k].numel() for k in ks])):
            grads[k] = part.view(grads[k].shape)


def sum_replicated_grads(grads, shards) -> None:
    """Sum, in place of ``grads``, over the batch axes the gradients of the
    leaves not split over them (the others' the FSDP reduce-scatter has
    summed), and over "model" those of ``shards.partial``, the leaves
    replicated over "model" of which each rank's work used its part (the
    hybrid's split mamba2 layers'); one all-reduce per dtype for each sum.
    The other leaves replicated over "model" have their whole gradient on
    every rank and are not summed over it."""
    axes = shards.batch_axes
    if shards.dp > 1:
        _sum_flat(grads, [k for k, spec in shards.specs.items()
                          if not set(axes) & {a for e in spec
                                              for a in axes_of(e)}],
                  shards.mesh, axes)
    if shards.partial:
        _sum_flat(grads, shards.partial, shards.mesh, MODEL)


def shard_place(shards):
    """``Model.init``'s ``place``: keep this rank's shard of each leaf (a
    copy, so the whole leaf is freed)."""
    def place(path, v, axes):
        part = local_shard(v, shards.specs[path], shards.mesh)
        return v if part.shape == v.shape else part.clone(
            memory_format=torch.contiguous_format)
    return place


def build_train_step(model, opt_cfg: AdamWConfig, mesh=None, rules=None):
    """Returns (init_fn, step_fn).

    ``init_fn(key)``: key a seed (a generator on the model's device) or a
    ``torch.Generator``; returns (state, axes). Over ``mesh`` each leaf is
    drawn whole from the same generator as on one device and only this
    rank's shard is kept, leaf by leaf. ``step_fn(state, batch)`` updates
    ``state`` in place and returns (state, metrics): when the loss or the
    grad norm is not finite, params, m and v stay as they were, ``step``
    still advances and ``metrics["skipped"]`` is 1 (the JAX package's
    in-graph guard). Over ``mesh`` (under ``rules``, default
    ``default_rules``) ``batch`` is the global batch; the model takes each
    rank's rows of it."""
    if mesh is not None:
        model = model.with_mesh(mesh, rules)
    shards = model.shards()

    def init_fn(key):
        params, axes = model.init(
            key, place=None if shards is None else shard_place(shards))
        opt = adamw_init(params)
        return {"params": params, "m": opt["m"], "v": opt["v"],
                "step": opt["step"]}, axes

    def step_fn(state, batch):
        total, metrics, grads = loss_and_grads(model, state["params"], batch)
        if shards is None:
            gnorm = global_norm(grads)
        else:
            sum_replicated_grads(grads, shards)
            gnorm = global_norm(grads, shards.specs, shards.mesh)
        ok = bool(torch.isfinite(total) & torch.isfinite(gnorm))
        if ok:
            opt_metrics = adamw_update_(opt_cfg, state["params"], grads,
                                        state, gnorm=gnorm)
        else:
            state["step"] = state["step"] + 1
            opt_metrics = {"grad_norm": gnorm,
                           "lr": learning_rate(opt_cfg, state["step"])}
        del grads
        metrics = dict(metrics, **opt_metrics,
                       skipped=torch.tensor(not ok))
        return state, {k: v.to(torch.float32) if torch.is_tensor(v) else v
                       for k, v in metrics.items()}

    return init_fn, step_fn


def state_shardings(shards):
    """The flat checkpoint keys of the state (``_flatten_state``'s) with
    their (spec, mesh); None without a mesh."""
    if shards is None:
        return None
    return {f"{group}::{k}": (spec, shards.mesh)
            for group in ("params", "m", "v")
            for k, spec in shards.specs.items()}


@dataclasses.dataclass
class StragglerMonitor:
    """Flags steps slower than factor x running median (at 1000-node scale
    this signal feeds the scheduler; here it logs and counts)."""
    factor: float = 3.0
    times: list = dataclasses.field(default_factory=list)
    flagged: int = 0

    def record(self, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) < 5:
            return False
        med = float(np.median(self.times[-50:]))
        if dt > self.factor * med:
            self.flagged += 1
            log.warning("straggler step: %.3fs vs median %.3fs", dt, med)
            return True
        return False


def train(model, opt_cfg: AdamWConfig, data_iter, tcfg: TrainConfig,
          mesh=None, rules=None, probe_fn: Optional[Callable] = None):
    """Run the loop; returns (final state, history dict: the JAX loop's
    keys, and ``skipped``, each step's NaN-guard flag). Resumes from the
    newest checkpoint in ``tcfg.ckpt_dir``, the data stream's state
    included, whatever mesh (or none) wrote it. A step's time is taken when
    its loss reaches the host. Over ``mesh`` every rank calls it with the
    same arguments and data stream (see ``build_train_step``)."""
    if mesh is not None:
        model = model.with_mesh(mesh, rules)
    init_fn, step_fn = build_train_step(model, opt_cfg, mesh, rules)
    shardings = state_shardings(model.shards())
    state, axes = init_fn(tcfg.seed)
    start_step = 0
    if tcfg.ckpt_dir and latest_step(tcfg.ckpt_dir) is not None:
        flat, meta, start_step = restore_checkpoint(tcfg.ckpt_dir,
                                                    shardings=shardings)
        state = _unflatten_state(flat, device=model.device)
        if "data_state" in meta and hasattr(data_iter, "restore"):
            data_iter.restore(meta["data_state"])
        log.info("restored checkpoint at step %d", start_step)

    monitor = StragglerMonitor(tcfg.straggler_factor)
    history = {"loss": [], "step_time": [], "probe": [], "skipped": []}
    for step in range(start_step, tcfg.steps):
        batch = data_iter.next_batch()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        monitor.record(dt)
        history["loss"].append(loss)
        history["step_time"].append(dt)
        history["skipped"].append(bool(metrics["skipped"]))
        if tcfg.log_every and step % tcfg.log_every == 0:
            log.info("step %d loss %.4f (%.2fs)", step, loss, dt)
        if probe_fn and tcfg.probe_every and step % tcfg.probe_every == 0:
            history["probe"].append((step, probe_fn(state, batch)))
        if (tcfg.ckpt_dir and tcfg.ckpt_every
                and (step + 1) % tcfg.ckpt_every == 0):
            save_checkpoint(tcfg.ckpt_dir, step + 1, _flatten_state(state),
                            metadata={"data_state": getattr(
                                data_iter, "state", lambda: {})()},
                            shardings=shardings)
    history["straggler_flags"] = monitor.flagged
    return state, history


def _flatten_state(state):
    out = {}
    for group in ("params", "m", "v"):
        for k, v in state[group].items():
            out[f"{group}::{k}"] = v
    out["step::step"] = state["step"]
    return out


def _unflatten_state(flat, device: DeviceLike = "cpu"):
    """The state of a flat checkpoint tree (numpy arrays, or tensors for
    bf16 leaves), as tensors on ``device`` in the dtypes it was saved in."""
    state = {"params": {}, "m": {}, "v": {}}
    for k, v in flat.items():
        t = torch.as_tensor(v).to(device)
        group, key = k.split("::", 1)
        if group == "step":
            state["step"] = t.to(torch.int32)
        else:
            state[group][key] = t
    return state


__all__ = ["StragglerMonitor", "TrainConfig", "build_train_step",
           "loss_and_grads", "shard_place", "state_shardings",
           "sum_replicated_grads", "train"]
