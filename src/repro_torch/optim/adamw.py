"""AdamW with global-norm clipping (counterpart of ``repro.optim.adamw``).

Moments are fp32 whatever the parameters' dtype, and the arithmetic is the
JAX package's, step for step: the clip scale min(1, clip / max(|g|, 1e-9)),
the bias corrections 1 - b**step in fp32, decay only on tensors of two or
more dims, the new parameter cast back to its own dtype.

``adamw_update`` is the functional form, a literal port. ``adamw_update_``
does the same operations in the same order in place, under
``torch.no_grad()``, a slice of rows at a time: the training loop's form.
At llama3.2-3b's width the functional form does not fit on one 80 GB card
(its new moments live beside the old ones, and its fp32 temporaries of one
28 x 3072 x 8192 stack take about 20 GB), while the in-place form adds at
most a few slices of ``SLICE_ELEMS`` fp32 values to the state it updates.
The two give the same bits.

Over a device mesh every leaf is a rank's shard and the update runs on
the shards as it is; ``global_norm`` takes the leaves' specs and the mesh
and sums each shard's squares over the axes its leaf is split on (a leaf
replicated over an axis counts once, not once per rank).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

# the most elements of one tensor that the in-place update (and the norm)
# widens to fp32 at once: 2**26 values, 256 MiB a temporary
SLICE_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def adamw_init(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    dev = next(iter(params.values())).device if params else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {
        "m": {k: zeros(v) for k, v in params.items()},
        "v": {k: zeros(v) for k, v in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _row_slices(t: torch.Tensor):
    """Views of ``t`` along its leading dim, each of at most
    ``SLICE_ELEMS`` elements (one row at least); a 0-d tensor is one
    slice."""
    if t.dim() == 0:
        return [t]
    per_row = max(t[0].numel(), 1)
    rows = max(SLICE_ELEMS // per_row, 1)
    return list(t.split(rows))


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares in fp32, each leaf summed a
    slice of rows at a time (so no leaf is widened whole).

    Over ``mesh``: ``tree`` maps keys to this rank's shards and ``specs``
    maps the same keys to their specs; each slice's sum is all-reduced
    over the mesh axes its leaf is split on (one all-reduce per set of
    axes, of every such slice's sum at once; a replicated leaf, whose
    gradient the step has summed to the same whole on every rank, is
    counted once), and the sums are added in
    the same order as without a mesh, so a mesh of one rank gives the same
    bits."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(s.float()))
                              for g in _leaves(tree)
                              for s in _row_slices(g)))
    from ..distributed.collectives import all_reduce_
    from ..distributed.sharding import axes_of
    parts, by_axes = [], {}
    for k, g in tree.items():
        axes = tuple(sorted({a for e in specs[k] for a in axes_of(e)},
                            key=mesh.axis_names.index))
        for s in _row_slices(g):
            by_axes.setdefault(axes, []).append(len(parts))
            parts.append(torch.sum(torch.square(s.float())))
    for axes, idx in by_axes.items():
        if axes and mesh.size(axes) > 1:
            summed = all_reduce_(torch.stack([parts[i] for i in idx]), mesh,
                                 axes)
            for j, i in enumerate(idx):
                parts[i] = summed[j]
    return torch.sqrt(sum(parts))


def _clip_scale(cfg: AdamWConfig, gnorm: torch.Tensor):
    if not cfg.clip_norm:
        return 1.0
    clip = torch.tensor(cfg.clip_norm, dtype=torch.float32,
                        device=gnorm.device)
    return torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)


def learning_rate(cfg: AdamWConfig, step: torch.Tensor):
    """The lr of ``step`` (the step counter after this update)."""
    return cfg.lr * (cfg.schedule(step) if cfg.schedule else 1.0)


def _bias_corrections(cfg: AdamWConfig, step: torch.Tensor):
    s = step.to(torch.float32)
    return 1.0 - cfg.b1 ** s, 1.0 - cfg.b2 ** s


def adamw_update(cfg: AdamWConfig, params, grads, state):
    """Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = _clip_scale(cfg, gnorm)
    lr = learning_rate(cfg, step)
    b1c, b2c = _bias_corrections(cfg, step)

    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].to(torch.float32) * scale
        m = cfg.b1 * state["m"][k] + (1 - cfg.b1) * g
        v = cfg.b2 * state["v"][k] + (1 - cfg.b2) * g * g
        mh = m / b1c
        vh = v / b2c
        upd = mh / (torch.sqrt(vh) + cfg.eps)
        if cfg.weight_decay and p.dim() >= 2:      # no decay on norms/bias
            upd = upd + cfg.weight_decay * p.to(torch.float32)
        new_p[k] = (p.to(torch.float32) - lr * upd).to(p.dtype)
        new_m[k] = m
        new_v[k] = v
    return new_p, {"m": new_m, "v": new_v, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def adamw_update_(cfg: AdamWConfig, params, grads, state,
                  gnorm: Optional[torch.Tensor] = None):
    """``adamw_update`` in place: params, ``state["m"]`` and ``state["v"]``
    are overwritten slice by slice, ``state["step"]`` advances; returns the
    metrics. ``gnorm``: the grads' global norm, where the caller has it."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = _clip_scale(cfg, gnorm)
    lr = learning_rate(cfg, step)
    b1c, b2c = _bias_corrections(cfg, step)
    for k, p in params.items():
        decay = cfg.weight_decay and p.dim() >= 2
        for ps, gs, ms, vs in zip(*(_row_slices(t) for t in (
                p, grads[k], state["m"][k], state["v"][k]))):
            g = gs.to(torch.float32) * scale
            ms.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            g2 = (1 - cfg.b2) * g
            vs.mul_(cfg.b2).add_(g2.mul_(g))
            del g
            upd = ms / b1c
            vh = torch.div(vs, b2c, out=g2)
            upd.div_(vh.sqrt_().add_(cfg.eps))
            del g2, vh
            pf = ps.to(torch.float32)
            if decay:
                upd.add_(cfg.weight_decay * pf)
            ps.copy_(pf.sub_(upd.mul_(lr)))
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}


__all__ = ["AdamWConfig", "SLICE_ELEMS", "adamw_init", "adamw_update",
           "adamw_update_", "global_norm", "learning_rate"]
