"""Checkpointing with the JAX package's on-disk layout, so a checkpoint
written by either package loads in the other.

Layout (one directory per step):
    ckpt_dir/step_00000042/manifest.json      leaves + shapes/dtypes + metadata
    ckpt_dir/step_00000042/<escaped-key>.npy  one file per leaf

Writes are atomic: a temp dir is renamed into place only after the manifest
is fsynced, so a killed job never leaves a torn checkpoint. Leaves are read
back as numpy arrays; callers place them on a device.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

_SAFE = {"/": "__", ".": "_d_"}


def _escape(key: str) -> str:
    for a, b in _SAFE.items():
        key = key.replace(a, b)
    return key


def _to_numpy(val) -> np.ndarray:
    if isinstance(val, torch.Tensor):
        return val.detach().cpu().numpy()
    return np.asarray(val)


def save_checkpoint(ckpt_dir: str, step: int, tree: Dict[str, Any],
                    metadata: Optional[dict] = None, keep_last: int = 3):
    """tree: flat dict key -> tensor / array. Returns the step directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
    for key, val in tree.items():
        arr = _to_numpy(val)
        fname = _escape(key) + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _cleanup(ckpt_dir, keep_last)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None):
    """Returns (tree of numpy arrays, metadata, step); latest step by
    default."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    tree = {key: np.load(os.path.join(d, info["file"]))
            for key, info in manifest["leaves"].items()}
    return tree, manifest["metadata"], step


def _cleanup(ckpt_dir: str, keep_last: int):
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
