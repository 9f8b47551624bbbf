"""Checkpointing with the JAX package's on-disk layout, so a checkpoint
written by either package loads in the other.

Layout (one directory per step):
    ckpt_dir/step_00000042/manifest.json      leaves + shapes/dtypes + metadata
    ckpt_dir/step_00000042/<escaped-key>.npy  one file per leaf

Writes are atomic: a temp dir is renamed into place only after the manifest
is fsynced, so a killed job never leaves a torn checkpoint. Leaves are read
back as numpy arrays; callers place them on a device. numpy has no bf16:
a bf16 leaf is written as the JAX package writes it (its raw 2-byte bits,
numpy type ``V2``, manifest dtype "bfloat16") and read back as a bf16 CPU
tensor.

``save_checkpoint_async`` copies every leaf to host memory before it
returns, then writes on a daemon thread, so training can go on (and change
its tensors in place) while the disk write proceeds.

Over a device mesh (``shardings``: key -> (spec, mesh), each leaf a rank's
shard) every rank calls ``save_checkpoint``: each leaf is all-gathered in
turn and rank 0 writes it whole, so the files are the mesh-independent
form the JAX package writes and one leaf at a time is the extra memory.
``restore_checkpoint(..., shardings=)`` places each leaf's shard on the
mesh's device, whatever mesh (or none) wrote it: an elastic restore.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
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
        t = val.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(val)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == np.dtype("V2") else str(arr.dtype)


def _from_file(path: str, dtype: str):
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return arr


def _gathered(tree: Dict[str, Any], shardings):
    """(key, whole leaf) in key order; over a mesh each sharded leaf is
    all-gathered on every rank as it is reached."""
    from ..distributed.collectives import gather_full
    for key, val in tree.items():
        if shardings and key in shardings:
            spec, mesh = shardings[key]
            val = gather_full(val, spec, mesh)
        yield key, val


def save_checkpoint(ckpt_dir: str, step: int, tree: Dict[str, Any],
                    metadata: Optional[dict] = None, keep_last: int = 3,
                    shardings: Optional[Dict[str, Any]] = None):
    """tree: flat dict key -> tensor / array. Returns the step directory.
    ``shardings`` (key -> (spec, mesh)): every rank of the mesh calls this
    with its shards; rank 0 writes, the others join the gathers and wait
    until the step directory is in place."""
    if shardings:
        import torch.distributed as dist
        if dist.get_rank() != 0:
            for _ in _gathered(tree, shardings):
                pass
            dist.barrier()
            return os.path.join(ckpt_dir, f"step_{step:08d}")
        try:
            return _write(ckpt_dir, step, _gathered(tree, shardings),
                          metadata, keep_last)
        finally:
            dist.barrier()
    return _write(ckpt_dir, step, tree.items(), metadata, keep_last)


def _write(ckpt_dir: str, step: int, items, metadata, keep_last: int):
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
    for key, val in items:
        arr = _to_numpy(val)
        fname = _escape(key) + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape),
            "dtype": _dtype_name(arr)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _cleanup(ckpt_dir, keep_last)
    return final


def save_checkpoint_async(ckpt_dir: str, step: int, tree: Dict[str, Any],
                          metadata: Optional[dict] = None,
                          keep_last: int = 3) -> threading.Thread:
    """Snapshot every leaf to host memory (a copy, complete when this
    returns: a later in-place change to a tensor does not reach the
    checkpoint), then write it on a daemon thread; returns the thread."""
    snapshot = {k: np.array(_to_numpy(v), copy=True) for k, v in tree.items()}
    t = threading.Thread(
        target=save_checkpoint, args=(ckpt_dir, step, snapshot),
        kwargs={"metadata": metadata, "keep_last": keep_last}, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       shardings: Optional[Dict[str, Any]] = None):
    """Returns (tree of numpy arrays, bf16 leaves as bf16 CPU tensors,
    metadata, step); latest step by default. With ``shardings`` (key ->
    (spec, mesh)) those leaves are this rank's shards instead, as tensors
    on the mesh's device (read and cut one leaf at a time)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    tree = {}
    for key, info in manifest["leaves"].items():
        val = _from_file(os.path.join(d, info["file"]), info["dtype"])
        if shardings and key in shardings:
            from ..distributed.sharding import local_shard
            spec, mesh = shardings[key]
            val = local_shard(torch.as_tensor(val), spec, mesh).to(
                mesh.device, copy=True, memory_format=torch.contiguous_format)
        tree[key] = val
    return tree, manifest["metadata"], step


def _cleanup(ckpt_dir: str, keep_last: int):
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint",
           "save_checkpoint_async"]
