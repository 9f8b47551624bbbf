"""Carry weights and state across from the JAX package as numpy arrays.

The JAX package's ``FittedKpca``, ``ShardedFittedKpca``, ``DkpcaSetup`` and
``AdmmState`` leaves, converted to numpy (``np.asarray`` on each), become the
port's dataclasses on a chosen device. Checkpoints need no conversion: both packages write the
same layout (``repro_torch.checkpoint``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .admm import DkpcaSetup
from .kernels_math import KernelSpec
from .oos import FittedKpca, ShardedFittedKpca
from .solver import AdmmState

FITTED_LEAVES = ("x_support", "coefs", "row_mean_coef", "bias", "gamma",
                 "k_row_mean", "k_grand_mean")
STATE_LEAVES = ("alpha", "b", "g", "znorm2", "rho")


def _f32(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=dev)


def fitted_from_numpy(arrays: Mapping[str, np.ndarray], spec: KernelSpec,
                      device: DeviceLike = "cuda") -> FittedKpca:
    """JAX ``FittedKpca`` leaves (``k_row_mean``/``k_grand_mean`` may be
    absent or None) -> the port's ``FittedKpca`` on ``device``."""
    dev = resolve_device(device)
    leaves = {k: (None if arrays.get(k) is None else _f32(arrays[k], dev))
              for k in FITTED_LEAVES}
    return FittedKpca(spec=spec, **leaves)


SHARDED_LEAVES = ("x_support", "coefs_ext", "row_mean_coef", "bias",
                  "gamma", "k_row_mean", "k_grand_mean")


def sharded_from_numpy(arrays: Mapping[str, np.ndarray], spec: KernelSpec,
                       n_support: int, shard_sizes,
                       device: DeviceLike = "cuda") -> ShardedFittedKpca:
    """JAX ``ShardedFittedKpca`` leaves (``k_row_mean``/``k_grand_mean`` may
    be absent or None) and its static fields -> the port's
    ``ShardedFittedKpca`` on ``device``."""
    dev = resolve_device(device)
    leaves = {k: (None if arrays.get(k) is None else _f32(arrays[k], dev))
              for k in SHARDED_LEAVES}
    return ShardedFittedKpca(spec=spec, n_support=int(n_support),
                             shard_sizes=tuple(int(n) for n in shard_sizes),
                             **leaves)


def setup_from_numpy(arrays: Mapping[str, np.ndarray],
                     include_self: bool = True,
                     device: DeviceLike = "cuda") -> DkpcaSetup:
    """JAX ``DkpcaSetup`` leaves -> the port's ``DkpcaSetup`` on ``device``
    (routing tables become int64 index tensors, the mask bool)."""
    dev = resolve_device(device)
    t = {k: _f32(arrays[k], dev) for k in ("x", "k", "lam", "vec", "kcross",
                                           "gamma")}
    for k in ("src", "rsl"):
        t[k] = torch.as_tensor(np.array(arrays[k], np.int64), device=dev)
    t["mask"] = torch.as_tensor(np.array(arrays["mask"], bool), device=dev)
    return DkpcaSetup(include_self=include_self, **t)


def state_from_numpy(arrays: Mapping[str, np.ndarray],
                     device: DeviceLike = "cuda") -> AdmmState:
    """JAX ``AdmmState`` leaves (``t`` as an int or 0-d array) -> the port's
    ``AdmmState`` on ``device``."""
    dev = resolve_device(device)
    t = {k: _f32(arrays[k], dev) for k in STATE_LEAVES}
    return AdmmState(t=int(np.asarray(arrays["t"])), **t)


__all__ = ["fitted_from_numpy", "setup_from_numpy", "sharded_from_numpy",
           "state_from_numpy"]
