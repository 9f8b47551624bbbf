"""Weights from the JAX package into the port's parameter dict.

``params_from_jax`` takes the JAX package's flat parameter dict as numpy
arrays (``{k: np.asarray(v) for k, v in params.items()}``; bf16 arrives as
``ml_dtypes`` bfloat16) and returns torch tensors under the same keys. The
keys and shapes are checked against the port's own parameters for ``cfg``
(built on the meta device): a missing or extra key, or a shape that
differs, raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import DeviceLike, resolve_device
from .common import abstract_params
from .model import build_model


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor of ``a``'s values; bf16 (``ml_dtypes``) bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def params_from_jax(np_params: Dict[str, np.ndarray], device: DeviceLike,
                    dtype: Optional[torch.dtype] = None, *,
                    cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """The port's params of ``cfg`` from the JAX package's, on ``device``,
    each in its own dtype (or ``dtype``)."""
    dev = resolve_device(device)
    model = build_model(cfg, device="meta")
    want, _ = abstract_params(model.init)
    missing = sorted(set(want) - set(np_params))
    extra = sorted(set(np_params) - set(want))
    if missing or extra:
        raise KeyError(f"{cfg.name}: parameter keys differ from the port's: "
                       f"missing {missing}, extra {extra}")
    out = {}
    for key, arr in np_params.items():
        t = tensor_from_numpy(arr)
        if tuple(t.shape) != tuple(want[key].shape):
            raise ValueError(f"{cfg.name}: {key} has shape "
                             f"{tuple(t.shape)}, the port's "
                             f"{tuple(want[key].shape)}")
        out[key] = t.to(device=dev, dtype=dtype or t.dtype)
    return out
