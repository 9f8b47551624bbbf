"""Process environment for the port's launchers (counterpart of
``repro.launch.env``). Stdlib only: importing it initializes nothing.

Environment variables understood here:

  * ``REPRO_PLATFORM`` -> the launchers' device: ``cuda`` (the default),
    ``gpu`` (which means ``cuda``) or ``cpu``; ``tpu`` and anything else
    are refused.
  * ``REPRO_TILE_TABLE`` -> a tile table file for the kernels' launch
    choices, read once by ``repro_torch.kernels.autotune.default_table``
    before the first kernel dispatch; listed here because this layer is
    where deployments set it.

The JAX package's other fields (``enable_x64``, ``host_devices``,
``gpu_flags``, ``preallocate_gpu``, ``extra_xla_flags``) configure XLA
before its backend starts. PyTorch has no such backend to pin: float64 is
asked for per tensor, a CPU run needs no fake devices (the ring fit spawns
processes over gloo), and the card's allocator grows on demand. So they
are dropped, not ported.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

PLATFORMS = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


def platform_device(platform: Optional[str]) -> str:
    """The device string for a ``REPRO_PLATFORM`` value (None or empty:
    the card)."""
    if not platform:
        return "cuda"
    key = platform.strip().lower()
    if key not in PLATFORMS:
        raise ValueError(f"REPRO_PLATFORM={platform!r}: the port runs on "
                         f"{sorted(PLATFORMS)}, not {key!r}")
    return PLATFORMS[key]


def device_from_environ(environ: Optional[Mapping[str, str]] = None) -> str:
    """The launchers' device as ``REPRO_PLATFORM`` asks for it."""
    env = os.environ if environ is None else environ
    return platform_device(env.get("REPRO_PLATFORM"))


__all__ = ["PLATFORMS", "device_from_environ", "platform_device"]
