"""Shared helpers for the kernel wrappers.

The JAX package picks Pallas interpret mode with a backend probe; here the
tensor decides: a CUDA tensor launches the hand-written kernel, a CPU tensor
takes the plain PyTorch version, anything else raises (``on_card``).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

SMS = 132   # streaming multiprocessors of the H100 the grids are sized for


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on a CUDA device, False when every tensor is
    on the CPU; a mix or another device type raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"operands must all be on one CUDA device or all on "
                     f"the CPU, got {sorted(kinds)}")


def check_kernel_operand(name: str, t: torch.Tensor, ndim: int,
                         device: torch.device) -> None:
    """What every hand-written kernel takes: fp32, contiguous, on the card."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (or NULL for None) as a ctypes argument."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_of(device: torch.device) -> int:
    """PyTorch's current stream on ``device``: its raw handle, read without
    building a Stream object."""
    return torch._C._cuda_getCurrentRawStream(_index(device))


def launch_guard(device: torch.device):
    """A launch goes to the current device: the device's context where it
    is another, else nothing to enter."""
    if _index(device) == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None \
        else device.index


def check_launch(name: str, rc: int) -> None:
    """Raise when the C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def cdiv(v: int, m: int) -> int:
    """Tiles of size ``m`` covering ``v`` (the kernels mask the ragged last
    tile themselves, so no operand is ever padded)."""
    return (v + m - 1) // m


__all__ = ["SMS", "cdiv", "check_kernel_operand", "check_launch",
           "launch_guard", "on_card", "ptr", "stream_of"]
