"""PyTorch/CUDA port of the decentralized kernel PCA system.

Laid out like the JAX package ``repro`` (``core/``, ``kernels/``,
``serve/``, ``checkpoint/``, ``data/``) so each module's counterpart is easy
to find; it imports neither JAX nor ``repro``.

Conventions:
  * Entry points (``build_setup``, ``central_kpca``, ``fit_central``,
    ``from_dual``/``from_decentralized``, ``KpcaEngine``) run on the card
    (``device="cuda"``) unless the caller asks for ``device="cpu"``; with no
    CUDA device they raise instead of silently running on the CPU
    (``repro_torch.device.resolve_device``).
  * The tensor's device picks the path: a CUDA tensor goes through the
    hand-written Hopper kernels (``repro_torch.kernels``), a CPU tensor
    through their plain PyTorch versions. There is no fallback between them.
  * fp32 means IEEE fp32: TF32 is switched off below for matmuls and cuDNN,
    and the hand-written kernels accumulate in fp32 on the CUDA cores.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
