"""Model substrate (counterpart of ``repro.models.common``): parameter
collection with logical axes, norms, initializers, dtype policy.

Parameters live in FLAT dicts keyed by '/'-separated paths, the JAX
package's own paths; a parallel dict maps each path to its tuple of logical
axis names. Stacked layer parameters carry a leading "layers" axis. The
draws come from an explicit ``torch.Generator`` (on the device the
parameters are made on) with the JAX package's fan-in rule; they are not
``jax.random``'s numbers. A collector with no generator makes tensors on
the ``meta`` device: shapes and dtypes, no memory (``abstract_params``).

Every product of token rows with weights goes through ``tok_einsum``: the
rows are cut into blocks of ``TOKEN_BLOCK`` (the last one padded with
zeros) and each block is one product of the same shape. cuBLAS picks its
kernel, and with it the order of each output's sum, by the row count, so
without the blocks a token's bf16 outputs depend on how many tokens share
the call: llama3.2-3b's decode logits then drift from a prefill of the same
tokens by 0.145 through 28 layers, 6.5x the 2e-2 gate, and with the blocks
they are the same bits (measured on an NVIDIA H100 80GB HBM3 at a
700.00 W power limit). A request's outputs also stop depending on what it
is batched with.

Over a device mesh (``repro_torch.distributed.Mesh``) each process holds
its shard of every parameter (``distributed.sharding.spec_for``) and runs
its rows of the batch (``local_batch``); the model functions take the
layout as ``shards`` (``distributed.Shards``) and issue the collectives
(FSDP gathers, Megatron "f" and "g") themselves. Without a mesh they run
as on one card. ``ScanBlock.run`` is a loop over the stacked layer slices, with the JAX
package's rematerialization policies under autograd (``remat``: "full"
recomputes each layer in the backward pass, "dots" keeps the outputs of
the token-by-weight products and recomputes the rest); ``unroll`` is
accepted and ignored.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import DeviceLike, resolve_device
from ..distributed.collectives import batch_axes_of

# (path, full tensor, logical axes) -> the tensor the collector keeps
Place = Callable[[str, torch.Tensor, Tuple[Optional[str], ...]],
                 torch.Tensor]

Params = Dict[str, torch.Tensor]
Axes = Dict[str, Tuple[Optional[str], ...]]


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def model_device(device: DeviceLike) -> torch.device:
    """``meta`` as it is (shapes only), else the entry-point rule: the card
    unless the caller asks for the CPU, and a raise without a card."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


class ParamCollector:
    """Creates parameters, records logical axes, draws from the generator
    (None: the meta device). ``place``, where given, gets each drawn
    tensor whole with its path and axes and returns what the collector
    keeps (a mesh rank's shard: the whole tensor is freed leaf by leaf)."""

    def __init__(self, generator: Optional[torch.Generator],
                 dtype: torch.dtype = torch.bfloat16,
                 place: Optional[Place] = None):
        self.generator = generator
        self.device = torch.device("meta") if generator is None \
            else generator.device
        self.dtype = dtype
        self.place = place
        self.params: Params = {}
        self.axes: Axes = {}

    def child_place(self, prefix: str) -> Optional[Place]:
        """``place`` for a sub-collector whose paths go under ``prefix/``."""
        if self.place is None:
            return None
        return lambda path, v, axes: self.place(f"{prefix}/{path}", v, axes)

    def _next(self) -> Optional[torch.Generator]:
        """The generator a sub-collector draws from (the JAX package splits
        its key here; one generator is shared instead)."""
        return self.generator

    def param(self, path: str, shape: Tuple[int, ...],
              axes: Tuple[Optional[str], ...], init: str = "normal",
              scale: Optional[float] = None, dtype=None) -> torch.Tensor:
        if len(shape) != len(axes):
            raise ValueError(f"{path}: shape {shape} vs axes {axes}")
        if path in self.params:
            raise ValueError(f"duplicate param {path}")
        dt = dtype or self.dtype
        shape = tuple(int(d) for d in shape)
        if init not in ("zeros", "ones", "normal"):
            raise ValueError(init)
        if self.device.type == "meta":
            v = torch.empty(shape, dtype=dt, device="meta")
        elif init == "zeros":
            v = torch.zeros(shape, dtype=dt, device=self.device)
        elif init == "ones":
            v = torch.ones(shape, dtype=dt, device=self.device)
        else:
            if scale is None:
                # conservative fan-in: product of all-but-last non-stack dims
                dims = shape[1:] if (axes and axes[0] in ("layers", "stack")) \
                    else shape
                fan_in = max(int(math.prod(dims[:-1])) or dims[-1], 1)
                scale = 1.0 / math.sqrt(fan_in)
            v = torch.randn(shape, generator=self.generator,
                            dtype=torch.float32, device=self.device)
            v = v.mul_(scale).to(dt)
        if self.place is not None and self.device.type != "meta":
            v = self.place(path, v, tuple(axes))
        self.params[path] = v
        self.axes[path] = tuple(axes)
        return v


class StackedCollector:
    """Proxy collector that prepends a 'layers' stack dim to every param —
    the stacked layers, drawn per layer through the stack dim."""

    def __init__(self, parent: ParamCollector, n: int, prefix: str):
        self._p = parent
        self._n = n
        self._prefix = prefix
        self.dtype = parent.dtype

    def _next(self):
        return self._p._next()

    def param(self, path, shape, axes, init="normal", scale=None, dtype=None):
        return self._p.param(f"{self._prefix}/{path}", (self._n,) + tuple(shape),
                             ("layers",) + tuple(axes), init=init,
                             scale=scale, dtype=dtype)


def abstract_params(init_fn) -> Tuple[Params, Axes]:
    """``init_fn(None)`` on the meta device -> (parameters as meta tensors,
    logical axes), allocating nothing."""
    return init_fn(None)


TOKEN_BLOCK = 64


def block_of(block: int, total: int, device) -> int:
    """The block a loop over ``total`` items takes: ``block``, or on the
    meta device (the dry-run's shapes-only step) all of them in one, whose
    products count the blocks' operations alike."""
    return total if torch.device(device).type == "meta" else block


def tok_einsum(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` for x (B, S, ...) token rows and a weight
    w with no token dims, computed in blocks of TOKEN_BLOCK tokens (the
    last one padded), so each token's result does not depend on B x S."""
    b, s = x.shape[:2]
    rows = x.reshape(b * s, *x.shape[2:])
    m = rows.shape[0]
    pad = (-m) % TOKEN_BLOCK
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, *rows.shape[1:]))])
    outs = [torch.einsum(eq, blk[None], w)[0] for blk in rows.split(
        block_of(TOKEN_BLOCK, rows.shape[0], rows.device))]
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out[:m].reshape(b, s, *out.shape[1:])


# ----------------------------------------------------------------------
# normalization / activations
# ----------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(dt)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")       # jax.nn.gelu's default


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def local_batch(batch: Dict[str, torch.Tensor], mesh):
    """(this rank's rows of ``batch``, shared): each entry split along its
    leading (batch) dim over the mesh's batch axes. When the batch does not
    divide by their size every rank runs the whole batch and ``shared`` is
    True (the JAX package's ``constrain_act`` and ``moe_forward`` leave
    such a batch replicated; it never raises). Without a mesh, or with one
    rank on the batch axes, the batch as it is."""
    if mesh is None:
        return batch, False
    axes = batch_axes_of(mesh)
    dp = mesh.size(axes)
    b = batch["tokens"].shape[0]
    if dp == 1 or b % dp:
        return batch, dp > 1
    n, i = b // dp, mesh.index(axes)
    return {k: v[i * n:(i + 1) * n] for k, v in batch.items()}, False


def positions_of(b: int, s: int, start: int, device) -> torch.Tensor:
    """(b, s) absolute positions start .. start + s - 1 of every row."""
    return (start + torch.arange(s, device=device))[None].expand(b, s)


def constrain_act(x: torch.Tensor, mesh) -> torch.Tensor:
    """The JAX package pins activations to (batch over the data axes,
    replicated) unless the batch does not divide; here each rank's
    activations are already its own rows (``local_batch`` made that
    choice), so there is nothing to pin."""
    return x


# ----------------------------------------------------------------------
# stacked-layer utilities
# ----------------------------------------------------------------------

def slice_layer(params: Params, prefix: str) -> Params:
    """Sub-dict of params under `prefix/` with the prefix stripped."""
    plen = len(prefix) + 1
    return {k[plen:]: v for k, v in params.items() if k.startswith(prefix + "/")}


def merge(prefix: str, sub: Params) -> Params:
    return {f"{prefix}/{k}": v for k, v in sub.items()}


def layer_slices(stacked: Params) -> List[Params]:
    """Every layer's parameters, each stacked tensor unbound once along its
    leading 'layers' dim (views, no copy). Under autograd one
    ``UnbindBackward`` per stack stacks the layers' grads once; ``v[i]``
    per layer would give each layer a ``SelectBackward`` that builds a
    zero tensor of the whole stack."""
    parts = {k: torch.unbind(v, 0) for k, v in stacked.items()}
    return [{k: parts[k][i] for k in parts}
            for i in range(n_stacked(stacked))]


def n_stacked(stacked: Params) -> int:
    return next(iter(stacked.values())).shape[0] if stacked else 0


def _save_weight_products(ctx, op, *args, **kwargs):
    """The "dots" policy (``jax.checkpoint_policies.
    checkpoint_dots_with_no_batch_dims``): keep the outputs of products
    with no batch dim, which here are the token-by-weight products
    (``tok_einsum``'s blocks reach ``bmm`` with a batch of 1), and
    recompute the rest, attention's batched products included."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_block(block_fn, remat: str):
    """``block_fn`` under the remat policy, where autograd records: "full"
    saves nothing inside the block (``jax.checkpoint`` with
    ``nothing_saveable``), "dots" saves the weight products; anything else,
    or no autograd, calls it as it is. The blocks draw no random numbers,
    so no RNG state is kept for the recomputation."""
    if not torch.is_grad_enabled() or remat not in ("full", "dots"):
        return block_fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_weight_products)
    return lambda p, carry: checkpoint(block_fn, p, carry, **kw)


@dataclasses.dataclass
class ScanBlock:
    """Apply a block function over stacked layer params, layer by layer."""

    @staticmethod
    def run(block_fn, stacked: Params, carry, remat: str = "full",
            unroll=1):
        """carry -> loop over the leading 'layers' dim of every stacked
        param, each layer under ``remat`` (see ``remat_block``); returns
        (carry, the per-layer outputs stacked, or None)."""
        return ScanBlock.run_layers(block_fn, layer_slices(stacked), carry,
                                    remat)

    @staticmethod
    def run_layers(block_fn, layers: List[Params], carry,
                   remat: str = "full"):
        """``run`` over a list of layer dicts (``layer_slices``' or a run
        of them): the JAX package's scan over a slice of the stack."""
        fn = remat_block(block_fn, remat)
        outs = []
        for layer in layers:
            carry, out = fn(layer, carry)
            outs.append(out)
        if not outs or outs[0] is None:
            return carry, None
        if isinstance(outs[0], tuple):
            return carry, tuple(torch.stack(parts) for parts in zip(*outs))
        return carry, torch.stack(outs)
