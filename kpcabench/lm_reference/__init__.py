"""Plain references of the LM families the benchmark trains, one file a
family (``<family>.py``, found by the ``family`` a configuration file
states), each in plain ``torch`` and float32, importing nothing of the
port. A family's module gives:

  * ``leaves(cfg)``: {leaf path: (shape, init, scale)} of the model, under
    the paths the port's parameter tree uses, so that one set of weights
    drawn by the benchmark is handed to both sides;
  * ``loss(params, tokens, labels, cfg, prec)``: the mean next-token
    cross-entropy of one micro-batch, differentiable, its products in
    ``prec`` (``FP32``, or ``FP8``: the control, fp8 training's products
    forward and backward).

The weights, the AdamW step and the precisions every family shares are
here."""

from __future__ import annotations

import dataclasses
import importlib
import math

import torch


def family(name: str):
    """The reference module of an LM family (``lm_reference/<name>.py``)."""
    return importlib.import_module(f"kpcabench.lm_reference.{name}")


def fan_in_scale(shape, stacked: bool) -> float:
    """1 / sqrt(fan-in), the fan-in the product of every dim but the last
    (and but the stack dim of a stacked leaf)."""
    dims = shape[1:] if stacked else shape
    return 1.0 / math.sqrt(max(math.prod(dims[:-1]) or dims[-1], 1))


def draw_params(table: dict, seed: int, device, dtype=torch.bfloat16
                ) -> dict:
    """The weights of ``table`` (``leaves(cfg)``) from ``seed`` on
    ``device`` in ``dtype``: one generator, one draw a leaf, in the
    table's order; ones and zeros where the table says so."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + 17) % (1 << 63))
    out = {}
    for path, (shape, init, scale) in table.items():
        if init == "ones":
            out[path] = torch.ones(shape, dtype=dtype, device=device)
        elif init == "zeros":
            out[path] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            v = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device)
            out[path] = v.mul_(scale).to(dtype)
    return out


@dataclasses.dataclass(frozen=True)
class Precision:
    """How the reference's products take their operands: as they are
    (fp32, TF32 off), or as fp8 training takes them, the control: each
    operand rounded to float8 e4m3 and the gradient arriving at the
    product's output to e5m2 (so the backward products take fp8 operands
    too), each with one scale a tensor that maps its largest magnitude to
    the format's largest."""

    fp8: bool = False

    def einsum(self, eq: str, *ops):
        if not self.fp8:
            return torch.einsum(eq, *ops)
        out = torch.einsum(eq, *[Fp8Round.apply(t) for t in ops])
        return Fp8GradRound.apply(out)


FP32 = Precision()
FP8 = Precision(fp8=True)
E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


def round_fp8(x, fmt):
    """x rounded (to nearest) to ``fmt`` at the scale that maps max |x|
    to the format's largest value."""
    amax = torch.clamp(torch.amax(torch.abs(x)), min=1e-30)
    scale = torch.finfo(fmt).max / amax
    return (x * scale).to(fmt).to(x.dtype) / scale


class Fp8Round(torch.autograd.Function):
    """An operand rounded to e4m3; identity in the backward pass."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x.detach(), E4M3)

    @staticmethod
    def backward(ctx, g):
        return g


class Fp8GradRound(torch.autograd.Function):
    """Identity; the gradient that arrives rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, E5M2)


def no_tf32():
    """float32 products in float32: TF32 off for matmul and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def adamw_step(params: dict, grads: dict, m: dict, v: dict, step: int,
               opt: dict) -> dict:
    """One AdamW step (Loshchilov and Hutter, arXiv:1711.05101) with
    global-norm clipping, in place: moments in float32, bias-corrected,
    eps outside the square root, decoupled decay on leaves of two or more
    dims, each parameter computed in float32 and stored back in its own
    dtype. ``step`` counts from 1. Returns {"grad_norm", "scale"}."""
    gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                          for g in grads.values()))
    scale = min(1.0, opt["clip_norm"] / max(gnorm, 1e-9)) \
        if opt["clip_norm"] else 1.0
    b1, b2 = opt["b1"], opt["b2"]
    c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k].float() * scale
            m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            v[k].mul_(b2).add_(g * g, alpha=1.0 - b2)
            upd = (m[k] / c1) / (torch.sqrt(v[k] / c2) + opt["eps"])
            pf = p.float()
            if opt["weight_decay"] and p.dim() >= 2:
                upd = upd + opt["weight_decay"] * pf
            p.copy_((pf - opt["lr"] * upd).to(p.dtype))
    return dict(grad_norm=gnorm, scale=scale)


__all__ = ["FP32", "FP8", "Fp8GradRound", "Fp8Round", "Precision",
           "adamw_step", "draw_params", "family", "fan_in_scale", "no_tf32",
           "round_fp8"]
