"""The numbers that decide ``correct``: the program's outputs against the
plain reference (``reference.EXACT``), each a relative error over the
magnitude its rounding scales with. The same functions judge the control
(``reference.TF32`` put in the program's place)."""

from __future__ import annotations

import torch

from . import reference


def fit_numbers(alpha, row_mean_coef, bias, ref: reference.Fit) -> dict:
    """One fit's numbers: ``alpha``, max |alpha - alpha_ref| over max
    |alpha_ref| (the ADMM iterate after the iterations, every node);
    ``centring``, the packaged model's centring terms, the larger of
    |c - c_ref| / sum |a_ref| (c = -sum a) and |b - b_ref| over the size of
    b's terms."""
    dt = torch.float64
    a = alpha.to(ref.alpha.device, dt)
    alpha_err = float(torch.max(torch.abs(a - ref.alpha))
                      / ref.scale["alpha"])
    c_err = abs(float(row_mean_coef) - float(ref.row_mean_coef)) \
        / float(torch.sum(torch.abs(ref.coefs)))
    b_err = abs(float(bias) - float(ref.bias)) / float(ref.scale["bias"])
    return dict(alpha=alpha_err, centring=max(c_err, b_err))


def score_numbers(got, ref_scores, ref_size) -> dict:
    """A request's number: ``scores``, max over its rows of |s - s_ref|
    over the size of the row's terms."""
    g = torch.as_tensor(got).reshape(-1).to(ref_scores.device,
                                            torch.float64)
    return dict(scores=float(torch.max(torch.abs(g - ref_scores)
                                       / ref_size)))


def worst(readings: list) -> dict:
    """The largest of each number over a list of readings."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


__all__ = ["fit_numbers", "score_numbers", "worst"]
