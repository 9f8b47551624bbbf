"""Operation and byte counts of the math each op needs, from shapes
alone: one file an op. Operations count a multiply-add as two; bytes count
each fp32 input read once and each output written once."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parents[1]
                    / "peaks.json").read_text())


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the TF32 peak or
    bytes at the HBM peak, whichever is longer."""
    return max(ops / PEAKS["tf32_flops_per_s"],
               nbytes / PEAKS["hbm_bytes_per_s"])


def share_pct(ops: float, nbytes: float, seconds: float):
    """100 x bound_s / seconds; None where no time was measured."""
    if not seconds or seconds <= 0.0:
        return None
    return 100.0 * bound_s(ops, nbytes) / seconds
