"""ADMM penalty-parameter policies (port of ``repro.core.rho``).

Assumption 2 of the paper gives a closed-form lower bound on rho that
guarantees monotone decrease of the augmented Lagrangian (Theorem 2):

    rho >= ( sqrt(lam1^4 + 8 |Omega_j| lam1 * sum_n lam_n^3) + lam1^2 )
           / ( |Omega_j| * lam1 )

per node j, where lam_n are the eigenvalues of K_j. We take the max over
nodes. The paper's experiments instead use a hand-tuned warm-up schedule
(rho(1)=100 fixed; rho(2): 10 -> 50 -> 100); both are provided.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def assumption2_rho(eigvals: torch.Tensor,
                    degree: torch.Tensor) -> torch.Tensor:
    """Per-node Theorem-2 rho bound.

    eigvals: (..., N) eigenvalues of (centered) K_j, any order.
    degree:  (...,) |Omega_j|.
    """
    lam = torch.as_tensor(eigvals)
    lam1 = torch.max(lam, dim=-1).values
    s3 = torch.sum(torch.clamp(lam, min=0.0) ** 3, dim=-1)
    d = torch.as_tensor(degree, dtype=lam.dtype, device=lam.device)
    return (torch.sqrt(lam1 ** 4 + 8.0 * d * lam1 * s3) + lam1 ** 2) \
        / (d * lam1)


@dataclasses.dataclass(frozen=True)
class RhoSchedule:
    """Paper §6.1 warm-up: start small, increase to rho_final at given steps.

    values[i] applies from iteration boundaries[i] onward;
    boundaries[0] must be 0.
    """

    boundaries: tuple = (0, 10, 20)
    values: tuple = (10.0, 50.0, 100.0)

    def __post_init__(self):
        if len(self.boundaries) != len(self.values) or self.boundaries[0] != 0:
            raise ValueError(f"bad RhoSchedule {self.boundaries} / "
                             f"{self.values}")

    def at(self, t: int) -> float:
        """rho at iteration ``t`` (fp32-rounded, as the JAX schedule)."""
        idx = sum(int(t) >= b for b in self.boundaries) - 1
        return float(np.float32(self.values[idx]))

    @staticmethod
    def constant(rho: float) -> "RhoSchedule":
        return RhoSchedule(boundaries=(0,), values=(float(rho),))


def auto_rho(eigvals_per_node, degrees, safety: float = 1.05) -> float:
    """Global constant rho satisfying Assumption 2 on every node."""
    lam = torch.as_tensor(eigvals_per_node, dtype=torch.float32)
    deg = torch.as_tensor(degrees, dtype=torch.float32, device=lam.device)
    return float(torch.max(assumption2_rho(lam, deg)) * safety)


__all__ = ["RhoSchedule", "assumption2_rho", "auto_rho"]
