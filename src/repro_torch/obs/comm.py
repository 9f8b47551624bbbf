"""Per-iteration communication accounting for the ADMM transport (a copy
of the JAX package's ``obs.comm``, stdlib only, so the port imports nothing
of ``repro``).

The paper's headline iteration cost is O(|Omega_j| N) numbers moved per
node per iteration (§4.2). ``CommLedger`` measures it from the transport
itself instead of re-deriving it on paper:

  * ``repro_torch.core.solver.DenseComm`` accepts a ledger and reports
    every ``exchange`` (bytes + message count) into it;
  * ``repro_torch.core.solver.admm_step`` brackets its body with
    ``begin_iteration``/``end_iteration``, so everything recorded in
    between is exactly ONE iteration's traffic.

The JAX package counts at trace time, once per iteration shape; the port
runs eagerly, so the hooks fire on every executed iteration and
``per_iter`` holds the last one's profile. Both give the same ``per_iter``
(fixed shapes, fixed topology within a run) and, with the driver's
``add_iterations``, the same ``totals()``: after a re-knit, both scale the
last ``per_iter`` by every executed iteration. Traffic recorded outside an
iteration bracket accumulates into the one-off ``setup`` profile.

``DenseComm`` simulates the whole network on one device, so its profile
counts **network-wide** bytes (every directed edge), payload only (no
framing or protocol overhead).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class CommProfile:
    """Accumulated traffic for one accounting window (an iteration, or
    the setup phase)."""

    bytes: int = 0             # point-to-point payload bytes
    messages: int = 0          # point-to-point sends (ppermute / edge)
    collectives: int = 0       # psum/pmax/pmean invocations
    collective_bytes: int = 0  # their payload bytes

    def add_exchange(self, nbytes: int, n_messages: int = 1) -> None:
        self.bytes += int(nbytes)
        self.messages += int(n_messages)

    def add_collective(self, nbytes: int) -> None:
        self.collectives += 1
        self.collective_bytes += int(nbytes)

    def scaled(self, n: int) -> "CommProfile":
        return CommProfile(self.bytes * n, self.messages * n,
                           self.collectives * n, self.collective_bytes * n)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class CommLedger:
    """Communication recorder shared by one solver run.

    Attach via ``repro_torch.core.solver.run_chunked(ledger=...)``; read
    ``per_iter`` / ``setup`` / ``totals()`` after. Not thread-safe: the
    driver loop runs on one thread (the same contract as the driver
    itself, ``run_chunked`` docstring).
    """

    def __init__(self):
        self.per_iter = CommProfile()   # last iteration's profile
        self.setup = CommProfile()      # one-off (outside any iteration)
        self.iterations = 0             # iterations actually executed
        self._active: Optional[CommProfile] = None

    # -- hooks called by the transport ---------------------------------------

    def begin_iteration(self) -> None:
        self._active = CommProfile()

    def end_iteration(self) -> None:
        if self._active is not None:
            self.per_iter = self._active
            self._active = None

    def record_exchange(self, nbytes: int, n_messages: int = 1) -> None:
        tgt = self._active if self._active is not None else self.setup
        tgt.add_exchange(nbytes, n_messages)

    def record_collective(self, nbytes: int) -> None:
        tgt = self._active if self._active is not None else self.setup
        tgt.add_collective(nbytes)

    # -- host-side bookkeeping ----------------------------------------------

    def add_iterations(self, n: int) -> None:
        self.iterations += int(n)

    def totals(self) -> CommProfile:
        """Cumulative traffic: setup + per-iteration profile times the
        executed iteration count (the per-iteration profile is constant
        across iterations — fixed shapes, fixed topology)."""
        it = self.per_iter.scaled(self.iterations)
        return CommProfile(
            self.setup.bytes + it.bytes,
            self.setup.messages + it.messages,
            self.setup.collectives + it.collectives,
            self.setup.collective_bytes + it.collective_bytes)

    def snapshot(self) -> dict:
        return {"per_iter": self.per_iter.as_dict(),
                "setup": self.setup.as_dict(),
                "iterations": self.iterations,
                "totals": self.totals().as_dict()}


__all__ = ["CommLedger", "CommProfile"]
