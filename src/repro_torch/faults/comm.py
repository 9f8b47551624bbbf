"""FaultyComm: transport-level fault injection for the ADMM solver (port of
the JAX package's ``faults.comm``).

Wraps a communicator (``repro_torch.core.solver.DenseComm``: ``local`` /
``exchange`` / ``all_sum`` / ``all_max``) and censors undelivered messages
by zeroing the received columns of masked slots: the received block is
``(J, S, N)`` and the mask ``(J, S)`` — receiver j, slot s.

Zeroing alone is only half the semantics: the solver must also drop the
censored slots from the consensus weights so ``rho_bar`` renormalizes over
the slots actually heard and the matching duals freeze (rho = 0 ⇒ the dual
update is a no-op). That half lives in ``admm_step(slot_mask=...)``; this
wrapper guarantees that whatever DID arrive on a dead link can never leak
into the update, even if a future refactor forgets a mask multiply.

The driver wraps each censored iteration's transport in one (a plain
object, no metric); fault *accounting* (``faults_injected_total`` etc.) is
host-side in the driver.
"""

from __future__ import annotations

from typing import Any, Callable


class FaultyComm:
    """A communicator that censors exchanged columns by a slot mask."""

    __slots__ = ("base", "mask")

    def __init__(self, base: Any, mask: Any):
        self.base = base
        self.mask = mask

    # -- communicator protocol ---------------------------------------------

    def local(self, fn: Callable) -> Any:
        return self.base.local(fn)

    def exchange(self, cols: Any) -> Any:
        return self.base.exchange(cols) * self.mask[..., None]

    def all_sum(self, x: Any) -> Any:
        return self.base.all_sum(x)

    def all_max(self, x: Any) -> Any:
        return self.base.all_max(x)

    @property
    def ledger(self):
        return getattr(self.base, "ledger", None)


__all__ = ["FaultyComm"]
