"""Versioned model publishing: the trainer-to-server hand-off (port of
``repro.serve.publisher.ModelHandle``; the background publisher and the
streaming glue wait for a later slice).

``KpcaEngine`` reads THROUGH the handle: each drain snapshots (model,
version) once, so every slab of that drain scores against one consistent
model even if a publish lands mid-drain. Publishing is a reference swap
under a lock, never a copy, so it never blocks serving.
"""

from __future__ import annotations

import threading
from typing import Tuple

from ..core import oos


class ModelHandle:
    """Thread-safe versioned reference to a servable ``FittedKpca``."""

    def __init__(self, model, version: int = 0):
        self._lock = threading.Lock()
        # Serializes the read-rebuild-publish cycle of ``refresh``: two
        # concurrent refreshes must not both rebuild from the same base.
        self._refresh_lock = threading.Lock()
        self._model = model                 # guarded-by: _lock
        self._version = version             # guarded-by: _lock
        self._kind = type(model)

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def current(self):
        """The live model."""
        with self._lock:
            return self._model

    def get(self) -> Tuple[object, int]:
        """Consistent (model, version) snapshot — take it once per batch."""
        with self._lock:
            return self._model, self._version

    def publish(self, model) -> int:
        """Atomically swap in a new model; returns its version number."""
        if not isinstance(model, self._kind):
            raise TypeError(
                f"handle serves {self._kind.__name__}, got "
                f"{type(model).__name__}")
        with self._lock:
            self._model = model
            self._version += 1
            return self._version

    def refresh(self, alpha) -> int:
        """Publish the current model rebuilt around live dual coefficients
        (``oos.refresh_coefficients``); returns the new version."""
        with self._refresh_lock:
            model = oos.refresh_coefficients(self.current(), alpha)
            return self.publish(model)


__all__ = ["ModelHandle"]
