"""Batched kPCA projection-serving engine (port of
``repro.serve.kpca_engine``, synchronous drain over a plain ``FittedKpca``).

Variable-size requests are packed head-to-tail into fixed-width slabs padded
up to POWER-OF-TWO shape buckets. Each slab is copied host -> device, goes
through ``oos.projector`` of the drain's model version (the hand-written
projection kernel on the card, the plain version on the CPU; the per-model
operands are formed once per version) and is copied back; per-request results are
sliced off the slabs. The projection kernel's summation order depends on the
support set alone, so on the card a request's scores are bit-identical to
``oos.project`` on it alone, however it was batched (tests/test_torch_gpu.py);
on the CPU the plain version agrees to fp32 rounding.

``submit`` returns a future; ``flush`` is the synchronous drain and
``project_many`` the one-call convenience. The background flusher,
admission control, deadlines, retries, warmup, zero-copy staging and bf16
query slabs wait for a later slice.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, List, Sequence, Union

import numpy as np
import torch

from ..core import oos
from ..core.oos import FittedKpca
from ..device import DeviceLike, resolve_device
from .batching import (EngineStats, RequestQueue, RequestStats, SlotFuture,
                       pack_slabs, pow2_buckets)
from .publisher import ModelHandle


@dataclasses.dataclass
class KpcaServeConfig:
    max_batch: int = 128          # widest bucket = slab width
    min_bucket: int = 8           # narrowest bucket (absorbs tiny tails)

    def buckets(self) -> List[int]:
        """Power-of-two widths: min_bucket, 2*min_bucket, ..., max_batch."""
        return pow2_buckets(self.min_bucket, self.max_batch)


class KpcaEngine:
    """Micro-batching projection server over a fitted kPCA artifact.

    Reads its model THROUGH a versioned ``ModelHandle`` (a bare model is
    wrapped in a private one); each drain snapshots (model, version) once
    and serves every slab of the drain from it. The model is kept on the
    engine's device (the card unless ``device="cpu"``).
    """

    def __init__(self, model: Union[FittedKpca, ModelHandle],
                 cfg: KpcaServeConfig = None, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if isinstance(model, ModelHandle):
            self.handle = model
        else:
            self.handle = ModelHandle(model.to(self.device))
        if not isinstance(self.handle.current(), FittedKpca):
            raise TypeError("KpcaEngine serves a FittedKpca")
        self.cfg = cfg or KpcaServeConfig()
        self._buckets = self.cfg.buckets()
        self._stats_lock = threading.Lock()
        self.stats = EngineStats()            # guarded-by: _stats_lock
        self._queue = RequestQueue()
        # (version, scores function) of the last model served; only the
        # draining thread touches it (flush is synchronous)
        self._projector = (None, None)

    @property
    def model(self) -> FittedKpca:
        """The live model (read through the handle)."""
        return self.handle.current()

    # ---- request API -----------------------------------------------------

    def submit(self, x_query) -> SlotFuture:
        """Enqueue one (Q, M) request; returns a future resolving to its
        (Q, C) float32 scores at the next ``flush``."""
        x = np.asarray(x_query, np.float32)
        if x.ndim != 2 or x.shape[1] != self.model.n_features:
            raise ValueError(
                f"request must be (Q, {self.model.n_features}), "
                f"got {x.shape}")
        return self._queue.put(x, n=x.shape[0])

    def flush(self) -> dict:
        """Serve every queued request synchronously; resolves the futures
        and returns {request_id: (Q, C) scores}. On failure the drained
        requests go back to the front of the queue and the error raises."""
        entries = self._queue.drain()
        if not entries:
            return {}
        try:
            out = self._serve(entries)
        except BaseException:
            self._queue.restore(entries)
            raise
        SlotFuture.resolve([(e.future, out[e.rid]) for e in entries])
        return out

    def project_many(self, requests: Sequence[Any]) -> List[np.ndarray]:
        """Convenience: submit + flush a list of (Q_i, M) arrays; returns
        the per-request (Q_i, C) score arrays in submission order."""
        futs = [self.submit(x) for x in requests]
        self.flush()
        return [f.result() for f in futs]

    # ---- internals -------------------------------------------------------

    def _serve(self, entries) -> dict:
        # One consistent (model, version) snapshot for the whole drain.
        model, version = self.handle.get()
        if self._projector[0] != version:
            self._projector = (version,
                               oos.projector(model.to(self.device)))
        project = self._projector[1]
        slabs, plan = pack_slabs(entries, self.cfg.max_batch, self._buckets)
        host, dts = [], []
        for slab, _take in slabs:
            t0 = time.perf_counter()
            xq = torch.from_numpy(slab).to(self.device)      # host -> device
            scores = project(xq)
            host.append(scores.cpu().numpy())                # device -> host
            dts.append(time.perf_counter() - t0)
        out = {}
        for e, segs in zip(entries, plan):
            buf = np.empty((e.n, model.n_components), np.float32)
            for si, row, off, m in segs:
                buf[off:off + m] = host[si][row:row + m]
            out[e.rid] = buf
        padded = sum(slab.shape[0] - take for slab, take in slabs)
        touched = [sum(dts[si] for si in {s[0] for s in segs})
                   for segs in plan]
        with self._stats_lock:
            self.stats.n_requests += len(entries)
            self.stats.n_queries += sum(e.n for e in entries)
            self.stats.n_padded += padded
            self.stats.n_flushes += 1
            self.stats.total_time_s += sum(dts)
            for e, dt in zip(entries, touched):
                self.stats.per_request.append(
                    RequestStats(e.rid, e.n, dt, version))
        return out


__all__ = ["EngineStats", "KpcaEngine", "KpcaServeConfig", "RequestStats"]
