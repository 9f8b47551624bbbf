"""Sharded kPCA projection serving with adaptive routing (port of
``repro.serve.sharded``).

The out-of-sample score is a sum over support points, so it shards along
either operand of the kernel matrix:

  * **model-parallel** (``"mp"``): each device holds some shards of a
    ``ShardedFittedKpca`` and computes their raw partials
    ``P_j = K(X_query, X_j) @ coefs_ext_j`` (B, C+1) through the projection
    kernel's partial projector (``kernels.project.partial_projector``); the
    devices' partials are summed on the first device and the GLOBAL
    centering applied once (``core.oos.finalize_partial_scores``). The JAX
    package's ``shard_map`` + ``psum`` becomes per-device partials plus a
    sum.
  * **data-parallel** (``"dp"``): every device holds every shard and the
    QUERY rows are split over the devices; each finishes its own rows,
    centering included. No reduction.
  * **single-device** (``"single"``): the same-math loop over shards on the
    engine's device; the only choice when the host has fewer devices than
    shards (``launch.mesh.make_serving_mesh`` returns None).

A mesh is a list of ``torch.device``; device i holds shards i, i + D, ...
for mp (D devices, any D <= S). On the card every device of the list must
be a CUDA device, else the router raises; work on a device other than the
first runs on that device's own stream, bridged to the caller's current
stream both ways. ``CrossoverTable`` picks the policy per slab;
``ShardedRouter`` owns the engine's sharded hot path: the policy decision
and a placement cache keyed on the model VERSION that holds one prepared
support per shard and device (``partial_projector``), so steady-state
drains never re-split a support set or re-copy the model.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ..core.oos import ShardedFittedKpca, finalize_partial_scores
from ..kernels.project.ops import partial_projector
from ..launch.mesh import make_serving_mesh
from ..obs import metrics, trace

POLICIES = ("mp", "dp", "single")

# One dispatch's device result plus the routing decision that produced it.
ShardedScores = collections.namedtuple("ShardedScores", "scores policy")


def _pow2(n: int, floor: int = 8) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class CrossoverTable:
    """Routing decision table: (slab rows, support rows) -> policy.

    ``table`` holds measured winners keyed by pow2-bucketed (rows, support)
    pairs (``measure_crossover`` fills it for a concrete model, mesh and
    host). Unmeasured keys fall back to two thresholds whose defaults are
    the JAX package's, kept for parity: they were measured on a 1-core CPU
    container, not on a card, so a card deployment should measure its own
    (``measure_crossover``):

      * support <= ``single_max_support``: the single-device reduction;
      * above that, slabs with >= ``dp_min_rows`` rows go data-parallel,
        smaller slabs model-parallel.

    Data-parallel also needs the rows to divide evenly over the shards;
    otherwise ``choose`` degrades to "mp" or "single".
    """

    single_max_support: int = 2048
    dp_min_rows: int = 2048
    table: Mapping[Tuple[int, int], str] = \
        dataclasses.field(default_factory=dict)

    def choose(self, n_rows: int, n_support: int, n_shards: int, *,
               has_mesh: bool) -> str:
        if not has_mesh or n_shards <= 1:
            return "single"
        policy = self.table.get((_pow2(n_rows), _pow2(n_support)))
        if policy is None:
            if n_support <= self.single_max_support:
                policy = "single"
            elif n_rows >= self.dp_min_rows:
                policy = "dp"
            else:
                policy = "mp"
        if policy == "dp" and n_rows % n_shards:
            policy = "mp" if n_support > self.single_max_support \
                else "single"
        return policy


@dataclasses.dataclass(frozen=True)
class _Placed:
    """One device's share of a placed model: its shards' partial
    projectors (shard order) and the centering terms it finishes with."""

    device: torch.device
    shards: Tuple
    row_mean_coef: torch.Tensor
    bias: torch.Tensor


def _indexed(device) -> torch.device:
    """A CUDA device with its index (``cuda`` is the current device), so
    that the same card compares equal however it was named."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_devices(devices: Sequence[torch.device],
                   home: torch.device) -> None:
    """One device type for the whole mesh and the engine's device: on the
    card a shard placed anywhere but a CUDA device raises."""
    kinds = {d.type for d in devices} | {home.type}
    if kinds not in ({"cuda"}, {"cpu"}):
        raise ValueError(f"the serving mesh and the engine's device must "
                         f"all be CUDA devices or all the CPU, got "
                         f"{[str(d) for d in devices]} for {home}")


class ShardedRouter:
    """Policy-routed, placement-cached dispatch for sharded serving.

    ``devices`` is the mesh (None: routing is "single" on ``home``);
    ``home`` is where slabs arrive and results leave (the engine's
    device, the mesh's first device by default). The placement cache is
    keyed on the model version per policy group — "mp" wants each device's
    shards on it, "dp" every shard on every device, "single" every shard
    on ``home`` — and is paid once per publish: ``n_placements`` counts
    fills, ``n_placement_hits`` dispatches served from it.

    Thread-safety: ``dispatch`` runs on one thread at a time (the engine's
    device-runner, or under its dispatch lock); the lock only guards the
    placement dict against a concurrent ``measure_crossover`` or warmup.
    """

    _GROUPS = {"mp": "sliced", "dp": "replicated", "single": "home"}

    def __init__(self, devices: Optional[Sequence[torch.device]], *,
                 home: Optional[torch.device] = None, policy: str = "auto",
                 crossover: Optional[CrossoverTable] = None):
        if policy != "auto" and policy not in POLICIES:
            raise ValueError(f"policy must be 'auto' or one of {POLICIES}, "
                             f"got {policy!r}")
        self.devices = None if devices is None \
            else [_indexed(d) for d in devices]
        if home is None:
            if not self.devices:
                raise ValueError("a router with no mesh needs its home "
                                 "device")
            home = self.devices[0]
        self.home = _indexed(home)
        if self.devices:
            _check_devices(self.devices, self.home)
        self.policy = policy
        self.crossover = crossover if crossover is not None \
            else CrossoverTable()
        self._lock = threading.Lock()
        self._placed: Dict[str, Tuple[int, List[_Placed]]] = {}
        self.n_placements = 0              # guarded-by: _lock
        self.n_placement_hits = 0          # guarded-by: _lock
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._m_routed = {p: metrics.counter(
            "serve_routing_total",
            "Sharded slabs dispatched, by routing policy", policy=p)
            for p in POLICIES}

    # -- routing ------------------------------------------------------------

    def choose(self, n_rows: int, model: ShardedFittedKpca) -> str:
        """The policy this slab will dispatch under (deterministic in
        (rows, model), which warmup relies on). Data-parallel splits the
        rows over the mesh's devices, so it needs them to divide evenly."""
        has_mesh = bool(self.devices)
        if self.policy == "auto":
            policy = self.crossover.choose(n_rows, int(model.n_support),
                                           model.n_shards, has_mesh=has_mesh)
            if policy == "dp" and n_rows % len(self.devices):
                policy = "mp"
            return policy
        if not has_mesh or model.n_shards <= 1:
            return "single"
        if self.policy == "dp" and n_rows % len(self.devices):
            return "mp"
        return self.policy

    # -- placement cache ----------------------------------------------------

    def _place(self, model: ShardedFittedKpca, version: int,
               policy: str) -> List[_Placed]:
        group = self._GROUPS[policy]
        with self._lock:
            hit = self._placed.get(group)
            if hit is not None and hit[0] == version:
                self.n_placement_hits += 1
                return hit[1]
        # Build OUTSIDE the lock: each shard's support is split on its
        # device (one launch per shard on the card); a racy duplicate is
        # the same values.
        if group == "home":
            placed = place_sharded_model(model, [self.home], replicate=True)
        else:
            placed = place_sharded_model(model, self.devices,
                                         replicate=group == "replicated",
                                         stream_for=self._on)
        with self._lock:
            self._placed[group] = (version, placed)
            self.n_placements += 1
        return placed

    # -- streams ------------------------------------------------------------

    def _on(self, dev: torch.device):
        """Run work for ``dev``: the caller's current stream for the home
        device; another CUDA device's own stream, after it has waited for
        the home stream's work so far."""
        if dev.type != "cuda" or dev == self.home:
            return contextlib.nullcontext()
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams.setdefault(dev, torch.cuda.Stream(dev))
        stream.wait_stream(torch.cuda.current_stream(self.home))
        return torch.cuda.stream(stream)

    def _back_home(self, dev: torch.device) -> None:
        """The home stream waits for the work just issued on ``dev``."""
        if dev.type == "cuda" and dev != self.home:
            torch.cuda.current_stream(self.home).wait_stream(
                self._streams[dev])

    # -- dispatch -----------------------------------------------------------

    def dispatch(self, model: ShardedFittedKpca, version: int,
                 xq: torch.Tensor, policy: Optional[str] = None
                 ) -> ShardedScores:
        """Route one (B, M) slab on the home device: pick or honour the
        policy, fetch this version's placement, run it. Returns the (B, C)
        scores on the home device (not yet copied to the host) and the
        policy."""
        if policy is None:
            policy = self.choose(int(xq.shape[0]), model)
        placed = self._place(model, version, policy)
        with trace.span("serve.shard_dispatch", policy=policy,
                        rows=int(xq.shape[0])):
            if policy == "dp":
                out = self._data_parallel(placed, xq, model.n_support)
            else:
                total = None
                for part in placed:
                    with self._on(part.device):
                        p = _partials(part, xq.to(part.device)).to(self.home)
                    self._back_home(part.device)
                    total = p if total is None else total + p
                home = placed[0] if placed[0].device == self.home else \
                    _Placed(self.home, (), model.row_mean_coef.to(self.home),
                            model.bias.to(self.home))
                out = finalize_partial_scores(total, home.row_mean_coef,
                                              home.bias, model.n_support)
        self._m_routed[policy].inc()
        return ShardedScores(out, policy)

    def _data_parallel(self, placed: List[_Placed], xq: torch.Tensor,
                       n_support: int) -> torch.Tensor:
        rows = xq.shape[0] // len(placed)
        outs = []
        for i, part in enumerate(placed):
            with self._on(part.device):
                q = xq[i * rows:(i + 1) * rows].to(part.device)
                scores = finalize_partial_scores(
                    _partials(part, q), part.row_mean_coef, part.bias,
                    n_support)
                outs.append(scores.to(self.home))
            self._back_home(part.device)
        return torch.cat(outs, dim=0)


def place_sharded_model(model: ShardedFittedKpca,
                        devices: Sequence[torch.device], *,
                        replicate: bool = False,
                        stream_for=None) -> List[_Placed]:
    """Place a sharded model on a mesh: device i gets shards i, i + D, ...
    (model-parallel), or every shard with ``replicate`` (data-parallel and
    the single-device reduction). Each non-empty shard becomes a
    ``partial_projector`` on its device (its true rows only: the padding
    contributes exactly zero), and each device gets the global centering
    terms. ``stream_for(device)`` gives the context to issue a device's
    work in (the router passes its per-device streams); by default the
    current stream."""
    s, d = model.n_shards, len(devices)
    placed = []
    for i, dev in enumerate(devices):
        dev = torch.device(dev)
        shards = range(s) if replicate else range(i, s, d)
        ctx = stream_for(dev) if stream_for is not None \
            else contextlib.nullcontext()
        with ctx:
            fns = tuple(_shard_projector(model, j, dev) for j in shards
                        if model.shard_sizes[j])
            placed.append(_Placed(dev, fns, model.row_mean_coef.to(dev),
                                  model.bias.to(dev)))
    return placed


def _shard_projector(model: ShardedFittedKpca, j: int, dev: torch.device):
    n = model.shard_sizes[j]
    return partial_projector(
        model.spec, model.x_support[j, :n].to(dev).contiguous(),
        model.coefs_ext[j, :n].to(dev).contiguous(),
        gamma=model.gamma.to(dev))


def _partials(part: _Placed, xq: torch.Tensor) -> torch.Tensor:
    """Sum of one device's shards' raw (B, C+1) partials, in shard order."""
    total = None
    for fn in part.shards:
        p = fn(xq)
        total = p if total is None else total + p
    return total


def measure_crossover(model: ShardedFittedKpca, *,
                      devices: Optional[Sequence[torch.device]] = None,
                      row_buckets=(256, 1024, 4096),
                      reps: int = 3) -> CrossoverTable:
    """Time every feasible policy at each row bucket for THIS model on THIS
    host and return a ``CrossoverTable`` pinning the winners. Slabs are
    zeros (the cost does not depend on the values); the first call per
    policy is untimed; each timed call ends with a device sync."""
    if devices is None and model.device.type == "cuda":
        devices = make_serving_mesh(model.n_shards)
    router = ShardedRouter(devices, home=model.device)
    support_key = _pow2(int(model.n_support))
    table = {}
    for rows in row_buckets:
        xq = torch.zeros((int(rows), model.n_features), dtype=torch.float32,
                         device=router.home)
        best, best_t = "single", float("inf")
        for policy in POLICIES:
            if policy != "single" and not devices:
                continue
            if policy == "dp" and rows % len(devices):
                continue
            _sync(router.dispatch(model, 0, xq, policy).scores)
            t = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                _sync(router.dispatch(model, 0, xq, policy).scores)
                t = min(t, time.perf_counter() - t0)
            if t < best_t:
                best, best_t = policy, t
        table[(_pow2(int(rows)), support_key)] = best
    return CrossoverTable(table=table)


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def project_sharded(model: ShardedFittedKpca, x_query: torch.Tensor, *,
                    devices: Optional[Sequence[torch.device]] = None,
                    policy: str = "mp",
                    crossover: Optional[CrossoverTable] = None
                    ) -> torch.Tensor:
    """Sharded centered out-of-sample scores: (B, M) -> (B, C), equal to
    ``oos.project(gather_fitted(model))`` to fp32 tolerance for every
    policy.

    ``devices`` is the mesh (None: ``make_serving_mesh(model.n_shards)``
    for a model on the card, no mesh on the CPU); results land on the
    query's device. ``policy`` is "mp" (default), "dp", "single" or "auto"
    (route via ``crossover``); an infeasible choice (no mesh, or "dp" with
    rows that do not divide over the devices) degrades to the same math,
    as in the JAX package.
    """
    if policy != "auto" and policy not in POLICIES:
        raise ValueError(f"policy must be 'auto' or one of {POLICIES}, "
                         f"got {policy!r}")
    if devices is None and model.device.type == "cuda":
        devices = make_serving_mesh(model.n_shards)
    router = ShardedRouter(devices, home=x_query.device,
                           policy="auto" if policy == "auto" else policy,
                           crossover=crossover)
    chosen = router.choose(int(x_query.shape[0]), model)
    return router.dispatch(model, 0, x_query, chosen).scores


__all__ = ["CrossoverTable", "POLICIES", "ShardedRouter", "ShardedScores",
           "measure_crossover", "place_sharded_model", "project_sharded"]
