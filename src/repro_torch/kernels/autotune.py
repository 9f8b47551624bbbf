"""Measured-search autotuner for the hand-written kernels' launch choices
(counterpart of ``repro.kernels.autotune``).

The port's kernels derive three launch choices from the shape:

  * ``gram``: output rows per block (``gram.tile_rows``: 128, or 64 where
    128-row tiles would leave a cross-Gram's grid under one wave of SMs; a
    self-Gram keeps 128, since a tile and its mirror must be the same
    square work);
  * ``project``/``project_partial``: feature slices per 64-row support
    tile (``project.support_chunking``: 1, 2, 4 or 8, a portable cluster);
  * ``centering``: one launch through shared memory, or two passes over
    slabs of ``rows`` rows (``centering.center_plan``).

Those derivations are the defaults. This module answers the same questions
by measurement:

  * a candidate list per op, filtered by legality for the concrete shape;
  * each candidate first held against the default's output (gram bitwise,
    project 2e-5, centering 2e-4, each scaled by max(1, |default|)); a
    candidate that disagrees is dropped and counted, never timed or stored;
  * each surviving candidate timed on the card: its device time per call,
    CUDA events around one call queued behind a spin kernel (so the host's
    launch cost is not in it), best of ``k`` after one untimed warm-up
    call; the library is built before the first trial, so no build is
    timed;
  * the winner persisted to a JSON **tile table** keyed by ``(op,
    pow2-shape-bucket, dtype, backend)`` and read by the wrappers — a tuned
    entry changes the dispatch of every later call with that key;
  * no entry -> the derivation, so an empty or missing table gives exactly
    the dispatch the wrappers had without a table, bit for bit.

Keys. The backend is ``cuda:<device name>``, so a table written on one card
model is never applied on another. gram's shape is the self-Gram's x (Z, n,
M) or the cross-Gram's (Z, n, k, M), so the two never share an entry.
project's shape is (L, M) alone, never the batch: the JAX package keys on
(B, L, M), but here batch invariance rests on the slicing being a function
of L alone (a query's scores must not depend on what it was batched with),
so the tuner times every serving bucket for one L and keeps the slicing
with the least total time over them. Centering's is (Z, n, M).

Lookups cost nothing per call on the serving path: gram and centering
resolve their choice once per exact shape (an ``lru_cache`` in each
wrapper, registered here), and a projector once when it is built
(``kernels.project.ops``). ``set_default_table`` clears those caches; a
projector built before then keeps its slicing. A table entry that is
illegal for the exact shape it meets (a ``small`` centring past the
shared-memory budget at a larger shape of the same bucket) is not applied:
the derivation runs there.

Point ``REPRO_TILE_TABLE`` at a table file to load it process-wide (read
once, before the first kernel dispatch), or install one with
``set_default_table``. ``python -m repro_torch.kernels.autotune --out
build/tile_table.json`` searches the paper's shapes on the card; a key
already in the table is a cache hit and re-runs nothing (``--force``
re-searches it; ``--assert-cached`` fails unless every key hits).

Observability: every trial bumps ``autotune_trials_total`` and runs under
an ``autotune.<op>`` span; cache hits bump ``autotune_cached_total``,
candidates dropped for disagreeing ``autotune_rejected_total``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import metrics, trace

ALL_OPS = ("gram", "project", "project_partial", "centering")
# No knobs: the wrapper derives its choice from the shape, as without a
# table. A table hit's knobs are merged over these.
DEFAULT_TILES: Dict[str, Dict[str, int]] = {op: {} for op in ALL_OPS}
KNOBS = {"gram": ("rows",), "project": ("slices",),
         "project_partial": ("slices",), "centering": ("small", "rows")}
GRAM_ROWS = (64, 128)
SLICES = (1, 2, 4, 8)
CENTER_ROWS = (8, 16, 32, 64, 128, 256)
# candidate against the default's output, scaled by max(1, |default|)
AGREE_TOL = {"gram": 0.0, "project": 2e-5, "project_partial": 2e-5,
             "centering": 2e-4}
SPIN_CYCLES = 2_000_000          # about 1 ms: covers the host's launch cost

TABLE_ENV_VAR = "REPRO_TILE_TABLE"
TABLE_VERSION = 1

_m_trials = metrics.counter(
    "autotune_trials_total", "Tile candidates timed by the autotuner")
_m_cached = metrics.counter(
    "autotune_cached_total", "Tune requests answered from the tile table")
_m_rejected = metrics.counter(
    "autotune_rejected_total",
    "Tile candidates dropped for disagreeing with the default's output")


def _pow2_bucket(n: int, floor: int = 8) -> int:
    """Smallest power of two >= n (and >= floor): the shape-bucket axis of
    a tile-table key."""
    b = floor
    while b < n:
        b *= 2
    return b


def shape_bucket(shape: Sequence[int]) -> Tuple[int, ...]:
    """Bucket every dim of ``shape`` to a power of two."""
    return tuple(_pow2_bucket(int(d)) for d in shape)


def _dtype_name(dtype: Any) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return np.dtype(dtype).name


def table_key(op: str, shape: Sequence[int], dtype: Any,
              backend: str) -> str:
    """Canonical JSON key: ``op|d1xd2x...|dtype|backend`` with the shape
    pow2-bucketed."""
    dims = "x".join(str(d) for d in shape_bucket(shape))
    return f"{op}|{dims}|{_dtype_name(dtype)}|{backend}"


@functools.lru_cache(maxsize=None)
def device_backend(index: Optional[int] = None) -> str:
    """The backend field of this card's keys: ``cuda:<device name>``."""
    if not torch.cuda.is_available():
        raise RuntimeError("tile tables are keyed by a CUDA device, and "
                           "torch sees none")
    if index is None:
        index = torch.cuda.current_device()
    return f"cuda:{torch.cuda.get_device_name(index)}"


# ---- legality -------------------------------------------------------------

def check_knobs(op: str, shape: Sequence[int], knobs: Dict[str, int],
                exact: bool = True) -> None:
    """Raise ValueError unless ``knobs`` is a legal launch choice for
    ``op`` at ``shape``. With ``exact`` the shape is the problem's own and
    the shape-dependent limits apply (centering's shared-memory budget and
    slab count); without it (a loaded table's bucketed key) only the knob
    domain is checked."""
    if op not in KNOBS:
        raise ValueError(f"unknown op {op!r} (one of {ALL_OPS})")
    extra = set(knobs) - set(KNOBS[op])
    if extra:
        raise ValueError(f"{op}: unknown knob(s) {sorted(extra)}")
    if op == "gram":
        rows = knobs.get("rows")
        if len(shape) == 3:
            if rows != 128:
                raise ValueError(f"gram self-Gram {tuple(shape)}: rows must "
                                 f"be 128 (mirrored square tiles), got "
                                 f"{rows}")
        elif len(shape) != 4 or rows not in GRAM_ROWS:
            raise ValueError(f"gram {tuple(shape)}: rows must be one of "
                             f"{GRAM_ROWS} on a (Z, n, k, M) cross-Gram, got "
                             f"{rows}")
    elif op in ("project", "project_partial"):
        if len(shape) != 2 or knobs.get("slices") not in SLICES:
            raise ValueError(f"{op} {tuple(shape)}: slices must be one of "
                             f"{SLICES} on an (L, M) key, got "
                             f"{knobs.get('slices')}")
    else:
        if len(shape) != 3:
            raise ValueError(f"centering key must be (Z, n, M), got "
                             f"{tuple(shape)}")
        small = knobs.get("small")
        if small not in (0, 1) or (small == 1) == ("rows" in knobs):
            raise ValueError(f"centering: small=1, or small=0 with rows, "
                             f"got {knobs}")
        if small == 0:
            rows = knobs["rows"]
            if not CENTER_ROWS[0] <= rows <= CENTER_ROWS[-1]:
                raise ValueError(f"centering: rows {rows} outside "
                                 f"{CENTER_ROWS[0]}..{CENTER_ROWS[-1]}")
        if exact:
            from .centering.centering import small_fits
            _, n, m = shape
            if small == 1 and not small_fits(n, m):
                raise ValueError(f"centering {tuple(shape)}: the block does "
                                 f"not fit the one-launch path's shared "
                                 f"memory")
            if small == 0 and -(-n // knobs["rows"]) > knobs["rows"]:
                raise ValueError(f"centering {tuple(shape)}: rows "
                                 f"{knobs['rows']} gives more slabs than "
                                 f"rows per slab")


def is_legal(op: str, shape: Sequence[int], knobs: Dict[str, int]) -> bool:
    try:
        check_knobs(op, shape, knobs)
    except ValueError:
        return False
    return True


@dataclasses.dataclass
class Trial:
    """One timed candidate: its knobs and its device seconds (best of k;
    for project, summed over the serving buckets)."""
    blocks: Dict[str, int]
    seconds: float


class TileTable:
    """In-memory tile table with JSON round-trip.

    ``entries`` maps ``table_key`` strings to knob dicts, plus the winner's
    ``us`` and the default's ``default_us`` and ``default`` knobs for
    provenance. Lookups are plain dict reads; tuning writes happen before
    serving traffic.
    """

    def __init__(self, entries: Optional[Dict[str, Dict[str, Any]]] = None):
        self.entries: Dict[str, Dict[str, Any]] = dict(entries or {})

    # -- persistence --------------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "TileTable":
        """Read a table file; a wrong version or an entry outside its op's
        knob domain raises ValueError."""
        with open(path) as f:
            payload = json.load(f)
        if payload.get("version") != TABLE_VERSION:
            raise ValueError(
                f"tile table {path}: version {payload.get('version')!r} "
                f"!= supported {TABLE_VERSION}")
        entries = payload.get("entries", {})
        for key, entry in entries.items():
            op, dims = key.split("|")[:2]
            check_knobs(op, [int(d) for d in dims.split("x")],
                        _knobs(op, entry), exact=False)
        return cls(entries)

    def save(self, path: str) -> None:
        payload = {"version": TABLE_VERSION, "entries": self.entries}
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")

    # -- lookup/update ------------------------------------------------------

    def lookup(self, op: str, shape: Sequence[int], dtype: Any,
               backend: str) -> Optional[Dict[str, int]]:
        hit = self.entries.get(table_key(op, shape, dtype, backend))
        return None if hit is None else _knobs(op, hit)

    def put(self, op: str, shape: Sequence[int], dtype: Any, backend: str,
            blocks: Dict[str, int], seconds: float,
            **provenance: Any) -> str:
        """Store ``blocks`` for ``shape``'s key; an illegal choice at that
        shape raises ValueError."""
        check_knobs(op, shape, blocks)
        key = table_key(op, shape, dtype, backend)
        self.entries[key] = dict(blocks, us=round(seconds * 1e6, 3),
                                 **provenance)
        return key

    def __len__(self) -> int:
        return len(self.entries)


def _knobs(op: str, entry: Dict[str, Any]) -> Dict[str, int]:
    return {k: int(entry[k]) for k in KNOBS[op] if k in entry}


# Process-wide table, initialized lazily from $REPRO_TILE_TABLE, and the
# wrappers' cached choices that depend on it.
_default_table: Optional[TileTable] = None
_dispatch_caches: List[Callable] = []


def default_table() -> TileTable:
    global _default_table
    if _default_table is None:
        path = os.environ.get(TABLE_ENV_VAR)
        if path and os.path.exists(path):
            _default_table = TileTable.load(path)
        else:
            _default_table = TileTable()
    return _default_table


def set_default_table(table: Optional[TileTable]) -> None:
    """Install (or with None: reset, re-reading $REPRO_TILE_TABLE on next
    use) the process-wide table, and clear every cached launch choice."""
    global _default_table
    _default_table = table
    for cache in _dispatch_caches:
        cache.cache_clear()


def register_dispatch_cache(fn: Callable) -> Callable:
    """Mark a wrapper's ``lru_cache``d choice as one that
    ``set_default_table`` clears (usable as a decorator)."""
    _dispatch_caches.append(fn)
    return fn


def get_tiles(op: str, shape: Sequence[int], dtype: Any,
              table: Optional[TileTable] = None,
              backend: Optional[str] = None) -> Dict[str, int]:
    """Knobs for one dispatch: the table's entry for this (op,
    shape-bucket, dtype, backend), else ``DEFAULT_TILES[op]`` (empty: derive
    from the shape). ``backend`` defaults to the current card's."""
    t = table if table is not None else default_table()
    hit = t.lookup(op, shape, dtype, backend or device_backend())
    return dict(DEFAULT_TILES[op], **(hit or {}))


def _backend_of(device: torch.device) -> str:
    return device_backend(device.index if device.index is not None
                          else torch.cuda.current_device())


def dispatch_knobs(op: str, shape: Sequence[int], dtype: Any,
                   device: torch.device) -> Dict[str, int]:
    """What a wrapper applies at an exact shape on ``device``: the default
    table's entry where it is legal there, else {} (derive)."""
    knobs = get_tiles(op, shape, dtype, backend=_backend_of(device))
    return knobs if knobs and is_legal(op, shape, knobs) else {}


# ---- candidate lists --------------------------------------------------------

def gram_candidates(z: int, n: int, k: int, m: int,
                    symmetric: bool = False) -> List[Dict[str, int]]:
    """Rows per block: 128 for a self-Gram, 64 or 128 for a cross-Gram."""
    return [{"rows": 128}] if symmetric else [{"rows": r}
                                              for r in GRAM_ROWS]


def project_candidates(l: int, m: int) -> List[Dict[str, int]]:
    """Feature slices per support tile."""
    return [{"slices": s} for s in SLICES]


def centering_candidates(z: int, n: int, m: int) -> List[Dict[str, int]]:
    """One launch where the block fits; two passes at each legal slab
    height (one per slab count), and the derived plan's."""
    from .centering.centering import center_plan
    shape = (z, n, m)
    cands = [{"small": 1}] if is_legal("centering", shape,
                                       {"small": 1}) else []
    plan = center_plan(z, n, m)
    seen = set()
    rows = sorted(set(CENTER_ROWS) | ({plan.rows} if not plan.small
                                      else set()))
    for r in rows:
        knobs = {"small": 0, "rows": r}
        slabs = -(-n // r)
        if slabs not in seen and is_legal("centering", shape, knobs):
            seen.add(slabs)
            cands.append(knobs)
    return cands


# ---- measurement ------------------------------------------------------------

def _device_seconds(fn: Callable[[], Any], k: int) -> float:
    """Best-of-k device seconds of one ``fn()`` call: CUDA events around
    the call, queued behind a spin kernel so that the host's launch cost
    falls inside the spin; one untimed warm-up call first."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = math.inf
    for _ in range(k):
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def _agrees(op: str, got: torch.Tensor, want: torch.Tensor) -> bool:
    if AGREE_TOL[op] == 0.0:
        return bool(torch.equal(got, want))
    err = (got - want).abs() / torch.clamp(want.abs(), min=1.0)
    return bool(err.max() <= AGREE_TOL[op])


def _require_card(*tensors: torch.Tensor) -> torch.device:
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("tuning needs CUDA tensors: the plain versions a "
                         "CPU tensor runs have no tiles")
    return tensors[0].device


def _search(op: str, shape: Sequence[int], dtype: Any,
            default: Dict[str, int], candidates: List[Dict[str, int]],
            run: Callable[[Dict[str, int]], List[Callable[[], Any]]],
            k: int, table: Optional[TileTable], force: bool,
            device: torch.device) -> Tuple[Dict[str, int], List[Trial]]:
    """Shared search loop: cache check, each candidate held against the
    default's outputs, the agreeing ones timed, the winner committed.
    ``run(knobs)`` returns a list of zero-argument callables, each one
    launch at one of the op's shapes (project: one per serving bucket)."""
    from ._build import load_library
    backend = _backend_of(device)
    t = table if table is not None else default_table()
    if not force:
        hit = t.lookup(op, shape, dtype, backend)
        if hit is not None:
            _m_cached.inc()
            return dict(DEFAULT_TILES[op], **hit), []
    load_library()                   # the build is never timed
    if default not in candidates:
        candidates = [default] + list(candidates)
    want = [fn() for fn in run(default)]
    trials: List[Trial] = []
    with trace.span(f"autotune.{op}", shape=list(shape),
                    n_candidates=len(candidates)):
        for knobs in candidates:
            calls = run(knobs)
            if not all(_agrees(op, fn(), w) for fn, w in zip(calls, want)):
                _m_rejected.inc()
                if trace.is_enabled():
                    trace.instant(f"autotune.{op}.rejected", **knobs)
                continue
            seconds = sum(_device_seconds(fn, k) for fn in calls)
            trials.append(Trial(dict(knobs), seconds))
            _m_trials.inc()
            if trace.is_enabled():
                trace.instant(f"autotune.{op}.trial", **knobs,
                              us=round(seconds * 1e6, 2))
    best = min(trials, key=lambda tr: tr.seconds)
    default_s = next(tr.seconds for tr in trials if tr.blocks == default)
    t.put(op, shape, dtype, backend, best.blocks, best.seconds,
          default=dict(default), default_us=round(default_s * 1e6, 3))
    return dict(DEFAULT_TILES[op], **best.blocks), trials


def tune_gram(spec, x: torch.Tensor, y: Optional[torch.Tensor] = None,
              gamma=None, k: int = 3, table: Optional[TileTable] = None,
              force: bool = False,
              candidates: Optional[List[Dict[str, int]]] = None
              ) -> Tuple[Dict[str, int], List[Trial]]:
    """Search gram's rows per block for x (n, M) / (Z, n, M) against y
    (None: the self-Gram); returns (winning knobs, trials — empty on a
    table hit)."""
    from .gram.gram import gram_tiles, tile_rows
    from .gram.ops import gamma_operand
    dev = _require_card(x) if y is None else _require_card(x, y)
    xb = (x if x.dim() == 3 else x[None]).contiguous()
    yb = None if y is None else (y if y.dim() == 3 else y[None]).contiguous()
    z, n, m = xb.shape
    kk = n if yb is None else yb.shape[1]
    shape = (z, n, m) if yb is None else (z, n, kk, m)
    g = gamma_operand(spec, xb.reshape(-1, m), gamma)
    default = {"rows": tile_rows(z, n, kk, yb is None)}
    cands = candidates if candidates is not None \
        else gram_candidates(z, n, kk, m, yb is None)

    def run(knobs):
        return [lambda: gram_tiles(spec, xb, yb, g, rows=knobs["rows"])]

    return _search("gram", shape, xb.dtype, default, cands, run, k, table,
                   force, dev)


def _tune_project(op: str, make, x_queries, x_support: torch.Tensor,
                  k: int, table, force, candidates):
    from .project.project import support_chunking
    queries = [x_queries] if isinstance(x_queries, torch.Tensor) \
        else list(x_queries)
    dev = _require_card(x_support, *queries)
    l, m = x_support.shape
    shape = (l, m)
    default = {"slices": support_chunking(l)[1]}
    cands = candidates if candidates is not None \
        else project_candidates(l, m)

    def run(knobs):
        project = make(knobs["slices"])
        return [functools.partial(project, xq) for xq in queries]

    return _search(op, shape, x_support.dtype, default, cands, run, k,
                   table, force, dev)


def tune_project(spec, x_queries, x_support: torch.Tensor,
                 coefs: torch.Tensor, row_mean_coef=None, bias=None,
                 gamma=None, k: int = 3, table: Optional[TileTable] = None,
                 force: bool = False,
                 candidates: Optional[List[Dict[str, int]]] = None
                 ) -> Tuple[Dict[str, int], List[Trial]]:
    """Search the fused projection's feature slices for an (L, M) support
    set, timing every query batch of ``x_queries`` (one (B, M) tensor per
    serving bucket, or one tensor) and keeping the slicing with the least
    total time over them."""
    from .project.ops import projector
    return _tune_project(
        "project", lambda s: projector(spec, x_support, coefs, row_mean_coef,
                                       bias, gamma, slices=s),
        x_queries, x_support, k, table, force, candidates)


def tune_project_partial(spec, x_queries, x_support: torch.Tensor,
                         coefs_ext: torch.Tensor, gamma=None, k: int = 3,
                         table: Optional[TileTable] = None,
                         force: bool = False,
                         candidates: Optional[List[Dict[str, int]]] = None
                         ) -> Tuple[Dict[str, int], List[Trial]]:
    """Search the per-shard partial projection's feature slices, as
    ``tune_project``."""
    from .project.ops import partial_projector
    return _tune_project(
        "project_partial", lambda s: partial_projector(
            spec, x_support, coefs_ext, gamma, slices=s),
        x_queries, x_support, k, table, force, candidates)


def tune_centering(k_matrix: torch.Tensor, k: int = 3,
                   table: Optional[TileTable] = None, force: bool = False,
                   candidates: Optional[List[Dict[str, int]]] = None
                   ) -> Tuple[Dict[str, int], List[Trial]]:
    """Search the centring plan for k_matrix (..., n, M)."""
    from .centering.centering import center_plan, center_tiles, plan_of
    dev = _require_card(k_matrix)
    km = k_matrix.reshape(-1, *k_matrix.shape[-2:])
    z, n, m = km.shape
    shape = (z, n, m)
    derived = center_plan(z, n, m)
    default = {"small": 1} if derived.small else {"small": 0,
                                                  "rows": derived.rows}
    cands = candidates if candidates is not None \
        else centering_candidates(z, n, m)

    def run(knobs):
        plan = plan_of(z, n, m, knobs)
        return [lambda: center_tiles(k_matrix, plan=plan)]

    return _search("centering", shape, k_matrix.dtype, default, cands, run,
                   k, table, force, dev)


# ---- CLI ----------------------------------------------------------------------

def serving_buckets(max_batch: int) -> List[int]:
    """The pow2 serving buckets the engines dispatch: 8 ... max_batch."""
    out, b = [], 8
    while b < max_batch:
        out.append(b)
        b *= 2
    return out + [max_batch]


def main(argv=None) -> List[dict]:
    """``python -m repro_torch.kernels.autotune --out
    build/tile_table.json``: tune gram, project, project_partial and
    centering at the paper's shapes (the Fig. 3/5 fit's Grams and
    centrings, the served models' projections over every serving bucket)
    on the card, and persist the table. Rerunning against an existing
    table only fills gaps; ``--assert-cached`` fails unless every
    requested key answers from the table (0 trials). Returns one record
    per tuned shape (op, shape, default and chosen knobs, their device
    ms, trials)."""
    import argparse
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--out", default="build/tile_table.json")
    ap.add_argument("--m", type=int, default=784, help="feature dim")
    ap.add_argument("--nodes", type=int, default=20,
                    help="batched cross-Gram: nodes (the ring's sweep)")
    ap.add_argument("--per-node", type=int, default=100,
                    help="samples per node")
    ap.add_argument("--support", type=int, nargs="+", default=[500, 2000],
                    help="support rows of the served models (landmarks, "
                         "the pooled samples); the largest also sizes the "
                         "self-Gram and the centring")
    ap.add_argument("--max-batch", type=int, default=128,
                    help="widest serving bucket")
    ap.add_argument("--shards", type=int, default=4,
                    help="shard count sizing project_partial's per-shard "
                         "support slice (the largest support over shards)")
    ap.add_argument("--ops", nargs="*", default=None, choices=ALL_OPS,
                    help="subset of ops to tune (default: all)")
    ap.add_argument("--k", type=int, default=3, help="timing repeats")
    ap.add_argument("--force", action="store_true",
                    help="re-search keys already in the table")
    ap.add_argument("--assert-cached", action="store_true",
                    help="fail unless every requested key is already a "
                         "table hit")
    args = ap.parse_args(argv)

    from ..core.kernels_math import KernelSpec
    from ..data import kpca_dataset
    from ..device import resolve_device
    from .gram.ops import gamma_operand, gram_op
    dev = resolve_device("cuda")
    spec = KernelSpec(kind="rbf")
    table = TileTable.load(args.out) if os.path.exists(args.out) \
        else TileTable()
    want = set(args.ops) if args.ops else set(ALL_OPS)
    pooled = max(args.support)
    data = torch.as_tensor(kpca_dataset(pooled + args.max_batch, m=args.m,
                                        seed=0), device=dev)
    xs_all, xq_all = data[:pooled], data[pooled:]
    rng = np.random.default_rng(0)
    records: List[dict] = []

    def record(op, shape, result):
        knobs, trials = result
        records.append(dict(op=op, shape=list(shape), chosen=knobs,
                            trials=len(trials),
                            trial_ms={json.dumps(tr.blocks, sort_keys=True):
                                      tr.seconds * 1e3 for tr in trials}))
        print(f"{op} {'x'.join(map(str, shape))}: {knobs} "
              f"({len(trials)} trials)", flush=True)

    if "gram" in want:
        nodes = xs_all[:args.nodes * args.per_node].reshape(
            args.nodes, args.per_node, args.m)
        neigh = torch.roll(nodes, 1, dims=0).contiguous()
        record("gram", (args.nodes, args.per_node, args.per_node, args.m),
               tune_gram(spec, nodes, neigh, k=args.k, table=table,
                         force=args.force))
        record("gram", (1, pooled, args.m),
               tune_gram(spec, xs_all, k=args.k, table=table,
                         force=args.force))
    buckets = serving_buckets(args.max_batch)
    queries = [xq_all[:b].contiguous() for b in buckets]
    if "project" in want:
        for l in args.support:
            coefs = torch.as_tensor(rng.normal(size=(l, 2)).astype(
                np.float32), device=dev)
            record("project", (l, args.m), tune_project(
                spec, queries, xs_all[:l].contiguous(), coefs, k=args.k,
                table=table, force=args.force))
    if "project_partial" in want:
        lp = -(-pooled // max(args.shards, 1))
        coefs_ext = torch.as_tensor(rng.normal(size=(lp, 3)).astype(
            np.float32), device=dev)
        coefs_ext[:, -1] = 1.0
        record("project_partial", (lp, args.m), tune_project_partial(
            spec, queries, xs_all[:lp].contiguous(), coefs_ext, k=args.k,
            table=table, force=args.force))
    if "centering" in want:
        gamma = gamma_operand(spec, xs_all, None)
        big = gram_op(spec, xs_all, gamma=gamma)
        nodes = xs_all[:args.nodes * args.per_node].reshape(
            args.nodes, args.per_node, args.m)
        small = gram_op(spec, nodes, gamma=gamma)
        for km in (big[None], small):
            record("centering", tuple(km.shape), tune_centering(
                km, k=args.k, table=table, force=args.force))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    table.save(args.out)
    backend = _backend_of(dev)
    for r in records:       # default and chosen device ms, as stored
        entry = table.entries[table_key(r["op"], r["shape"], torch.float32,
                                        backend)]
        r.update(default=entry["default"],
                 default_ms=entry["default_us"] / 1e3,
                 chosen_ms=entry["us"] / 1e3)
    print(f"wrote {len(table)} entries -> {args.out}", flush=True)
    n_trials = sum(r["trials"] for r in records)
    if args.assert_cached and n_trials:
        raise SystemExit(
            f"--assert-cached: expected every key to hit the table, but "
            f"{n_trials} trials ran (stale or missing entries)")
    return records


__all__ = [
    "ALL_OPS", "DEFAULT_TILES", "TABLE_ENV_VAR", "TABLE_VERSION",
    "TileTable", "Trial", "centering_candidates", "check_knobs",
    "default_table", "device_backend", "dispatch_knobs", "get_tiles",
    "gram_candidates", "project_candidates", "register_dispatch_cache",
    "serving_buckets", "set_default_table", "shape_bucket", "table_key",
    "tune_centering", "tune_gram", "tune_project", "tune_project_partial",
]

if __name__ == "__main__":
    main()
