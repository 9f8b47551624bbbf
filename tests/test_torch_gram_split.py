"""The gram kernel's short-row route (``csrc/gram.cu``: ``gram_split_kernel``)
on the CPU: which shapes take it, what the wrapper hands the kernel, and a
float32 emulation of the route's summation order held to fp32 grade.

The route runs only on the card (``tests/test_torch_gpu.py`` holds it to the
plain version there). Here ``split_count`` is checked to be a function of
(n, k, m) alone that keeps every shape of the paper's fit on the one-block-
per-tile route, and the route's arithmetic is emulated in numpy: operands
split into TF32 halves (round to nearest, ties away), three products per
8-feature k-step in the kernel's order into a per-stage partial whose
accumulation is truncated toward zero (the tensor core's accumulation is not
round-to-nearest; truncation is its one-signed worst case), one rounded
fp32 add per stage, the K-tiles cut into the cluster's contiguous ranges,
the ranks' partials added in rank order, the norms summed in the split
pass's block-per-row order, and the rbf epilogue in fp32. Against a float64
Gram the emulation's error must stay within twice the plain fp32 version's,
the gate ``chip_smoke.py`` holds the card's kernel to.
"""

import inspect

import numpy as np
import pytest
import torch

from repro_torch.core import KernelSpec
from repro_torch.core.kernels_math import resolve_gamma
from repro_torch.kernels import gram_reference
from repro_torch.kernels.gram import gram as gram_mod
from repro_torch.kernels.gram.gram import (ROW_PAD, gram_tiles,
                                           padded_stride, split_count)

# (z, n, k, m) of every Gram of the paper's fit (M = 784): the setup's
# batched slot Grams, central kPCA's, the similarity and compression cross
# Grams, the ring's centring sweep
FIT_SHAPES = [(20, 500, 500, 784), (1, 2000, 2000, 784),
              (1, 100, 2000, 784), (1, 500, 2000, 784),
              (20, 100, 100, 784)]
# the DKPCA activation probe's: the pooled self-Gram and the node Grams at
# every family's width, the ring's sweep and slot Grams
PROBE_SHAPES = ([(1, 96, 96, e) for e in (1024, 2048, 3072, 4096)]
                + [(3, 96, 96, e) for e in (1024, 2048, 3072, 4096)]
                + [(z, 24, 24, 3072) for z in (1, 4)]
                + [(z, 72, 72, 3072) for z in (1, 4)])


def test_split_count_takes_n_k_m_alone():
    assert list(inspect.signature(split_count).parameters) == ["n", "k", "m"]


@pytest.mark.parametrize("z,n,k,m", FIT_SHAPES)
def test_fit_shapes_keep_one_block_per_tile(z, n, k, m):
    assert split_count(n, k, m) == 1


@pytest.mark.parametrize("z,n,k,m", PROBE_SHAPES)
def test_probe_shapes_split_the_feature_axis(z, n, k, m):
    s = split_count(n, k, m)
    assert 1 < s <= 16
    assert s <= padded_stride(m) // ROW_PAD   # a K-tile or more per CTA


@pytest.mark.parametrize("n,k,m,want", [
    (128, 128, 1024, True), (129, 24, 4096, False), (24, 129, 4096, False),
    (1, 1, 993, True), (96, 96, 992, False), (96, 96, 784, False)])
def test_split_count_edges(n, k, m, want):
    """One output tile (n, k <= 128) and at least 32 K-tiles of 32
    features (m > 992)."""
    assert (split_count(n, k, m) > 1) == want


class _Lib:
    """Stands in for the kernel library: records each kpca_gram call."""

    def __init__(self):
        self.calls = []

    def kpca_gram(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """gram_tiles on CPU tensors with the card's checks and the library
    replaced: what the wrapper would launch, without a card."""
    lib = _Lib()
    monkeypatch.setattr(gram_mod, "check_kernel_operand",
                        lambda *a, **k: None)
    monkeypatch.setattr(gram_mod, "load_library", lambda: lib)
    monkeypatch.setattr(gram_mod, "stream_of", lambda dev: 0)
    monkeypatch.setattr(gram_mod, "launch_guard",
                        lambda dev: __import__("contextlib").nullcontext())
    monkeypatch.setattr(gram_mod, "dispatch_rows",
                        lambda z, n, k, m, sym, dt, dev: gram_mod.tile_rows(
                            z, n, k, sym))
    return lib


# kpca_gram's arguments: ..., batch 7, n 8, k 9, m 10, mp 11, rows 12,
# splits 13, kind 14, ...
@pytest.mark.parametrize("n,k,m", [(24, 24, 3072), (96, 96, 4096),
                                   (100, 100, 784)])
@pytest.mark.parametrize("symmetric", [False, True])
def test_wrapper_launches_split_count_at_every_batch(fake_card, n, k, m,
                                                     symmetric):
    """The split count the wrapper launches follows (n, k, m) whatever the
    batch, the operand type and the card's tile choice, and is counted as
    one launch per Gram."""
    spec = KernelSpec(kind="rbf", gamma=0.5)
    g = torch.tensor(0.5)
    if symmetric:
        k = n
    launches = gram_tiles.launches
    for z in (1, 3, 4, 20):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.zeros((z, n, m), dtype=dtype)
            y = None if symmetric else torch.zeros((z, k, m), dtype=dtype)
            out = gram_tiles(spec, x, y, g)
            assert out.shape == (z, n, k)
    assert gram_tiles.launches == launches + 8
    seen = {(c[7], c[13]) for c in fake_card.calls}
    assert seen == {(z, split_count(n, k, m)) for z in (1, 3, 4, 20)}
    assert all(c[11] == padded_stride(m) for c in fake_card.calls)


# ---- the route's summation order, emulated ----------------------------------

SPLIT_THREADS = 256     # the split pass's threads a row on this route


def tf32_rna(v):
    """cvt.rna.tf32.f32: 10 mantissa bits, to nearest, ties away from 0."""
    u = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    u = (u.astype(np.uint64) + 0x1000) & 0xFFFFE000
    return u.astype(np.uint32).view(np.float32)


def to_f32_toward_zero(v64):
    """float64 to float32, truncated toward zero."""
    f = v64.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v64)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def split_norms(x32, mp):
    """The split pass's squared row norms, a 256-thread block a row: fma
    thread-strided, a shuffle tree per warp, then the warps in order."""
    rows, m = x32.shape
    v = np.zeros((rows, mp), np.float32)
    v[:, :m] = x32
    ss = np.zeros((rows, SPLIT_THREADS), np.float32)
    for c0 in range(0, mp, SPLIT_THREADS):
        blk = v[:, c0:c0 + SPLIT_THREADS].astype(np.float64)
        ss = (blk * blk + ss.astype(np.float64)).astype(np.float32)
    ss = ss.reshape(rows, SPLIT_THREADS // 32, 32)
    lane = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        ss = ss + ss[:, :, lane ^ off]
    total = np.zeros(rows, np.float32)
    for w in range(SPLIT_THREADS // 32):
        total = total + ss[:, w, 0]
    return total


def emulated_split_dots(x32, y32, splits):
    """x . y^T in the route's order (see the module docstring)."""
    m = x32.shape[1]
    mp = -(-m // ROW_PAD) * ROW_PAD
    halves = []
    for v in (x32, y32):
        p = np.zeros((v.shape[0], mp), np.float32)
        p[:, :m] = v
        hi = tf32_rna(p)
        halves.append((hi.astype(np.float64),
                       tf32_rna(p - hi).astype(np.float64)))
    (xh, xl), (yh, yl) = halves
    kt = mp // ROW_PAD
    total = None
    for r in range(splits):
        acc = np.zeros((x32.shape[0], y32.shape[0]), np.float32)
        for t in range(r * kt // splits, (r + 1) * kt // splits):
            part = None
            for kk in range(ROW_PAD // 8):
                s = slice(t * ROW_PAD + 8 * kk, t * ROW_PAD + 8 * kk + 8)
                for a, b in ((xl, yh), (xh, yl), (xh, yh)):
                    prod = a[:, s] @ b[:, s].T        # exact in float64
                    part = to_f32_toward_zero(
                        prod if part is None else part.astype(np.float64)
                        + prod)
            acc = acc + part
        total = acc if total is None else total + acc
    return total


def emulated_split_rbf(x32, gamma32, splits):
    """The route's self-Gram: rbf epilogue in fp32 on the emulated dots,
    its diagonal 1 (Epilogue::self_value)."""
    mp = padded_stride(x32.shape[1])
    dot = emulated_split_dots(x32, x32, splits)
    a = split_norms(x32, mp)
    ab = a[:, None] + a[None, :]
    d2 = np.maximum((ab.astype(np.float64)
                     - 2.0 * dot.astype(np.float64)).astype(np.float32), 0)
    k = np.exp(-gamma32 * d2).astype(np.float32)
    np.fill_diagonal(k, 1.0)
    return k


def _rows(kind, n, m, seed):
    rng = np.random.default_rng(seed)
    if kind == "probe":     # the probe's seeded activations
        return (rng.standard_normal((n, m)) * 0.005).astype(np.float32)
    # all positive, wide norms: every product one-signed
    return (1.0 + np.abs(rng.standard_normal((n, m)))).astype(np.float32)


@pytest.mark.parametrize("m", [1024, 2048, 3072, 4096])
@pytest.mark.parametrize("rows", ["probe", "positive"])
def test_emulated_route_is_fp32_grade(rows, m):
    """At the probe's 96 rows: the route's order within 2x the plain fp32
    version's error against float64."""
    n = 96
    x = _rows(rows, n, m, seed=m)
    xt = torch.as_tensor(x)
    spec = KernelSpec(kind="rbf")
    g32 = resolve_gamma(spec, xt)
    plain = gram_reference(spec, xt, gamma=g32).numpy()
    exact = gram_reference(spec, xt.double(), gamma=g32.double()).numpy()
    got = emulated_split_rbf(x, np.float32(g32), split_count(n, n, m))
    err = np.abs(got.astype(np.float64) - exact).max()
    err_plain = np.abs(plain.astype(np.float64) - exact).max()
    assert err <= 2.0 * err_plain, (err, err_plain)


def test_emulated_split_is_batch_free_and_ordered():
    """The cluster sum is in rank order over contiguous K-tile ranges: the
    same operands give the same bits, and a rank's range does not depend on
    anything but m and the split count."""
    x = _rows("probe", 24, 3072, seed=1)
    y = _rows("probe", 24, 3072, seed=2)
    s = split_count(24, 24, 3072)
    first = emulated_split_dots(x, y, s)
    assert np.array_equal(first, emulated_split_dots(x, y, s))
    np.testing.assert_allclose(first, x.astype(np.float64) @ y.T.astype(
        np.float64), rtol=0, atol=1e-6)
