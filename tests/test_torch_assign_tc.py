"""The arithmetic of the port's 3xTF32 ``assign_centroids`` kernel,
emulated in torch on the CPU, against the JAX package.

(The CUDA kernel itself runs only on a card: ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold it against the port's plain version there.)

The kernel (``csrc/assign_centroids.cu``) splits every f32 operand a into
``hi = tf32(a)`` and ``lo = tf32(a - hi)`` (round to nearest, ties away, to
10 mantissa bits), accumulates ``lo_c·hi_x + hi_c·lo_x + hi_c·hi_x`` per
8-feature k-step in f32, takes the first minimum of ``||c||² − 2·acc`` per
centroid chunk of its split plan and merges the chunks in order (the earlier
chunk first on equal values).  ``_emulate`` does the same with torch ops.
Inputs are made with numpy from a seed and fed to the emulation, to the JAX
oracle ``repro.kernels.ref.assign_centroids`` and to the Pallas kernel in
interpret mode.  Limit per row: ``|d2 − want| <= DIST_RTOL·(||x||² + ||c||²)``
of the selected pair (the size of the terms that cancel; 3xTF32 keeps about
2^-21 of it per product), ids equal except where the two distances agree
within that limit; on integer data everything is exact.  The same emulation
with TF32 alone (``hi_c·hi_x``) must break that limit on SIFT-like data at
d = 128: the check can tell the two apart.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.data import sift_like
from repro_torch.kernels import assign_centroids as kac

DIST_RTOL = 1e-5
H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """f32 rounded to 10 mantissa bits, to nearest with ties away from zero
    (``cvt.rna.tf32.f32``): add half of the dropped 13 bits to the
    magnitude, then clear them."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split3(a: torch.Tensor):
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def _dots(X: torch.Tensor, C: torch.Tensor, tf32_only: bool) -> torch.Tensor:
    """(n, k) x·c as the kernel forms it: per 8-feature k-step, the three
    products small terms first, accumulated in f32."""
    n, d = X.shape
    k = C.shape[0]
    xh, xl = split3(X)
    ch, cl = split3(C)
    acc = torch.zeros((n, k), dtype=torch.float32)
    for e in range(0, max(d, 1), 8):
        s = slice(e, e + 8)
        if tf32_only:
            acc = acc + xh[:, s] @ ch[:, s].T
            continue
        acc = acc + xh[:, s] @ cl[:, s].T
        acc = acc + xl[:, s] @ ch[:, s].T
        acc = acc + xh[:, s] @ ch[:, s].T
    return acc


def _emulate(X: np.ndarray, C: np.ndarray, chunk: int,
             tf32_only: bool = False):
    """(assign, d2): the kernel's partials, first minimum per chunk of
    ``chunk`` centroids, chunks merged in order, d2 finalized once."""
    Xt, Ct = torch.from_numpy(X), torch.from_numpy(C)
    k = Ct.shape[0]
    part = (Ct * Ct).sum(-1)[None, :] - 2.0 * _dots(Xt, Ct, tf32_only)
    best_v = torch.full((Xt.shape[0],), float("inf"))
    best_i = torch.full((Xt.shape[0],), -1, dtype=torch.int64)
    for a in range(0, k, chunk):
        p = part[:, a:a + chunk]
        i = torch.argmin(p, dim=1)               # the chunk's first minimum
        v = p.gather(1, i[:, None])[:, 0]
        take = v < best_v                        # the earlier chunk on ties
        best_v = torch.where(take, v, best_v)
        best_i = torch.where(take, i + a, best_i)
    d2 = torch.clamp(best_v + (Xt * Xt).sum(-1), min=0.0)
    return best_i.to(torch.int32).numpy(), d2.numpy()


def _scale(X, C, ids):
    return (X.astype(np.float64) ** 2).sum(-1) + (
        C.astype(np.float64) ** 2).sum(-1)[ids]


def _check(got, want, X, C):
    """(ok, max |d2 err| / limit, near-tie rows)."""
    gi, gd = (np.asarray(a) for a in got)
    wi, wd = (np.asarray(a) for a in want)
    lim = DIST_RTOL * _scale(X, C, wi)
    gap = np.abs(gd.astype(np.float64) - wd)
    within = gap <= lim
    ok = bool(within.all()) and bool(((gi == wi) | within).all())
    return ok, float((gap / lim).max()), int(((gi != wi) & within).sum())


def _floats(n, k, d, seed):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((8, d)).astype(np.float32) * 3
    X = (means[rng.integers(0, 8, n)]
         + rng.standard_normal((n, d)).astype(np.float32))
    C = (means[rng.integers(0, 8, k)]
         + rng.standard_normal((k, d)).astype(np.float32))
    return X.astype(np.float32), C.astype(np.float32)


def _ints(n, k, d, seed):
    """Integer coordinates: exact partials and ties everywhere; the
    centroid before every tile boundary repeats after it, so equal partials
    straddle the chunk boundaries."""
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 3, (n, d)).astype(np.float32)
    C = rng.integers(0, 3, (k, d)).astype(np.float32)
    for b in range(kac.COLS, k, kac.COLS):
        C[b] = C[b - 1]
    return X, C


def _chunks(n, k):
    """S = 1, S = 2, the split plan's S and S = k (one centroid a chunk)."""
    plan = kac.split_plan(n, k, H100_SMS)
    return sorted({k, -(-k // 2), plan.chunk, 1})


@pytest.mark.parametrize("n,k,d", [(200, 300, 16), (96, 257, 37),
                                   (64, 130, 4), (130, 64, 128)])
def test_emulation_matches_jax_on_floats(n, k, d):
    X, C = _floats(n, k, d, n + k + d)
    want = jref.assign_centroids(jnp.asarray(X), jnp.asarray(C))
    for chunk in _chunks(n, k):
        ok, ratio, _ = _check(_emulate(X, C, chunk), want, X, C)
        assert ok, (chunk, ratio)
        assert ratio < 0.25, (chunk, ratio)   # 3xTF32 sits far inside


def test_emulation_matches_pallas_interpret_on_floats():
    n, k, d = 64, 256, 24
    X, C = _floats(n, k, d, 7)
    want = jops.assign_centroids(jnp.asarray(X), jnp.asarray(C),
                                 force="interpret", bn=64, bk=128)
    for chunk in _chunks(n, k):
        ok, ratio, _ = _check(_emulate(X, C, chunk), want, X, C)
        assert ok, (chunk, ratio)


@pytest.mark.parametrize("n,k,d", [(100, 300, 8), (40, 260, 16),
                                   (33, 129, 5)])
def test_emulation_exact_on_integers(n, k, d):
    """Integer data: hi holds every value (lo = 0), the products and sums
    are exact, so every chunking equals the JAX oracle bit for bit."""
    X, C = _ints(n, k, d, n * k)
    want = jref.assign_centroids(jnp.asarray(X), jnp.asarray(C))
    for chunk in _chunks(n, k):
        gi, gd = _emulate(X, C, chunk)
        np.testing.assert_array_equal(gi, np.asarray(want[0]))
        np.testing.assert_array_equal(gd, np.asarray(want[1]))


def test_emulation_exact_on_integers_against_pallas_interpret():
    X, C = _ints(64, 256, 8, 3)
    want = jops.assign_centroids(jnp.asarray(X), jnp.asarray(C),
                                 force="interpret", bn=64, bk=128)
    for chunk in _chunks(64, 256):
        gi, gd = _emulate(X, C, chunk)
        np.testing.assert_array_equal(gi, np.asarray(want[0]))
        np.testing.assert_array_equal(gd, np.asarray(want[1]))


def test_tf32_alone_breaks_the_limit():
    """The planted fault: TF32 products alone (inputs rounded to 10
    mantissa bits) exceed the limit on SIFT-like data at d = 128, where
    3xTF32 stays far inside it."""
    g = torch.Generator().manual_seed(11)
    data = sift_like(768, 128, 16, generator=g).numpy()
    X, C = data[:512], data[512:]
    want = jref.assign_centroids(jnp.asarray(X), jnp.asarray(C))
    ok3, r3, _ = _check(_emulate(X, C, 128), want, X, C)
    ok1, r1, _ = _check(_emulate(X, C, 128, tf32_only=True), want, X, C)
    assert ok3 and r3 < 0.25, r3
    assert not ok1 and r1 > 1.0, r1


def test_tf32_rounding_is_to_nearest_ties_away():
    """tf32_rna on values with known 10-bit roundings (the kernel's
    ``cvt.rna``): below half rounds down, half rounds away, above rounds
    up, the sign is kept, and lo is what is left (exact)."""
    one = 1.0
    ulp = 2.0 ** -10
    vals = torch.tensor([one + 0.49 * ulp, one + 0.5 * ulp, one + 0.51 * ulp,
                         -(one + 0.5 * ulp), 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one, one + ulp, one + ulp, -(one + ulp), 3.0, 0.0])
    assert torch.equal(tf32_rna(vals), want)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32))
    hi, lo = split3(x)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert bool((rest <= 2.0 ** -21 * x.double().abs()).all())


@pytest.mark.parametrize("n,k", [(10_000, 16_384), (1_000_000, 16_384),
                                 (1_010_000, 256), (300, 77), (129, 200),
                                 (513, 1000), (1, 1), (10_000, 256)])
def test_split_plan_chunks_cover_centroids(n, k):
    plan = kac.split_plan(n, k, H100_SMS)
    assert plan.chunk % kac.COLS == 0 and plan.chunk >= kac.COLS
    assert plan.splits == -(-k // plan.chunk)
    assert (plan.splits - 1) * plan.chunk < k <= plan.splits * plan.chunk
    assert plan.rows in kac.ROWS
    assert plan.ctas == -(-n // plan.rows) * plan.splits


def test_split_plan_at_the_paths_shapes():
    """One chunk where the row tiles fill the card (n = 10^6, and PQ
    training's 1,010,000 x 256 at d = 16, on 64-row tiles): a single
    launch.  An ``add`` batch (n = 10^4) is cut so that pass 1 fills at
    least one wave of 128-row tiles."""
    big = kac.split_plan(1_000_000, 16_384, H100_SMS)
    assert big.splits == 1 and big.rows == 128
    pq = kac.split_plan(1_010_000, 256, H100_SMS)
    assert pq.splits == 1 and pq.rows == 64
    plan = kac.split_plan(10_000, 16_384, H100_SMS)
    assert plan.splits > 1 and plan.ctas >= H100_SMS and plan.rows == 128
    assert plan.splits <= kac.MAX_SPLITS
