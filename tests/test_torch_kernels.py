"""Port kernels' plain versions vs the JAX package's, on the CPU.

(The CUDA kernels are held against these plain versions on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.)

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: move scores within 1e-4·max|score| (ΔI cancels large terms, so
the error scales with the largest score, not each one); refine distances
rtol 1e-5 (plus 1e-6 of the largest squared norm, for the cancellation in
``||y||² + ||x||² − 2x·y``); merged ids exactly.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them as fast and
    leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gs_case(B, d, k, C, seed, empty=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, d)).astype(np.float32)
    D = (rng.standard_normal((k, d)) * 5).astype(np.float32)
    cnt = rng.integers(1, 9, size=k).astype(np.float32)
    cnt[:empty] = 0.0
    u = rng.integers(0, k, size=B).astype(np.int32)
    cand = rng.integers(0, k, size=(B, C)).astype(np.int32)
    return x, u, cand, D, cnt


def _rm_case(B, d, C, kappa, N, seed):
    rng = np.random.default_rng(seed)
    Xsrc = rng.standard_normal((N, d)).astype(np.float32)
    x = rng.standard_normal((B, d)).astype(np.float32)
    rows = rng.integers(0, N, size=(B, C)).astype(np.int32)
    cand = rows.copy()
    cand[rng.random((B, C)) < 0.2] = -1           # invalid candidates
    cand[:, 1] = cand[:, 0]                       # duplicate ids dedupe
    old_ids = rng.integers(0, N, size=(B, kappa)).astype(np.int32)
    old_ids[:, -2:] = -1                          # short lists
    old_d = np.sort(rng.random((B, kappa)).astype(np.float32) * 40, axis=1)
    old_d[:, -2:] = np.inf
    rows = np.maximum(rows, 0)
    return x, rows, cand, old_ids, old_d, Xsrc


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _assert_scores(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    scale = np.abs(want[fin]).max()
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("mode", ["bkm", "lloyd"])
@pytest.mark.parametrize("B,d,k,C", [(64, 24, 32, 9), (33, 100, 16, 5)])
def test_gather_score_ref_matches_jax(mode, B, d, k, C):
    args = _gs_case(B, d, k, C, B + d, empty=2)
    want = jref.gather_score(*map(jnp.asarray, args), mode=mode)
    got = tref.gather_score(*_t(*args), mode=mode)
    _assert_scores(got.numpy(), want)


@pytest.mark.parametrize("mode", ["bkm", "lloyd"])
def test_gather_score_ref_matches_pallas_interpret(mode):
    args = _gs_case(4, 8, 8, 3, 11, empty=1)
    want = jops.gather_score(*map(jnp.asarray, args), mode=mode,
                             force="interpret", tile=2)
    got = tops.gather_score(*_t(*args), mode=mode)
    _assert_scores(got.numpy(), want)


def _consistent_case(B, d, k, C, seed, empty=2):
    """Cluster sums that agree with the counts: k clusters of about 60
    SIFT-like rows, the first ``empty`` empty, the next one a singleton."""
    rng = np.random.default_rng(seed)
    n = 60 * k
    X = np.abs(rng.standard_normal((n, d)) * 4 + rng.standard_normal(d) * 4
               ) ** 1.5
    assign = rng.integers(empty + 1, k, size=n)
    assign[0] = empty
    D = np.zeros((k, d))
    np.add.at(D, assign, X)
    cnt = np.bincount(assign, minlength=k).astype(np.float32)
    idx = rng.integers(0, n, size=B)
    idx[0] = 0
    cand = assign[rng.integers(0, n, size=(B, C))]
    cand[::4, -1] = rng.integers(0, empty, size=cand[::4].shape[0])
    return (X[idx].astype(np.float32), assign[idx].astype(np.int32),
            cand.astype(np.int32), D.astype(np.float32), cnt)


@pytest.mark.parametrize("mode", ["bkm", "lloyd"])
def test_score_scale_limit_holds_and_catches_faults(mode):
    """Per element, |port - JAX| stays within 1e-5·score_scale, and the
    same limit rejects a wrong D row (and, in bkm, a dropped ||x||²)."""
    args = _consistent_case(48, 128, 32, 9, 21)
    want = np.asarray(jref.gather_score(*map(jnp.asarray, args), mode=mode))
    x, u, cand, D, cnt = _t(*args)
    got = tref.gather_score(x, u, cand, D, cnt, mode=mode)
    limit = 1e-5 * tref.score_scale(x, u, cand, D, cnt, mode=mode).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), fin)
    assert (np.abs(got.numpy()[fin] - want[fin]) <= limit[fin]).all()
    faults = [tref.gather_score(x, u, (cand + 1) % 32, D, cnt, mode=mode)]
    if mode == "bkm":
        rows = torch.cat([u[:, None], cand], 1).long()
        faults.append(tref.scores_from_dots(
            tref.gather_dots(x, rows, D), cnt[rows], (D * D).sum(-1)[rows],
            torch.zeros(x.shape[0]), mode))
    for bad in faults:
        both = fin & np.isfinite(bad.numpy())
        over = np.abs(bad.numpy()[both] - want[both]) > limit[both]
        assert over.mean() > 0.5, over.mean()


def _kernel_order_sums(a, rows, lanes):
    """sum(a * rows, -1) as the CUDA kernel adds it: float4 slice f of a row
    goes to lane f mod ``lanes`` of its row group, a lane sums its slices'
    4-term dots in slice order, and the group's lanes are added by an xor
    butterfly (lane 0's order).  a (B, d); rows (B, R, d) -> (B, R)."""
    B, R, d = rows.shape
    f4 = -(-d // 4)
    S = -(-f4 // lanes)
    pad = S * lanes * 4 - d
    prod = torch.nn.functional.pad(a[:, None, :] * rows, (0, pad))
    prod = prod.view(B, R, S, lanes, 4)
    dot4 = ((prod[..., 0] + prod[..., 1]) + prod[..., 2]) + prod[..., 3]
    acc = torch.zeros((B, R, lanes))
    for s in range(S):
        acc = acc + dot4[:, :, s]
    lane = torch.arange(lanes)
    o = lanes // 2
    while o:
        acc = acc + acc[..., lane ^ o]
        o //= 2
    return acc[..., 0]


def _gather_score_kernel_order(x, u, cand, D, cnt, mode):
    """The kernel's arithmetic in torch: x·v, v·v and x·x in its per-lane
    order at ``layout(d).lanes`` lanes a row, ||D_v||² from each gathered
    row (no hoisted (k,) norms), then scores_from_dots."""
    from repro_torch.kernels.gather_score import layout
    lanes = layout(x.shape[1]).lanes
    rows = torch.cat([u[:, None], cand], 1).long()
    G = D[rows]
    dots = _kernel_order_sums(x, G, lanes)
    dsq = _kernel_order_sums(G.flatten(0, 1), G.flatten(0, 1)[:, None],
                             lanes).view(dots.shape)
    xsq = _kernel_order_sums(x, x[:, None], lanes)[:, 0]
    return tref.scores_from_dots(dots, cnt[rows], dsq, xsq, mode)


@pytest.mark.parametrize("mode", ["bkm", "lloyd"])
@pytest.mark.parametrize("d", [24, 100, 128, 960])
def test_gather_score_row_norms_within_limit(mode, d):
    """||D_v||² taken from the gathered rows in the kernel's per-lane order
    (the CUDA kernel's design) stays within 1e-5·score_scale of the JAX
    plain version, whose norms are hoisted over all k rows; the planted
    faults (a wrong D row; in bkm ||x||² dropped) still fail that limit."""
    args = _consistent_case(48, d, 32, 9, 21 + d)
    want = np.asarray(jref.gather_score(*map(jnp.asarray, args), mode=mode))
    x, u, cand, D, cnt = _t(*args)
    got = _gather_score_kernel_order(x, u, cand, D, cnt, mode).numpy()
    limit = 1e-5 * tref.score_scale(x, u, cand, D, cnt, mode=mode).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    assert (np.abs(got[fin] - want[fin]) <= limit[fin]).all()
    faults = [_gather_score_kernel_order(x, u, (cand + 1) % 32, D, cnt,
                                         mode)]
    if mode == "bkm":
        from repro_torch.kernels.gather_score import layout
        rows = torch.cat([u[:, None], cand], 1).long()
        G = D[rows]
        faults.append(tref.scores_from_dots(
            _kernel_order_sums(x, G, layout(d).lanes), cnt[rows],
            (G * G).sum(-1), torch.zeros(x.shape[0]), mode))
    for bad in faults:
        bad = bad.numpy()
        both = fin & np.isfinite(bad)
        over = np.abs(bad[both] - want[both]) > limit[both]
        assert over.mean() > 0.5, over.mean()


def _assert_refine(got, want, x, Xsrc):
    gi, gd = (np.asarray(a) for a in got)
    wi, wd = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi, wi)
    scale = max(float((x * x).sum(1).max()), float((Xsrc * Xsrc).sum(1).max()))
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("B,d,C,kappa,N", [(40, 16, 24, 10, 300),
                                           (17, 130, 9, 12, 64)])
def test_refine_merge_ref_matches_jax(B, d, C, kappa, N):
    args = _rm_case(B, d, C, kappa, N, B * C)
    want = jref.refine_merge(*map(jnp.asarray, args))
    got = tref.refine_merge(*_t(*args))
    _assert_refine(got, want, args[0], args[-1])


def test_refine_merge_ref_matches_pallas_interpret():
    args = _rm_case(4, 8, 5, 4, 32, 3)
    want = jops.refine_merge(*map(jnp.asarray, args), force="interpret",
                             tile=2)
    got = tops.refine_merge(*_t(*args))
    _assert_refine(got, want, args[0], args[-1])


def test_merge_lists_matches_jax_with_ties():
    """Exact on integer-valued distances, where ties are everywhere: the
    first-minimum position rule and the retire-all-copies dedupe decide."""
    rng = np.random.default_rng(5)
    B, kappa, C = 32, 8, 12
    old_ids = rng.integers(-1, 10, size=(B, kappa)).astype(np.int32)
    old_d = rng.integers(0, 6, size=(B, kappa)).astype(np.float32)
    cand = rng.integers(-1, 10, size=(B, C)).astype(np.int32)
    cd = rng.integers(0, 6, size=(B, C)).astype(np.float32)
    wi, wd = jref.merge_lists(*map(jnp.asarray, (old_ids, old_d, cand, cd)),
                              kappa)
    gi, gd = tref.merge_lists(*_t(old_ids, old_d, cand, cd), kappa)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def test_refine_merge_ref_hoisted_norms_equal():
    x, rows, cand, oi, od, Xsrc = _t(*_rm_case(8, 16, 6, 5, 50, 9))
    a = tref.refine_merge(x, rows, cand, oi, od, Xsrc)
    b = tref.refine_merge(x, rows, cand, oi, od, Xsrc,
                          ysq=(Xsrc * Xsrc).sum(-1))
    for p, q in zip(a, b):
        assert torch.equal(p, q)
