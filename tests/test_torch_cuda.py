"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels build at first
use) and skips without one; the decision is taken inside each test.  This
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: scores within 1e-5·``ref.score_scale`` element by element (the
size of the terms that cancel in each score); refine distances rtol 1e-5 +
1e-6·max squared norm, ids exact; centroid and scan distances within
1e-5·(||x||² + ||c||²) of each selected pair, ids equal except where the two
selected distances agree within that limit; within-cluster distances
(``pairwise_sq``) within 1e-5·(||x_i||² + ||x_j||²) element by element; on
integer data everything exact.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc there)")
    return torch.device("cuda")


def _gs_case(B, d, k, C, seed, dev, empty=3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, d, generator=g)
    D = torch.randn(k, d, generator=g) * 5
    cnt = torch.randint(1, 9, (k,), generator=g).float()
    cnt[:empty] = 0.0
    u = torch.randint(0, k, (B,), generator=g, dtype=torch.int32)
    cand = torch.randint(0, k, (B, C), generator=g, dtype=torch.int32)
    return [t.to(dev) for t in (x, u, cand, D, cnt)]


def _rm_case(B, d, C, kappa, N, seed, dev, integer=False):
    g = torch.Generator().manual_seed(seed)
    if integer:        # integer coordinates: exact distances, many ties
        Xsrc = torch.randint(0, 3, (N, d), generator=g).float()
        x = torch.randint(0, 3, (B, d), generator=g).float()
    else:
        Xsrc = torch.randn(N, d, generator=g)
        x = torch.randn(B, d, generator=g)
    rows = torch.randint(0, N, (B, C), generator=g, dtype=torch.int32)
    cand = torch.where(torch.rand(B, C, generator=g) < 0.2, -1, rows)
    if C > 1:
        cand[:, 1] = cand[:, 0]
    old_ids = torch.randint(0, N, (B, kappa), generator=g, dtype=torch.int32)
    old_ids[:, -2:] = -1
    old_d = torch.sort(torch.rand(B, kappa, generator=g) * 40, 1).values
    old_d[:, -2:] = float("inf")
    if integer:
        old_d = old_d.round()
    return [t.contiguous().to(dev) for t in
            (x, rows, cand.to(torch.int32), old_ids, old_d, Xsrc)]


def _assert_scores(got, want, args, mode):
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(got[~fin], want[~fin])
    limit = 1e-5 * ref.score_scale(*args, mode=mode)
    ratio = float(((got - want).abs() / limit)[fin].max())
    assert ratio <= 1.0, ratio


def _assert_refine(got, want, x, Xsrc):
    gi, gd = got
    wi, wd = want
    assert torch.equal(gi, wi)
    scale = float((x * x).sum(1).max()) + float((Xsrc * Xsrc).sum(1).max())
    fin = torch.isfinite(wd)
    assert torch.equal(torch.isfinite(gd), fin)
    assert bool(((gd[fin] - wd[fin]).abs()
                 <= 1e-5 * wd[fin].abs() + 1e-6 * scale).all())


@pytest.mark.parametrize("mode", ["bkm", "lloyd"])
@pytest.mark.parametrize("d", [128, 100, 37, 1100])
def test_gather_score_kernel_matches_plain(dev, mode, d):
    args = _gs_case(257, d, 64, 11, d, dev)
    before = _build.launch_counts["gather_score"]
    got = ops.gather_score(*args, mode=mode)
    want = ops.gather_score(*args, mode=mode, force="ref")
    torch.cuda.synchronize()
    assert _build.launch_counts["gather_score"] == before + 1
    _assert_scores(got, want, args, mode)


@pytest.mark.parametrize("mode", ["bkm", "lloyd"])
@pytest.mark.parametrize("B,C,d", [(1, 1, 128), (257, 6, 960), (33, 1, 37),
                                   (64, 300, 24), (5, 50, 1100),
                                   (1024, 50, 128), (3, 13, 130)])
def test_gather_score_kernel_layout_edges(dev, mode, B, C, d):
    """The row layout's edges: GIST1M's width (32 lanes a row, 8 slices a
    lane), d % 4 != 0, C = 1, C + 1 not a multiple of the rows a warp holds,
    C past one 256-row chunk, B odd (a CTA holds two samples) and the
    re-read path past d = 1024; out-of-range ids score NaN (a bad source
    cluster NaNs its sample's row in bkm), empty clusters +inf in lloyd.
    One launch per call."""
    from repro_torch.kernels.gather_score import layout
    lay = layout(d)
    assert lay.samples_per_cta == 2 and lay.lanes * lay.rows_per_warp == 32
    x, u, cand, D, cnt = _gs_case(B, d, 64, C, B + C + d, dev)
    cand[1::3, -1] = 0                       # an empty cluster
    bad_c, bad_u = cand.clone(), u.clone()
    bad_c[::7, 0] = 64                       # past k
    bad_c[B // 2, -1] = -1
    bad_u[B - 1] = 70
    before = _build.launch_counts["gather_score"]
    got = ops.gather_score(x, bad_u, bad_c, D, cnt, mode=mode)
    torch.cuda.synchronize()
    assert _build.launch_counts["gather_score"] == before + 1
    # the plain version indexes D by the ids, so it runs on the valid ids
    nan = (bad_c != cand)
    if mode == "bkm":
        nan |= (bad_u != u)[:, None]
    assert torch.equal(torch.isnan(got), nan)
    args = (x, u, cand, D, cnt)
    want = ops.gather_score(*args, mode=mode, force="ref")
    if mode == "lloyd" and B > 1:
        assert bool(torch.isinf(want).any())  # the empty clusters
    keep = ~nan
    fin = torch.isfinite(want) & keep
    assert torch.equal(torch.isfinite(got) & keep, fin)
    assert torch.equal(got[keep & ~fin], want[keep & ~fin])
    limit = 1e-5 * ref.score_scale(*args, mode=mode)
    assert bool(((got - want).abs()[fin] <= limit[fin]).all())


@pytest.mark.parametrize("d,C,kappa", [(128, 136, 50), (37, 9, 12),
                                       (960, 40, 64), (1100, 5, 3)])
def test_refine_merge_kernel_matches_plain(dev, d, C, kappa):
    args = _rm_case(129, d, C, kappa, 2000, d + C, dev)
    before = _build.launch_counts["refine_merge"]
    got = ops.refine_merge(*args)
    want = ops.refine_merge(*args, force="ref")
    torch.cuda.synchronize()
    assert _build.launch_counts["refine_merge"] == before + 1
    _assert_refine(got, want, args[0], args[-1])


def test_refine_merge_kernel_ties_exact(dev):
    """Integer data: every distance is exact and ties are everywhere, so the
    first-minimum rule and the dedupe decide, bit for bit."""
    args = _rm_case(200, 16, 40, 20, 300, 7, dev, integer=True)
    gi, gd = ops.refine_merge(*args)
    wi, wd = ops.refine_merge(*args, force="ref")
    torch.cuda.synchronize()
    assert torch.equal(gi, wi) and torch.equal(gd, wd)


@pytest.mark.parametrize("C", [1, 31, 33, 127, 129, 200])
@pytest.mark.parametrize("kappa", [1, 50, 64])
def test_refine_merge_kernel_matches_plain_off_multiples(dev, C, kappa):
    """C off the warp (32) and CTA (128) multiples, so the staging, the
    8-row batches and the merge's padding to a power of two all have
    ragged ends; κ at its extremes (the kernel runs for κ <= 64)."""
    args = _rm_case(70, 24, C, kappa, 500, C * 100 + kappa, dev)
    got = ops.refine_merge(*args)
    want = ops.refine_merge(*args, force="ref")
    torch.cuda.synchronize()
    _assert_refine(got, want, args[0], args[-1])


def test_refine_merge_kernel_largest_merge(dev):
    """The largest κ + C the kernel merges (4,096 entries a row), on
    integer data (exact, tie-heavy), and one entry more is refused."""
    from repro_torch.kernels.refine_merge import MAX_L
    args = _rm_case(9, 8, MAX_L - 64, 64, 3000, 11, dev, integer=True)
    gi, gd = ops.refine_merge(*args)
    wi, wd = ops.refine_merge(*args, force="ref")
    torch.cuda.synchronize()
    assert torch.equal(gi, wi) and torch.equal(gd, wd)
    args = _rm_case(2, 8, MAX_L - 63, 64, 300, 12, dev)
    with pytest.raises(ValueError, match="4096"):
        ops.refine_merge(*args)


@pytest.mark.parametrize("kappa,C", [(50, 136), (1, 40), (64, 129)])
def test_refine_merge_kernel_dedupe_ties_exact(dev, kappa, C):
    """Integer data with ids drawn from a small range: duplicate ids within
    and across the old and candidate lists, equal distances between them,
    -1 ids and +inf old entries, and rows whose lists run out."""
    x, rows, cand, old_ids, old_d, Xsrc = _rm_case(300, 8, C, kappa, 400,
                                                   kappa + C, dev,
                                                   integer=True)
    g = torch.Generator().manual_seed(kappa)
    cand = torch.randint(-1, 12, cand.shape, generator=g,
                         dtype=torch.int32).to(dev)
    old_ids = torch.randint(-1, 12, old_ids.shape, generator=g,
                            dtype=torch.int32).to(dev)
    args = (x, rows, cand, old_ids, old_d, Xsrc)
    gi, gd = ops.refine_merge(*args)
    wi, wd = ops.refine_merge(*args, force="ref")
    torch.cuda.synchronize()
    assert torch.equal(gi, wi) and torch.equal(gd, wd)
    if kappa > 12:                # more slots than the 12 ids: lists run out
        assert bool((wi == -1).any())


def test_gk_means_kernels_match_ref_on_card(dev):
    from repro_torch.core.gkmeans import gk_means
    from repro_torch.data import gmm_blobs
    X = gmm_blobs(4096, 32, 64, generator=torch.Generator(dev).manual_seed(1))
    out = []
    for force in (None, "ref"):
        out.append(gk_means(X, 64, kappa=16, xi=32, tau=3, iters=8,
                            generator=torch.Generator().manual_seed(0),
                            force=force, device=dev))
    a, b = out
    assert abs(a.distortion - b.distortion) <= 0.01 * b.distortion
    assert np.isfinite(a.history).all()


# ------------------------------- baselines, probe and descent sources, search

def _blobs4k(dev):
    from repro_torch.data import gmm_blobs
    return gmm_blobs(4096, 32, 64, generator=torch.Generator(dev).manual_seed(2))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _baseline_run(path, X, force):
    """(final distortion, the path's kernels) of one baseline path."""
    from repro_torch.core import (closure_kmeans, engine, gk_means, lloyd,
                                  minibatch_kmeans, nn_descent)
    from repro_torch.core.gkmeans import _tree_init
    from repro_torch.core.objective import distortion
    dev = X.device
    if path == "kgraph_gk_means":
        # one graph for both runs, built outside the counted path (its own
        # kernel is held on recall in test_nn_descent_kernels_...)
        g = nn_descent(X, 16, iters=6, generator=_gen(1), force="ref",
                       device=dev)
        return gk_means(X, 64, graph=g, iters=8, generator=_gen(2),
                        force=force, device=dev).distortion, (
            "gather_score",)
    if path == "lloyd":
        return lloyd(X, 64, iters=10, generator=_gen(3), force=force,
                     device=dev)[2][-1], ("assign_centroids",)
    if path == "minibatch":
        a, _ = minibatch_kmeans(X, 64, steps=40, batch_size=256,
                                generator=_gen(4), force=force, device=dev)
        return float(distortion(X, a, 64)), ("assign_centroids",)
    if path == "probe_source":
        a0 = _tree_init(X, 64, _gen(5))
        res = engine.run(X, engine.init_state(X, a0, 64),
                         engine.probe_source(8), engine.EngineConfig(
                             batch_size=512, iters=5, min_move_frac=-1.0,
                             force=force), generator=_gen(6))
        return float(res.final), ("probe_centroids", "gather_score")
    return closure_kmeans(X, 64, iters=6, leaf=16, batch_size=512,
                          generator=_gen(7), force=force, device=dev)[2][-1], (
        "gather_score",)


@pytest.mark.parametrize("path", ["kgraph_gk_means", "lloyd", "minibatch",
                                  "probe_source", "closure"])
def test_baseline_kernels_match_ref_on_card(dev, path):
    """Each baseline path through its kernels and with force="ref" from
    equal generators: final distortion within 1%; every kernel of the path
    launched in the kernel run and none in the plain one."""
    X = _blobs4k(dev)
    _build.reset_launch_counts()
    got, names = _baseline_run(path, X, None)
    launched = dict(_build.launch_counts)
    _build.reset_launch_counts()
    want, _ = _baseline_run(path, X, "ref")
    assert not any(_build.launch_counts.values())
    assert all(launched[name] > 0 for name in names), launched
    assert abs(got - want) <= 0.01 * want, (got, want)


def test_nn_descent_kernels_match_ref_on_card(dev):
    """Recall@κ within 0.02 of the plain run from equal generators; on
    integer data the two descent builds are equal bit for bit."""
    from repro_torch.core import brute_force_knn, nn_descent, recall_at
    from repro_torch.core.graph_build import GraphBuildConfig, build_graph
    X = _blobs4k(dev)
    gt = brute_force_knn(X, 16)
    rec = [float(recall_at(nn_descent(X, 16, iters=6, generator=_gen(1),
                                      force=force, device=dev).ids, gt, 16))
           for force in (None, "ref")]
    assert abs(rec[0] - rec[1]) <= 0.02, rec
    Xi = torch.randint(0, 4, (3000, 8), generator=_gen(9)).float().to(dev)
    cfg = GraphBuildConfig(kappa=12, source="descent", tau=3, chunk=700)
    got, _ = build_graph(Xi, cfg, generator=_gen(3))
    want, _ = build_graph(Xi, cfg._replace(force="ref"), generator=_gen(3))
    assert torch.equal(got.ids, want.ids) and torch.equal(got.dist,
                                                          want.dist)


def test_minibatch_final_assignment_matches_plain(dev):
    from repro_torch.core import minibatch_kmeans
    X = _blobs4k(dev)
    a, C = minibatch_kmeans(X, 64, steps=40, batch_size=256,
                            generator=_gen(4), device=dev)
    ga = ops.assign_centroids(X, C)
    assert torch.equal(ga[0], a)
    wa = ref.assign_centroids(X, C)
    _assert_sel((ga[0][:, None], ga[1][:, None]),
                (wa[0][:, None], wa[1][:, None]),
                _pair_scale(X, C, wa[0][:, None]))


def test_graph_search_on_card_matches_cpu(dev):
    """No kernel: the card's search against the CPU's with the same
    beacons, at least 99% of the ids equal (float sums in another order
    can flip a near-tie in the pool); distances exact for the ids
    returned (rtol 1e-5)."""
    from repro_torch.core import build_knn_graph, graph_search
    X = _blobs4k(dev)
    g = build_knn_graph(X, 16, xi=32, tau=3, generator=_gen(0), device=dev)
    Q = X[:256] + 0.1 * torch.randn(256, 32, generator=torch.Generator(
        dev).manual_seed(5), device=dev)
    beacons = torch.randint(0, 4096, (256, 8 * 16), generator=_gen(6))
    gi, gd = graph_search(X, g.ids, Q, 5, 16, 12, beacons=beacons,
                          device=dev)
    ci, cd = graph_search(X.cpu(), g.ids.cpu(), Q.cpu(), 5, 16, 12,
                          beacons=beacons, device="cpu")
    exact = ((X[gi.long()] - Q[:, None, :]) ** 2).sum(-1)
    assert torch.allclose(gd, exact, rtol=1e-5, atol=1e-5)
    same = (gi.cpu() == ci).float().mean()
    assert float(same) >= 0.99, float(same)


def test_probe_source_above_the_kernel_cap_raises(dev):
    from repro_torch.core import engine
    with pytest.raises(ValueError, match="p <= 128"):
        engine.probe_source(129)
    X, C = _centroid_case(64, 300, 16, 0, dev)
    with pytest.raises(ValueError):
        ops.probe_centroids(X, C, 129)


# ------------------------------------------------- IVF kernels (centroids, scan)

def _assert_sel(got, want, scale):
    """Distances within 1e-5·scale per element (scale: the size of the
    terms that cancel, ||x||² + ||c||² of that element); ids equal except
    where the two selected distances agree within that limit; -1/+inf
    slots equal."""
    gi, gd = got
    wi, wd = want
    lim = 1e-5 * scale
    fin = torch.isfinite(wd)
    assert torch.equal(torch.isfinite(gd), fin)
    assert torch.equal(gi[~fin], wi[~fin])
    gap = (gd - wd).abs()
    assert bool((gap[fin] <= lim[fin]).all()), float((gap / lim)[fin].max())
    assert bool(((gi == wi) | (fin & (gap <= lim))).all())


def _centroid_case(n, k, d, seed, dev, integer=False):
    g = torch.Generator().manual_seed(seed)
    if integer:        # integer coordinates: exact partials, ties everywhere
        X = torch.randint(0, 3, (n, d), generator=g).float()
        C = torch.randint(0, 3, (k, d), generator=g).float()
    else:
        X = torch.randn(n, d, generator=g) * 3
        C = torch.randn(k, d, generator=g) * 3
    return X.to(dev), C.to(dev)


def _pair_scale(X, C, ids):
    """||x||² + ||c||² of each selected (row, centroid) pair."""
    return (X * X).sum(-1)[:, None] + (C * C).sum(-1)[ids.long().clamp(min=0)]


@pytest.mark.parametrize("n,k,d", [(300, 77, 128), (129, 200, 37),
                                   (513, 1000, 100)])
def test_assign_centroids_kernel_matches_plain(dev, n, k, d):
    X, C = _centroid_case(n, k, d, n + k, dev)
    before = _build.launch_counts["assign_centroids"]
    ga, gd = ops.assign_centroids(X, C)
    wa, wd = ops.assign_centroids(X, C, force="ref")
    torch.cuda.synchronize()
    assert _build.launch_counts["assign_centroids"] == before + 1
    _assert_sel((ga[:, None], gd[:, None]), (wa[:, None], wd[:, None]),
                _pair_scale(X, C, wa[:, None]))


@pytest.mark.parametrize("n", [1, 129, 10_000])
@pytest.mark.parametrize("k", [1, 7, 256, 16_384])
@pytest.mark.parametrize("d", [4, 16, 37, 128])
def test_assign_centroids_tc_kernel_grid(dev, n, k, d):
    """The 3xTF32 kernel over K padded to 8 (d = 4, 37), PQ's d = 16, one
    centroid, a partial tile, the 64-row tiles (k <= 256) and 128-row ones,
    one row, a ragged row tile and an ``add`` batch."""
    X, C = _centroid_case(n, k, d, n + k + d, dev)
    ga, gd = ops.assign_centroids(X, C)
    wa, wd = ops.assign_centroids(X, C, force="ref")
    torch.cuda.synchronize()
    assert bool(((ga >= 0) & (ga < k)).all())
    _assert_sel((ga[:, None], gd[:, None]), (wa[:, None], wd[:, None]),
                _pair_scale(X, C, wa[:, None]))


def _assign_at(monkeypatch, sms, X, C):
    """ops.assign_centroids with the split plan computed for ``sms``
    SMs."""
    monkeypatch.setattr(_build, "sm_count", lambda i: sms)
    try:
        return ops.assign_centroids(X, C)
    finally:
        monkeypatch.undo()


def _device_launches(fn, names, tries=5):
    """Device launches of the kernels ``names`` in one call of ``fn``, from
    a torch.profiler trace (retaken when a trace comes back empty)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    count = 0
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        count = sum(1 for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA
                    and any(name in ev.name for name in names))
        if count:
            break
    return count


@pytest.mark.parametrize("n,k,d", [(10_000, 16_384, 128), (300, 1000, 37),
                                   (129, 256, 16), (200, 700, 4)])
def test_assign_centroids_split_bit_equal(dev, monkeypatch, n, k, d):
    """S = 1 (plan for 1 SM), the card's own plan and S forced high (plan
    for 10,000 SMs): ids and d2 equal bit for bit, and match the plain
    version; one device launch a call at S = 1, two when the plan splits
    (pass 1 and the merge), one wrapper call counted either way."""
    from repro_torch.kernels.assign_centroids import split_plan
    X, C = _centroid_case(n, k, d, n * 3 + d, dev)
    assert split_plan(n, k, 1).splits == 1
    assert split_plan(n, k, 10_000).splits > 1
    before = _build.launch_counts["assign_centroids"]
    outs = [_assign_at(monkeypatch, sms, X, C)
            for sms in (1, _sms(), 10_000)]
    torch.cuda.synchronize()
    assert _build.launch_counts["assign_centroids"] == before + 3
    for got in outs[1:]:
        assert torch.equal(got[0], outs[0][0])
        assert torch.equal(got[1], outs[0][1])
    wa, wd = ops.assign_centroids(X, C, force="ref")
    _assert_sel((outs[0][0][:, None], outs[0][1][:, None]),
                (wa[:, None], wd[:, None]), _pair_scale(X, C, wa[:, None]))
    names = ("assign_tc_kernel", "assign_merge_kernel")
    for sms in (1, 10_000):
        splits = split_plan(n, k, sms).splits
        got = _device_launches(lambda: _assign_at(monkeypatch, sms, X, C),
                               names)
        assert got == 1 + (splits > 1), (sms, splits, got)


@pytest.mark.parametrize("n,k,d,p", [(300, 77, 128, 16), (129, 200, 37, 64),
                                     (257, 300, 24, 128), (10, 5, 8, 5)])
def test_probe_centroids_kernel_matches_plain(dev, n, k, d, p):
    X, C = _centroid_case(n, k, d, n + p, dev)
    before = _build.launch_counts["probe_centroids"]
    got = ops.probe_centroids(X, C, p)
    want = ops.probe_centroids(X, C, p, force="ref")
    torch.cuda.synchronize()
    assert _build.launch_counts["probe_centroids"] == before + 1
    _assert_sel(got, want, _pair_scale(X, C, want[0]))


def _sms():
    return _build.sm_count(torch.cuda.current_device())


@pytest.mark.parametrize("n,k,d,p", [(64, 16384, 128, 16),
                                     (10, 5000, 24, 128),
                                     (200, 3000, 37, 16),
                                     (200, 3000, 37, 64)])
def test_probe_centroids_split_matches_plain(dev, n, k, d, p):
    """Shapes whose split plan has several centroid chunks (two launches
    per call): the served batch, p=128 with a partial last tile, and
    d=37 (4-byte copies)."""
    from repro_torch.kernels.centroid_assign import split_plan
    assert split_plan(n, k, p, _sms()).splits > 1
    X, C = _centroid_case(n, k, d, n + p, dev)
    before = _build.launch_counts["probe_centroids"]
    got = ops.probe_centroids(X, C, p)
    want = ops.probe_centroids(X, C, p, force="ref")
    torch.cuda.synchronize()
    assert _build.launch_counts["probe_centroids"] == before + 1
    _assert_sel(got, want, _pair_scale(X, C, want[0]))


@pytest.mark.parametrize("n,k,d,seed,repeat", [(300, 260, 16, 4, False),
                                               (64, 3000, 16, 5, True),
                                               (200, 5000, 8, 6, True)])
def test_centroid_kernels_ties_exact(dev, n, k, d, seed, repeat):
    """Integer data: the partials are exact and tie everywhere, so the
    first-minimum rule decides, bit for bit.  The split shapes repeat the
    centroid before every 64-centroid boundary after it, so equal partials
    straddle each chunk boundary of the probe's plan."""
    from repro_torch.kernels.centroid_assign import UNIT, split_plan
    X, C = _centroid_case(n, k, d, seed, dev, integer=True)
    if repeat:
        at = torch.arange(UNIT, k, UNIT, device=dev)
        C[at] = C[at - 1]
        assert split_plan(n, k, 64, _sms()).splits > 1
    for p in (1, 7, 64):
        gi, gd = ops.probe_centroids(X, C, p)
        wi, wd = ops.probe_centroids(X, C, p, force="ref")
        torch.cuda.synchronize()
        assert torch.equal(gi, wi) and torch.equal(gd, wd)
    ga, gd = ops.assign_centroids(X, C)
    wa, wd = ops.assign_centroids(X, C, force="ref")
    assert torch.equal(ga, wa) and torch.equal(gd, wd)


def _small_index(dev, d, integer=False, n=3000, k=40, block_rows=32):
    from repro_torch import index as ivf
    X, C = _centroid_case(n, k, d, d + k, dev, integer)
    a, _ = ops.assign_centroids(X, C, force="ref")

    class R:
        assign, centroids = a, C
    R.k = k
    index = ivf.build_ivf(X, R, block_rows=block_rows, device=dev)
    return X, ivf.remove(index, torch.arange(0, n, 7))   # tombstones too


def _tile_map(index, Q, nprobe):
    from repro_torch import index as ivf
    cids, _ = ops.probe_centroids(Q, index.centroids, nprobe, force="ref")
    return ivf.build_tile_map(cids, index.starts, index.caps,
                              max_tiles=index.max_list_tiles,
                              block_rows=index.block_rows,
                              null_tile=index.null_tile)


@pytest.mark.parametrize("d,nprobe,topk,raw", [(128, 4, 10, False),
                                               (128, 1, 200, False),
                                               (37, 3, 16, True),
                                               (24, 40, 1024, False)])
def test_ivf_scan_kernel_matches_plain(dev, d, nprobe, topk, raw):
    X, index = _small_index(dev, d)
    Q = (X[:65] + 0.1 * torch.randn(65, d, device=dev)).contiguous()
    tm = _tile_map(index, Q, nprobe)
    before = _build.launch_counts["ivf_scan"]
    kw = dict(block_rows=index.block_rows, topk=topk, raw=raw)
    got = ops.ivf_scan(Q, index.vecs, index.ids, tm, **kw)
    want = ops.ivf_scan(Q, index.vecs, index.ids, tm, force="ref", **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts["ivf_scan"] == before + 1
    _assert_sel(got, want, _pair_scale(Q, X, want[0]))   # id i is row i
    if nprobe == 1:
        assert bool((got[0] == -1).any())      # lists exhausted


def test_ivf_scan_kernel_ties_exact(dev):
    X, index = _small_index(dev, 16, integer=True)
    Q = X[:64].contiguous()
    tm = _tile_map(index, Q, 5)
    kw = dict(block_rows=index.block_rows, topk=20)
    gi, gd = ops.ivf_scan(Q, index.vecs, index.ids, tm, **kw)
    wi, wd = ops.ivf_scan(Q, index.vecs, index.ids, tm, force="ref", **kw)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi) and torch.equal(gd, wd)


def _scan_at(monkeypatch, sms, Q, index, tm, **kw):
    """ops.ivf_scan with the split plan computed for ``sms`` SMs."""
    monkeypatch.setattr(_build, "sm_count", lambda i: sms)
    try:
        return ops.ivf_scan(Q, index.vecs, index.ids, tm,
                            block_rows=index.block_rows, **kw)
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("d,nprobe,topk,raw", [(128, 6, 10, False),
                                               (37, 3, 16, True),
                                               (24, 12, 100, False)])
def test_ivf_scan_split_matches_plain(dev, monkeypatch, d, nprobe, topk,
                                      raw):
    """The same queries at S = 1 (plan for 1 SM), at the card's own plan
    and with S forced high (plan for 10,000 SMs, mostly one live slot a
    chunk): every plan gives the same lists bit for bit, and they match the
    plain version."""
    from repro_torch.kernels.ivf_scan import split_plan
    X, index = _small_index(dev, d)
    Q = (X[:40] + 0.1 * torch.randn(40, d, device=dev)).contiguous()
    tm = _tile_map(index, Q, nprobe)
    kw = dict(topk=topk, raw=raw)
    assert split_plan(40, tm.shape[1], topk, 1).splits == 1
    assert split_plan(40, tm.shape[1], topk, 10_000).splits > 8
    outs = [_scan_at(monkeypatch, sms, Q, index, tm, **kw)
            for sms in (1, _sms(), 10_000)]
    want = ops.ivf_scan(Q, index.vecs, index.ids, tm, force="ref",
                        block_rows=index.block_rows, **kw)
    torch.cuda.synchronize()
    for got in outs[1:]:
        assert torch.equal(got[0], outs[0][0])
        assert torch.equal(got[1], outs[0][1])
    _assert_sel(outs[0], want, _pair_scale(Q, X, want[0]))


@pytest.mark.parametrize("sms", [1, 132, 10_000])
def test_ivf_scan_split_ties_exact(dev, monkeypatch, sms):
    """Integer data and a map that repeats two live tiles in turn, with
    null-tile runs between: every chunk boundary has equal partials on
    both sides, so chunk order decides the ties, bit for bit."""
    X, index = _small_index(dev, 16, integer=True)
    Q = X[:24].contiguous()
    tm = _tile_map(index, Q, 3)
    live = (index.ids.view(-1, index.block_rows) >= 0).any(1)
    a, b = [int(t) for t in torch.nonzero(live)[:2, 0]]
    pat = torch.tensor([a, b, index.null_tile, index.null_tile, a, b, b, a],
                       dtype=torch.int32, device=dev)
    tm = torch.cat([tm, pat.repeat(24, 3)], 1).contiguous()
    kw = dict(topk=40)
    gi, gd = _scan_at(monkeypatch, sms, Q, index, tm, **kw)
    wi, wd = ops.ivf_scan(Q, index.vecs, index.ids, tm, force="ref",
                          block_rows=index.block_rows, **kw)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi) and torch.equal(gd, wd)


@pytest.mark.parametrize("nq", [5, 300])
def test_exhaustive_search_kernel_matches_plain(dev, nq):
    """exhaustive_search's map (T = every tile of the slab, more than one
    1,024-slot segment) at a split plan (5 queries) and at S = 1."""
    from repro_torch import index as ivf
    X, index = _small_index(dev, 16, n=12_000, k=30, block_rows=8)
    assert index.capacity_rows // index.block_rows > 1024
    Q = (X[:nq] + 0.1 * torch.randn(nq, 16, device=dev)).contiguous()
    before = _build.launch_counts["ivf_scan"]
    got = ivf.exhaustive_search(index, Q, topk=10)
    want = ivf.exhaustive_search(index, Q, topk=10, force="ref")
    torch.cuda.synchronize()
    assert _build.launch_counts["ivf_scan"] == before + 1
    _assert_sel(got, want, _pair_scale(Q, X, want[0]))


def test_search_kernels_match_plain_on_card(dev):
    from repro_torch import index as ivf
    X, index = _small_index(dev, 32)
    Q = (X[:100] + 0.05 * torch.randn(100, 32, device=dev)).contiguous()
    for nprobe in (1, 8, 40):
        before = dict(_build.launch_counts)
        gi, gd = ivf.search(index, Q, topk=10, nprobe=nprobe)
        wi, wd = ivf.search(index, Q, topk=10, nprobe=nprobe, force="ref")
        torch.cuda.synchronize()
        assert _build.launch_counts["probe_centroids"] == \
            before["probe_centroids"] + 1
        assert _build.launch_counts["ivf_scan"] == before["ivf_scan"] + 1
        _assert_sel((gi, gd), (wi, wd), _pair_scale(Q, X, wi))


# --------------------------------------- compressed-list and grouped scans

def _adc_scale(lut, vnorm, codes, pos):
    """vnorm + Σ_m |lut[m, code[m]]| of each selected row: the size of the
    terms an ADC partial sums."""
    p = pos.long().clamp(min=0)
    c = codes[p].long()                                   # (q, k, M)
    if lut.shape[2] == 1:
        terms = lut[:, None, :, 0] * c.float()
    else:
        terms = torch.gather(lut[:, None].expand(-1, c.shape[1], -1, -1), 3,
                             c[..., None])[..., 0]
    return vnorm[p].abs() + terms.abs().sum(-1)


def _codec_index(dev, d, kind, nsub):
    from repro_torch import index as ivf
    X, index = _small_index(dev, d)
    return X, ivf.quantize_index(index, kind, nsub=nsub, iters=2,
                                 generator=torch.Generator().manual_seed(d))


@pytest.mark.parametrize("kind,d,nsub,nprobe,topk", [
    ("int8", 128, 0, 4, 40), ("pq", 128, 8, 4, 40), ("pq", 128, 32, 3, 10),
    ("int8", 37, 0, 2, 16), ("pq", 24, 4, 40, 1024), ("pq", 24, 6, 1, 100)])
def test_ivf_scan_adc_kernel_matches_plain(dev, kind, d, nsub, nprobe, topk):
    """int8 at M=128 and 37 (16-byte and 1-byte code loads), PQ at nsub 8
    (8-byte loads), 32 (a 32 KB table), 4 and 6 (4-byte and 1-byte loads);
    topk up to 1024, and past the candidates at nprobe=1."""
    from repro_torch.index import quantize as q
    X, index = _codec_index(dev, d, kind, nsub)
    Q = (X[:65] + 0.1 * torch.randn(65, d, device=dev)).contiguous()
    tm = _tile_map(index, Q, nprobe)
    lut, qc = q.build_lut(index.codec, Q)
    args = (lut, qc, index.vnorm, index.codes, index.ids, tm)
    kw = dict(block_rows=index.block_rows, topk=topk)
    before = _build.launch_counts["ivf_scan_adc"]
    gi, gp, gd = ops.ivf_scan_adc(*args, **kw)
    wi, wp, wd = ops.ivf_scan_adc(*args, force="ref", **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts["ivf_scan_adc"] == before + 1
    scale = _adc_scale(lut, index.vnorm, index.codes, wp) + qc.abs()[:, None]
    _assert_sel((gp, gd), (wp, wd), scale)
    _assert_sel((gi, gd), (wi, wd), scale)
    if nprobe == 1:
        assert bool((gp == -1).any())          # lists exhausted


@pytest.mark.parametrize("W", [1, 256])
def test_ivf_scan_adc_kernel_ties_exact(dev, W):
    """Integer tables, codes and norms: every sum exact, many ties, and
    the kernel equals its plain version bit for bit."""
    g = torch.Generator().manual_seed(W)
    nq, M, bl, ntiles = 40, 16, 32, 30
    lut = torch.randint(-3, 4, (nq, M, W), generator=g).float()
    codes = torch.randint(0, 4 if W == 1 else 256, (ntiles * bl, M),
                          generator=g).to(torch.uint8)
    vnorm = torch.randint(0, 6, (ntiles * bl,), generator=g).float()
    pids = torch.arange(ntiles * bl, dtype=torch.int32)
    pids[torch.rand(ntiles * bl, generator=g) < 0.2] = -1
    pids[-bl:] = -1
    tm = torch.randint(0, ntiles, (nq, 7), generator=g, dtype=torch.int32)
    tm[:, -2:] = ntiles - 1                     # null-tile padding
    qc = torch.randint(-2, 3, (nq,), generator=g).float()
    args = [t.to(dev) for t in (lut, qc, vnorm, codes, pids, tm)]
    got = ops.ivf_scan_adc(*args, block_rows=bl, topk=50)
    want = ops.ivf_scan_adc(*args, block_rows=bl, topk=50, force="ref")
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _adc_at(monkeypatch, sms, *args, **kw):
    """ops.ivf_scan_adc with the split plan computed for ``sms`` SMs."""
    monkeypatch.setattr(_build, "sm_count", lambda i: sms)
    try:
        return ops.ivf_scan_adc(*args, **kw)
    finally:
        monkeypatch.undo()


def _adc_wide(dev, nq, M, W, bl=32, ntiles=40, T=9):
    """Random inputs with a table of M·W floats (no codec trains one this
    wide cheaply): (lut, qconst, vnorm, codes, pids, tile_map)."""
    g = torch.Generator().manual_seed(M * W)
    lut = torch.randn(nq, M, W, generator=g)
    codes = torch.randint(0, 256, (ntiles * bl, M), generator=g).to(
        torch.uint8)
    vnorm = torch.rand(ntiles * bl, generator=g) * 50
    pids = torch.arange(ntiles * bl, dtype=torch.int32)
    pids[torch.rand(ntiles * bl, generator=g) < 0.4] = -1
    pids[-bl:] = -1                             # the null tile
    tm = torch.randint(0, ntiles, (nq, T), generator=g, dtype=torch.int32)
    qc = torch.randn(nq, generator=g)
    return [t.to(dev).contiguous() for t in (lut, qc, vnorm, codes, pids,
                                             tm)]


@pytest.mark.parametrize("kind,d,nsub,nq,nprobe,topk", [
    ("pq", 128, 8, 64, 16, 40), ("int8", 128, 0, 64, 16, 40),
    ("int8", 37, 0, 40, 4, 1), ("pq", 24, 4, 40, 40, 1024),
    ("wide", 0, 128, 20, 0, 40), ("wide", 0, 128, 6, 0, 1024)])
def test_ivf_scan_adc_split_bit_equal(dev, monkeypatch, kind, d, nsub, nq,
                                      nprobe, topk):
    """The same queries at S = 1 (plan for 1 SM), at the card's own plan
    and with S forced high (plan for 10,000 SMs): positions, ids and
    partials equal bit for bit for every plan, and match the plain
    version.  Served-batch shapes (64 queries, nprobe 16, topk 40, PQ
    nsub=8 and int8), topk 1 and 1,024, and a 32,768-float table (M=128,
    W=256), at topk 40 and at topk 1,024 (the largest shared memory)."""
    from repro_torch.index import quantize as q
    from repro_torch.kernels.ivf_scan import split_plan
    if kind == "wide":
        args = _adc_wide(dev, nq, nsub, 256)
        bl = 32
    else:
        X, index = _codec_index(dev, d, kind, nsub)
        Q = (X[:nq] + 0.1 * torch.randn(nq, d, device=dev)).contiguous()
        lut, qc = q.build_lut(index.codec, Q)
        args = (lut, qc, index.vnorm, index.codes, index.ids,
                _tile_map(index, Q, nprobe))
        bl = index.block_rows
    lut, qc, vnorm, codes, _, tm = args
    kw = dict(block_rows=bl, topk=topk)
    assert split_plan(nq, tm.shape[1], topk, 1).splits == 1
    assert split_plan(nq, tm.shape[1], topk, 10_000).splits > 1
    before = _build.launch_counts["ivf_scan_adc"]
    outs = [_adc_at(monkeypatch, sms, *args, **kw)
            for sms in (1, _sms(), 10_000)]
    want = ops.ivf_scan_adc(*args, force="ref", **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts["ivf_scan_adc"] == before + 3
    for got in outs[1:]:
        for a, b in zip(got, outs[0]):
            assert torch.equal(a, b)
    gi, gp, gd = outs[0]
    wi, wp, wd = want
    scale = _adc_scale(lut, vnorm, codes, wp) + qc.abs()[:, None]
    _assert_sel((gp, gd), (wp, wd), scale)
    _assert_sel((gi, gd), (wi, wd), scale)


@pytest.mark.parametrize("sms", [1, 132, 10_000])
def test_ivf_scan_adc_split_ties_exact(dev, monkeypatch, sms):
    """Integer tables, codes and norms and a map that repeats two live
    tiles in turn with null-tile runs between: ties on both sides of every
    chunk boundary, and every plan equals the plain version bit for bit."""
    g = torch.Generator().manual_seed(sms)
    nq, M, W, bl, ntiles = 24, 8, 256, 40, 30
    lut = torch.randint(-3, 4, (nq, M, W), generator=g).float()
    codes = torch.randint(0, 256, (ntiles * bl, M), generator=g).to(
        torch.uint8)
    vnorm = torch.randint(0, 6, (ntiles * bl,), generator=g).float()
    pids = torch.arange(ntiles * bl, dtype=torch.int32)
    pids[torch.rand(ntiles * bl, generator=g) < 0.3] = -1
    pids[:bl] = -1                              # an empty list tile
    pids[-bl:] = -1                             # the null tile
    tm = torch.randint(0, ntiles, (nq, 12), generator=g, dtype=torch.int32)
    pat = torch.tensor([3, 4, ntiles - 1, ntiles - 1, 3, 4, 4, 0, 3],
                       dtype=torch.int32)
    tm = torch.cat([tm, pat.repeat(nq, 3)], 1)
    qc = torch.randint(-2, 3, (nq,), generator=g).float()
    args = [t.to(dev).contiguous() for t in (lut, qc, vnorm, codes, pids, tm)]
    kw = dict(block_rows=bl, topk=30)
    got = _adc_at(monkeypatch, sms, *args, **kw)
    want = ops.ivf_scan_adc(*args, force="ref", **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _group_inputs(index, Q, nprobe, G):
    from repro_torch import index as ivf
    order, union, qmask = ivf.build_group_map(
        _tile_map(index, Q, nprobe), group=G, null_tile=index.null_tile)
    Qg = Q[order.clamp(max=Q.shape[0] - 1).long()].contiguous()
    return order, (Qg, index.vecs, index.ids, union, qmask)


@pytest.mark.parametrize("d,G,nprobe,topk,raw", [
    (128, 8, 4, 10, False), (37, 3, 3, 16, True), (1100, 4, 2, 10, False),
    (24, 8, 40, 1024, False), (128, 8, 1, 200, False)])
def test_ivf_scan_grouped_kernel_matches_plain(dev, d, G, nprobe, topk, raw):
    """d=128 and 37 (float4 and scalar row loads), 1100 (the re-read
    path), topk up to 1024, and lists exhausted at nprobe=1."""
    X, index = _small_index(dev, d)
    Q = (X[:67] + 0.1 * torch.randn(67, d, device=dev)).contiguous()
    order, args = _group_inputs(index, Q, nprobe, G)
    kw = dict(block_rows=index.block_rows, topk=topk, raw=raw)
    before = _build.launch_counts["ivf_scan_grouped"]
    got = ops.ivf_scan_grouped(*args, **kw)
    want = ops.ivf_scan_grouped(*args, force="ref", **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts["ivf_scan_grouped"] == before + 1
    _assert_sel(got, want, _pair_scale(args[0], X, want[0]))
    if nprobe == 1:
        assert bool((got[0] == -1).any())


@pytest.mark.parametrize("d,G,nprobe,topk,raw", [
    (128, 8, 4, 10, False), (24, 8, 40, 1024, False), (37, 8, 3, 16, True),
    (128, 8, 16, 10, False)])
def test_ivf_scan_grouped_split_matches_plain(dev, d, G, nprobe, topk, raw):
    """64 queries at G=8 (8 groups), whose split plan cuts each union into
    several slot chunks (two launches per call): topk up to 1024, raw."""
    from repro_torch.kernels.ivf_scan_grouped import split_plan
    X, index = _small_index(dev, d)
    Q = (X[:64] + 0.1 * torch.randn(64, d, device=dev)).contiguous()
    _, args = _group_inputs(index, Q, nprobe, G)
    assert split_plan(*args[3].shape, topk, _sms()).splits > 1
    kw = dict(block_rows=index.block_rows, topk=topk, raw=raw)
    before = _build.launch_counts["ivf_scan_grouped"]
    got = ops.ivf_scan_grouped(*args, **kw)
    want = ops.ivf_scan_grouped(*args, force="ref", **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts["ivf_scan_grouped"] == before + 1
    _assert_sel(got, want, _pair_scale(args[0], X, want[0]))


@pytest.mark.parametrize("nprobe,topk,raw", [(5, 20, False), (12, 50, False),
                                             (12, 7, True)])
def test_ivf_scan_grouped_kernel_ties_exact(dev, nprobe, topk, raw):
    """Integer data at 8 groups: the plan splits each union, equal partials
    fall in different chunks (repeated rows and tiles), and the result is
    bit-identical to the plain version."""
    from repro_torch.kernels.ivf_scan_grouped import split_plan
    X, index = _small_index(dev, 16, integer=True)
    _, args = _group_inputs(index, X[:64].contiguous(), nprobe, 8)
    assert split_plan(*args[3].shape, topk, _sms()).splits > 1
    kw = dict(block_rows=index.block_rows, topk=topk, raw=raw)
    gi, gd = ops.ivf_scan_grouped(*args, **kw)
    wi, wd = ops.ivf_scan_grouped(*args, force="ref", **kw)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi) and torch.equal(gd, wd)


def test_search_codec_and_grouped_match_plain_on_card(dev):
    from repro_torch import index as ivf
    X, index = _small_index(dev, 32)
    Q = (X[:100] + 0.05 * torch.randn(100, 32, device=dev)).contiguous()
    for kind in ("int8", "pq"):
        cx = ivf.quantize_index(index, kind, nsub=8, iters=2,
                                generator=torch.Generator().manual_seed(1))
        for rerank in (None, 0):
            before = _build.launch_counts["ivf_scan_adc"]
            kw = dict(topk=10, nprobe=8, codec=kind, rerank=rerank)
            gi, gd = ivf.search(cx, Q, **kw)
            wi, wd = ivf.search(cx, Q, force="ref", **kw)
            torch.cuda.synchronize()
            assert _build.launch_counts["ivf_scan_adc"] == before + 1
            scale = _pair_scale(Q, X, wi)
            if rerank == 0:   # distances to the reconstructions
                scale = scale + wd.abs().nan_to_num(posinf=0.0)
            _assert_sel((gi, gd), (wi, wd), scale)
    for qgroup in (4, 8):
        before = _build.launch_counts["ivf_scan_grouped"]
        gi, gd = ivf.search(index, Q, topk=10, nprobe=8, qgroup=qgroup)
        wi, wd = ivf.search(index, Q, topk=10, nprobe=8, qgroup=qgroup,
                            force="ref")
        torch.cuda.synchronize()
        assert _build.launch_counts["ivf_scan_grouped"] == before + 1
        _assert_sel((gi, gd), (wi, wd), _pair_scale(Q, X, wi))


# ------------------------------------------------- pairwise_sq

def _pw_case(B, m, d, seed, dev, dtype, integer=False):
    g = torch.Generator().manual_seed(seed)
    if integer:        # integer coordinates: every distance is exact
        X = torch.randint(0, 3, (B, m, d), generator=g).float()
    else:
        X = torch.randn(B, m, d, generator=g) * 3 + 1
    return X.to(dtype).to(dev)


def _assert_pairwise(got, want, Xb):
    """Within 1e-5·(||x_i||² + ||x_j||²) per element, finite, non-negative
    and exactly symmetric (both sides of the kernel run the same sums)."""
    sq = (Xb.float() ** 2).sum(-1)
    lim = 1e-5 * (sq[:, :, None] + sq[:, None, :])
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all()) and bool((got >= 0).all())
    gap = (got - want).abs()
    assert bool((gap <= lim).all()), float((gap / lim.clamp(min=1e-30)).max())
    assert torch.equal(got, got.mT)


@pytest.mark.parametrize("B", [1, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [1, 8, 130, 512, 960])
@pytest.mark.parametrize("m", [1, 16, 48, 64, 128, 200])
def test_pairwise_sq_kernel_matches_plain(dev, m, d, dtype, B):
    Xb = _pw_case(B, m, d, m * 1000 + d, dev, dtype)
    before = _build.launch_counts["pairwise_sq"]
    got = ops.pairwise_sq(Xb)
    want = ops.pairwise_sq(Xb, force="ref")
    torch.cuda.synchronize()
    assert _build.launch_counts["pairwise_sq"] == before + 1
    _assert_pairwise(got, want, Xb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_pairwise_sq_kernel_exact_on_integers(dev, dtype):
    """Integer data: norms, dots and distances are exact, so kernel and
    plain version agree bit for bit (duplicate rows give exact zeros)."""
    Xb = _pw_case(50, 72, 33, 5, dev, dtype, integer=True)
    got = ops.pairwise_sq(Xb)
    want = ops.pairwise_sq(Xb, force="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_pairwise_sq_kernel_unaligned_view(dev):
    """A contiguous view that starts mid-allocation (not 16-byte aligned)
    takes the kernel's scalar loads."""
    base = _pw_case(1, 1, 3 * 40 * 64 + 1, 9, dev, torch.float32).flatten()
    Xb = base[1:].view(3, 40, 64)
    _assert_pairwise(ops.pairwise_sq(Xb), ops.pairwise_sq(Xb, force="ref"),
                     Xb)


def test_pairwise_sq_kernel_rejects_bad_input(dev):
    Xb = _pw_case(4, 16, 8, 3, dev, torch.float32)
    before = _build.launch_counts["pairwise_sq"]
    with pytest.raises(ValueError, match="contiguous"):
        ops.pairwise_sq(Xb.transpose(1, 2))
    with pytest.raises(ValueError, match="3-D"):
        ops.pairwise_sq(Xb[0])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.pairwise_sq(Xb.double())
    assert _build.launch_counts["pairwise_sq"] == before
    for _ in range(3):
        ops.pairwise_sq(Xb)
    assert _build.launch_counts["pairwise_sq"] == before + 3


# ---------------------------------------------------------- the obs layer

def test_sync_counter_raises_on_a_stray_sync(dev):
    """Inside ``sync_counter`` a stray ``.item()`` raises; the counted reads
    (``sc.get``, ``syncs.read``, ``sc.block``) do not, and count; the mode
    is restored after."""
    from repro_torch.obs import syncs
    x = torch.arange(8.0, device=dev)
    before = torch.cuda.get_sync_debug_mode()
    with pytest.raises(RuntimeError, match="synchroniz"):
        with syncs.sync_counter():
            x.sum().item()
    assert torch.cuda.get_sync_debug_mode() == before
    with syncs.sync_counter() as sc:
        got = sc.get(x.sum())
        back = syncs.read({"x": x})
        sc.block()
    assert sc.syncs == 3 and float(got) == 28.0
    assert back["x"].device.type == "cpu"


def test_telemetry_record_syncs_nothing_on_card(dev):
    """``record`` with a 0-d device row and device values, and with an int
    row, syncs nothing; ``to_dict`` reads once, counted."""
    from repro_torch.obs import syncs
    from repro_torch.obs import telemetry as obs_tel
    tel = obs_tel.init(4, dev)
    row = torch.full((), 2, dtype=torch.int64, device=dev)
    v = torch.arange(5.0, device=dev)
    with syncs.sync_counter() as sc:
        obs_tel.record(tel, row, moves=v.sum().to(torch.int32),
                       distortion=v.mean(), hit_rate=0.5)
        obs_tel.record(tel, 1, proposed=9, graph_mean_dist=v.max())
        d = obs_tel.to_dict(tel)
    assert sc.syncs == 1
    assert d["moves"] == [0, 0, 10, 0] and d["proposed"] == [0, 9, 0, 0]
    assert d["distortion"][2] == 2.0 and d["hit_rate"][2] == 0.5
    assert d["graph_mean_dist"][1] == 4.0


def test_gk_means_under_sync_counter_on_card(dev):
    """A small ``gk_means`` with telemetry under the strict counter: no
    stray sync, epochs + 1 counted reads, rows equal to the result's."""
    from repro_torch.core.gkmeans import gk_means
    from repro_torch.data import gmm_blobs
    from repro_torch.obs import syncs
    from repro_torch.obs import telemetry as obs_tel
    X = gmm_blobs(4096, 32, 64, generator=torch.Generator(dev).manual_seed(1))
    before = _build.launch_counts["gather_score"]
    with syncs.sync_counter() as sc:
        r = gk_means(X, 64, kappa=16, xi=32, tau=3, iters=6,
                     min_move_frac=0.0, telemetry=True,
                     generator=torch.Generator().manual_seed(0), device=dev)
    ep = len(r.history)
    assert sc.syncs == r.host_syncs == ep + 1
    assert _build.launch_counts["gather_score"] > before
    d = obs_tel.to_dict(r.telemetry, rows=ep)
    assert d["moves"] == r.moves
    assert all(p >= m for p, m in zip(d["proposed"], d["moves"]))


def test_search_syncs_nothing_on_card(dev):
    """f32, query-grouped and int8 ``search`` under the strict counter: no
    sync at all."""
    from repro_torch import index as ivf
    from repro_torch.obs import syncs
    X, index = _small_index(dev, 32)
    q8 = ivf.quantize_index(index, "int8")
    Q = (X[:64] + 0.05 * torch.randn(64, 32, device=dev)).contiguous()
    ivf.search(index, Q, nprobe=8)
    torch.cuda.synchronize()
    with syncs.sync_counter() as sc:
        ivf.search(index, Q, nprobe=8)
        ivf.search(index, Q, nprobe=8, qgroup=4)
        ivf.search(q8, Q, nprobe=8, codec="int8")
    assert sc.syncs == 0


def test_profiler_range_per_launch(dev):
    """In a torch.profiler trace each wrapper call of ``gather_score`` and
    ``refine_merge`` is one ``repro_torch.kernels.<name>`` range holding its
    kernel launch, and every device launch the trace kept came from one."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs.timing import kernel_scope, scope_coverage
    assert kernel_scope("gather_score") is kernel_scope("refine_merge")
    gs = _gs_case(1024, 128, 4096, 50, 0, dev)
    rm = _rm_case(256, 64, 40, 16, 5000, 1, dev)
    ops.gather_score(*gs)
    ops.refine_merge(*rm)
    want = {"gather_score": 5, "refine_merge": 5}
    torch.cuda.synchronize()
    before = dict(_build.launch_counts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            ops.gather_score(*gs)
            ops.refine_merge(*rm)
        torch.cuda.synchronize()
    calls = {k: _build.launch_counts[k] - before[k] for k in want}
    cov = scope_coverage(prof.events(), ("gather_score_kernel",
                                         "refine_merge_kernel"))
    assert calls == want
    assert cov["ranges"] == want and cov["range_launches"] == want
    assert 0 < cov["device_launches"] == cov["in_range"] <= 10


# ------------------------------------------------------ clustered-KV decode

def _kv_case(dev, B=2, S=512, Hkv=2, G=2, hd=32, integer=False, seed=0):
    """(q, k_cache, v_cache) on the card: keys around 16 centres per batch
    row (integer-valued when ``integer``: every sum exact in f32, in any
    order), queries that point at cached keys."""
    g = torch.Generator().manual_seed(seed)
    centers = torch.randn(B, 16, Hkv, hd, generator=g) * 2.0
    which = torch.randint(0, 16, (B, S), generator=g)
    k = centers[torch.arange(B)[:, None], which] + 0.3 * torch.randn(
        B, S, Hkv, hd, generator=g)
    if integer:
        k = k.round()
    v = torch.randn(B, S, Hkv, hd, generator=g)
    tgt = torch.randint(0, S, (B, Hkv * G), generator=g)
    picked = k[torch.arange(B)[:, None], tgt,
               torch.arange(Hkv * G)[None] // G]
    q = (2.0 * picked)[:, None]
    return q.to(dev), k.to(dev), v.to(dev)


def test_tree_and_run_slices_on_card_match_per_slice(dev):
    """Integer-valued keys: the slice-batched tree and ``run_slices`` on the
    card equal per-slice calls — assignments and counts exactly."""
    from repro_torch.core import engine as eng
    from repro_torch.core import two_means as tm
    _, k, _ = _kv_case(dev, integer=True)
    X = k.permute(0, 2, 1, 3).reshape(4, 512, 32).contiguous()
    a = tm.two_means_tree(X, 32, generator=torch.Generator().manual_seed(1),
                          refine_iters=2)
    g = torch.Generator().manual_seed(1)
    for s in range(4):
        assert torch.equal(a[s], tm.two_means_tree(X[s], 32, generator=g,
                                                   refine_iters=2))
    words = torch.randint(0, 2 ** 32, (4, 3, 4),
                          generator=torch.Generator().manual_seed(2))
    for mode in ("bkm", "lloyd"):
        cfg = eng.EngineConfig(batch_size=128, mode=mode, iters=3,
                               min_move_frac=-1.0)
        st = eng.run_slices(X, a, 32, cfg, epoch_words=words)
        for s in range(4):
            r = eng.run(X[s], eng.init_state(X[s], a[s], 32),
                        eng.dense_source(), cfg, epoch_words=words[s])
            assert torch.equal(st.assign[s], r.state.assign), (mode, s)
            assert torch.equal(st.cnt[s], r.state.cnt), (mode, s)
            torch.testing.assert_close(st.D[s], r.state.D, rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kv_cluster_syncs_nothing_and_top_c_all_is_full(dev, dtype):
    """A build with refinement and the attention calls under the strict
    counter: no host sync, no kernel launch; at top_c = kc the clustered
    attention is full attention (1e-5 in f32, the reference test's 1e-2
    in bf16)."""
    from repro_torch.core import kv_cluster as kv
    from repro_torch.models import decode_attention
    from repro_torch.obs import syncs
    q, k, v = (t.to(dtype) for t in _kv_case(dev))
    length = torch.tensor(400, device=dev)
    before = dict(_build.launch_counts)
    torch.cuda.synchronize()
    with syncs.sync_counter() as sc:
        cl = kv.build_kv_clusters(k, 32, refine_epochs=2, cap_factor=8,
                                  generator=torch.Generator().manual_seed(0),
                                  device=dev)
        out = kv.clustered_decode_attention(q, k, v, cl, length, top_c=32)
        full = decode_attention(q, k, v, length)
        rec = kv.candidate_recall(q, k, cl, length, top_c=4)
        torch.cuda.synchronize()
    assert sc.syncs == 0
    assert dict(_build.launch_counts) == before
    assert out.dtype == dtype and cl.table.dtype == torch.int32
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), full.float(), rtol=tol, atol=tol)
    t = cl.table.reshape(4, -1)
    for s in range(4):
        assert sorted(t[s][t[s] >= 0].tolist()) == list(range(512))
    assert 0.0 <= float(rec) <= 1.0


def test_load_index_mmap_then_search_on_card(dev, tmp_path):
    """An index saved on the card, loaded memory-mapped onto the host, then
    moved to the card, searches exactly as the same file loaded there."""
    from repro_torch import index as ivf
    X, index = _small_index(dev, 32)
    path = str(tmp_path / "ix.ivf")
    ivf.save_index(index, path)
    mapped = ivf.load_index(path, mmap=True)
    assert mapped.device.type == "cpu"
    moved = mapped.to(dev)
    assert moved.device.type == "cuda"
    direct = ivf.load_index(path, device=dev)
    Q = (X[:64] + 0.05 * torch.randn(64, 32, device=dev)).contiguous()
    a, b = ivf.search(moved, Q, nprobe=8), ivf.search(direct, Q, nprobe=8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ------------------------------------------------------ the sharded topology

def test_sharded_emulation_on_card_matches_plain(dev):
    """The R = 4 emulation on the card on integer data (exact distances
    and sums, so atomic adds cannot reorder anything): the graph build
    through the kernels equals the plain versions' build, and the engine
    run from it equals the plain run."""
    from repro_torch.core import engine
    from repro_torch.core.knn_graph import build_knn_graph
    from repro_torch.core.two_means import two_means_tree
    g = torch.Generator().manual_seed(5)
    X = torch.randint(0, 4, (2048, 16), generator=g).float().to(dev)
    out = {}
    for force in (None, "ref"):
        before = _build.launch_counts["refine_merge"]
        graph = build_knn_graph(X, 8, xi=32, tau=3, shards=4, force=force,
                                generator=torch.Generator().manual_seed(1),
                                device=dev)
        assert (_build.launch_counts["refine_merge"] > before) == (
            force is None)
        a0 = two_means_tree(X, 64, generator=torch.Generator().manual_seed(2))
        res = engine.run(X, engine.init_state(X, a0, 64),
                         engine.graph_source(graph.ids),
                         engine.EngineConfig(batch_size=128, iters=4,
                                             shards=4, sparse_updates=True,
                                             force=force),
                         generator=torch.Generator().manual_seed(3))
        out[force] = (graph, res)
    (gk, rk), (gr, rr) = out[None], out["ref"]
    assert torch.equal(gk.ids, gr.ids) and torch.equal(gk.dist, gr.dist)
    assert torch.equal(rk.state.assign, rr.state.assign)
    assert rk.history == rr.history


def test_nccl_group_of_one_on_card(dev, tmp_path):
    """A world-size-1 NCCL group on the card: ``ShardedEngine.run`` (one
    counted read an epoch, nothing else syncs), ``GraphBuilder`` and
    ``ShardedIvf.search`` (no sync; ids equal to ``search``'s)."""
    from repro_torch import index as ivf
    from repro_torch.core import engine
    from repro_torch.core.distributed import (ShardedEngine, ShardedIvf,
                                              sharded_graph_builder)
    from repro_torch.core.graph_build import GraphBuildConfig, build_graph
    from repro_torch.core.recall import brute_force_knn, recall_at
    from repro_torch.core.two_means import two_means_tree
    from repro_torch.data import gmm_blobs
    from repro_torch.launch.mesh import close_group, init_group
    from repro_torch.obs import syncs
    init_group(dev, rank=0, world_size=1, store_path=tmp_path / "store")
    try:
        X = gmm_blobs(4096, 32, 64,
                      generator=torch.Generator(dev).manual_seed(1))
        cfg = GraphBuildConfig(kappa=8, xi=32, tau=3)
        gt = brute_force_knn(X, 8)
        g1, _ = sharded_graph_builder(None, cfg).build(
            X, generator=torch.Generator().manual_seed(1))
        g0, _ = build_graph(X, cfg, generator=torch.Generator().manual_seed(1))
        assert abs(float(recall_at(g1.ids, gt, 8))
                   - float(recall_at(g0.ids, gt, 8))) <= 0.02
        st = engine.init_state(X, two_means_tree(
            X, 64, generator=torch.Generator().manual_seed(2)), 64)
        ecfg = engine.EngineConfig(batch_size=256, iters=5,
                                   sparse_updates=True, min_move_frac=-1.0)
        eng = ShardedEngine(None, ecfg)
        eng.run(X, g0.ids, st.assign, st.D, st.cnt,
                generator=torch.Generator().manual_seed(3))   # warm-up
        torch.cuda.synchronize()
        with syncs.sync_counter() as sc:
            res = eng.run(X, g0.ids, st.assign, st.D, st.cnt,
                          generator=torch.Generator().manual_seed(3))
        assert sc.syncs == res.host_syncs == res.epochs == 5
        assert int(res.state.cnt.sum()) == 4096
        one = engine.run(X, engine.BKMState(st.assign.clone(), st.D.clone(),
                                            st.cnt.clone(), st.moves.clone()),
                         engine.graph_source(g0.ids), ecfg,
                         generator=torch.Generator().manual_seed(3))
        assert abs(res.history[-1] - one.history[-1]) <= 0.01 * one.history[-1]
        Xi, index = _small_index(dev, 32)
        Q = (Xi[:64] + 0.05 * torch.randn(64, 32, device=dev)).contiguous()
        sh = ShardedIvf(index)
        sh.search(Q, nprobe=8)
        torch.cuda.synchronize()
        with syncs.sync_counter() as sc:
            ids, d2 = sh.search(Q, nprobe=8)
        assert sc.syncs == 0
        assert torch.equal(ids, ivf.search(index, Q, nprobe=8)[0])
    finally:
        close_group()


def test_tuned_wrappers_equal_across_their_sweep(dev):
    """Every tuned wrapper (the probe, the three scans) gives
    ``torch.equal`` outputs for each knob of its sweep grid: the split plan
    decides nothing in the result."""
    from repro_torch.kernels import autotune
    cases = autotune.sweep_cases(dev, n=200_000, k=4_096, nq=2_000)
    assert {c[0] for c in cases} == set(autotune.SWEEP_TILES)
    for kernel, shape, _, call in cases:
        want = call(autotune.DEFAULT_TILE[kernel])
        for knob in autotune.SWEEP_TILES[kernel]:
            got = call(knob)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                kernel, shape, knob)


def test_lm_serving_on_card_matches_cpu(dev):
    """The dense LM path at the SMOKE preset on the card: greedy ``serve``
    deterministic with 0 host syncs in its decode steps, and a prefill plus
    two decode steps within 0.03·max|want| of the CPU's on the same
    parameters (cuBLAS and the CPU sum bf16 products in other orders)."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.train import scaled_config
    from repro_torch.models import Model
    from repro_torch.models.model import init_params
    cfg = scaled_config("qwen2-72b", "smoke").scaled(attn_chunk=16)
    t1, st = tserve.serve(cfg, batch=2, prompt_len=32, gen=6, device=dev)
    t2, _ = tserve.serve(cfg, batch=2, prompt_len=32, gen=6, device=dev)
    assert torch.equal(t1, t2) and st["decode_host_syncs"] == 0
    assert len(st["decode_step_ms"]) == 5
    card = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    cpu = Model(cfg, "cpu")
    cpu.load_state_dict(card.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 34),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    outs = []
    for m in (card, cpu):
        logits, cache = m.prefill({"tokens": toks[:, :32].to(m.device)}, 34)
        seq = [logits.cpu()]
        for i in range(2):
            logits, cache = m.decode_step(
                toks[:, 32 + i: 33 + i].to(m.device), cache)
            seq.append(logits.cpu())
        outs.append(seq)
    for got, want in zip(*outs):
        assert float((got - want).abs().max()) <= 0.03 * float(
            want.abs().max())


def test_moe_decode_step_on_card(dev):
    """The MoE family at the SMOKE preset on the card: a decode step (both
    MoE archs) with 0 host syncs under ``sync_counter`` (CUDA sync-debug
    mode "error") and finite logits, equal on a rerun; ``moe_ffn`` in
    float32 on the card against the CPU on the same inputs (expert ids,
    ranks and slots equal, outputs within 1e-5·max|want|, aux within
    1e-6); and the lower expert winning a tie on the card."""
    from repro_torch.launch.train import scaled_config
    from repro_torch.models import moe
    from repro_torch.models.model import init_params
    from repro_torch.obs.syncs import sync_counter
    for arch in ("qwen2-moe-a2.7b", "grok-1-314b"):
        cfg = scaled_config(arch, "smoke").scaled(attn_chunk=16)
        model = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
        toks = torch.randint(0, cfg.vocab, (2, 17), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(1)
                             ).to(dev)
        outs = []
        for _ in range(2):
            _, cache = model.prefill({"tokens": toks[:, :16]}, 17)
            with sync_counter() as sc:
                logits, cache = model.decode_step(toks[:, 16:], cache)
            assert sc.syncs == 0 and bool(torch.isfinite(logits).all())
            outs.append(logits)
        assert torch.equal(outs[0], outs[1])
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 256, 64, generator=g)
    router = torch.randn(64, 8, generator=g) / 8
    ws = [torch.randn(s, generator=g) / s[1] ** 0.5
          for s in ((8, 64, 96), (8, 64, 96), (8, 96, 64))]
    want, want_aux = moe.moe_ffn(x, *ws, router, top_k=2,
                                 capacity_factor=0.5)
    got, got_aux = moe.moe_ffn(x.to(dev), *(w.to(dev) for w in ws),
                               router.to(dev), top_k=2, capacity_factor=0.5)
    C = moe.capacity(256, 8, 2, 0.5)
    for xx, rr in ((x, router), (x.to(dev), router.to(dev))):
        _, _, idx = moe.route(xx[0], rr, 2)
        outs.append((idx.cpu(), *(t.cpu() for t in moe.slots(
            idx, moe.expert_counts(idx, 8), C))))
    for a, b in zip(outs[-2], outs[-1]):
        assert torch.equal(a, b)
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6
    tie = torch.zeros(64, 8, device=dev)
    tie[:, [2, 5, 6]] = 1.0                 # three equal, dominant columns
    _, _, idx = moe.route(x[0].abs().to(dev), tie, 2)
    assert (idx.cpu() == torch.tensor([2, 5])).all()


def test_ssm_serving_on_card_matches_cpu(dev):
    """The Mamba-2 family at the SMOKE preset on the card: greedy ``serve``
    deterministic with 0 host syncs in its decode steps; a prefill (72
    tokens at chunk 64: the padding path) plus two decode steps within
    0.03·max|want| of the CPU's on the same parameters in bf16 (cuBLAS and
    the CPU sum bf16 products in other orders), and within 1e-4·max|want|
    in float32, logits and every layer's SSD state and conv tail (the
    float32 products are full float32 on the card, not TF32)."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.train import scaled_config
    from repro_torch.models import Model
    from repro_torch.models.model import init_params
    from repro_torch.obs.syncs import sync_counter
    cfg = scaled_config("mamba2-2.7b", "smoke")
    t1, st = tserve.serve(cfg, batch=2, prompt_len=32, gen=6, device=dev)
    t2, _ = tserve.serve(cfg, batch=2, prompt_len=32, gen=6, device=dev)
    assert torch.equal(t1, t2) and st["decode_host_syncs"] == 0
    assert len(st["decode_step_ms"]) == 5
    card = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    cpu = Model(cfg, "cpu")
    cpu.load_state_dict(card.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 74),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    for tol in (0.03, 1e-4):
        if tol < 0.03:
            card.float(), cpu.float()
        outs = []
        for m in (card, cpu):
            logits, cache = m.prefill({"tokens": toks[:, :72].to(m.device)},
                                      74)
            seq = [logits.cpu()]
            for i in range(2):
                tok = toks[:, 72 + i: 73 + i].to(m.device)
                with sync_counter() as sc:
                    logits, cache = m.decode_step(tok, cache)
                assert sc.syncs == 0 and cache["len"] == 73 + i
                seq.append(logits.cpu())
            outs.append((seq, {k: cache[k].float().cpu()
                               for k in ("state", "conv")}))
        (got, gcache), (want, wcache) = outs
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= tol * float(w.abs().max())
        for key in ("state", "conv"):
            for g, w in zip(gcache[key], wcache[key]):
                assert float((g - w).abs().max()) <= tol * float(
                    w.abs().max()), (key, tol)


def test_hybrid_serving_on_card_matches_cpu(dev):
    """The hybrid family at the SMOKE preset on the card: greedy ``serve``
    deterministic with 0 host syncs in its decode steps; at window 16 a
    prefill of 40 tokens (the ring rolls by 8) plus four decode steps
    (across position 48) within 0.03·max|want| of the CPU's on the same
    parameters in bf16, and within 1e-4·max|want| in float32: logits and
    every h, conv tail and k/v ring."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.train import scaled_config
    from repro_torch.models import Model
    from repro_torch.models.model import init_params
    from repro_torch.obs.syncs import sync_counter
    cfg = scaled_config("recurrentgemma-9b", "smoke")
    t1, st = tserve.serve(cfg, batch=2, prompt_len=32, gen=6, device=dev)
    t2, _ = tserve.serve(cfg, batch=2, prompt_len=32, gen=6, device=dev)
    assert torch.equal(t1, t2) and st["decode_host_syncs"] == 0
    assert len(st["decode_step_ms"]) == 5
    cfg = cfg.scaled(window=16)
    card = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    cpu = Model(cfg, "cpu")
    cpu.load_state_dict(card.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 44),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    for tol in (0.03, 1e-4):
        if tol < 0.03:
            card.float(), cpu.float()
        outs = []
        for m in (card, cpu):
            logits, cache = m.prefill({"tokens": toks[:, :40].to(m.device)},
                                      44)
            seq = [logits.cpu()]
            for i in range(4):
                tok = toks[:, 40 + i: 41 + i].to(m.device)
                with sync_counter() as sc:
                    logits, cache = m.decode_step(tok, cache)
                assert sc.syncs == 0 and cache["len"] == 41 + i
                seq.append(logits.cpu())
            states = [t.float().cpu() for pair in (
                *cache["groups"].values(), cache["tail"]) for t in pair]
            outs.append((seq, states))
        (got, gstates), (want, wstates) = outs
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= tol * float(w.abs().max())
        for gs, ws in zip(gstates, wstates):
            for g, w in zip(gs, ws):
                assert float((g - w).abs().max()) <= tol * float(
                    w.abs().max()), tol


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-2b"])
def test_audio_vlm_serving_on_card_matches_cpu(dev, arch):
    """Whisper and the VLM at the SMOKE preset on the card: greedy
    ``serve`` deterministic with 0 host syncs in its decode steps; a
    prefill (Whisper: 40 frames and a 24-token prompt; the VLM: 16 patches
    and 24 tokens) plus four decode steps within 0.03·max|want| of the
    CPU's on the same parameters and inputs in bf16, and within
    1e-4·max|want| in float32: logits and every cache tensor (Whisper's
    xk and xv too)."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.train import scaled_config
    from repro_torch.models import Model
    from repro_torch.models.model import init_params
    from repro_torch.obs.syncs import sync_counter
    cfg = scaled_config(arch, "smoke")
    t1, st = tserve.serve(cfg, batch=2, prompt_len=32, gen=6, device=dev)
    t2, _ = tserve.serve(cfg, batch=2, prompt_len=32, gen=6, device=dev)
    assert torch.equal(t1, t2) and st["decode_host_syncs"] == 0
    assert len(st["decode_step_ms"]) == 5
    card = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    cpu = Model(cfg, "cpu")
    cpu.load_state_dict(card.state_dict())
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 28), generator=g,
                         dtype=torch.int32)
    stub = ({"frames": torch.randn((2, 40, cfg.d_model), generator=g)}
            if cfg.family == "audio" else
            {"patches": torch.randn((2, cfg.n_patches, cfg.frontend_dim),
                                    generator=g)})
    n = 24 + (cfg.n_patches if cfg.family == "vlm" else 0)
    for tol in (0.03, 1e-4):
        if tol < 0.03:
            card.float(), cpu.float()
        outs = []
        for m in (card, cpu):
            batch = {"tokens": toks[:, :24].to(m.device),
                     **{k: v.to(m.device) for k, v in stub.items()}}
            logits, cache = m.prefill(batch, n + 4)
            seq = [logits.cpu()]
            for i in range(4):
                tok = toks[:, 24 + i: 25 + i].to(m.device)
                with sync_counter() as sc:
                    logits, cache = m.decode_step(tok, cache)
                assert sc.syncs == 0 and cache["len"] == n + 1 + i
                seq.append(logits.cpu())
            outs.append((seq, [cache[k].float().cpu() for k in sorted(cache)
                               if k != "len"]))
        (got, gstates), (want, wstates) = outs
        assert len(gstates) == (4 if cfg.family == "audio" else 2)
        for g_, w in zip(got, want):
            assert float((g_ - w).abs().max()) <= tol * float(w.abs().max())
        for gs, ws in zip(gstates, wstates):
            for g_, w in zip(gs, ws):
                assert float((g_ - w).abs().max()) <= tol * float(
                    w.abs().max()), tol


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "qwen2-moe-a2.7b",
                                  "mamba2-2.7b", "recurrentgemma-9b",
                                  "whisper-base", "internvl2-2b"])
def test_train_step_on_card_matches_cpu(dev, arch):
    """One ``make_train_step`` step of each family at the SMOKE preset (2
    layers; the hybrid 3) on the card against the same step on the CPU,
    from the same parameters: in float32 the loss within 1e-5 relative,
    the grad norm and every clipped grad within 1e-4 of max|want|, and the
    parameters after an Adafactor step from the same (the CPU's) grads
    within 1e-5 of max|want|; in bf16
    the dense step runs under ``sync_counter`` (0 host syncs) with a
    finite loss within 1e-2 of the CPU's."""
    from repro_torch.launch.train import scaled_config
    from repro_torch.models import Model
    from repro_torch.models.model import init_params
    from repro_torch.obs.syncs import sync_counter
    from repro_torch.train import make_optimizer, make_train_step
    from repro_torch.train.optimizer import Optimizer
    cfg = scaled_config(arch, "smoke").scaled(
        n_layers=3 if arch == "recurrentgemma-9b" else 2, loss_chunk=32,
        attn_chunk=32)
    card = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    cpu = Model(cfg, "cpu")
    cpu.load_state_dict(card.state_dict())
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 64), generator=g),
             "labels": torch.randint(0, cfg.vocab, (2, 64), generator=g)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((2, 64, cfg.d_model), generator=g)
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((2, cfg.n_patches, cfg.frontend_dim),
                                       generator=g)
    if arch == "qwen1.5-4b":
        losses = []
        for m in (card, cpu):
            m16 = Model(cfg, m.device)
            m16.load_state_dict(m.state_dict())
            opt = make_optimizer("adamw")
            step = make_train_step(m16, opt)
            state = opt.init(dict(m16.named_parameters()))
            b = {k: v.to(m.device) for k, v in batch.items()}
            sid = torch.tensor(0, device=m.device)   # a copy: made outside
            with sync_counter() as sc:
                _, met = step(state, b, sid)
            assert sc.syncs == 0
            losses.append(float(met["loss"]))
        assert np.isfinite(losses).all()
        assert abs(losses[0] - losses[1]) <= 1e-2 * abs(losses[1])
    outs = []
    for m in (card.float(), cpu.float()):
        box = {}

        def update(grads, state, params, step, box=box):
            box["grads"] = {n: t.cpu() for n, t in grads.items()}
            return params, state
        step = make_train_step(m, Optimizer(lambda p: None, update))
        _, met = step(None, {k: v.to(m.device) for k, v in batch.items()},
                      torch.tensor(0, device=m.device))
        outs.append(({k: float(v) for k, v in met.items()}, box["grads"]))
    (gm, gg), (wm, wg) = outs
    assert abs(gm["loss"] - wm["loss"]) <= 1e-5 * abs(wm["loss"])
    assert abs(gm["grad_norm"] - wm["grad_norm"]) <= 1e-4 * wm["grad_norm"]
    for n in wg:
        assert float((gg[n] - wg[n]).abs().max()) <= 1e-4 * float(
            wg[n].abs().max()), n
    # Adafactor on both from the same (the CPU's) grads
    after = []
    for m in (card, cpu):
        opt = make_optimizer("adafactor", lr=1e-2, warmup=1)
        params = dict(m.named_parameters())
        opt.update({n: g.to(m.device) for n, g in wg.items()},
                   opt.init(params), params, torch.tensor(0, device=m.device))
        after.append({n: t.detach().cpu() for n, t in params.items()})
    for n, w in after[1].items():
        assert float((after[0][n] - w).abs().max()) <= 1e-5 * float(
            w.abs().max()), n


def test_checkpoint_roundtrip_on_card(dev, tmp_path):
    """``train.checkpoint`` with card tensors: a tree of bf16, float32 and
    int32 leaves saved and restored onto the devices of ``like``'s
    leaves, bit for bit; and a tree of CPU zeros restored onto the card
    with ``device=``."""
    from repro_torch.train import checkpoint as ckpt
    g = torch.Generator(dev).manual_seed(0)
    tree = {"w": torch.randn((64, 32), generator=g,
                             device=dev).to(torch.bfloat16),
            "state": {"r": torch.rand(64, generator=g, device=dev),
                      "n": torch.arange(7, dtype=torch.int32, device=dev)}}
    ckpt.save(str(tmp_path), 3, tree, extra={"seed": 0})
    like_cpu = {"w": torch.zeros((64, 32), dtype=torch.bfloat16),
                "state": {"r": torch.zeros(64),
                          "n": torch.zeros(7, dtype=torch.int32)}}
    for like, device in ((tree, None), (like_cpu, dev)):
        got, step, extra = ckpt.restore(str(tmp_path), like, device=device)
        assert step == 3 and extra == {"seed": 0}
        for (p, a), (_, b) in zip(ckpt._items(tree), ckpt._items(got)):
            assert b.device.type == "cuda" and b.dtype == a.dtype, p
            assert torch.equal(a, b), p
