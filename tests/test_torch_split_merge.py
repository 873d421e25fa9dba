"""The split-and-merge design of the port's ``probe_centroids`` and
``ivf_scan_grouped`` kernels, held against the JAX package on the CPU.

The CUDA kernels cut each call's work into chunks (``split_plan``: centroid
chunks for the probe, slot chunks of each group's union for the grouped
scan), keep a sorted partial list per chunk, and merge the lists in chunk
order by strict insertion.  The kernels run only on a card
(``tests/test_torch_cuda.py``); here the plans are checked as pure
functions, and the merge is emulated in torch at the plans' own chunks —
per-chunk ``kernels.ref`` top lists, merged in chunk order with the
kernels' insert rule (position = count of entries <= the candidate, only
strictly below the k-th entry) — and compared with the JAX package's plain
versions and its Pallas probe in interpret mode, on the same numpy inputs.

Tolerances: on integer data every partial is exact and ties sit on both
sides of chunk boundaries, so ids and distances must be equal bit for bit;
on float data as ``tests/test_torch_ivf.py``: distances rtol 1e-5 plus
1e-6 of the largest squared norm, ids equal except at near-ties.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import index as jivf
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import centroid_assign as kca
from repro_torch.kernels import ivf_scan_grouped as kgrp
from repro_torch.kernels import ref as tref

INF = float("inf")
H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them as fast and
    leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------- plans

@pytest.mark.parametrize("n,k,p", [(64, 16_384, 16), (10_000, 16_384, 16),
                                   (10_000, 16_384, 64), (10, 5_000, 128),
                                   (200, 3_000, 37), (1_000_000, 16_384, 1),
                                   (300, 260, 64), (10, 5, 5)])
def test_probe_plan_chunks_cover_centroids(n, k, p):
    """Whole half tiles per chunk; the chunks cover [0, k) in order, each
    non-empty, with no gap or overlap; the CTA count is row tiles × S."""
    plan = kca.split_plan(n, k, p, H100_SMS)
    assert plan.rows in kca.ROWS and plan.chunk % kca.UNIT == 0
    bounds = [min(s * plan.chunk, k) for s in range(plan.splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == k
    assert all(a < b for a, b in zip(bounds, bounds[1:]))
    assert plan.splits == -(-k // plan.chunk)
    assert plan.ctas == -(-n // plan.rows) * plan.splits


def test_probe_plan_fills_the_card():
    """The served batch (64 × 16,384, p=16) splits into at least 132 CTAs;
    nq=10,000 runs at least one full wave; rows that fill the card alone
    get one chunk."""
    served = kca.split_plan(64, 16_384, 16, H100_SMS)
    assert served.splits > 1 and served.ctas >= H100_SMS
    for p in (1, 16, 64):
        assert kca.split_plan(10_000, 16_384, p, H100_SMS).ctas >= H100_SMS
    assert kca.split_plan(1_000_000, 16_384, 16, H100_SMS).splits == 1


@pytest.mark.parametrize("p", [0, kca.MAX_P + 1])
def test_probe_plan_refuses_p_outside_the_kernel(p):
    with pytest.raises(ValueError, match="p <= 128"):
        kca.split_plan(64, 1024, p, H100_SMS)


@pytest.mark.parametrize("ngroups,U,topk", [(8, 128, 10), (8, 512, 10),
                                            (8, 96, 1024), (3, 24, 16),
                                            (1_250, 512, 10), (8, 3, 10)])
def test_grouped_plan_chunks_cover_union(ngroups, U, topk):
    """The nominal chunks cover [0, U) in order with no gap or overlap;
    each holds MIN_SLOTS slots or more when split; a row merges at most
    MAX_MERGE candidates."""
    plan = kgrp.split_plan(ngroups, U, topk, H100_SMS)
    bounds = [min(s * plan.chunk, U) for s in range(plan.splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == U
    assert all(a < b for a, b in zip(bounds, bounds[1:]))
    assert plan.ctas == ngroups * plan.splits
    if plan.splits > 1:
        assert plan.chunk >= kgrp.MIN_SLOTS
        assert plan.splits * topk <= kgrp.MAX_MERGE


def test_grouped_plan_fills_the_card():
    """A served batch (8 groups of 8 at nprobe 16: U >= 128) splits into at
    least 132 CTAs; 1,250 groups (nq=10,000) keep one chunk."""
    for U in (128, 256, 512, 1024):
        plan = kgrp.split_plan(8, U, 10, H100_SMS)
        assert plan.ctas >= H100_SMS and plan.chunk >= kgrp.MIN_SLOTS
    assert kgrp.split_plan(1_250, 512, 10, H100_SMS).splits == 1


def test_grouped_limits_refused():
    with pytest.raises(ValueError, match="topk <= 1024"):
        kgrp.split_plan(8, 128, kgrp.MAX_TOPK + 1, H100_SMS)
    Qg = torch.zeros((18, 4))
    union = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="G <= 8"):
        kgrp.ivf_scan_grouped(Qg, torch.zeros((8, 4)),
                              torch.zeros(8, dtype=torch.int32), union,
                              torch.zeros((18, 3), dtype=torch.int32),
                              block_rows=8)


def test_slot_chunks_cut_the_live_span():
    """Each group's chunks tile [0, span) in slot order, span ending after
    the last slot a query of the group probed; the same cut on every
    device, and nothing probed past it."""
    rng = np.random.default_rng(3)
    G, U, splits = 4, 40, 6
    qmask = (rng.random((5 * G, U)) < 0.15).astype(np.int32)
    qmask[:, 30:] = 0                    # null padding
    qmask[G:2 * G] = 0                   # a group that probed nothing
    b = kgrp.slot_chunks(torch.from_numpy(qmask), G, splits).numpy()
    assert b.shape == (5, splits + 1)
    for g in range(5):
        probed = np.nonzero(qmask[g * G:(g + 1) * G].any(0))[0]
        span = probed.max() + 1 if len(probed) else 0
        assert b[g, 0] == 0 and b[g, -1] == span
        assert (np.diff(b[g]) >= 0).all()
        assert (np.diff(b[g]) <= -(-span // splits)).all()


# ------------------------------------------------------------- merge emulation

def _merge_in_chunk_order(lists, k):
    """The kernels' pass 2: each row's chunk lists (v, ids), in chunk order,
    inserted one candidate at a time at position = count of entries <= v,
    and only when strictly below the k-th entry."""
    rows = lists[0][0].shape[0]
    out_v = torch.full((rows, k), INF)
    out_i = torch.full((rows, k), -1, dtype=torch.int32)
    for r in range(rows):
        ld, li = [INF] * k, [-1] * k
        for v, ids in lists:
            for c in range(v.shape[1]):
                x = float(v[r, c])
                if x < ld[-1]:
                    pos = sum(e <= x for e in ld)
                    ld.insert(pos, x)
                    li.insert(pos, int(ids[r, c]))
                    ld.pop()
                    li.pop()
        out_v[r] = torch.tensor(ld)
        out_i[r] = torch.tensor(li, dtype=torch.int32)
    return out_v, out_i


def _probe_by_chunks(X, C, p, plan):
    """Per-chunk stable top-p of the partials at the plan's chunks, merged
    in chunk order, d2 finalised once."""
    Xt, Ct = torch.from_numpy(X), torch.from_numpy(C)
    n, k = Xt.shape[0], Ct.shape[0]
    part = (Ct * Ct).sum(-1)[None, :] - 2.0 * (Xt @ Ct.T)
    lists = []
    for s in range(plan.splits):
        a, b = s * plan.chunk, min((s + 1) * plan.chunk, k)
        cols = torch.arange(a, b, dtype=torch.int32)
        lists.append(tref.stable_topk(part[:, a:b], cols.expand(n, -1), p))
    v, ids = _merge_in_chunk_order(lists, p)
    d2 = torch.clamp(v + (Xt * Xt).sum(-1)[:, None], min=0.0)
    return ids, torch.where(ids < 0, INF, d2)


def _int_centroid_case(n, k, d, seed):
    """Integer coordinates (exact partials, ties everywhere) with the
    centroid before every UNIT boundary repeated after it, so equal
    partials straddle each chunk boundary of any plan."""
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 3, (n, d)).astype(np.float32)
    C = rng.integers(0, 3, (k, d)).astype(np.float32)
    for b in range(kca.UNIT, k, kca.UNIT):
        C[b] = C[b - 1]
    return X, C


def _blobs(n, d, comps, seed, spread=4.0):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((comps, d)) * spread
    comp = rng.integers(0, comps, size=n)
    return (means[comp] + rng.standard_normal((n, d))).astype(np.float32)


def _tol(*mats):
    return 1e-6 * max(float((np.asarray(m, np.float64) ** 2).sum(-1).max())
                      for m in mats)


def _assert_topk(got, want, tol):
    """As tests/test_torch_ivf.py: distances within rtol 1e-5 + tol; ids
    equal but at near-ties; the -1 / +inf tail equal."""
    gi, gd = (np.asarray(a) for a in got)
    wi, wd = (np.asarray(a) for a in want)
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    np.testing.assert_array_equal(gi[~fin], wi[~fin])
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-5, atol=tol)
    gap = np.abs(np.where(fin, gd, 0.0) - np.where(fin, wd, 0.0))
    near = fin & (gap <= 1e-5 * np.abs(np.where(fin, wd, 0.0)) + tol)
    assert ((gi == wi) | near).all()


def _assert_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("n,k,d,p", [(40, 256, 8, 5), (70, 300, 6, 12),
                                     (16, 200, 4, 64)])
def test_probe_merge_equals_reference_on_ties(n, k, d, p):
    """Integer data: the chunked merge equals the JAX plain probe exactly."""
    X, C = _int_centroid_case(n, k, d, n + k)
    plan = kca.split_plan(n, k, p, H100_SMS)
    assert plan.splits > 1
    got = _probe_by_chunks(X, C, p, plan)
    _assert_equal(got, jref.probe_centroids(jnp.asarray(X), jnp.asarray(C),
                                            p))


def test_probe_merge_equals_pallas_interpret_on_ties():
    """Integer data: the chunked merge equals the Pallas probe (a running
    top-p over centroid tiles of 64) in interpret mode, exactly."""
    n, k, d, p = 40, 256, 8, 5
    X, C = _int_centroid_case(n, k, d, 5)
    plan = kca.split_plan(n, k, p, H100_SMS)
    assert plan.splits > 1
    want = jops.probe_centroids(jnp.asarray(X), jnp.asarray(C), p,
                                force="interpret", bn=64, bk=64)
    _assert_equal(_probe_by_chunks(X, C, p, plan), want)


@pytest.mark.parametrize("p", [1, 8])
def test_probe_merge_matches_reference_on_floats(p):
    X = _blobs(64, 16, 8, 21)
    C = _blobs(300, 16, 8, 22)
    plan = kca.split_plan(64, 300, p, H100_SMS)
    assert plan.splits > 1
    _assert_topk(_probe_by_chunks(X, C, p, plan),
                 jref.probe_centroids(jnp.asarray(X), jnp.asarray(C), p),
                 _tol(X, C))


BL = 16


def _grouped_by_chunks(Qg, vecs, pids, union, qmask, G, topk, plan, raw):
    """Per-chunk grouped scans (raw partials) at the kernel's cut of each
    group's live span, merged in chunk order, finalised once."""
    Qg, vecs, pids, union, qmask = (torch.from_numpy(np.array(a)) for a in
                                    (Qg, vecs, pids, union, qmask))
    ngroups = union.shape[0]
    bounds = kgrp.slot_chunks(qmask, G, plan.splits)
    lists = []
    for s in range(plan.splits):
        v = torch.full((ngroups * G, topk), INF)
        ids = torch.full((ngroups * G, topk), -1, dtype=torch.int32)
        for g in range(ngroups):
            a, b = int(bounds[g, s]), int(bounds[g, s + 1])
            if a == b:
                continue
            rows = slice(g * G, (g + 1) * G)
            ids[rows], v[rows] = tref.ivf_scan_grouped(
                Qg[rows], vecs, pids, union[g:g + 1, a:b].contiguous(),
                qmask[rows, a:b].contiguous(), block_rows=BL, topk=topk,
                raw=True)
        lists.append((v, ids))
    v, ids = _merge_in_chunk_order(lists, topk)
    if not raw:
        v = torch.clamp(v + (Qg * Qg).sum(-1)[:, None], min=0.0)
    return ids, torch.where(ids < 0, INF, v)


def _int_grouped_case(seed, ngroups=3, G=8, U=24, ntiles=10, d=4):
    """Integer rows and queries (exact partials, ties everywhere); each
    group's union sorted with repeats (a tile on both sides of a chunk
    boundary scores equal rows in two chunks) and null padding last."""
    rng = np.random.default_rng(seed)
    vecs = rng.integers(-2, 3, (ntiles * BL, d)).astype(np.float32)
    pids = np.arange(ntiles * BL, dtype=np.int32)
    pids[rng.random(ntiles * BL) < 0.2] = -1
    pids[-BL:] = -1                                  # the null tile
    Qg = rng.integers(-2, 3, (ngroups * G, d)).astype(np.float32)
    union = np.sort(rng.integers(0, ntiles - 1, (ngroups, U)), 1)
    union[:, -U // 4:] = ntiles - 1
    qmask = (rng.random((ngroups * G, U)) < 0.6).astype(np.int32)
    qmask[:, -U // 4:] = 0
    return Qg, vecs, pids, union.astype(np.int32), qmask


@pytest.mark.parametrize("raw,topk", [(False, 25), (True, 10), (False, 3)])
def test_grouped_merge_equals_reference_on_ties(raw, topk):
    """Integer data: the chunked merge equals the JAX plain grouped scan
    exactly (union slot order, then row order, decide every tie)."""
    G = 8
    args = _int_grouped_case(topk)
    plan = kgrp.split_plan(args[3].shape[0], args[3].shape[1], topk,
                           H100_SMS)
    assert plan.splits > 1
    got = _grouped_by_chunks(*args, G, topk, plan, raw)
    want = jref.ivf_scan_grouped(*(jnp.asarray(a) for a in args),
                                 block_rows=BL, topk=topk, raw=raw)
    _assert_equal(got, want)


class _FakeResult:
    def __init__(self, assign, centroids, k):
        self.assign, self.centroids, self.k = assign, centroids, k


def test_grouped_merge_matches_reference_on_floats():
    """A small JAX index, its group map at G=8 (8 groups): the chunked
    merge against the JAX plain grouped scan."""
    G, q, nprobe, topk = 8, 64, 3, 10
    X = _blobs(512, 16, 8, 0)
    C = _blobs(8, 16, 8, 1)
    a = np.argmin(((X[:, None] - C[None]) ** 2).sum(-1), 1).astype(np.int32)
    j = jivf.build_ivf(X, _FakeResult(a, C, 8), block_rows=BL)
    rng = np.random.default_rng(5)
    Q = (X[:q] + 0.1 * rng.standard_normal((q, 16))).astype(np.float32)
    cids, _ = jref.probe_centroids(jnp.asarray(Q), j.centroids, nprobe)
    tm = jivf.build_tile_map(cids, j.starts, j.caps,
                             max_tiles=j.max_list_tiles, block_rows=BL,
                             null_tile=j.null_tile)
    order, union, qmask = (np.asarray(t) for t in jivf.build_group_map(
        tm, group=G, null_tile=j.null_tile))
    Qg = Q[np.clip(order, 0, q - 1)]
    args = (Qg, np.asarray(j.vecs), np.asarray(j.ids), union, qmask)
    plan = kgrp.split_plan(union.shape[0], union.shape[1], topk, H100_SMS)
    assert plan.splits > 1
    got = _grouped_by_chunks(*args, G, topk, plan, False)
    want = jref.ivf_scan_grouped(*(jnp.asarray(x) for x in args),
                                 block_rows=BL, topk=topk)
    _assert_topk(got, want, _tol(Qg, np.asarray(j.vecs)))
