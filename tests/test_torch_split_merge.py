"""The split-and-merge designs of the port's ``probe_centroids``,
``ivf_scan_grouped`` and ``ivf_scan`` kernels, and the sort-based merge of
its ``refine_merge`` kernel, held against the JAX package on the CPU.

The CUDA kernels cut each call's work into chunks (``split_plan``: centroid
chunks for the probe, slot chunks of each group's union for the grouped
scan, chunks of each query's live slots for the per-query scan), keep a
sorted partial list per chunk, and merge the lists in chunk order by strict
insertion.  The kernels run only on a card (``tests/test_torch_cuda.py``);
here the plans are checked as pure functions, and the merge is emulated in
torch at the plans' own chunks — per-chunk ``kernels.ref`` top lists,
merged in chunk order with the kernels' insert rule (position = count of
entries <= the candidate, only strictly below the k-th entry) — and
compared with the JAX package's plain versions and its Pallas kernels in
interpret mode, on the same numpy inputs.  The per-query scan's CTA is
emulated too (eight warp-private strict-insert lists, merged by each
entry's rank by (value, candidate position)), and so is ``refine_merge``'s
merge (a stable sort by (distance, position) of order-preserving 64-bit
keys, a first-occurrence test against each id's lowest sorted rank, a
prefix-sum compaction).

Tolerances: on integer data every partial is exact and ties sit on both
sides of chunk boundaries, so ids and distances must be equal bit for bit;
on float data as ``tests/test_torch_ivf.py``: distances rtol 1e-5 plus
1e-6 of the largest squared norm, ids equal except at near-ties.
"""
from __future__ import annotations

import bisect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container image has no hypothesis wheel
    from _hyp import given, settings, strategies as st

from repro import index as jivf
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import centroid_assign as kca
from repro_torch.kernels import ivf_scan as kivf
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


# ------------------------------------------------------- per-query ivf_scan

@pytest.mark.parametrize("nq,T,topk", [(64, 144, 10), (64, 576, 10),
                                       (1, 144, 10), (10_000, 144, 10),
                                       (8, 16_384, 10), (3, 2, 1024),
                                       (100, 9, 100), (5, 0, 10)])
def test_scan_plan_chunks_cover_live_slots(nq, T, topk):
    """The plan's chunks, cut by ``slot_chunks`` from ``live_slots`` on a
    map with out-of-range tiles, empty tiles and null runs, cover each
    query's live slots [0, n) in order, ceil(n / S) a chunk, no gap or
    overlap; S is at most T and the merge at most MAX_MERGE candidates."""
    plan = kivf.split_plan(nq, T, topk, H100_SMS)
    assert plan.ctas == nq * plan.splits
    assert 1 <= plan.splits <= max(T, 1)
    assert plan.splits == 1 or plan.splits * topk <= kivf.MAX_MERGE
    rng = np.random.default_rng(nq + T)
    bl, n_tiles, q = 8, 40, min(nq, 16)
    pids = rng.integers(0, 50, n_tiles * bl).astype(np.int32)
    pids[rng.random(pids.size) < 0.6] = -1
    pids[:bl] = -1                                  # an empty list tile
    pids[-bl:] = -1                                 # the null tile
    tm = rng.integers(-2, n_tiles + 2, (q, T)).astype(np.int32)
    tm[:, T // 2:] = n_tiles - 1                    # a null run
    live = kivf.live_slots(torch.from_numpy(tm), torch.from_numpy(pids),
                           bl).numpy()
    inr = (tm >= 0) & (tm < n_tiles)
    tile_live = (pids.reshape(n_tiles, bl) >= 0).any(1)
    np.testing.assert_array_equal(
        live, inr & tile_live[np.clip(tm, 0, n_tiles - 1)])
    b = kivf.slot_chunks(torch.from_numpy(live), plan.splits).numpy()
    n = live.sum(1)
    assert b.shape == (q, plan.splits + 1)
    assert (b[:, 0] == 0).all() and (b[:, -1] == n).all()
    step = np.diff(b, axis=1)
    assert (step >= 0).all()
    assert (step <= -(-n // plan.splits)[:, None]).all()


def test_scan_plan_fills_the_card():
    """A served batch (64 queries, nprobe 16: T = 144 on the SIFT1M index)
    splits into at least 132 CTAs; a lone query too; nq=10,000 (and any
    nq >= the SM count) keeps one chunk."""
    for nq, T in ((64, 144), (64, 576), (1, 144), (131, 9)):
        assert kivf.split_plan(nq, T, 10, H100_SMS).ctas >= H100_SMS
    for nq in (132, 10_000):
        assert kivf.split_plan(nq, 144, 10, H100_SMS).splits == 1


@pytest.mark.parametrize("topk", [0, kivf.MAX_TOPK + 1])
def test_scan_plan_refuses_topk_outside_the_kernel(topk):
    with pytest.raises(ValueError, match="topk <= 1024"):
        kivf.split_plan(64, 144, topk, H100_SMS)


WARPS = 8  # warps of the scan's pass-1 CTA, one private list each


def _chunk_by_warps(part, ids, bl, topk):
    """The pass-1 CTA on one chunk: candidates in position order (chunk
    slot · bl + row), items of 32 rows to warp (item mod 8), each warp's
    strict-insert list of (value, position, id), then each entry placed at
    its rank: its index plus its count of entries of the other lists below
    it by (value, position)."""
    groups = -(-bl // 32)
    lists = [[] for _ in range(WARPS)]
    for p in range(len(part)):
        if ids[p] < 0:
            continue
        slot, r = divmod(p, bl)
        lst = lists[(slot * groups + r // 32) % WARPS]
        v = float(part[p])
        if len(lst) == topk and not v < lst[-1][0]:
            continue
        lst.insert(sum(e[0] <= v for e in lst), (v, p, int(ids[p])))
        del lst[topk:]
    out_v, out_i = [INF] * topk, [-1] * topk
    keys = [[(e[0], e[1]) for e in lst] for lst in lists]
    for w, lst in enumerate(lists):
        for j, (v, p, i) in enumerate(lst):
            rank = j + sum(bisect.bisect_left(keys[o], (v, p))
                           for o in range(WARPS) if o != w)
            if rank < topk:
                out_v[rank], out_i[rank] = v, i
    return (torch.tensor(out_v, dtype=torch.float32),
            torch.tensor(out_i, dtype=torch.int32))


def _scan_by_chunks(Q, vecs, pids, tm, bl, topk, splits, raw):
    """The per-query scan at ``splits`` chunks of each query's live slots:
    per-chunk ``kernels.ref.ivf_scan`` lists (raw), each equal to the
    warp-private emulation of the pass-1 CTA, merged in chunk order,
    finalised once."""
    Q, vecs, pids, tm = (torch.from_numpy(np.array(a)) for a in
                         (Q, vecs, pids, tm))
    nq = Q.shape[0]
    live = kivf.live_slots(tm, pids, bl)
    bounds = kivf.slot_chunks(live, splits)
    lists = [(torch.full((nq, topk), INF),
              torch.full((nq, topk), -1, dtype=torch.int32))
             for _ in range(splits)]
    offs = torch.arange(bl)
    for q in range(nq):
        slots = torch.nonzero(live[q])[:, 0]
        for s in range(splits):
            a, b = int(bounds[q, s]), int(bounds[q, s + 1])
            if a == b:
                continue
            sub = tm[q, slots[a:b]][None].contiguous()
            ri, rv = tref.ivf_scan(Q[q:q + 1], vecs, pids, sub,
                                   block_rows=bl, topk=topk, raw=True)
            pos = (sub[0].long()[:, None] * bl + offs).reshape(-1)
            v = vecs[pos]
            part = (v * v).sum(-1) - 2.0 * (v * Q[q:q + 1]).sum(-1)
            wv, wi = _chunk_by_warps(part, pids[pos], bl, topk)
            assert torch.equal(wi, ri[0]) and torch.equal(wv, rv[0])
            lists[s][0][q], lists[s][1][q] = rv[0], ri[0]
    v, ids = _merge_in_chunk_order(lists, topk)
    if not raw:
        v = torch.clamp(v + (Q * Q).sum(-1)[:, None], min=0.0)
    return ids, torch.where(ids < 0, INF, v)


def _int_scan_case(seed, nq=6, T=24, ntiles=10, bl=40, d=4):
    """Integer rows and queries (exact partials, ties everywhere); each
    query's map alternates two live tiles (a tile repeated across every
    chunk boundary), then random live tiles, an empty tile and runs of the
    null tile.  bl = 40 leaves a ragged last 32-row group."""
    rng = np.random.default_rng(seed)
    vecs = rng.integers(-2, 3, (ntiles * bl, d)).astype(np.float32)
    pids = np.arange(ntiles * bl, dtype=np.int32)
    pids[rng.random(ntiles * bl) < 0.3] = -1
    pids[:bl] = -1                                   # an empty list tile
    pids[-bl:] = -1                                  # the null tile
    Q = rng.integers(-2, 3, (nq, d)).astype(np.float32)
    tm = rng.integers(0, ntiles - 1, (nq, T)).astype(np.int32)
    tm[:, :6] = [3, 4, 3, 4, 4, 3]
    tm[:, 10:14] = ntiles - 1
    tm[:, -4:] = ntiles - 1
    return Q, vecs, pids, tm, bl


@pytest.mark.parametrize("raw,topk", [(False, 25), (True, 10), (False, 3)])
def test_scan_merge_equals_reference_on_ties(raw, topk):
    """Integer data: the chunked scan at the plan's chunks (one live slot
    each) and at 3 chunks equals the JAX plain scan exactly."""
    Q, vecs, pids, tm, bl = _int_scan_case(topk)
    plan = kivf.split_plan(Q.shape[0], tm.shape[1], topk, H100_SMS)
    assert plan.splits > 3
    want = jref.ivf_scan(*(jnp.asarray(a) for a in (Q, vecs, pids, tm)),
                         block_rows=bl, topk=topk, raw=raw)
    for splits in (plan.splits, 3):
        _assert_equal(_scan_by_chunks(Q, vecs, pids, tm, bl, topk, splits,
                                      raw), want)


def test_scan_merge_equals_pallas_interpret_on_ties():
    """Integer data: the chunked scan equals the Pallas ivf_scan (a running
    top-k over the map's tiles) in interpret mode, exactly."""
    Q, vecs, pids, tm, bl = _int_scan_case(7, nq=4)
    plan = kivf.split_plan(4, tm.shape[1], 10, H100_SMS)
    want = jops.ivf_scan(*(jnp.asarray(a) for a in (Q, vecs, pids, tm)),
                         block_rows=bl, topk=10, force="interpret")
    _assert_equal(_scan_by_chunks(Q, vecs, pids, tm, bl, 10, plan.splits,
                                  False), want)


def test_scan_merge_matches_reference_on_floats():
    """A small JAX index and its tile map at nprobe 3 (null-tile padding
    after short lists): the chunked scan against the JAX plain scan."""
    q, nprobe, topk = 12, 3, 10
    X = _blobs(512, 16, 8, 0)
    C = _blobs(8, 16, 8, 1)
    a = np.argmin(((X[:, None] - C[None]) ** 2).sum(-1), 1).astype(np.int32)
    j = jivf.build_ivf(X, _FakeResult(a, C, 8), block_rows=BL)
    rng = np.random.default_rng(6)
    Q = (X[:q] + 0.1 * rng.standard_normal((q, 16))).astype(np.float32)
    cids, _ = jref.probe_centroids(jnp.asarray(Q), j.centroids, nprobe)
    tm = np.asarray(jivf.build_tile_map(
        cids, j.starts, j.caps, max_tiles=j.max_list_tiles, block_rows=BL,
        null_tile=j.null_tile))
    plan = kivf.split_plan(q, tm.shape[1], topk, H100_SMS)
    assert plan.splits > 1
    args = (Q, np.asarray(j.vecs), np.asarray(j.ids), tm)
    want = jref.ivf_scan(*(jnp.asarray(x) for x in args), block_rows=BL,
                         topk=topk)
    _assert_topk(_scan_by_chunks(*args, BL, topk, plan.splits, False), want,
                 _tol(Q, np.asarray(j.vecs)))


# --------------------------------------------------- refine_merge's merge

PAD = np.uint64(2**64 - 1)
LOW = np.uint64(0xFFFFFFFF)


def _order_key(d):
    """The kernel's order-preserving bits of f32 distances (-0 as +0)."""
    u = np.where(d == 0, np.float32(0), d).astype(np.float32).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u,
                    u | np.uint32(0x80000000)).astype(np.uint64)


def _merge_by_sort(old_ids, old_d, cand_ids, cd, kappa):
    """refine_merge's merge: 64-bit keys (distance bits, position) sorted,
    padded to a power of two >= max(L, 128); each id's lowest sorted rank
    among the finite entries (the kernel's hash table), an entry kept when
    its rank is its id's lowest; a prefix sum over the kept flags in rank
    order gives each its output slot, the first κ taken."""
    ent_i = np.concatenate([old_ids, cand_ids], 1).astype(np.int32)
    ent_d = np.concatenate([old_d, cd], 1).astype(np.float32)
    ent_d = np.where(ent_i < 0, np.float32(INF), ent_d)
    B, L = ent_d.shape
    P = 128
    while P < L:
        P *= 2
    inf_key = _order_key(np.array([INF], np.float32))[0]
    rank = np.arange(P, dtype=np.uint64)
    out_i = np.full((B, kappa), -1, np.int32)
    out_d = np.full((B, kappa), INF, np.float32)
    for b in range(B):
        key = np.full(P, PAD, np.uint64)
        key[:L] = (_order_key(ent_d[b]) << np.uint64(32)) | rank[:L]
        key.sort()
        fin = (key >> np.uint64(32)) < inf_key
        pos = (key & LOW).astype(np.int64)
        lowest = {}
        for j in reversed(np.nonzero(fin)[0]):
            lowest[int(ent_i[b][pos[j]])] = j
        keep = np.zeros(P, bool)
        keep[list(lowest.values())] = True
        slot = np.cumsum(keep) - keep
        take = np.nonzero(keep & (slot < kappa))[0]
        out_i[b, slot[take]] = ent_i[b][pos[take]]
        out_d[b, slot[take]] = ent_d[b][pos[take]]
    return out_i, out_d


@settings(deadline=None, max_examples=16)
@given(st.integers(0, 2**31 - 1), st.integers(1, 64), st.integers(0, 70))
def test_refine_sort_merge_equals_reference(seed, kappa, C):
    """Tie-heavy integer distances and ids from a small range: duplicate
    ids within and across the old and candidate lists, ids of -1, +inf old
    entries and lists that run out.  The sort-based merge equals both
    plain merges (JAX and the port's) bit for bit."""
    rng = np.random.default_rng(seed)
    B = 6
    old_ids = rng.integers(-1, 9, (B, kappa)).astype(np.int32)
    old_d = rng.integers(0, 4, (B, kappa)).astype(np.float32)
    old_d[rng.random((B, kappa)) < 0.2] = INF
    cand_ids = rng.integers(-1, 9, (B, C)).astype(np.int32)
    cd = rng.integers(0, 4, (B, C)).astype(np.float32)
    got = _merge_by_sort(old_ids, old_d, cand_ids, cd, kappa)
    want = jref.merge_lists(*(jnp.asarray(a) for a in
                              (old_ids, old_d, cand_ids, cd)), kappa)
    _assert_equal(got, want)
    port = tref.merge_lists(*(torch.from_numpy(a) for a in
                              (old_ids, old_d, cand_ids, cd)), kappa)
    _assert_equal(got, port)
    if kappa > 9:                    # at most 9 distinct ids: lists run out
        assert (got[0] == -1).any()
