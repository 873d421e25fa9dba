"""The split-and-merge design of the port's ``ivf_scan_adc`` kernel, held
against the JAX package on the CPU.

The CUDA kernel (``kernels/csrc/ivf_scan_adc.cu``) takes the per-query
scan's plan (``ivf_scan.split_plan``): each query's live slots
(``ivf_scan.live_slots``) cut into S contiguous chunks in slot order
(``ivf_scan.slot_chunks``), a CTA per chunk whose eight warps keep private
strict-insert lists of (partial, packed row position, candidate position)
and merge them by each entry's rank by (value, candidate position); the
chunk lists are merged in chunk order, and the last write gathers ids by
position and adds the query constant.  The kernel runs only on a card
(``tests/test_torch_cuda.py``); here that design is emulated in torch at
the plan's chunks and compared with the JAX package's plain
``ivf_scan_adc`` and its Pallas kernel in interpret mode, on the same numpy
inputs.

Tolerances: on integer-valued tables, codes and norms every partial is
exact and ties sit on both sides of chunk boundaries, so positions, ids and
partials must be equal bit for bit; on float data the partials within
1e-5 of the size of the terms they sum, positions equal except at
near-ties.
"""
from __future__ import annotations

import bisect
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import ivf_scan as kivf
from repro_torch.kernels import ivf_scan_adc as kadc
from repro_torch.kernels import ref as tref
from test_torch_split_merge import _merge_in_chunk_order

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


def _partials(lut_q, vnorm, codes, rows, W):
    """vnorm[row] + sum_m of the table terms of each row (a code >= W adds
    0; W = 1 multiplies), in m order, as the kernel sums them."""
    cd = codes[rows].long()                               # (n, M)
    M = cd.shape[1]
    acc = torch.zeros(rows.shape[0])
    for m in range(M):
        if W == 1:
            term = lut_q[m, 0] * cd[:, m].float()
        else:
            term = torch.where(cd[:, m] < W,
                               lut_q[m, cd[:, m].clamp(max=W - 1)], 0.0)
        acc = acc + term
    return vnorm[rows] + acc


WARPS = 8  # warps of the pass-1 CTA, one private list each


def _chunk_by_warps(part, payload, bl, topk, rng):
    """The pass-1 CTA on one chunk: candidates in position order (chunk
    slot · bl + row), items of 32 rows to warp (item mod 8), the warps'
    items interleaved in the order ``rng`` draws (each warp's own in
    order).  An item's candidates are its live rows strictly below the
    warp's k-th entry and not above ``low()``; they wait
    in the warp's buffer of 32, which goes into the list (strict inserts in
    position order: what the kernel's one-step merge gives) when the next
    item's candidates would overflow it, and at the end.  Then each entry
    at or below ``low()`` lands at its rank: its index plus its count
    of the other lists' entries below it by (value, position).  Returns
    (values, payloads) of the chunk's list."""
    groups = -(-bl // 32)
    n_items = len(part) // bl * groups
    todo = [list(range(w, n_items, WARPS)) for w in range(WARPS)]
    lists = [[] for _ in range(WARPS)]
    bufs = [[] for _ in range(WARPS)]

    def kth(lst, j=topk):
        return lst[j - 1][0] if len(lst) >= j else INF

    def low():
        """A value k candidates lie at or below: any list's k-th, or the
        largest of the lists' c-th entries, c = ceil(k / 8)."""
        c = -(-topk // WARPS)
        return min(min(kth(x) for x in lists), max(kth(x, c) for x in lists))

    def flush(w):
        lst = lists[w]
        for v, p, i in bufs[w]:
            if v < kth(lst):
                lst.insert(sum(e[0] <= v for e in lst), (v, p, i))
                del lst[topk:]
        bufs[w] = []
    while any(todo):
        w = rng.choice([i for i in range(WARPS) if todo[i]])
        item = todo[w].pop(0)
        slot, g = divmod(item, groups)
        own, thr = kth(lists[w]), low()
        rows = range(slot * bl + 32 * g, slot * bl + min(32 * g + 32, bl))
        cands = [(float(part[p]), p, int(payload[p])) for p in rows
                 if payload[p] >= 0 and float(part[p]) < own
                 and float(part[p]) <= thr]
        if len(bufs[w]) + len(cands) > 32:
            flush(w)
        bufs[w] += cands
    for w in range(WARPS):
        flush(w)
    out_v, out_i = [INF] * topk, [-1] * topk
    keys = [[(e[0], e[1]) for e in lst] for lst in lists]
    bound = low()
    for w, lst in enumerate(lists):
        for j, (v, p, i) in enumerate(lst):
            if v > bound:                # some list holds k entries below
                continue
            rank = j + sum(bisect.bisect_left(keys[o], (v, p))
                           for o in range(WARPS) if o != w)
            if rank < topk:
                out_v[rank], out_i[rank] = v, i
    return (torch.tensor(out_v, dtype=torch.float32),
            torch.tensor(out_i, dtype=torch.int32))


def _adc_by_chunks(lut, qconst, vnorm, codes, pids, tm, bl, topk, splits,
                   exact=True):
    """The ADC scan at ``splits`` chunks of each query's live slots: each
    chunk's list from the pass-1 CTA's warp-private lists (payload: the
    packed row position; the warps' items interleaved at random, with the
    kernel's cross-warp pruning) — with ``exact`` (integer data) checked
    equal to
    ``kernels.ref.ivf_scan_adc`` on the chunk's slots — merged in chunk
    order; ids by position and qconst added at the end."""
    lut, qconst, vnorm, codes, pids, tm = (
        torch.from_numpy(np.array(a)) for a in
        (lut, qconst, vnorm, codes, pids, tm))
    nq, _, W = lut.shape
    rng = random.Random(splits * 1000 + topk)
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
            _, rp, rv = tref.ivf_scan_adc(lut[q:q + 1], torch.zeros(1),
                                          vnorm, codes, pids, sub,
                                          block_rows=bl, topk=topk)
            pos = (sub[0].long()[:, None] * bl + offs).reshape(-1)
            part = _partials(lut[q], vnorm, codes, pos, W)
            payload = torch.where(pids[pos] >= 0, pos, -1)
            wv, wp = _chunk_by_warps(part, payload, bl, topk, rng)
            if exact:
                assert torch.equal(wp, rp[0]) and torch.equal(wv, rv[0])
            lists[s][0][q], lists[s][1][q] = wv, wp
    v, pos = _merge_in_chunk_order(lists, topk)
    empty = pos < 0
    ids = torch.where(empty, -1, pids[pos.clamp(min=0).long()])
    part = torch.where(empty, INF, v + qconst[:, None])
    return ids, pos, part


def _int_adc_case(seed, W, nq=5, T=24, ntiles=10, bl=40, M=6):
    """Integer tables, codes and norms (exact partials, ties everywhere);
    each query's map alternates two live tiles (a tile repeated across every
    chunk boundary), then random tiles, an empty list tile and runs of the
    null tile.  Codes reach past W (they add 0); bl = 40 leaves a ragged
    last 32-row group."""
    rng = np.random.default_rng(seed)
    lut = rng.integers(-3, 4, (nq, M, W)).astype(np.float32)
    codes = rng.integers(0, 4 if W == 1 else min(2 * W, 256),
                         (ntiles * bl, M)).astype(np.uint8)
    vnorm = rng.integers(0, 6, ntiles * bl).astype(np.float32)
    pids = np.arange(ntiles * bl, dtype=np.int32)
    pids[rng.random(ntiles * bl) < 0.3] = -1
    pids[:bl] = -1                                   # an empty list tile
    pids[-bl:] = -1                                  # the null tile
    tm = rng.integers(0, ntiles - 1, (nq, T)).astype(np.int32)
    tm[:, :6] = [3, 4, 3, 4, 4, 3]
    tm[:, 10:14] = ntiles - 1
    tm[:, -4:] = ntiles - 1
    qconst = rng.integers(-2, 3, nq).astype(np.float32)
    return lut, qconst, vnorm, codes, pids, tm, bl


def _assert_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("W", [1, 16, 256])
@pytest.mark.parametrize("topk", [1, 3, 16, 25])
def test_adc_split_equals_reference_on_ties(W, topk):
    """Integer data: the chunked scan at S = 1, 2, 5 and T (mostly one live
    slot a chunk) equals the JAX plain ADC scan exactly — positions, ids
    and partials.  T = 48 slots give each warp several items, so the
    cross-warp bound prunes (topk 16: two entries a list make it)."""
    *args, bl = _int_adc_case(W + topk, W, T=48, ntiles=16)
    want = jref.ivf_scan_adc(*(jnp.asarray(a) for a in args), block_rows=bl,
                             topk=topk)
    T = args[-1].shape[1]
    for splits in (1, 2, 5, T):
        _assert_equal(_adc_by_chunks(*args, bl, topk, splits), want)


@pytest.mark.parametrize("W", [1, 256])
def test_adc_split_equals_pallas_interpret_on_ties(W):
    """Integer data: the chunked scan at the plan's own S equals the Pallas
    ivf_scan_adc (a running top-k over the map's tiles) in interpret mode,
    exactly."""
    *args, bl = _int_adc_case(11, W, nq=3, T=12)
    nq, T = args[-1].shape
    plan = kivf.split_plan(nq, T, 10, H100_SMS)
    assert plan.splits > 1
    want = jops.ivf_scan_adc(*(jnp.asarray(a) for a in args), block_rows=bl,
                             topk=10, force="interpret")
    _assert_equal(_adc_by_chunks(*args, bl, 10, plan.splits), want)


def test_adc_split_matches_reference_on_floats():
    """Float tables and norms: the chunked scan at the plan's S against the
    JAX plain scan, partials within 1e-5 of the size of their terms,
    positions equal except at near-ties."""
    rng = np.random.default_rng(8)
    nq, M, W, bl, ntiles, T, topk = 6, 8, 256, 32, 12, 10, 10
    lut = rng.standard_normal((nq, M, W)).astype(np.float32)
    codes = rng.integers(0, 256, (ntiles * bl, M)).astype(np.uint8)
    vnorm = (rng.random(ntiles * bl) * 20).astype(np.float32)
    pids = np.arange(ntiles * bl, dtype=np.int32)
    pids[rng.random(ntiles * bl) < 0.5] = -1
    pids[-bl:] = -1
    tm = rng.integers(0, ntiles, (nq, T)).astype(np.int32)
    qconst = rng.standard_normal(nq).astype(np.float32)
    args = (lut, qconst, vnorm, codes, pids, tm)
    plan = kivf.split_plan(nq, T, topk, H100_SMS)
    assert plan.splits > 1
    gi, gp, gd = (np.asarray(a) for a in
                  _adc_by_chunks(*args, bl, topk, plan.splits, exact=False))
    wi, wp, wd = (np.asarray(a) for a in jref.ivf_scan_adc(
        *(jnp.asarray(a) for a in args), block_rows=bl, topk=topk))
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    np.testing.assert_array_equal(gp[~fin], wp[~fin])
    scale = (np.abs(vnorm[np.clip(wp, 0, None)]) + M * np.abs(lut).max()
             + np.abs(qconst)[:, None])
    gap = np.abs(np.where(fin, gd - wd, 0.0))
    assert (gap[fin] <= 1e-5 * scale[fin]).all()
    near = fin & (gap <= 1e-5 * scale)
    assert ((gp == wp) | near).all() and ((gi == wi) | near).all()


@pytest.mark.parametrize("nq,T,topk", [(64, 144, 40), (64, 576, 40),
                                       (1, 144, 40), (10_000, 144, 40),
                                       (64, 144, 1024), (3, 2, 1)])
def test_adc_plan_fills_the_card_and_covers_live_slots(nq, T, topk):
    """The ADC wrapper launches with the per-query scan's plan: a served
    batch (64 queries at nprobe 16, T = 144) fills the card with at least
    132 CTAs (one query too), nq=10,000 keeps one chunk, S · topk stays
    within one merging warp's budget, scratch is (nq, S, topk); the
    chunks cover each query's live slots in order."""
    plan = kivf.split_plan(nq, T, topk, H100_SMS)
    if nq < H100_SMS:
        assert plan.ctas >= min(H100_SMS, nq * T)
    else:
        assert plan.splits == 1
    assert plan.splits == 1 or plan.splits * topk <= kivf.MAX_MERGE
    rng = np.random.default_rng(T)
    bl, n_tiles, q = 8, 40, min(nq, 16)
    pids = rng.integers(0, 50, n_tiles * bl).astype(np.int32)
    pids[rng.random(pids.size) < 0.5] = -1
    pids[-bl:] = -1
    tm = rng.integers(-1, n_tiles + 1, (q, T)).astype(np.int32)
    tm[:, T // 2:] = n_tiles - 1                    # null padding
    live = kivf.live_slots(torch.from_numpy(tm), torch.from_numpy(pids), bl)
    b = kivf.slot_chunks(live, plan.splits).numpy()
    n = live.sum(1).numpy()
    assert (b[:, 0] == 0).all() and (b[:, -1] == n).all()
    assert (np.diff(b, axis=1) >= 0).all()


class _Launched(Exception):
    pass


class _FakeFn:
    argtypes = None
    restype = None


class _FakeLib:
    def __getattr__(self, name):
        return _FakeFn()


@pytest.mark.parametrize("nq,sms", [(64, 132), (10_000, 132), (3, 1)])
def test_adc_wrapper_launches_its_plan(monkeypatch, nq, sms):
    """The wrapper hands the kernel split_plan's S and (nq, S, topk)
    scratch when S > 1 (null pointers otherwise), and the outputs ids, pos
    and part: no PyTorch op runs after the launch."""
    seen = {}

    def fake_launch(name, fn, dev, *args):
        seen["args"] = args
        raise _Launched(name)
    monkeypatch.setattr(_build, "launch", fake_launch)
    monkeypatch.setattr(_build, "check_tensor", lambda *a, **k: None)
    monkeypatch.setattr(_build, "library", lambda name: _FakeLib())
    monkeypatch.setattr(_build, "sm_count", lambda index: sms)
    T, topk, bl = 144, 40, 8
    with pytest.raises(_Launched):
        kadc.ivf_scan_adc(torch.zeros(nq, 8, 256), torch.zeros(nq),
                          torch.zeros(16), torch.zeros((16, 8),
                                                       dtype=torch.uint8),
                          torch.zeros(16, dtype=torch.int32),
                          torch.zeros((nq, T), dtype=torch.int32),
                          block_rows=bl, topk=topk)
    args = seen["args"]
    plan = kivf.split_plan(nq, T, topk, sms)
    assert args[-1] == plan.splits and args[-2] == topk
    scratch = args[9:11]
    assert all(p is None for p in scratch) == (plan.splits == 1)
