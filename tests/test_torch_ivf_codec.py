"""The port's compressed-list (int8/PQ) and query-grouped IVF paths vs the
JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages; the JAX
side runs its plain versions (``force="ref"``) and, in two small cases, its
Pallas bodies in interpret mode.  Tolerances, each with its reason:

* scan partials: per slot 1e-5·(the magnitudes of the terms summed), i.e.
  ``vnorm + Σ_m |lut[m, code[m]]|`` for the ADC scan and ``||q||² + ||v||²``
  for the f32 scans — the two sides sum in different orders;
* ids and row positions: equal, except at a slot where the two selected
  values agree within that limit (a near-tie that rounding decides);
* integer-valued tables, codes and norms: everything exact, ties included;
* ``build_group_map``, ``train_int8`` and the packed layouts: exact;
* int8 codes: exact except where ``(x − zero)/scale`` lies within 1e-4 of
  a half (rounding of the quotient decides), counted; PQ codes: exact
  except where the two nearest codebook entries are within 1e-5·‖c‖² of
  each other, counted;
* PQ codebooks with the reference's draws: within 1e-4 (the engine's
  matmul rounds differently; the moves agree);
* engine runs on the dense source: as tests/test_torch_core.py's graph
  source (moves and counts exact, D and distortions to f32 rounding).
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import index as jivf
from repro.core import engine as jeng
from repro.core import permute as jperm
from repro.index import quantize as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import index as tivf
from repro_torch import interop
from repro_torch.core import engine as teng
from repro_torch.index import probe as tprobe
from repro_torch.index import quantize as tq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve_index as tserve


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them as fast and
    leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeResult:
    """Stands in for a GKMeansResult in build_ivf."""
    def __init__(self, assign, centroids, k):
        self.assign, self.centroids, self.k = assign, centroids, k


def _blobs(n, d, comps, seed, spread=4.0):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((comps, d)) * spread
    comp = rng.integers(0, comps, size=n)
    return (means[comp] + rng.standard_normal((n, d))).astype(np.float32)


N, D, K, BL = 512, 16, 8, 16          # the small index of most tests


def _jax_index(seed=0, n=N):
    X = _blobs(n, D, K, seed)
    C = _blobs(K, D, K, seed + 1)
    a = np.argmin(((X[:, None] - C[None]) ** 2).sum(-1), 1).astype(np.int32)
    return X, jivf.build_ivf(X, FakeResult(a, C, K), block_rows=BL)


@pytest.fixture(scope="module")
def coded():
    """{kind: (X, JAX index with that codec)}; PQ has nsub=4 (dsub=4)."""
    X, j = _jax_index()
    return {"int8": (X, jivf.quantize_index(j, "int8")),
            "pq": (X, jivf.quantize_index(j, "pq", nsub=4, iters=3,
                                          key=jax.random.PRNGKey(7)))}


def _np(a):
    return np.asarray(a)


def _t(a):
    """A writable torch copy of a (read-only) JAX or numpy array."""
    return torch.from_numpy(np.array(a))


def _codec_arrays(j):
    if j.codec is None:
        return {}
    kw = {"codes": _np(j.codes), "vnorm": _np(j.vnorm)}
    if j.codec.kind == "int8":
        kw.update(int8_scale=_np(j.codec.scale), int8_zero=_np(j.codec.zero))
    else:
        kw["pq_codebook"] = _np(j.codec.codebook)
    return kw


def _to_port(j):
    """A JAX index, codec included, carried over by interop.ivf_index."""
    return interop.ivf_index(
        *(_np(getattr(j, f)) for f in
          ("centroids", "vecs", "ids", "starts", "caps")),
        j.block_rows, j.repack_threshold, device="cpu", **_codec_arrays(j))


def _queries(X, nq, seed):
    rng = np.random.default_rng(seed)
    return (X[:nq] + 0.1 * rng.standard_normal((nq, X.shape[1]))).astype(
        np.float32)


def _smallest_list_rows(X, j):
    """The rows of the smallest non-empty list: queries near them that
    probe one list run out of candidates before a topk of 20."""
    sizes = j.list_sizes()
    c = int(np.argmin(np.where(sizes > 0, sizes, 1 << 30)))
    s, cap = int(j.starts[c]), int(j.caps[c])
    ids = _np(j.ids)[s:s + cap]
    assert 0 < (ids >= 0).sum() < 20
    return X[ids[ids >= 0]]


def _tile_map(j, Q, nprobe):
    cids, _ = jref.probe_centroids(jnp.asarray(Q), j.centroids, nprobe)
    return _np(jivf.build_tile_map(cids, j.starts, j.caps,
                                   max_tiles=j.max_list_tiles,
                                   block_rows=j.block_rows,
                                   null_tile=j.null_tile))


def _assert_sel(gi, gd, wi, wd, lim):
    """-1/+inf pattern exact; values within ``lim`` per slot; ids (or
    positions) equal except at near-ties.  Returns the near-tie count."""
    gi, gd, wi, wd = (np.asarray(a) for a in (gi, gd, wi, wd))
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    np.testing.assert_array_equal(gi[~fin], wi[~fin])
    gap = np.abs(np.where(fin, gd, 0.0) - np.where(fin, wd, 0.0))
    lim = np.broadcast_to(lim, gap.shape)
    assert (gap[fin] <= lim[fin]).all(), float((gap / lim)[fin].max())
    assert ((gi == wi) | (fin & (gap <= lim))).all()
    return int(((gi != wi) & fin).sum())


# ------------------------------------------------------- plain ADC scan vs JAX

def _adc_inputs(coded, kind, nq=24, nprobe=3, exhaust=False):
    X, j = coded[kind]
    Q = _queries(_smallest_list_rows(X, j) if exhaust else X, nq, 3)
    lut, qc = jq.build_lut(j.codec, jnp.asarray(Q))
    return (_np(lut), _np(qc), _np(j.vnorm), _np(j.codes), _np(j.ids),
            _tile_map(j, Q, nprobe))


def _adc_limit(lut, vnorm, codes, pos):
    """1e-5·(vnorm + Σ_m |lut[m, code[m]]|) of each selected row."""
    nq, M, W = lut.shape
    p = np.maximum(pos, 0)
    c = codes[p].astype(np.int64)                            # (q, k, M)
    if W == 1:
        terms = lut[:, None, :, 0] * c
    else:
        terms = np.take_along_axis(lut[:, None], c[..., None], -1)[..., 0]
    return 1e-5 * (np.abs(vnorm[p]) + np.abs(terms).sum(-1))


@pytest.mark.parametrize("kind,topk,nprobe", [("int8", 10, 3), ("pq", 10, 3),
                                              ("pq", 40, 3), ("int8", 20, 1)])
def test_adc_ref_matches_jax(coded, kind, topk, nprobe):
    """Both codecs; topk=40 is the default rerank depth; nprobe=1 near the
    smallest list runs past the candidates (exhausted slots -1/+inf)."""
    exhaust = nprobe == 1
    args = _adc_inputs(coded, kind, nq=6 if exhaust else 24, nprobe=nprobe,
                       exhaust=exhaust)
    kw = dict(block_rows=BL, topk=topk)
    wi, wp, wd = (_np(a) for a in jref.ivf_scan_adc(
        *(jnp.asarray(a) for a in args), **kw))
    gi, gp, gd = tref.ivf_scan_adc(*(_t(a) for a in args), **kw)
    lim = _adc_limit(args[0], args[2], args[3], wp)
    _assert_sel(gp, gd, wp, wd, lim)
    _assert_sel(gi, gd, wi, wd, lim)
    if exhaust:
        assert (gp.numpy() == -1).any()


@pytest.mark.parametrize("W", [1, 256])
def test_adc_ref_integer_ties_exact(W):
    """Integer tables, codes and norms: sums are exact, partials tie often,
    and the slot-then-row order must pick the same positions."""
    rng = np.random.default_rng(W)
    nq, M, ntiles = 9, 6, 12
    lut = rng.integers(-3, 4, (nq, M, W)).astype(np.float32)
    codes = rng.integers(0, 4 if W == 1 else 256, (ntiles * BL, M)).astype(
        np.uint8)
    vnorm = rng.integers(0, 5, ntiles * BL).astype(np.float32)
    pids = np.arange(ntiles * BL, dtype=np.int32)
    pids[rng.random(ntiles * BL) < 0.2] = -1
    pids[-BL:] = -1                                          # null tile
    tm = rng.integers(0, ntiles, (nq, 5)).astype(np.int32)
    qc = rng.integers(-2, 3, nq).astype(np.float32)
    args = (lut, qc, vnorm, codes, pids, tm)
    want = jref.ivf_scan_adc(*(jnp.asarray(a) for a in args), block_rows=BL,
                             topk=30)
    got = tref.ivf_scan_adc(*(_t(a) for a in args), block_rows=BL, topk=30)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def test_adc_matches_pallas_interpret(coded):
    args = _adc_inputs(coded, "pq", nq=4, nprobe=2)
    wi, wp, wd = (_np(a) for a in jops.ivf_scan_adc(
        *(jnp.asarray(a) for a in args), block_rows=BL, topk=10,
        force="interpret"))
    gi, gp, gd = tops.ivf_scan_adc(*(_t(a) for a in args), block_rows=BL,
                                   topk=10)
    _assert_sel(gp, gd, wp, wd, _adc_limit(args[0], args[2], args[3], wp))


# --------------------------------------------------- group map and grouped scan

@pytest.mark.parametrize("q,G,nprobe", [(32, 8, 3), (37, 4, 2), (5, 8, 4),
                                        (12, 1, 2)])
def test_build_group_map_matches_jax(q, G, nprobe):
    """Ragged tails (37 % 4, 5 < 8) carry index q; integer work, exact."""
    X, j = _jax_index(seed=q)
    tm = _tile_map(j, _queries(X, q, q + 1), nprobe)
    want = jivf.build_group_map(jnp.asarray(tm), group=G,
                                null_tile=j.null_tile)
    got = tprobe.build_group_map(_t(tm), group=G, null_tile=j.null_tile)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), _np(w))


def _grouped_inputs(q=24, G=4, nprobe=3, seed=0, exhaust=False):
    X, j = _jax_index(seed)
    Q = _queries(_smallest_list_rows(X, j) if exhaust else X, q, seed + 5)
    order, union, qmask = (_np(a) for a in jivf.build_group_map(
        jnp.asarray(_tile_map(j, Q, nprobe)), group=G,
        null_tile=j.null_tile))
    Qg = Q[np.clip(order, 0, q - 1)]
    return X, (Qg, _np(j.vecs), _np(j.ids), union, qmask)


def _pair_limit(Q, X, ids):
    """1e-5·(||q||² + ||v||²) of each selected pair (row i holds id i)."""
    xsq = (X.astype(np.float64) ** 2).sum(-1)
    qsq = (Q.astype(np.float64) ** 2).sum(-1)
    return 1e-5 * (qsq[:, None] + xsq[np.maximum(ids, 0)])


@pytest.mark.parametrize("raw,topk,nprobe", [(False, 10, 3), (True, 7, 3),
                                             (False, 20, 1)])
def test_grouped_ref_matches_jax(raw, topk, nprobe):
    exhaust = nprobe == 1
    X, args = _grouped_inputs(q=8 if exhaust else 24, nprobe=nprobe,
                              exhaust=exhaust)
    kw = dict(block_rows=BL, topk=topk, raw=raw)
    wi, wd = (_np(a) for a in jref.ivf_scan_grouped(
        *(jnp.asarray(a) for a in args), **kw))
    gi, gd = tref.ivf_scan_grouped(*(_t(a) for a in args), **kw)
    _assert_sel(gi, gd, wi, wd, _pair_limit(args[0], X, wi))
    if exhaust:
        assert (gi.numpy() == -1).any()


def test_grouped_ref_integer_ties_exact():
    """Integer rows and queries: union slot order, then row order, decide
    every tie, exactly as the reference."""
    rng = np.random.default_rng(11)
    ntiles, d, G, ng, U = 10, 4, 4, 3, 6
    vecs = rng.integers(-2, 3, (ntiles * BL, d)).astype(np.float32)
    pids = np.arange(ntiles * BL, dtype=np.int32)
    pids[rng.random(ntiles * BL) < 0.2] = -1
    Qg = rng.integers(-2, 3, (ng * G, d)).astype(np.float32)
    union = np.sort(rng.integers(0, ntiles, (ng, U)), 1).astype(np.int32)
    qmask = (rng.random((ng * G, U)) < 0.6).astype(np.int32)
    args = (Qg, vecs, pids, union, qmask)
    want = jref.ivf_scan_grouped(*(jnp.asarray(a) for a in args),
                                 block_rows=BL, topk=25)
    got = tref.ivf_scan_grouped(*(_t(a) for a in args), block_rows=BL,
                                topk=25)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def test_grouped_matches_pallas_interpret():
    X, args = _grouped_inputs(q=8, G=4, nprobe=2)
    wi, wd = jops.ivf_scan_grouped(*(jnp.asarray(a) for a in args),
                                   block_rows=BL, topk=10, force="interpret")
    gi, gd = tops.ivf_scan_grouped(*(_t(a) for a in args), block_rows=BL,
                                   topk=10)
    _assert_sel(gi, gd, wi, wd, _pair_limit(args[0], X, _np(wi)))


# --------------------------------------------------------------- rerank tail

def test_exact_rerank_matches_jax():
    X, j = _jax_index(seed=4)
    rng = np.random.default_rng(4)
    Q = _queries(X, 16, 9)
    pos = rng.integers(0, j.n_rows, (16, 40)).astype(np.int32)
    pos[rng.random(pos.shape) < 0.2] = -1
    pos[0] = -1                                         # no survivor at all
    wi, wp = jivf.probe.exact_rerank(jnp.asarray(Q), j.vecs, j.ids,
                                     jnp.asarray(pos), topk=10)
    gi, gp = tprobe.exact_rerank(_t(Q), _t(j.vecs), _t(j.ids), _t(pos),
                                 topk=10)
    _assert_sel(gi, gp, wi, wp, _pair_limit(Q, X, _np(wi)))
    assert (gi[0] == -1).all()


# ------------------------------------------------------------------- codecs

def _port_codec(jc):
    if jc.kind == "int8":
        return tq.Int8Codec(_t(jc.scale), _t(jc.zero))
    return tq.PqCodec(_t(jc.codebook))


def _code_near_ties(codec, X):
    """Rows x columns where rounding may decide the code (see the module
    docstring), as a boolean mask of the codes' shape."""
    if codec.kind == "int8":
        u = (X - _np(codec.zero)) / _np(codec.scale)
        return np.abs(np.abs(u - np.floor(u)) - 0.5) < 1e-4
    cb = _np(codec.codebook).astype(np.float64)
    Xs = X.reshape(X.shape[0], codec.nsub, -1).astype(np.float64)
    d2 = ((Xs[:, :, None, :] - cb[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=-1)[..., :2]
    return two[..., 1] - two[..., 0] <= 1e-5 * (cb ** 2).sum(-1).max()


@pytest.mark.parametrize("kind", ["int8", "pq"])
def test_codec_functions_match_jax(coded, kind):
    """encode / decode / pack_codes / build_lut / bytes_per_row."""
    X, j = coded[kind]
    tc = _port_codec(j.codec)
    Xe = np.concatenate([X, np.zeros((3, D), np.float32),
                         X[:5] * 3.0])                  # holes, clamped codes
    want = _np(jq.encode(j.codec, jnp.asarray(Xe)))
    got = tq.encode(tc, _t(Xe)).numpy()
    assert got.dtype == np.uint8
    off = got != want
    assert not (off & ~_code_near_ties(j.codec, Xe)).any()
    assert off.sum() <= 2
    codes = _np(j.codes)
    scale = float((X.astype(np.float64) ** 2).sum(-1).max())
    np.testing.assert_allclose(tq.decode(tc, _t(codes)).numpy(),
                               _np(jq.decode(j.codec, j.codes)), rtol=1e-6,
                               atol=1e-6)
    gc, gv = tq.pack_codes(tc, _t(j.vecs))
    wc, wv = jq.pack_codes(j.codec, j.vecs)
    assert not ((gc.numpy() != _np(wc)) & ~_code_near_ties(
        j.codec, _np(j.vecs))).any()
    same = (gc.numpy() == _np(wc)).all(-1)
    np.testing.assert_allclose(gv.numpy()[same], _np(wv)[same], rtol=1e-6,
                               atol=1e-6 * scale)
    Q = _queries(X, 7, 1)
    gl, gq = tq.build_lut(tc, _t(Q))
    wl, wq = jq.build_lut(j.codec, jnp.asarray(Q))
    np.testing.assert_allclose(gl.numpy(), _np(wl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gq.numpy(), _np(wq), rtol=1e-5, atol=1e-5)
    assert tq.bytes_per_row(tc, D) == jq.bytes_per_row(j.codec, D)
    assert tq.code_width(tc, D) == jq.code_width(j.codec, D)
    assert tq.lut_width(tc) == jq.lut_width(j.codec)


def test_train_int8_exact():
    X = _blobs(300, D, 4, 21)
    X[:, 3] = 1.5                                         # a constant dim
    w = jq.train_int8(jnp.asarray(X))
    g = tq.train_int8(_t(X))
    np.testing.assert_array_equal(g.scale.numpy(), _np(w.scale))
    np.testing.assert_array_equal(g.zero.numpy(), _np(w.zero))


@pytest.mark.parametrize("n", [2048, 100])
def test_train_pq_with_reference_draws(n):
    """The reference's seed rows and epoch subkeys injected; n=100 < 256
    pads the codebook with copies of row 0."""
    X = _blobs(n, 8, 16, 31)
    nsub, iters = 2, 3
    key = jax.random.PRNGKey(5)
    ksub = min(256, n)
    w = jq.train_pq(jnp.asarray(X), nsub, key=key, iters=iters,
                    batch_size=256)
    seeds, words = [], []
    for m in range(nsub):
        km = jax.random.fold_in(key, m)
        seeds.append(torch.from_numpy(
            _np(jperm.epoch_order(km, n))[:ksub].astype(np.int64)))
        rk = jax.random.fold_in(km, 1)
        words.append(interop.epoch_words(
            [_np(jax.random.bits(jax.random.fold_in(rk, t), (4,),
                                 jnp.uint32)) for t in range(iters)]))
    g = tq.train_pq(_t(X), nsub, iters=iters, batch_size=256,
                    seed_rows=seeds, epoch_words=words)
    assert g.codebook.shape == (nsub, 256, 4)
    np.testing.assert_allclose(g.codebook.numpy(), _np(w.codebook),
                               rtol=1e-4, atol=1e-4)
    if n < 256:
        np.testing.assert_array_equal(g.codebook[:, n:].numpy(),
                                      np.broadcast_to(
                                          g.codebook[:, :1].numpy(),
                                          (nsub, 256 - n, 4)))


# ------------------------------------------------------------- search paths

@pytest.mark.parametrize("kind,rerank", [("int8", None), ("pq", None),
                                         ("pq", 0), ("int8", 25)])
def test_search_codec_matches_jax(coded, kind, rerank):
    """A JAX index with a codec, carried over by interop.ivf_index, searches
    to the same ids (rerank at its default, off, and explicit)."""
    X, j = coded[kind]
    t = _to_port(j)
    assert t.codec_kind == kind
    np.testing.assert_array_equal(t.codes.numpy(), _np(j.codes))
    Q = _queries(X, 32, 6)
    kw = dict(topk=10, nprobe=3, codec=kind, rerank=rerank)
    wi, wd = jivf.search(j, jnp.asarray(Q), force="ref", **kw)
    gi, gd = tivf.search(t, _t(Q), **kw)
    if rerank == 0:       # distances to the reconstructions: ADC terms
        lim = 1e-5 * (np.abs(_np(wd)) + _pair_limit(Q, X, _np(wi)) * 1e5)
    else:
        lim = _pair_limit(Q, X, _np(wi))
    _assert_sel(gi, gd, wi, wd, lim)


@pytest.mark.parametrize("qgroup,nprobe", [(4, 3), (8, 8), (3, 1)])
def test_search_grouped_matches_jax(qgroup, nprobe):
    """On an index carried across: the grouped search equals the
    reference's, and the port's per-query search at distinct distances."""
    X, j = _jax_index(seed=8)
    t = _to_port(j)
    Q = _queries(X, 30, 10)                 # 30 % 4, 30 % 8: ragged tails
    wi, wd = jivf.search(j, jnp.asarray(Q), topk=10, nprobe=nprobe,
                         qgroup=qgroup, force="ref")
    gi, gd = tivf.search(t, _t(Q), topk=10, nprobe=nprobe, qgroup=qgroup)
    lim = _pair_limit(Q, X, _np(wi))
    _assert_sel(gi, gd, wi, wd, lim)
    pi, pd = tivf.search(t, _t(Q), topk=10, nprobe=nprobe)
    assert _assert_sel(gi, gd, pi, pd, lim) <= 2


# ------------------------------------------------------ engine: dense source

@pytest.fixture(scope="module")
def blobs():
    return _blobs(1024, 16, 32, 42, spread=4.0)


@pytest.mark.parametrize("mode", ["bkm", "lloyd"])
def test_dense_epoch_matches_jax(blobs, mode):
    """One epoch (8 move steps) from the same state: the same moves and
    counts, D to float32 rounding."""
    X, k = blobs, 32
    a = np.random.default_rng(4).integers(0, k, X.shape[0]).astype(np.int32)
    key = jax.random.PRNGKey(9)
    js = jeng.init_state(jnp.asarray(X), jnp.asarray(a), k)
    jout = jeng.epoch(jnp.asarray(X), js, jeng.dense_source(), key,
                      jeng.EngineConfig(batch_size=128, mode=mode))
    tst = interop.bkm_state(_np(js.assign), _np(js.D), _np(js.cnt),
                            device="cpu")
    tout = teng.epoch(_t(X), tst, teng.dense_source(),
                      _np(jax.random.bits(key, (4,), jnp.uint32)),
                      teng.EngineConfig(batch_size=128, mode=mode))
    np.testing.assert_array_equal(tout.assign.numpy(), _np(jout.assign))
    assert int(tout.moves) == int(jout.moves) > 0
    np.testing.assert_array_equal(tout.cnt.numpy(), _np(jout.cnt))
    np.testing.assert_allclose(tout.D.numpy(), _np(jout.D), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("mode", ["bkm", "lloyd"])
def test_dense_run_matches_jax(blobs, mode):
    X, k, iters = blobs, 16, 4
    a = np.random.default_rng(6).integers(0, k, X.shape[0]).astype(np.int32)
    kb = jax.random.PRNGKey(3)
    cfg = jeng.EngineConfig(batch_size=256, mode=mode, iters=iters)
    st = jeng.init_state(jnp.asarray(X), jnp.asarray(a), k)
    st, hist, _, ep, final, _ = jeng.run(jnp.asarray(X), st,
                                         jeng.dense_source(), kb, cfg)
    words = interop.epoch_words(
        [_np(jax.random.bits(jax.random.fold_in(kb, t), (4,), jnp.uint32))
         for t in range(iters)])
    js = jeng.init_state(jnp.asarray(X), jnp.asarray(a), k)
    tst = interop.bkm_state(_np(js.assign), _np(js.D), _np(js.cnt),
                            device="cpu")
    res = teng.run(_t(X), tst, teng.dense_source(),
                   teng.EngineConfig(batch_size=256, mode=mode, iters=iters),
                   epoch_words=words)
    ep = int(ep)
    assert res.epochs == ep and res.host_syncs == ep
    np.testing.assert_allclose(res.history, _np(hist)[:ep], rtol=1e-4)
    np.testing.assert_allclose(float(res.final), float(final), rtol=1e-4)
    np.testing.assert_array_equal(res.state.cnt.numpy(), _np(st.cnt))


# ------------------------------------------------------ lockstep and storage

def _assert_lockstep(t):
    codes, vnorm = tq.pack_codes(t.codec, t.vecs)
    np.testing.assert_array_equal(t.codes.numpy(), codes.numpy())
    np.testing.assert_allclose(t.vnorm.numpy(), vnorm.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["int8", "pq"])
def test_codec_lockstep_through_updates(coded, kind):
    """codes == encode(vecs) after a hole-filling add, an overflowing add
    (a repack), remove (codes untouched) and repack; the layouts equal the
    reference's."""
    X, j = coded[kind]
    t = _to_port(j)
    # tombstones first, so rows near the removed ones fill holes in place
    jr, tr = jivf.remove(j, np.arange(40)), tivf.remove(t, torch.arange(40))
    for m in (5, 300):
        Xn = X[:m] + 0.01 if m == 5 else _blobs(m, D, K, 77)
        j2, t2 = jivf.add(jr, Xn), tivf.add(tr, _t(Xn))
        assert (t2.n_rows > tr.n_rows) == (m == 300)
        np.testing.assert_array_equal(t2.ids.numpy(), _np(j2.ids))
        _assert_lockstep(t2)
        if m == 5:         # the rows written hold the new rows' codes
            rows = np.nonzero(_np(j2.ids) != _np(jr.ids))[0]
            src = t2.ids.numpy()[rows] - (int(_np(jr.ids).max()) + 1)
            assert sorted(src) == list(range(5))
            np.testing.assert_array_equal(
                t2.codes.numpy()[rows], tq.encode(t.codec, _t(Xn)).numpy()[src])
    r = tivf.remove(t, torch.arange(0, 100))
    assert r.n_rows == t.n_rows
    np.testing.assert_array_equal(r.codes.numpy(), t.codes.numpy())
    _assert_lockstep(r)
    rp = tivf.repack(r)
    assert rp.codec is r.codec or rp.codec_kind == kind
    _assert_lockstep(rp)
    np.testing.assert_array_equal(
        rp.ids.numpy(), _np(jivf.repack(jivf.remove(j, np.arange(100))).ids))
    _assert_lockstep(tivf.remove(t, torch.arange(0, 400)))   # repacks


def _assert_same_codec_index(t, j):
    np.testing.assert_array_equal(t.vecs.numpy(), _np(j.vecs))
    np.testing.assert_array_equal(t.ids.numpy(), _np(j.ids))
    np.testing.assert_array_equal(t.codes.numpy(), _np(j.codes))
    np.testing.assert_array_equal(t.vnorm.numpy(), _np(j.vnorm))
    for name, arr in _codec_arrays(j).items():
        if name not in ("codes", "vnorm"):
            field = {"int8_scale": "scale", "int8_zero": "zero",
                     "pq_codebook": "codebook"}[name]
            np.testing.assert_array_equal(getattr(t.codec, field).numpy(),
                                          arr)


@pytest.mark.parametrize("kind", ["int8", "pq"])
@pytest.mark.parametrize("fname", ["index.ivf", "index.npz"])
def test_codec_index_files_cross_load(coded, tmp_path, kind, fname):
    """A codec index written by either package loads in the other."""
    X, j = coded[kind]
    path = os.path.join(tmp_path, "j_" + fname)
    jivf.save_index(j, path)
    t = tivf.load_index(path, device="cpu")
    assert t.codec_kind == kind
    _assert_same_codec_index(t, j)
    path2 = os.path.join(tmp_path, "t_" + fname)
    tivf.save_index(t, path2)
    j2 = jivf.load_index(path2)
    assert j2.codec_kind == kind
    _assert_same_codec_index(t, j2)
    if fname.endswith(".ivf"):            # byte for byte the same file
        assert open(path, "rb").read() == open(path2, "rb").read()


# ----------------------------------------------------------------- launcher

@pytest.mark.parametrize("flags", [["--codec", "pq", "--nsub", "4"],
                                   ["--qgroup", "4"]])
def test_serve_index_codec_and_qgroup_on_cpu(tmp_path, capsys, flags):
    path = os.path.join(tmp_path, "ix.ivf")
    args = ["--device", "cpu", "--n", "2048", "--d", "16", "--k", "16",
            "--components", "32", "--nq", "64", "--batch", "32",
            "--rounds", "1", "--tau", "2", "--iters", "3",
            "--probes", "1,4,16"] + flags
    rows = tserve.main(args + ["--save", path])
    recs = [r["recall"] for r in rows]
    assert recs[0] <= recs[1] <= recs[2] and recs[-1] > 0.9
    assert all(r["host_syncs"] == 0 and r["qps"] > 0 for r in rows)
    again = tserve.main(args + ["--load", path])
    assert [r["recall"] for r in again] == recs
    out = capsys.readouterr().out
    assert "recall@10" in out
    if "--codec" in flags:
        assert "pq codec" in out and rows[0]["bytes_per_row"] == 8
