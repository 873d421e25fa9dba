"""The port's baselines, probe and descent sources and graph search against
the JAX package, on the same numpy inputs (CPU, small sizes).

Where a function draws randomness, the reference's ``jax.random`` draws are
computed here and injected into the port.  Tolerances, as each test states:
integer outputs (ids, assignments, member tables, moves) exact — on float
data but at near-ties, where the two frameworks' float32 sums may order two
distances differently; float outputs within rtol 1e-5 (histories of whole
engine runs 1e-4); end-to-end runs with their own generators within 1% of
the reference's final distortion or 0.02 of its recall@κ.
"""
from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import anns as janns
from repro.core import bkm as jbkm
from repro.core import closure as jcl
from repro.core import engine as jeng
from repro.core import graph_build as jgb
from repro.core import knn_graph as jknn
from repro.core import minibatch as jmb
from repro.core import objective as jobj
from repro.core import recall as jrec
from repro.core import two_means as jtm
from repro_torch import interop
from repro_torch.core import anns as tanns
from repro_torch.core import bkm as tbkm
from repro_torch.core import closure as tcl
from repro_torch.core import engine as teng
from repro_torch.core import graph_build as tgb
from repro_torch.core import knn_graph as tknn
from repro_torch.core import minibatch as tmb
from repro_torch.core import objective as tobj
from repro_torch.core import recall as trec
from repro_torch.kernels import ref as tref

# the packages export functions named like these modules
jll = importlib.import_module("repro.core.lloyd")
jnd = importlib.import_module("repro.core.nn_descent")
tll = importlib.import_module("repro_torch.core.lloyd")
tnd = importlib.import_module("repro_torch.core.nn_descent")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them as fast and
    leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def blobs():
    """(2048, 16) Gaussian blobs, made with numpy from a seed."""
    rng = np.random.default_rng(42)
    means = rng.standard_normal((32, 16)) * 4.0
    comp = rng.integers(0, 32, size=2048)
    X = means[comp] + rng.standard_normal((2048, 16))
    return X.astype(np.float32)


def _bits(key, count):
    return np.array(jax.random.bits(key, (count,), jnp.uint32))


def _epoch_words(key, iters):
    return interop.epoch_words([_bits(jax.random.fold_in(key, t), 4)
                                for t in range(iters)])


def _assert_near_ties(X, C, got, want, rtol=1e-5):
    """Assignments equal except where the two centroids lie equally near
    (within rtol of ||x||² + ||c||²)."""
    X, C = np.array(X, np.float64), np.array(C, np.float64)
    got, want = np.array(got), np.array(want)
    diff = np.nonzero(got != want)[0]
    for i in diff:
        dg = ((X[i] - C[got[i]]) ** 2).sum()
        dw = ((X[i] - C[want[i]]) ** 2).sum()
        scale = (X[i] ** 2).sum() + (C[want[i]] ** 2).sum()
        assert abs(dg - dw) <= rtol * scale, (i, dg, dw)
    assert len(diff) <= max(2, len(got) // 500), len(diff)


# ------------------------------------------------------------------ objective

def test_delta_I_matches_reference_and_gather_score():
    """Eqn. 3 on the same inputs (rtol 1e-5), with source clusters of one
    row and empty targets; and the same ΔI as gather_score's plain version
    scores (bkm mode), to f32 rounding of the terms that cancel."""
    rng = np.random.default_rng(0)
    B, C, d, k = 64, 6, 12, 40
    D = (rng.standard_normal((k, d)) * 5).astype(np.float32)
    cnt = rng.integers(1, 9, k).astype(np.float32)
    cnt[:3] = 0.0
    cnt[3:6] = 1.0
    x = rng.standard_normal((B, d)).astype(np.float32)
    u = rng.integers(3, k, B).astype(np.int32)
    u[:4] = [3, 4, 5, 3]
    cand = rng.integers(0, k, (B, C)).astype(np.int32)
    args = (x, D[u], cnt[u], D[cand], cnt[cand])
    want = np.array(jobj.delta_I(*map(jnp.asarray, args)))
    got = tobj.delta_I(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    gs = tref.gather_score(*map(torch.from_numpy, (x, u, cand, D, cnt)),
                           mode="bkm").numpy()
    scale = tref.score_scale(*map(torch.from_numpy, (x, u, cand, D, cnt)),
                             mode="bkm").numpy()
    assert (np.abs(gs - got) <= 1e-5 * scale).all()


@pytest.mark.parametrize("i,v", [(0, 3), (17, 0), (99, 5)])
def test_delta_I_brute_matches(i, v):
    """The O(n) oracle against the reference's (rtol 1e-5) and against the
    closed form of Eqn. 3 (rtol 1e-4: the oracle differences two sums)."""
    rng = np.random.default_rng(i)
    X = rng.standard_normal((120, 8)).astype(np.float32)
    a = rng.integers(0, 6, 120).astype(np.int32)
    a[99] = 6                                    # a cluster of one row
    k = 8
    want = float(jobj.delta_I_brute(jnp.array(X), jnp.array(a), k, i, v))
    Xt, at = torch.from_numpy(X), torch.from_numpy(a)
    got = float(tobj.delta_I_brute(Xt, at, k, i, v))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    st = tobj.cluster_stats(Xt, at, k)
    closed = float(tobj.delta_I(Xt[i], st.D[a[i]], st.cnt[a[i]],
                                st.D[v][None], st.cnt[v][None])[0])
    np.testing.assert_allclose(got, closed, rtol=1e-4, atol=1e-3)


# ------------------------------------------------------------------ knn_graph

@pytest.mark.parametrize("n,chunk", [(1024, 256), (1024, 300), (1000, 4096)])
def test_graph_distances_matches(n, chunk):
    """Chunked (256 divides 1024) and whole (300 does not; 4096 > n), with
    -1 ids (the last row, as in the reference): rtol 1e-5."""
    rng = np.random.default_rng(n + chunk)
    X = rng.standard_normal((n, 12)).astype(np.float32)
    ids = rng.integers(-1, n, (n, 7)).astype(np.int32)
    want = np.array(jknn.graph_distances(jnp.array(X), jnp.array(ids),
                                           chunk))
    got = tknn.graph_distances(torch.from_numpy(X), torch.from_numpy(ids),
                               chunk).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,k,cap", [(300, 16, 12), (300, 16, 40),
                                     (1000, 7, 3)])
def test_members_table_exact(n, k, cap):
    rng = np.random.default_rng(cap)
    a = rng.integers(0, k, n).astype(np.int32)
    want_t, want_o = jknn.members_table(jnp.array(a), k, cap)
    got_t, got_o = tknn.members_table(torch.from_numpy(a), k, cap)
    np.testing.assert_array_equal(got_t.numpy(), np.array(want_t))
    assert int(got_o) == int(want_o)
    assert got_t.dtype == torch.int32 and got_t.shape == (k, cap)


# --------------------------------------------------------------------- recall

def test_recall_top1_and_cooccurrence_exact():
    rng = np.random.default_rng(5)
    n, kappa = 500, 10
    gt = rng.integers(0, n, (n, kappa)).astype(np.int32)
    ids = np.where(rng.random((n, kappa)) < 0.3, gt[:, :1], rng.integers(
        0, n, (n, kappa))).astype(np.int32)
    assign = rng.integers(0, 20, n).astype(np.int32)
    assert float(trec.recall_top1(torch.from_numpy(ids),
                                  torch.from_numpy(gt))) == float(
        jrec.recall_top1(jnp.array(ids), jnp.array(gt)))
    np.testing.assert_array_equal(
        trec.cooccurrence_rate(torch.from_numpy(assign),
                               torch.from_numpy(gt)).numpy(),
        np.array(jrec.cooccurrence_rate(jnp.array(assign),
                                          jnp.array(gt))))


# -------------------------------------------------------------- probe source

@pytest.mark.parametrize("mode,p", [("bkm", 4), ("lloyd", 4), ("bkm", 1)])
def test_probe_epoch_matches(blobs, mode, p):
    """One probe-source epoch from the same state: assignment, moves and
    counts exact, D within rtol 1e-5."""
    X = blobs
    k = 32
    a = np.random.default_rng(6).integers(0, k, X.shape[0]).astype(np.int32)
    key = jax.random.PRNGKey(11)
    js = jeng.init_state(jnp.array(X), jnp.array(a), k)
    jout = jeng.epoch(jnp.array(X), js, jeng.probe_source(p), key,
                      jeng.EngineConfig(batch_size=256, mode=mode))
    tst = interop.bkm_state(np.array(js.assign), np.array(js.D),
                            np.array(js.cnt), device="cpu")
    tout = teng.epoch(torch.from_numpy(X), tst, teng.probe_source(p),
                      _bits(key, 4),
                      teng.EngineConfig(batch_size=256, mode=mode))
    np.testing.assert_array_equal(tout.assign.numpy(), np.array(jout.assign))
    assert int(tout.moves) == int(jout.moves) > 0
    np.testing.assert_array_equal(tout.cnt.numpy(), np.array(jout.cnt))
    np.testing.assert_allclose(tout.D.numpy(), np.array(jout.D), rtol=1e-5,
                               atol=1e-4)


def test_probe_keeps_own_cluster_when_empty_cells_crowd_it_out():
    """The reference's case (tests/test_engine.py): 2 real clusters and 6
    empty cells; each cluster's outlier sits nearer the origin (the empty
    cells' centroids) than its own centroid, so a top-4 probe returns only
    empty cells for it.  With the sample's own cluster appended, lloyd mode
    moves nothing, and bkm mode does not raise the distortion."""
    d, k = 8, 8
    base = np.zeros((32, d), np.float32)
    base[:15, 0] = 2.1
    base[15, 0] = 0.5
    base[16:31, 0] = -2.1
    base[31, 0] = -0.5
    X = torch.from_numpy(base)
    a0 = torch.tensor([0] * 16 + [1] * 16, dtype=torch.int32)
    st = teng.epoch(X, teng.init_state(X, a0, k), teng.probe_source(4),
                    [1, 2, 3, 4], teng.EngineConfig(batch_size=32,
                                                    mode="lloyd"))
    assert int(st.moves) == 0
    assert torch.equal(st.assign, a0)
    st_b = teng.epoch(X, teng.init_state(X, a0, k), teng.probe_source(4),
                      [1, 2, 3, 4], teng.EngineConfig(batch_size=32,
                                                      mode="bkm"))
    assert float(tobj.distortion(X, st_b.assign, k)) <= float(
        tobj.distortion(X, a0, k)) + 1e-6


# ------------------------------------------------------------ descent source

def _descent_draws(key, n, kappa, s, tau, random_init=True):
    """The reference's draws of one descent build (graph_build.py:
    _build_single, _build_rounds, _descent_round)."""
    _, kb = jax.random.split(key)
    kinit, kloop = jax.random.split(kb)
    init = (np.array(jgb._random_ids(kinit, jnp.arange(n, dtype=jnp.int32),
                                     n, kappa)) if random_init else None)
    p1, p2, sl = [], [], []
    for t in range(tau):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(kloop, t), 3)
        p1.append(np.array(jax.random.randint(k1, (n, s), 0, kappa)))
        p2.append(np.array(jax.random.randint(k2, (n, s), 0, kappa)))
        sl.append(np.array(jax.random.randint(k3, (n, kappa), 0, s)))
    return tgb.DescentDraws(init, np.stack(p1), np.stack(p2), np.stack(sl))


def _integer_data(n, d, seed):
    """Small-integer coordinates: every distance exact in float32, so the
    two frameworks' lists must agree bit for bit, ties included."""
    return np.random.default_rng(seed).integers(0, 4, (n, d)).astype(
        np.float32)


def test_reverse_edges_match_xla_last_writer():
    """The reference's reverse-edge scatter ``.at[ids, slot].set(src)``
    collides; XLA:CPU applies the writes in row-major order, so the last
    writer (the largest source row) wins — the port's ``amax`` winner."""
    rng = np.random.default_rng(7)
    n, kappa, s = 3000, 16, 32
    g_ids = rng.integers(-1, n, (n, kappa)).astype(np.int32)
    slot = rng.integers(0, s, (n, kappa)).astype(np.int32)
    ids = np.maximum(g_ids, 0)
    src = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, kappa))
    want = np.array(jax.jit(lambda i, sl, sr: jnp.full(
        (n, s), -1, jnp.int32).at[i.reshape(-1), sl.reshape(-1)].set(
        sr.reshape(-1)))(ids, slot, src))
    pick = np.zeros((n, s), np.int64)
    cand = tgb.descent_candidates(torch.from_numpy(g_ids),
                                  torch.from_numpy(pick),
                                  torch.from_numpy(pick),
                                  torch.from_numpy(slot).long()).numpy()
    want = np.where(want == np.arange(n)[:, None], -1, want)
    np.testing.assert_array_equal(cand[:, s:], want)


@pytest.mark.parametrize("n,kappa,sample,tau,random_init",
                         [(500, 12, 10, 2, True), (300, 6, 0, 2, False)])
def test_descent_build_bit_exact(n, kappa, sample, tau, random_init):
    """source='descent' with the reference's draws injected, on integer
    data: ids and distances bit for bit."""
    X = _integer_data(n, 8, n)
    key = jax.random.PRNGKey(n)
    s = sample or 2 * kappa
    cfg_j = jgb.GraphBuildConfig(kappa=kappa, source="descent", tau=tau,
                                 sample=sample, random_init=random_init,
                                 chunk=256)
    want, _ = jgb.build_graph(jnp.array(X), key, cfg_j)
    draws = _descent_draws(key, n, kappa, s, tau, random_init)
    got, diag = tgb.GraphBuilder(tgb.GraphBuildConfig(
        kappa=kappa, source="descent", tau=tau, sample=sample,
        random_init=random_init, chunk=100)).build(torch.from_numpy(X),
                                                   draws=draws)
    np.testing.assert_array_equal(got.ids.numpy(), np.array(want.ids))
    np.testing.assert_array_equal(got.dist.numpy(), np.array(want.dist))
    assert diag.overflow.shape == (tau,)


@pytest.mark.parametrize("n", [1, 3, 9])
def test_nn_descent_tiny_inputs_bit_exact(n):
    """n <= 1: all (-1, inf); n <= κ: -1 tails, no self, no duplicates."""
    kappa = 8
    X = _integer_data(n, 4, 100 + n)
    key = jax.random.PRNGKey(3)
    want = jnd.nn_descent(jnp.array(X), kappa, iters=2, key=key)
    draws = (None if n <= 1 else
             _descent_draws(key, n, kappa, 2 * kappa, 2))
    got = tnd.nn_descent(X, kappa, iters=2, draws=draws, device="cpu")
    np.testing.assert_array_equal(got.ids.numpy(), np.array(want.ids))
    np.testing.assert_array_equal(got.dist.numpy(), np.array(want.dist))
    for row, ids in enumerate(got.ids.numpy()):
        valid = ids[ids >= 0]
        assert row not in valid and len(set(valid)) == len(valid)


def test_nn_descent_recall_matches(blobs):
    """Blobs, the reference's draws injected and the port's own: recall@κ
    of each within 0.02 of the reference's."""
    X, kappa, iters = blobs, 16, 6
    gt = np.array(jrec.brute_force_knn(jnp.array(X), kappa))
    key = jax.random.PRNGKey(4)
    gj = jnd.nn_descent(jnp.array(X), kappa, iters=iters, key=key)
    rj = float(jrec.recall_at(gj.ids, jnp.array(gt), kappa))
    draws = _descent_draws(key, X.shape[0], kappa, 2 * kappa, iters)
    for kw in (dict(draws=draws),
               dict(generator=torch.Generator().manual_seed(4))):
        g = tnd.nn_descent(X, kappa, iters=iters, device="cpu", **kw)
        r = float(trec.recall_at(g.ids, torch.from_numpy(gt), kappa))
        assert abs(r - rj) <= 0.02, (r, rj, kw.keys())
        assert (np.diff(g.dist.numpy(), axis=1) >= 0).all()


# ----------------------------------------------------------------- baselines

@pytest.mark.parametrize("n,k", [(2048, 64), (37, 37)])
def test_init_random_ids_exact(blobs, n, k):
    key = jax.random.PRNGKey(n)
    X = blobs[:n]
    want = np.array(jll.init_random(jnp.array(X), k, key))
    ids = np.array(jax.random.choice(key, n, (k,), replace=False))
    got = tll.init_random(X, k, ids=ids, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [2, 48])
def test_init_kmeanspp_ids_exact(blobs, k):
    """The reference's first row and uniforms injected: the same k rows."""
    X = blobs
    key = jax.random.PRNGKey(k)
    want = np.array(jll.init_kmeanspp(jnp.array(X), k, key))
    first = int(jax.random.randint(key, (), 0, X.shape[0]))
    uni = np.array([float(jax.random.uniform(jax.random.fold_in(key, i), ()))
                    for i in range(1, k)], np.float32)
    got = tll.init_kmeanspp(X, k, first=first, uniforms=uni,
                            device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_lloyd_from_injected_centroids(blobs):
    """The reference's k-means++ centroids injected: assignment exact (but
    at near-ties), history rtol 1e-5, the same early stop."""
    X, k = blobs, 48
    key = jax.random.PRNGKey(2)
    ja, jC, jh = jll.lloyd(jnp.array(X), k, iters=15, key=key)
    C0 = np.array(jll.init_kmeanspp(jnp.array(X), k, key))
    ta, tC, th = tll.lloyd(X, k, iters=15, centroids=C0, device="cpu")
    assert len(th) == len(jh)
    np.testing.assert_allclose(th, jh, rtol=1e-5)
    _assert_near_ties(X, np.array(jC), ta.numpy(), np.array(ja))
    np.testing.assert_allclose(tC.numpy(), np.array(jC), rtol=1e-5,
                               atol=1e-5)


def test_minibatch_with_injected_batches(blobs):
    """The reference's init rows and batch rows injected: centroids within
    rtol 1e-5, final assignment exact but at near-ties."""
    X, k, steps, B = blobs, 32, 40, 128
    key = jax.random.PRNGKey(8)
    ja, jC = jmb.minibatch_kmeans(jnp.array(X), k, steps=steps,
                                  batch_size=B, key=key)
    kc, ks = jax.random.split(key)
    init = np.array(jax.random.choice(kc, X.shape[0], (k,), replace=False))
    bids = np.stack([np.array(jax.random.randint(
        jax.random.fold_in(ks, i), (B,), 0, X.shape[0]))
        for i in range(steps)])
    ta, tC = tmb.minibatch_kmeans(X, k, steps=steps, batch_size=B,
                                  init_ids=init, batch_ids=bids,
                                  device="cpu")
    np.testing.assert_allclose(tC.numpy(), np.array(jC), rtol=1e-5,
                               atol=1e-5)
    _assert_near_ties(X, np.array(jC), ta.numpy(), np.array(ja))


@pytest.mark.parametrize("source", ["dense", "graph"])
def test_run_bkm_history_matches(blobs, source):
    """Dense and graph sources from the same tree init, the reference's
    epoch words injected: history rtol 1e-4, counts exact."""
    X, k, iters = blobs, 64, 4
    a0 = np.random.default_rng(9).integers(0, k, X.shape[0]).astype(np.int32)
    G = None
    if source == "graph":
        G = np.random.default_rng(1).integers(0, X.shape[0], (X.shape[0], 12))
    key = jax.random.PRNGKey(3)
    jst, jh = jbkm.run_bkm(jnp.array(X), jnp.array(a0), k, iters=iters,
                           batch_size=256, key=key,
                           G=None if G is None else jnp.array(G))
    tst, th = tbkm.run_bkm(X, a0, k, iters=iters, batch_size=256,
                           epoch_words=_epoch_words(key, iters), G=G,
                           device="cpu")
    assert len(th) == iters
    np.testing.assert_allclose(th, np.array(jh), rtol=1e-4)
    np.testing.assert_array_equal(tst.cnt.numpy(), np.array(jst.cnt))


def _tree_seeds(key, n, k):
    """The reference tree's per-level seed offsets (two_means.py:70-75)."""
    i1s, i2s = [], []
    for lvl in range(k.bit_length() - 1):
        m = n >> lvl
        k1, k2 = jax.random.split(jax.random.fold_in(key, lvl))
        i1 = jax.random.randint(k1, (k,), 0, max(m, 1))
        r2 = jax.random.randint(k2, (k,), 0, max(m - 1, 1))
        i1s.append(np.array(i1))
        i2s.append(np.array((i1 + 1 + r2) % max(m, 1)))
    return np.stack(i1s), np.stack(i2s)


def _closure_draws(key, n, k2, trees, leaf, iters):
    """The reference's draws of one closure run (closure.py, graph_build.py:
    _build_single, _partition_round; two_means_dist's salts)."""
    kt, ki, kb = jax.random.split(key, 3)
    k0, n_pad = jgb._plan(n, jgb.GraphBuildConfig(xi=leaf))
    kpad, kb2 = jax.random.split(kt)
    pad = np.array(jax.random.randint(kpad, (n_pad - n,), 0, n,
                                        dtype=jnp.int32))
    _, kloop = jax.random.split(kb2)
    salts = []
    for t in range(trees):
        k1, _ = jax.random.split(jax.random.fold_in(kloop, t))
        salts.append(np.stack([_bits(jax.random.fold_in(k1, lvl), 2)
                               for lvl in range(k0.bit_length() - 1)]))
    graph = tgb.BuildDraws(pad, None, np.stack(salts), None)
    n2, _ = jtm.pad_plan(n, k2)
    extra = np.array(jax.random.randint(jax.random.fold_in(ki, 1),
                                          (n2 - n,), 0, n, dtype=jnp.int32))
    return tcl.ClosureDraws(graph, extra, _tree_seeds(ki, n2, k2),
                            _epoch_words(kb, iters))


@pytest.mark.parametrize("n,k,iters,leaf", [(1000, 16, 4, 24)])
def test_closure_kmeans_matches(blobs, n, k, iters, leaf):
    """The reference's draws injected: final distortion within 1% of the
    reference's.  leaf=24 is not a power of two (the reference's
    regression case), n=1000 pads the leaf-mate build and the tree init,
    and κ = 3·23 = 69 > 64 takes merge_topk, as the default leaf's 93
    does."""
    X = blobs[:n]
    key = jax.random.PRNGKey(3)
    ja, _, jh = jcl.closure_kmeans(jnp.array(X), k, iters=iters, leaf=leaf,
                                   key=key)
    ta, tC, th = tcl.closure_kmeans(
        X, k, iters=iters, leaf=leaf, device="cpu",
        draws=_closure_draws(key, n, k, 3, leaf, iters))
    assert abs(th[-1] - jh[-1]) <= 0.01 * jh[-1], (th[-1], jh[-1])
    assert ta.shape == (n,) and tC.shape == (k, 16) and th[-1] <= th[0]
    np.testing.assert_allclose(
        float(tobj.distortion(torch.from_numpy(X), ta, k)), th[-1],
        rtol=1e-4)


def test_closure_leafmate_graph_holds_only_leafmates(blobs):
    """random_init=False: no random seeding; rows hold at most
    trees*(leaf-1) distinct leaf-mates, -1 tails past them."""
    X = torch.from_numpy(blobs[:512])
    ids = tcl._leafmate_graph(X, 2, 8, torch.Generator().manual_seed(0),
                              None).numpy()
    assert ids.shape == (512, 14)
    for row, r in enumerate(ids):
        valid = r[r >= 0]
        assert 7 <= len(valid) <= 14 and row not in valid
        assert len(set(valid)) == len(valid)


# --------------------------------------------------------------- graph search

@pytest.mark.parametrize("topk,ef,iters", [(5, 16, 12)])
def test_graph_search_with_injected_beacons(blobs, topk, ef, iters):
    """The reference's beacons injected: ids exact, d2 within rtol 1e-5."""
    X = blobs
    g = tknn.build_knn_graph(X, 16, xi=32, tau=3, device="cpu",
                             generator=torch.Generator().manual_seed(0)
                             ).ids.numpy()
    q = (X[:64] + 0.1 * np.random.default_rng(9).standard_normal(
        (64, X.shape[1]))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    wi, wd = janns.graph_search(jnp.array(X), jnp.array(g),
                                jnp.array(q), topk, ef, iters, key=key)
    beacons = np.array(jax.vmap(lambda kk: jax.random.randint(
        kk, (8 * ef,), 0, X.shape[0], dtype=jnp.int32))(
        jax.random.split(key, q.shape[0])))
    gi, gd = tanns.graph_search(X, g, q, topk, ef, iters, beacons=beacons,
                                device="cpu")
    np.testing.assert_array_equal(gi.numpy(), np.array(wi))
    np.testing.assert_allclose(gd.numpy(), np.array(wd), rtol=1e-5,
                               atol=1e-5)
