"""Port core vs the JAX package, on the same numpy inputs (CPU, small sizes).

Where a function draws randomness, the reference's ``jax.random`` draws are
computed here and injected into the port, so integer outputs (visit orders,
partitions, member tables) must match exactly.  End-to-end stages run with
their own generators and are held to quality tolerances: recall@κ within
0.02 and final distortion within 1% of the reference on the same data.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import gkmeans as jgk
from repro.core import knn_graph as jknn
from repro.core import objective as jobj
from repro.core import permute as jperm
from repro.core import recall as jrec
from repro.core import two_means as jtm
from repro_torch import interop
from repro_torch.core import engine as teng
from repro_torch.core import knn_graph as tknn
from repro_torch.core import objective as tobj
from repro_torch.core import permute as tperm
from repro_torch.core import recall as trec
from repro_torch.core import two_means as ttm
from repro_torch.core.gkmeans import gk_means


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
    return np.asarray(jax.random.bits(key, (count,), jnp.uint32))


# --------------------------------------------------------------------- permute

@pytest.mark.parametrize("n", [2, 37, 1000, 1024, 4097])
def test_epoch_order_bit_exact(n):
    key = jax.random.PRNGKey(n)
    want = np.asarray(jperm.epoch_order(key, n))
    got = tperm.epoch_order(_bits(key, tperm.ROUNDS), n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert sorted(got.tolist()) == list(range(n))


def test_mix32_matches_uint32_arithmetic():
    x = np.random.default_rng(1).integers(0, 2 ** 32, 4096, dtype=np.uint64)
    want = np.asarray(jtm._mix32(jnp.asarray(x.astype(np.uint32))))
    got = tperm.mix32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# ------------------------------------------------------------------- objective

def test_objective_matches(blobs):
    X = blobs[:1000]
    a = np.random.default_rng(0).integers(0, 24, 1000).astype(np.int32)
    js = jobj.cluster_stats(jnp.asarray(X), jnp.asarray(a), 24)
    ts = tobj.cluster_stats(torch.from_numpy(X), torch.from_numpy(a), 24)
    np.testing.assert_allclose(ts.D.numpy(), np.asarray(js.D), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ts.cnt.numpy(), np.asarray(js.cnt))
    np.testing.assert_allclose(tobj.centroids(ts).numpy(),
                               np.asarray(jobj.centroids(js)), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        float(tobj.distortion(torch.from_numpy(X), torch.from_numpy(a), 24)),
        float(jobj.distortion(jnp.asarray(X), jnp.asarray(a), 24)),
        rtol=1e-5)
    C = np.array(jobj.centroids(js))
    ja, jd = jobj.assignment_distortion(jnp.asarray(X), jnp.asarray(C))
    ta, td = tobj.assignment_distortion(torch.from_numpy(X),
                                        torch.from_numpy(C), block=256)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(float(td), float(jd), rtol=1e-5)


# ------------------------------------------------------------------- two_means

def _tree_seeds(key, n, k):
    """The reference tree's per-level seed offsets (two_means.py:70-75)."""
    i1s, i2s = [], []
    for lvl in range(k.bit_length() - 1):
        m = n >> lvl
        k1, k2 = jax.random.split(jax.random.fold_in(key, lvl))
        i1 = jax.random.randint(k1, (k,), 0, max(m, 1))
        r2 = jax.random.randint(k2, (k,), 0, max(m - 1, 1))
        i1s.append(np.asarray(i1))
        i2s.append(np.asarray((i1 + 1 + r2) % max(m, 1)))
    return np.stack(i1s), np.stack(i2s)


def _dist_salts(key, k):
    return np.stack([_bits(jax.random.fold_in(key, lvl), 2)
                     for lvl in range(k.bit_length() - 1)])


def _assert_equal_size(assign, k):
    counts = np.bincount(assign, minlength=k)
    assert (counts == len(assign) // k).all(), counts


@pytest.mark.parametrize("n,k", [(512, 8), (1024, 32)])
def test_two_means_tree_same_partition(blobs, n, k):
    X = blobs[:n]
    key = jax.random.PRNGKey(n + k)
    want = np.asarray(jtm.two_means_tree(jnp.asarray(X), k, key))
    got = ttm.two_means_tree(torch.from_numpy(X), k,
                             seeds=_tree_seeds(key, n, k)).numpy()
    _assert_equal_size(got, k)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,k", [(512, 8), (2048, 64)])
def test_two_means_dist_same_partition(blobs, n, k):
    X = blobs[:n]
    key = jax.random.PRNGKey(7 * n + k)
    rows = np.arange(n, dtype=np.int32)
    want = np.asarray(jtm.two_means_dist(jnp.asarray(X), jnp.asarray(rows),
                                         k, key))
    got = ttm.two_means_dist(torch.from_numpy(X), torch.from_numpy(rows), k,
                             salts=_dist_salts(key, k)).numpy()
    _assert_equal_size(got, k)
    np.testing.assert_array_equal(got, want)


def test_monotone_u32_matches():
    f = np.random.default_rng(3).standard_normal(1000).astype(np.float32)
    f[:3] = [0.0, -0.0, np.inf]
    want = np.asarray(jtm._monotone_u32(jnp.asarray(f))).astype(np.int64)
    np.testing.assert_array_equal(
        ttm.monotone_u32(torch.from_numpy(f)).numpy(), want)


# ------------------------------------------------------------------- knn_graph

@pytest.mark.parametrize("cap,spill", [(12, 8), (40, 4)])
def test_members_table_local_exact(cap, spill):
    rng = np.random.default_rng(cap)
    a = rng.integers(0, 16, 300).astype(np.int32)
    pos = rng.permutation(1000)[:300].astype(np.int32)
    want = jknn.members_table_local(jnp.asarray(a), jnp.asarray(pos), 16,
                                    cap, spill)
    got = tknn.members_table_local(torch.from_numpy(a),
                                   torch.from_numpy(pos), 16, cap, spill)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_merge_topk_matches():
    rng = np.random.default_rng(8)
    B, kappa, C = 16, 70, 30
    g_ids = rng.integers(-1, 90, (B, kappa)).astype(np.int32)
    g_d = rng.random((B, kappa)).astype(np.float32)
    c_ids = rng.integers(-1, 90, (B, C)).astype(np.int32)
    c_d = rng.random((B, C)).astype(np.float32)
    wi, wd = jknn.merge_topk(*map(jnp.asarray, (g_ids, g_d, c_ids, c_d)),
                             kappa)
    gi, gd = tknn.merge_topk(*map(torch.from_numpy, (g_ids, g_d, c_ids, c_d)),
                             kappa)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize("n,phantoms", [(1, 0), (2, 0), (50, 0), (50, 14)])
def test_random_graph_no_self(n, phantoms):
    g = torch.Generator().manual_seed(n + phantoms)
    own = torch.cat([torch.arange(n), torch.randint(0, n, (phantoms,),
                                                    generator=g)])
    ids = tknn.random_graph(n, 6, g, own=own if phantoms else None,
                            device="cpu")
    assert ids.shape == (n + phantoms, 6) and ids.dtype == torch.int32
    if n == 1:
        assert (ids == -1).all()
    else:
        assert ((ids >= 0) & (ids < n)).all()
        assert (ids != own.to(torch.int32)[:, None]).all()


@pytest.mark.parametrize("n", [2048, 1500])     # 1500: phantom-row padding
def test_build_knn_graph_recall_matches(blobs, n):
    X = blobs[:n]
    kappa = 16
    gt = np.array(jrec.brute_force_knn(jnp.asarray(X), kappa))
    gj = jknn.build_knn_graph(jnp.asarray(X), kappa, xi=32, tau=4,
                              key=jax.random.PRNGKey(0))
    gt_t = trec.brute_force_knn(torch.from_numpy(X), kappa)
    np.testing.assert_array_equal(np.sort(gt_t.numpy(), 1), np.sort(gt, 1))
    gp, diag = tknn.build_knn_graph(
        X, kappa, xi=32, tau=4, generator=torch.Generator().manual_seed(0),
        device="cpu", return_diagnostics=True)
    rj = float(jrec.recall_at(gj.ids, jnp.asarray(gt), kappa))
    rp = float(trec.recall_at(gp.ids, torch.from_numpy(gt), kappa))
    assert abs(rp - rj) <= 0.02, (rp, rj)
    assert gp.ids.shape == (n, kappa) and gp.ids.dtype == torch.int32
    d = gp.dist.numpy()
    assert (np.diff(d, axis=1) >= 0).all()          # sorted ascending
    assert diag.overflow.shape == (4,) and int(diag.guided_moves[0]) == 0


# ---------------------------------------------------------------------- engine

@pytest.mark.parametrize("mode", ["bkm", "lloyd"])
def test_engine_run_history_matches(blobs, mode):
    X = blobs
    k, iters = 64, 6
    g = jknn.build_knn_graph(jnp.asarray(X), 16, xi=32, tau=2,
                             key=jax.random.PRNGKey(1))
    assign = np.asarray(jtm.two_means_tree(jnp.asarray(X), k,
                                           jax.random.PRNGKey(2)))
    kb = jax.random.PRNGKey(3)
    cfg = jeng.EngineConfig(batch_size=256, mode=mode, iters=iters)
    st = jeng.init_state(jnp.asarray(X), jnp.asarray(assign), k)
    st, hist, mh, ep, final, _ = jeng.run(jnp.asarray(X), st,
                                          jeng.graph_source(g.ids), kb, cfg)
    words = interop.epoch_words(
        [_bits(jax.random.fold_in(kb, t), 4) for t in range(iters)])
    graph = interop.knn_graph(np.asarray(g.ids), np.asarray(g.dist),
                              device="cpu")
    js = jeng.init_state(jnp.asarray(X), jnp.asarray(assign), k)
    tst = interop.bkm_state(np.asarray(js.assign), np.asarray(js.D),
                            np.asarray(js.cnt), device="cpu")
    tcfg = teng.EngineConfig(batch_size=256, mode=mode, iters=iters)
    res = teng.run(torch.from_numpy(X), tst, teng.graph_source(graph.ids),
                   tcfg, epoch_words=words)
    ep = int(ep)
    assert res.epochs == ep and res.host_syncs == ep
    np.testing.assert_allclose(res.history, np.asarray(hist)[:ep], rtol=1e-4)
    np.testing.assert_allclose(float(res.final), float(final), rtol=1e-4)
    np.testing.assert_array_equal(res.state.cnt.numpy(),
                                  np.asarray(st.cnt))


def test_engine_step_moves_match(blobs):
    """One epoch from the same state: the same moves and counts, and D to
    float32 rounding."""
    X = blobs[:1024]
    k = 32
    rng = np.random.default_rng(4)
    a = rng.integers(0, k, 1024).astype(np.int32)
    G = rng.integers(0, 1024, (1024, 8)).astype(np.int32)
    key = jax.random.PRNGKey(9)
    js = jeng.init_state(jnp.asarray(X), jnp.asarray(a), k)
    cfg = jeng.EngineConfig(batch_size=128, sparse_updates=True)
    jout = jeng.epoch(jnp.asarray(X), js, jeng.graph_source(jnp.asarray(G)),
                      key, cfg)
    tst = interop.bkm_state(np.asarray(js.assign), np.asarray(js.D),
                            np.asarray(js.cnt), device="cpu")
    tout = teng.epoch(torch.from_numpy(X), tst,
                      teng.graph_source(torch.from_numpy(G)), _bits(key, 4),
                      teng.EngineConfig(batch_size=128, sparse_updates=True))
    np.testing.assert_array_equal(tout.assign.numpy(), np.asarray(jout.assign))
    assert int(tout.moves) == int(jout.moves) > 0
    np.testing.assert_array_equal(tout.cnt.numpy(), np.asarray(jout.cnt))
    np.testing.assert_allclose(tout.D.numpy(), np.asarray(jout.D), rtol=1e-5,
                               atol=1e-4)


# ---------------------------------------------------------------------- gk_means

def test_gk_means_matches_reference_quality(blobs):
    X = blobs
    rj = jgk.gk_means(jnp.asarray(X), 64, kappa=16, xi=32, tau=4, iters=10,
                      key=jax.random.PRNGKey(0))
    rp = gk_means(X, 64, kappa=16, xi=32, tau=4, iters=10,
                  generator=torch.Generator().manual_seed(0), device="cpu")
    assert abs(rp.distortion - rj.distortion) <= 0.01 * rj.distortion, (
        rp.distortion, rj.distortion)
    assert rp.assign.shape == (2048,) and rp.centroids.shape == (64, 16)
    assert rp.host_syncs == len(rp.history) + 1
    assert set(rp.seconds) == {"graph", "init", "iter"}
    np.testing.assert_allclose(
        float(tobj.distortion(torch.from_numpy(X), rp.assign, 64)),
        rp.distortion, rtol=1e-4)
