"""Clustered-KV decode attention of the port vs the JAX package (CPU).

The shape is the reference test's (B=2, S=512, Hkv=2, G=2, hd=32, kc=32),
its fixture's recipe made with numpy from a seed; both packages get the same
arrays.  The reference's per-slice draws (``keys_r = split(key, B·Hkv)``:
the tree's seed offsets and the epoch words ``bits(fold_in(keys_r[i], t),
(4,))``) are injected into the port, so member tables must match exactly.

Tolerances: centroids and radii rtol 1e-5 / atol 1e-5; f32 attention
outputs rtol 1e-5 / atol 1e-5 — the scores reach ~60, where one f32 ulp is
3.8e-6, and the two frameworks add each 32-term dot in another order, so a
softmax weight moves by a few 1e-6 of itself; bf16 caches atol 1e-2 (the
reference test's); candidate recall exactly (a count over 8 heads).
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
from repro.core import kv_cluster as jkv
from repro.core import two_means as jtm
from repro.models.attention import decode_attention as jdecode
from repro_torch import index as tivf
from repro_torch import interop
from repro_torch.core import engine as teng
from repro_torch.core import kv_cluster as tkv
from repro_torch.core import two_means as ttm
from repro_torch.models import decode_attention as tdecode
from repro_torch.obs import syncs

B, S, HKV, G, HD, KC = 2, 512, 2, 2, 32, 32
F32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them as fast and
    leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cache():
    """(q, k_cache, v_cache) as numpy: keys with cluster structure, queries
    that each point at a (noised, scaled) cached key of their kv head."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((B, 16, HKV, HD)) * 2.0
    which = rng.integers(0, 16, (B, S))
    k = centers[np.arange(B)[:, None], which] + 0.3 * rng.standard_normal(
        (B, S, HKV, HD))
    v = rng.standard_normal((B, S, HKV, HD))
    tgt = rng.integers(0, S, (B, HKV * G))
    picked = k[np.arange(B)[:, None], tgt, np.arange(HKV * G)[None] // G]
    q = (2.0 * picked + 0.2 * rng.standard_normal((B, HKV * G, HD)))[:, None]
    return tuple(a.astype(np.float32) for a in (q, k, v))


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


def _draws(key, slices, n, k, epochs):
    """The reference's per-slice draws: tree seeds (i1, i2), each
    (slices, log2 k, k), and epoch words (slices, epochs, 4)."""
    keys_r = jax.random.split(key, slices)
    seeds = [_tree_seeds(keys_r[i], n, k) for i in range(slices)]
    words = np.array([[np.asarray(jax.random.bits(
        jax.random.fold_in(keys_r[i], t), (4,), jnp.uint32))
        for t in range(epochs)] for i in range(slices)], np.uint32)
    return (np.stack([s[0] for s in seeds]),
            np.stack([s[1] for s in seeds])), words.reshape(slices, epochs, 4)


def _slices(k_cache):
    return np.ascontiguousarray(
        k_cache.transpose(0, 2, 1, 3).reshape(B * HKV, S, HD))


@pytest.fixture(scope="module")
def ref_clusters(cache):
    """The reference's builds (no refinement; two epochs at cap_factor 8)
    and the port's with the same draws."""
    _, k, _ = cache
    key = jax.random.PRNGKey(5)
    seeds, words = _draws(key, B * HKV, S, KC, 2)
    out = {}
    for refine, cap_factor in ((0, 2), (2, 8)):
        j = jkv.build_kv_clusters(jnp.asarray(k), KC, key,
                                  cap_factor=cap_factor,
                                  refine_epochs=refine)
        t = tkv.build_kv_clusters(k, KC, cap_factor=cap_factor,
                                  refine_epochs=refine, tree_seeds=seeds,
                                  epoch_words=words, device="cpu")
        out[refine] = (j, t)
    return out


def _bf16(a):
    """A jax bf16 array as a torch bf16 tensor (exact through f32)."""
    return torch.tensor(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)


def _port(j):
    return interop.kv_clusters(np.asarray(j.centroids), np.asarray(j.table),
                               np.asarray(j.radii), device="cpu")


# ---------------------------------------------------------------- the tree

def test_tree_slices_bit_equal_per_slice_and_reference(cache):
    _, k, _ = cache
    X = _slices(k)
    key = jax.random.PRNGKey(7)
    (i1, i2), _ = _draws(key, B * HKV, S, KC, 0)
    got = ttm.two_means_tree(torch.from_numpy(X), KC, seeds=(i1, i2),
                             refine_iters=2)
    assert got.shape == (B * HKV, S) and got.dtype == torch.int32
    keys_r = jax.random.split(key, B * HKV)
    for s in range(B * HKV):
        one = ttm.two_means_tree(torch.from_numpy(X[s]), KC,
                                 seeds=(i1[s], i2[s]), refine_iters=2)
        assert torch.equal(got[s], one), s
        want = jtm.two_means_tree(jnp.asarray(X[s]), KC, keys_r[s],
                                  refine_iters=2)
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want))


def test_tree_slices_draw_per_slice_from_generator(cache):
    _, k, _ = cache
    X = torch.from_numpy(_slices(k))
    a = ttm.two_means_tree(X, KC, generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    for s in range(B * HKV):
        assert torch.equal(a[s], ttm.two_means_tree(X[s], KC, generator=g))


# -------------------------------------------------------------- the engine

@pytest.mark.parametrize("mode", ["bkm", "lloyd"])
@pytest.mark.parametrize("min_move_frac", [-1.0, 0.2])
def test_run_slices_matches_per_slice_run(cache, mode, min_move_frac):
    _, k, _ = cache
    X = torch.from_numpy(_slices(k))
    P, iters = B * HKV, 4
    rng = np.random.default_rng(11)
    a0 = torch.from_numpy(rng.integers(0, KC, (P, S)).astype(np.int32))
    words = torch.from_numpy(rng.integers(0, 2 ** 32, (P, iters, 4)))
    cfg = teng.EngineConfig(batch_size=128, mode=mode, iters=iters,
                            min_move_frac=min_move_frac)
    with syncs.sync_counter() as sc:
        st = teng.run_slices(X, a0, KC, cfg, epoch_words=words)
    runs = [teng.run(X[s], teng.init_state(X[s], a0[s], KC),
                     teng.dense_source(), cfg, epoch_words=words[s])
            for s in range(P)]
    epochs = max(r.epochs for r in runs)
    for s, r in enumerate(runs):
        np.testing.assert_array_equal(st.assign[s].numpy(),
                                      r.state.assign.numpy())
        np.testing.assert_array_equal(st.cnt[s].numpy(), r.state.cnt.numpy())
        np.testing.assert_allclose(st.D[s].numpy(), r.state.D.numpy(),
                                   rtol=1e-5, atol=1e-5)
        # the last epoch's moves: 0 for a slice that had stopped before it
        assert int(st.moves[s]) == (r.moves[-1] if r.epochs == epochs else 0)
    # one read an epoch while a slice may stop; none when none can
    assert sc.syncs == (0 if min_move_frac < 0 else epochs)
    # the early stop fired for some slice (in bkm mode, for some only)
    assert min_move_frac < 0 or min(r.epochs for r in runs) < iters


def test_run_slices_needs_draws_and_the_dense_source(cache):
    X = torch.zeros((2, 64, 4))
    a = torch.zeros((2, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="epoch_words or a generator"):
        teng.run_slices(X, a, 4, teng.EngineConfig())
    with pytest.raises(NotImplementedError, match="telemetry"):
        teng.run_slices(X, a, 4, teng.EngineConfig(telemetry=True),
                        generator=torch.Generator())


# --------------------------------------------------------------- the build

@pytest.mark.parametrize("refine", [0, 2])
def test_build_matches_reference(ref_clusters, refine):
    j, t = ref_clusters[refine]
    np.testing.assert_array_equal(t.table.numpy(), np.asarray(j.table))
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               **F32_TOL)
    jr, tr = np.asarray(j.radii), t.radii.numpy()
    np.testing.assert_array_equal(np.isneginf(tr), np.isneginf(jr))
    fin = np.isfinite(jr)
    np.testing.assert_allclose(tr[fin], jr[fin], **F32_TOL)
    assert t.table.dtype == torch.int32 and t.radii.dtype == torch.float32


def test_build_tables_hold_every_key_once(ref_clusters):
    for refine in (0, 2):
        t = ref_clusters[refine][1].table.reshape(B * HKV, -1)
        for s in range(B * HKV):
            ids = t[s][t[s] >= 0]
            assert sorted(ids.tolist()) == list(range(S))


def test_build_refined_assignment_is_the_reference_engine(cache):
    """The refinement alone: the reference's engine.run_inline from the
    same tree, against run_slices with the same words."""
    _, k, _ = cache
    X = _slices(k)
    key = jax.random.PRNGKey(5)
    keys_r = jax.random.split(key, B * HKV)
    (i1, i2), words = _draws(key, B * HKV, S, KC, 2)
    a0 = ttm.two_means_tree(torch.from_numpy(X), KC, seeds=(i1, i2),
                            refine_iters=2)
    cfg = teng.EngineConfig(batch_size=512, iters=2, min_move_frac=-1.0)
    got = teng.run_slices(torch.from_numpy(X), a0, KC, cfg,
                          epoch_words=words)
    jcfg = jeng.EngineConfig(batch_size=512, iters=2, min_move_frac=-1.0)
    for s in range(B * HKV):
        x = jnp.asarray(X[s])
        st = jeng.run_inline(x, jeng.init_state(x, jnp.asarray(a0[s].numpy()),
                                                KC),
                             jeng.dense_source(), keys_r[s], jcfg)[0]
        np.testing.assert_array_equal(got.assign[s].numpy(),
                                      np.asarray(st.assign))
        np.testing.assert_array_equal(got.cnt[s].numpy(), np.asarray(st.cnt))


def test_cluster_stats_empty_cluster_radius_is_neg_inf():
    """An empty cluster keeps centroid 0 and radius -inf, as the
    reference's segment_sum / segment_max (the engine's leaver guard never
    empties one, so a build does not reach this)."""
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((40, 8)).astype(np.float32)
    a = rng.integers(0, 6, 40).astype(np.int32)
    a[a == 2] = 5                                        # cluster 2 empty
    k = 8                                                # 6 and 7 empty too
    cent, radii = tkv._centroids_radii(torch.from_numpy(rows),
                                       torch.from_numpy(a).long(), k)
    D = jax.ops.segment_sum(jnp.asarray(rows), jnp.asarray(a), k)
    n = jax.ops.segment_sum(jnp.ones((40,)), jnp.asarray(a), k)
    jc = D / jnp.maximum(n, 1.0)[:, None]
    jr = jax.ops.segment_max(jnp.linalg.norm(jnp.asarray(rows) - jc[a],
                                             axis=-1), jnp.asarray(a), k)
    np.testing.assert_allclose(cent.numpy(), np.asarray(jc), **F32_TOL)
    jr = np.asarray(jr)
    assert np.isneginf(jr[[2, 6, 7]]).all()
    np.testing.assert_array_equal(np.isneginf(radii.numpy()), np.isneginf(jr))
    fin = np.isfinite(jr)
    np.testing.assert_allclose(radii.numpy()[fin], jr[fin], **F32_TOL)


# ------------------------------------------------------------ the attention

@pytest.mark.parametrize("top_c", [4, 16, 32])
@pytest.mark.parametrize("length", [S, 100])
def test_clustered_attention_matches_reference(cache, ref_clusters, top_c,
                                               length):
    q, k, v = cache
    for refine in (0, 2):
        j = ref_clusters[refine][0]
        want = jkv.clustered_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j,
            jnp.asarray(length), top_c=top_c)
        got = tkv.clustered_decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            _port(j), torch.tensor(length), top_c=top_c)
        assert got.shape == (B, 1, HKV * G, HD)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_clustered_attention_bf16_caches(cache, ref_clusters):
    q, k, v = cache
    j = ref_clusters[0][0]
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = jkv.clustered_decode_attention(jq, jk, jv, j, jnp.asarray(S),
                                          top_c=8)
    tq, tk, tv = (_bf16(a) for a in (jq, jk, jv))
    got = tkv.clustered_decode_attention(tq, tk, tv, _port(j), S, top_c=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=1e-2)


def test_all_masked_heads_average_uniformly(cache, ref_clusters):
    """length 0 masks every candidate: the -1e30 mask gives the uniform
    average of the gathered values, not NaN."""
    q, k, v = cache
    j = ref_clusters[0][0]
    want = jkv.clustered_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j, jnp.asarray(0),
        top_c=4)
    got = tkv.clustered_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        _port(j), 0, top_c=4)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("top_c", [1, 4, 8])
def test_candidate_recall_matches_reference(cache, ref_clusters, top_c):
    q, k, _ = cache
    for refine in (0, 2):
        j = ref_clusters[refine][0]
        want = float(jkv.candidate_recall(jnp.asarray(q), jnp.asarray(k), j,
                                          jnp.asarray(S), top_c))
        got = tkv.candidate_recall(torch.from_numpy(q), torch.from_numpy(k),
                                   _port(j), S, top_c)
        assert got.dtype == torch.float32 and float(got) == want


def test_selected_clusters_match_reference_where_untied(cache, ref_clusters):
    q, _, _ = cache
    j = ref_clusters[2][0]
    qs = q.reshape(B, HKV, G, HD) * HD ** -0.5
    want = np.asarray(jkv._select_clusters(jnp.asarray(qs), j, 8))
    got = tkv._select_clusters(torch.from_numpy(qs), _port(j), 8).numpy()
    cs = np.einsum("bhgd,bhkd->bhgk", qs, np.asarray(j.centroids))
    bound = cs + np.linalg.norm(qs, axis=-1)[..., None] * np.asarray(
        j.radii)[:, :, None, :]
    top9 = -np.sort(-bound, axis=-1)[..., :9]
    untied = (np.diff(top9, axis=-1) < 0).all(-1)
    np.testing.assert_array_equal(got[untied], want[untied])
    assert untied.any()


@pytest.mark.parametrize("window,length", [(0, S), (0, 100), (S, S + 300),
                                           (S, 200)])
def test_decode_attention_matches_reference(cache, window, length):
    q, k, v = cache
    want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(length), window=window)
    got = tdecode(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(v), torch.tensor(length), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(length), window=window, scale=0.05)
    got = tdecode(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(v), length, window=window, scale=0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_decode_attention_bf16_matches_reference(cache):
    q, k, v = (jnp.asarray(a).astype(jnp.bfloat16) for a in cache)
    want = jdecode(q, k, v, jnp.asarray(300))
    tq, tk, tv = (_bf16(a) for a in (q, k, v))
    got = tdecode(tq, tk, tv, 300)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=1e-2)


def test_top_c_all_clusters_is_full_attention(cache, ref_clusters):
    """Every key in one cluster of the table: attending to all clusters is
    full attention (the reference test's check, at 1e-5 here)."""
    q, k, v = cache
    t = ref_clusters[0][1]
    for length in (S, 100):
        full = tdecode(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), length)
        got = tkv.clustered_decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), t,
            length, top_c=KC)
        np.testing.assert_allclose(got.numpy(), full.numpy(), **F32_TOL)


# ------------------------------------------------------ memory-mapped loads

def _file_mapping(ptr, path):
    """True when address ``ptr`` lies in a mapping of file ``path``."""
    real = os.path.realpath(path)
    with open("/proc/self/maps") as f:
        for line in f:
            parts = line.split()
            lo, hi = (int(x, 16) for x in parts[0].split("-"))
            if lo <= ptr < hi and len(parts) >= 6 and parts[5] == real:
                return True
    return False


def _index_case(codec):
    rng = np.random.default_rng(21)
    means = rng.standard_normal((8, 16)) * 4.0
    X = (means[rng.integers(0, 8, 600)]
         + rng.standard_normal((600, 16))).astype(np.float32)
    C = means.astype(np.float32)
    a = np.argmin(((X[:, None] - C[None]) ** 2).sum(-1), 1).astype(np.int32)

    class R:
        assign, centroids, k = a, C, 8
    j = jivf.build_ivf(X, R, block_rows=16)
    if codec is not None:
        j = jivf.quantize_index(j, codec)
    return j, X


@pytest.mark.parametrize("codec", [None, "int8"])
def test_load_index_mmap_maps_the_file_and_searches_alike(tmp_path, codec):
    j, X = _index_case(codec)
    path = os.path.join(tmp_path, "ix.ivf")
    jivf.save_index(j, path)
    raw = open(path, "rb").read()
    mapped = tivf.load_index(path, mmap=True)
    plain = tivf.load_index(path, device="cpu")
    names = ["centroids", "vecs", "ids", "starts", "caps"] + (
        [] if codec is None else ["codes", "vnorm"])
    for name in names:
        tm = getattr(mapped, name)
        assert tm.device.type == "cpu"
        assert torch.equal(tm, getattr(plain, name)), name
        # the section is a view of the file's mapping, not a copy
        assert _file_mapping(tm.data_ptr(), path), name
    Q = torch.from_numpy(X[:40] + 0.05)
    kw = {} if codec is None else {"codec": codec}
    for nprobe in (1, 4):
        a = tivf.search(mapped, Q, nprobe=nprobe, **kw)
        b = tivf.search(plain, Q, nprobe=nprobe, **kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # copy-on-write: the tensors are writable, the file never changes
    mapped.vecs[0] += 1.0
    mapped.ids[0] = 7
    del mapped
    assert open(path, "rb").read() == raw


def test_load_index_mmap_npz_and_device(tmp_path, monkeypatch):
    j, _ = _index_case(None)
    path = os.path.join(tmp_path, "ix.npz")
    jivf.save_index(j, path)
    t = tivf.load_index(path, mmap=True)
    assert t.vecs.device.type == "cpu"
    np.testing.assert_array_equal(t.vecs.numpy(), np.asarray(j.vecs))
    with pytest.raises(ValueError, match="keeps the index on the host"):
        tivf.load_index(path, mmap=True, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tivf.load_index(path, mmap=True, device="cpu").k == j.k
