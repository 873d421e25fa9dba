"""The port's sharded topology against the reference's and against itself.

1. The one-device R-way emulation (``EngineConfig(shards=R)``,
   ``GraphBuildConfig(shards=R)``, ``two_means_dist(shards=R)``) against the
   reference's emulation in-process, the reference's draws injected: the
   reference pins its emulation to its mesh.  Assignments, counts, moves and
   the tree are held exactly (no near-tie arises at these inputs, so none
   is allowed), D within f32 tolerance; the graph build's ids up to
   near-ties (their distances within 1e-5 of the norms that cancel in
   them), recall@κ within 0.02 and the overflow of every round exactly.
2. The exact host and merge code: ``shard_lists`` array for array,
   ``merge_shard_topk`` and ``merge_probe_cells`` exactly.
3. Process groups: gloo ranks on the CPU (``tests/_torch_sharded_ranks.py``,
   one spawn per case, each with its own timeout) against the port's own
   emulation and single-device search: sparse and dense runs, the epoch,
   the tree and the graph build bit for bit; ``ShardedIvf`` ids equal to
   ``search``'s (``rerank=0`` for the codecs), recall at the default rerank
   no lower, and the telemetry slots equal to counts made on the host;
   n % R != 0 through the padding.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_sharded_ranks as ranks
from repro.core import engine as jeng
from repro.core import graph_build as jgb
from repro.core import recall as jrec
from repro.core import two_means as jtm
from repro.index import ivf as jivf
from repro.index import probe as jprobe
from repro.index import quantize as jq
from repro_torch import interop
from repro_torch.core import engine as teng
from repro_torch.core import graph_build as tgb
from repro_torch.core import recall as trec
from repro_torch.core import two_means as ttm
from repro_torch.core.objective import distortion as tdistortion
from repro_torch.index import ivf as tivf
from repro_torch.index import probe as tprobe
from repro_torch.index.quantize import bytes_per_row
from repro_torch.kernels import ref as tref
from repro_torch.obs import telemetry as ttel


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
    """(1024, 16) Gaussian blobs, made with numpy from a seed."""
    rng = np.random.default_rng(21)
    means = rng.standard_normal((24, 16)) * 4.0
    return (means[rng.integers(0, 24, 1024)]
            + rng.standard_normal((1024, 16))).astype(np.float32)


def _bits(key, count):
    return np.asarray(jax.random.bits(key, (count,), jnp.uint32))


def _port_state(js):
    return interop.bkm_state(np.asarray(js.assign), np.asarray(js.D),
                             np.asarray(js.cnt), device="cpu")


def _sources(kind, G):
    if kind == "graph":
        return jeng.graph_source(jnp.asarray(G)), teng.graph_source(
            torch.from_numpy(G))
    if kind == "dense":
        return jeng.dense_source(), teng.dense_source()
    return jeng.probe_source(3), teng.probe_source(3)


def _engine_case(blobs, k, seed):
    rng = np.random.default_rng(seed)
    n = blobs.shape[0]
    a = rng.integers(0, k, n).astype(np.int32)
    G = rng.integers(0, n, (n, 8)).astype(np.int32)
    return blobs, a, G


# --------------------------------------------------- 1. emulation vs reference

EPOCH_CASES = [
    # kind, shards, sparse, bf16, mode, masked
    ("graph", 2, True, False, "bkm", False),
    ("graph", 4, False, False, "bkm", False),
    ("graph", 4, True, True, "lloyd", False),
    ("graph", 4, True, False, "bkm", True),
    ("dense", 4, True, False, "bkm", False),
    ("dense", 2, False, False, "lloyd", False),
    ("probe", 2, True, False, "bkm", False),
]


@pytest.mark.parametrize("kind,shards,sparse,bf16,mode,masked", EPOCH_CASES)
def test_epoch_emulation_matches_reference(blobs, kind, shards, sparse,
                                           bf16, mode, masked):
    """One emulated epoch from the same state and key: the same moves,
    assignments and counts, D to f32 rounding."""
    k = 32
    X, a, G = _engine_case(blobs, k, shards)
    key = jax.random.PRNGKey(40 + shards)
    valid = np.arange(X.shape[0]) < 1000 if masked else None
    jsrc, tsrc = _sources(kind, G)
    js = jeng.init_state(jnp.asarray(X), jnp.asarray(a), k)
    jout = jeng.epoch(jnp.asarray(X), js, jsrc, key, jeng.EngineConfig(
        batch_size=64, mode=mode, sparse_updates=sparse, payload_bf16=bf16,
        shards=shards), None if valid is None else jnp.asarray(valid))
    tout = teng.epoch(torch.from_numpy(X), _port_state(js), tsrc,
                      _bits(key, 4), teng.EngineConfig(
                          batch_size=64, mode=mode, sparse_updates=sparse,
                          payload_bf16=bf16, shards=shards),
                      valid=None if valid is None
                      else torch.from_numpy(valid))
    np.testing.assert_array_equal(tout.assign.numpy(), np.asarray(jout.assign))
    assert int(tout.moves) == int(jout.moves) > 0
    np.testing.assert_array_equal(tout.cnt.numpy(), np.asarray(jout.cnt))
    np.testing.assert_allclose(tout.D.numpy(), np.asarray(jout.D),
                               rtol=1e-5, atol=1e-4)
    if masked:
        moved = tout.assign.numpy() != a
        assert not moved[1000:].any()


@pytest.mark.parametrize("shards,sparse", [(2, True), (4, False)])
def test_run_emulation_matches_reference(blobs, shards, sparse):
    """A 4-epoch emulated run with a validity mask: the same moves an
    epoch, assignments and counts; the distortion history within rtol
    1e-5."""
    k, iters = 32, 4
    X, a, G = _engine_case(blobs, k, 7)
    valid = np.arange(X.shape[0]) < 1010
    key = jax.random.PRNGKey(12)
    js = jeng.init_state(jnp.asarray(X), jnp.asarray(a), k)
    jcfg = jeng.EngineConfig(batch_size=64, iters=iters, shards=shards,
                             sparse_updates=sparse)
    st, hist, mh, ep, final, _ = jeng.run(
        jnp.asarray(X), jeng.init_state(jnp.asarray(X), jnp.asarray(a), k),
        jeng.graph_source(jnp.asarray(G)), key, jcfg, jnp.asarray(valid))
    words = interop.epoch_words(
        [_bits(jax.random.fold_in(key, t), 4) for t in range(iters)])
    res = teng.run(torch.from_numpy(X), _port_state(js),
                   teng.graph_source(torch.from_numpy(G)),
                   teng.EngineConfig(batch_size=64, iters=iters,
                                     shards=shards, sparse_updates=sparse),
                   epoch_words=words, valid=torch.from_numpy(valid))
    ep = int(ep)
    assert res.epochs == ep and res.moves == np.asarray(mh)[:ep].tolist()
    np.testing.assert_array_equal(res.state.assign.numpy(),
                                  np.asarray(st.assign))
    np.testing.assert_array_equal(res.state.cnt.numpy(), np.asarray(st.cnt))
    np.testing.assert_allclose(res.history, np.asarray(hist)[:ep], rtol=1e-5)
    np.testing.assert_allclose(float(res.final), float(final), rtol=1e-5)


def test_two_means_dist_emulation_matches_reference(blobs):
    """shards=4: the split is an integer radix select, so the partition is
    equal."""
    k = 32
    key = jax.random.PRNGKey(77)
    rows = np.arange(blobs.shape[0], dtype=np.int32)
    want = np.asarray(jtm.two_means_dist(jnp.asarray(blobs),
                                         jnp.asarray(rows), k, key,
                                         shards=4, data_axes=None))
    salts = np.stack([_bits(jax.random.fold_in(key, lvl), 2)
                      for lvl in range(k.bit_length() - 1)])
    got = ttm.two_means_dist(torch.from_numpy(blobs), torch.from_numpy(rows),
                             k, salts=salts, shards=4).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.bincount(got, minlength=k) == blobs.shape[0] // k).all()


def _partition_draws(key, n, cfg):
    """The reference's draws of one partition build (graph_build.py:
    _build_single, _build_rounds, _partition_round; two_means_dist's
    salts)."""
    k0, n_pad = jgb._plan(n, cfg)
    kpad, kb = jax.random.split(key)
    pad = np.array(jax.random.randint(kpad, (n_pad - n,), 0, n,
                                      dtype=jnp.int32))
    kinit, kloop = jax.random.split(kb)
    real_id = jnp.concatenate([jnp.arange(n, dtype=jnp.int32),
                               jnp.asarray(pad)])
    init = np.array(jgb._random_ids(kinit, real_id, n, cfg.kappa))
    salts, words = [], []
    for t in range(cfg.tau):
        k1, k2 = jax.random.split(jax.random.fold_in(kloop, t))
        salts.append(np.stack([_bits(jax.random.fold_in(k1, lvl), 2)
                               for lvl in range(k0.bit_length() - 1)]))
        words.append(_bits(k2, 4))
    return tgb.BuildDraws(pad, init, np.stack(salts),
                          interop.epoch_words(words))


def test_build_graph_emulation_matches_reference(blobs):
    """GraphBuildConfig(shards=4), phantom rows included (1000 -> 1024):
    the overflow of every round equal, ids equal but at near-ties (at most
    1% of the rows; the distance lists within 1e-5·(||x||² + ||y||²), the
    size of the terms that cancel), recall@κ within 0.02."""
    n, kappa = 1000, 8
    X = blobs[:n]
    key = jax.random.PRNGKey(31)
    kw = dict(kappa=kappa, xi=32, tau=3, chunk=256, shards=4)
    jg, jd = jgb.build_graph(jnp.asarray(X), key, jgb.GraphBuildConfig(**kw))
    jcfg = jgb.GraphBuildConfig(**kw)
    tg, td = tgb.build_graph(torch.from_numpy(X), tgb.GraphBuildConfig(**kw),
                             draws=_partition_draws(key, n, jcfg))
    np.testing.assert_array_equal(td.overflow.numpy(), np.asarray(jd.overflow))
    ids_t, ids_j = tg.ids.numpy(), np.asarray(jg.ids)
    # ||x||² + ||y||² − 2x·y rounds by a few ulps of the norms that cancel
    xsq = (X.astype(np.float64) ** 2).sum(1)
    scale = xsq[:, None] + xsq[np.maximum(ids_t, 0)]
    assert (np.abs(tg.dist.numpy() - np.asarray(jg.dist))
            <= 1e-5 * scale).all()
    mismatch = (ids_t != ids_j).any(1).mean()
    assert mismatch <= 0.01, mismatch           # near-ties only
    gt = np.array(jrec.brute_force_knn(jnp.asarray(X), kappa))
    rj = float(jrec.recall_at(jg.ids, jnp.asarray(gt), kappa))
    rt = float(trec.recall_at(tg.ids, torch.from_numpy(gt), kappa))
    assert abs(rt - rj) <= 0.02, (rt, rj)


# ------------------------------------------------- 2. exact host/merge code

class _Clustering:
    def __init__(self, assign, centroids, k):
        self.assign, self.centroids, self.k = assign, centroids, k


def _reference_index(codec):
    rng = np.random.default_rng(8)
    k, d, n = 11, 8, 700
    cent = rng.standard_normal((k, d)).astype(np.float32) * 3
    w = 1.0 / np.arange(1, k + 1)
    a = rng.choice(k, n, p=w / w.sum()).astype(np.int32)
    X = (cent[a] + rng.standard_normal((n, d))).astype(np.float32)
    j = jivf.build_ivf(X, _Clustering(a, cent, k), block_rows=8)
    if codec == "int8":
        j = jivf.attach_codec(j, jq.train_int8(jnp.asarray(X)))
    return j


@pytest.mark.parametrize("shards", [1, 3, 4])
@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_shard_lists_equals_reference(shards, codec):
    j = _reference_index(codec)
    kw = {}
    if codec == "int8":
        kw = dict(codes=np.asarray(j.codes), vnorm=np.asarray(j.vnorm),
                  int8_scale=np.asarray(j.codec.scale),
                  int8_zero=np.asarray(j.codec.zero))
    t = interop.ivf_index(*(np.asarray(getattr(j, f)) for f in (
        "centroids", "vecs", "ids", "starts", "caps")), j.block_rows,
        j.repack_threshold, device="cpu", **kw)
    want = jivf.shard_lists(j, shards)
    got = tivf.shard_lists(t, shards)
    conv = interop.sharded_lists(
        *(np.asarray(getattr(want, f)) for f in (
            "vecs", "ids", "starts", "caps", "owner")), want.rows_loc,
        want.shards, None if want.codes is None else np.asarray(want.codes),
        None if want.vnorm is None else np.asarray(want.vnorm), device="cpu")
    assert got.rows_loc == conv.rows_loc and got.shards == conv.shards
    for f in ("vecs", "ids", "starts", "caps", "owner", "codes", "vnorm"):
        g, w = getattr(got, f), getattr(conv, f)
        assert (g is None) == (w is None), f
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w), f


def test_merges_exact():
    """merge_shard_topk and merge_probe_cells against the reference's on
    lists with exact ties, +inf holes (id -1) and exhausted columns."""
    rng = np.random.default_rng(13)
    R, q, t = 3, 17, 5
    part = rng.integers(0, 6, (R, q, t)).astype(np.float32)
    ids = rng.permutation(R * q * t).reshape(R, q, t).astype(np.int32)
    hole = rng.random((R, q, t)) < 0.3
    part[hole], ids[hole] = np.inf, -1
    part.sort(-1)
    for topk in (1, 4, 20):
        wi, wd = jprobe.merge_shard_topk(jnp.asarray(ids), jnp.asarray(part),
                                         topk)
        gi, gd = tprobe.merge_shard_topk(torch.from_numpy(ids),
                                         torch.from_numpy(part), topk)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    L = 9
    gd = rng.integers(0, 4, (L, q)).astype(np.float32)
    gi = rng.integers(0, 50, (L, q)).astype(np.int32)
    cut = rng.random((L, q)) < 0.4
    gd[cut], gi[cut] = np.inf, -1
    gd[:, 0] = np.inf                           # an all-hole column
    for p in (1, 3, 9, 12):
        want = jprobe.merge_probe_cells(jnp.asarray(gd), jnp.asarray(gi), p)
        got = tprobe.merge_probe_cells(torch.from_numpy(gd),
                                       torch.from_numpy(gi), p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------- 3. process groups

@pytest.fixture(scope="module")
def main_case(tmp_path_factory):
    """The "main" case on 4 gloo ranks (R = 4)."""
    return ranks.spawn("main", 4, tmp_path_factory.mktemp("main"), 240)


@pytest.fixture(scope="module")
def pad_case(tmp_path_factory):
    """The "pad" case on 3 gloo ranks: 481 rows, 481 % 3 != 0."""
    return ranks.spawn("pad", 3, tmp_path_factory.mktemp("pad"), 240)


def _emulated_run(n, kind, sparse, bf16, mode, shards):
    """The port's one-device emulation of a ShardedEngine.run: the rows
    zero-padded to a multiple of ``shards``, with their validity mask."""
    X, a, G = ranks.engine_inputs(n)
    st = teng.init_state(X, a, ranks.K)
    n_pad = -(-n // shards) * shards
    pad = n_pad - n

    def padded(t):
        return torch.cat([t, torch.zeros((pad,) + t.shape[1:],
                                         dtype=t.dtype)])
    src = {"graph": teng.graph_source(padded(G)),
           "dense": teng.dense_source(), "probe": teng.probe_source(3)}[kind]
    st = teng.BKMState(padded(st.assign), st.D, st.cnt, st.moves)
    valid = torch.arange(n_pad) < n if pad else None
    return teng.run(padded(X), st, src,
                    ranks.engine_cfg(sparse, bf16, mode, shards),
                    epoch_words=ranks.WORDS, valid=valid)


def _assert_same_run(got, want, n):
    assert torch.equal(got.state.assign, want.state.assign[:n])
    assert torch.equal(got.state.D, want.state.D)
    assert torch.equal(got.state.cnt, want.state.cnt)
    assert got.moves == want.moves and got.epochs == want.epochs
    assert sum(got.moves) > 0
    np.testing.assert_allclose(got.history, want.history, rtol=1e-6)
    assert torch.equal(got.telemetry.i32, want.telemetry.i32)
    np.testing.assert_allclose(got.telemetry.f32.numpy(),
                               want.telemetry.f32.numpy(), rtol=1e-6)


@pytest.mark.parametrize("kind,sparse,bf16,mode", ranks.KINDS)
def test_group_run_equals_emulation(main_case, kind, sparse, bf16, mode):
    """ShardedEngine.run on 4 gloo ranks against engine.run(shards=4): the
    state bit for bit (sparse and dense updates, the bf16 payload, every
    candidate source), moves and telemetry counts exactly."""
    got = main_case[("run", kind, sparse, bf16, mode)]
    want = _emulated_run(ranks.N, kind, sparse, bf16, mode, 4)
    _assert_same_run(got, want, ranks.N)


def test_group_epoch_tree_and_distortion(main_case):
    X, a, G = ranks.engine_inputs()
    st = teng.init_state(X, a, ranks.K)
    want = teng.epoch(X, st, teng.graph_source(G), ranks.WORDS[0],
                      ranks.engine_cfg(True, False, "bkm", 4))
    got = main_case["epoch"]
    assert torch.equal(got.assign, want.assign)
    assert torch.equal(got.D, want.D) and torch.equal(got.cnt, want.cnt)
    assert int(got.moves) == int(want.moves) > 0
    np.testing.assert_allclose(float(main_case["distortion"]),
                               float(tdistortion(X, a, ranks.K)), rtol=1e-5)
    rows = torch.arange(ranks.N)
    tree = ttm.two_means_dist(X, rows, 16, salts=[[7, 8], [9, 10], [11, 12],
                                                  [13, 14]], shards=4)
    assert torch.equal(main_case["tree"], tree)


@pytest.mark.parametrize("source", ["partition", "descent"])
def test_group_builder_equals_emulation(main_case, source):
    """GraphBuilder over 4 gloo ranks against build_graph(shards=4): ids,
    distances, overflow, guided moves and the integer telemetry exactly."""
    g, d = main_case[("build", source)]
    cfg = tgb.GraphBuildConfig(kappa=ranks.KAPPA, source=source, xi=16,
                               tau=3, chunk=50, telemetry=True, shards=4)
    wg, wd = tgb.build_graph(ranks.engine_inputs()[0], cfg,
                             generator=torch.Generator().manual_seed(4))
    assert torch.equal(g.ids, wg.ids) and torch.equal(g.dist, wg.dist)
    assert torch.equal(d.overflow, wd.overflow)
    assert torch.equal(d.guided_moves, wd.guided_moves)
    assert torch.equal(d.telemetry.i32, wd.telemetry.i32)
    np.testing.assert_allclose(d.telemetry.f32.numpy(),
                               wd.telemetry.f32.numpy(), rtol=1e-6)
    if source == "partition":
        assert int(d.guided_moves.sum()) > 0


def _check_ivf(out, R):
    """Every ShardedIvf path against the single-device search."""
    c = ranks.IVF
    indexes, Q = ranks.ivf_indexes()
    X = indexes["f32"].vecs[indexes["f32"].ids >= 0]
    order = indexes["f32"].ids[indexes["f32"].ids >= 0].long()
    Xs = torch.empty_like(X)
    Xs[order] = X
    true = torch.cdist(Q, Xs).argsort(1)[:, :c["topk"]]
    for codec, qgroup, rerank in ranks.IVF_PATHS:
        ids, d2, tel = out[("ivf", codec, qgroup, rerank)]
        index = indexes[codec]
        wi, wd = tprobe.search(index, Q, topk=c["topk"], nprobe=c["nprobe"],
                               qgroup=qgroup, codec=codec, rerank=rerank)
        if codec == "f32" or rerank == 0:
            assert torch.equal(ids, wi), (codec, qgroup, rerank)
            np.testing.assert_allclose(d2.numpy(), wd.numpy(), rtol=1e-6)
        else:
            def rec(i):
                return float(trec.recall_at(i, true, c["topk"]))
            assert rec(ids) >= rec(wi), (codec, rec(ids), rec(wi))
        # the telemetry slots against counts made here
        cids, _ = tref.probe_centroids(Q, index.centroids, c["nprobe"])
        owner = tivf.shard_lists(index, R).owner
        caps = index.caps.long()[cids.long()]
        per = torch.zeros(R, dtype=torch.int64).index_add_(
            0, owner[cids.long()].reshape(-1), caps.reshape(-1))
        total = int(caps.sum())
        bpr = 4 * index.dim if codec == "f32" else bytes_per_row(
            index.codec, index.dim)
        assert int(ttel.column(tel, "scanned_rows")[0]) == total
        assert int(ttel.column(tel, "scanned_rows_max_shard")[0]) == int(
            per.max())
        assert float(ttel.column(tel, "scan_frac")[0]) == pytest.approx(
            total / (Q.shape[0] * index.capacity_rows), rel=1e-6)
        assert float(ttel.column(tel, "scanned_bytes")[0]) == pytest.approx(
            total * bpr, rel=1e-6)


def test_group_ivf_matches_search(main_case):
    """ShardedIvf on 4 gloo ranks: f32, qgroup 4, int8 and PQ with
    rerank=0 — ids equal to search's; the default rerank recalls no less;
    the four telemetry slots equal the host's counts."""
    _check_ivf(main_case, 4)


def test_group_padding_equals_emulation(pad_case):
    """3 gloo ranks, 481 rows: the zero-padded rows stay out of every move
    and statistic (the run equals the emulation over the padded rows with
    their mask), and ShardedIvf with k % 3 != 0 matches search."""
    for kind, sparse, bf16, mode in ranks.KINDS[:1] + ranks.KINDS[3:4]:
        want = _emulated_run(ranks.N + 1, kind, sparse, bf16, mode, 3)
        _assert_same_run(pad_case[("run", kind)], want, ranks.N + 1)
        assert int(want.state.cnt.sum()) == ranks.N + 1
    _check_ivf(pad_case, 3)


@pytest.mark.parametrize("case", ["main_case", "pad_case"])
def test_fsum_owned_equals_fsum_block(request, case):
    """``Comm.fsum_owned`` on 4 and on 3 gloo ranks: every rank's block of
    the rank-ordered sum equals ``fsum(x)`` sliced to its rows, bit for
    bit."""
    ok = request.getfixturevalue(case)["fsum_owned"]
    assert ok.shape == ({"main_case": 4, "pad_case": 3}[case],)
    assert bool(ok.all())


def test_group_dense_sync_receives_one_copy_of_the_deltas(main_case):
    """A dense group run on 4 gloo ranks under ``collective_counter``: per
    step the dense sync moves at most k·d·4 + k·4 bytes (one all-to-all of
    the (k, d) deltas and the (k,) count psum); gathering every rank's
    deltas, as before, moved (R−1)·k·d·4."""
    summ, steps, a2a = main_case["dense_sync"]
    k, d = ranks.K, ranks.D
    assert steps == 15 and a2a == steps
    assert summ["all-to-all"]["count"] == steps
    assert summ["all-reduce"]["count"] == steps
    assert summ["all-gather"]["count"] == 0
    per_step = summ["total_wire_bytes"] / steps
    assert per_step <= k * d * 4 + k * 4
    assert per_step == pytest.approx(
        k * d * 4 * 3 / 4 + 2 * k * 4 * 3 / 4)
    assert per_step < 3 * k * d * 4


def test_cluster_large_launcher_group_of_one(tmp_path):
    """``launch/cluster_large.py`` without torchrun (a gloo group of one on
    the CPU): every row assigned, the distortion falls, one host sync an
    epoch plus the final read, and a valid run record."""
    from repro_torch.launch import cluster_large
    from repro_torch.obs import emit
    path = tmp_path / "rec.json"
    assert cluster_large.main(["--device", "cpu", "--n", "3000", "--k",
                               "128", "--d", "8", "--iters", "3", "--emit",
                               str(path)]) == 0
    rec = emit.load_records(str(path))[0]
    emit.validate_record(rec)
    m = rec["metrics"]
    assert m["rows_assigned"] == 3000 and rec["shapes"]["init_pad_rows"] == 72
    assert m["host_syncs_run"] == m["epochs"] + 1
    assert m["distortion_final"] < m["distortion_init"]
    assert rec["config"]["backend"] == "gloo"
    assert len(rec["telemetry"]["moves"]) == m["epochs"]
