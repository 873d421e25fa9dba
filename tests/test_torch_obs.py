"""The port's observability layer against the JAX package's, on the CPU.

The telemetry registry, the helpers and the run records are held against
``repro.obs`` on the same values; engine and graph-build telemetry against
the reference's rows with the reference's draws injected.  Tolerances, as
each test states: counters (moves, proposed, empty clusters, overflow,
list updates) exact; distortion and hit rate within rtol 1e-4 (whole engine
runs), mean list distance within rtol 1e-5 (float data) or exact (integer
data).  The roofline inventory is held to the bounds ``PERF.md`` §6 lists
(4 significant figures).
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import graph_build as jgb
from repro.core import knn_graph as jknn
from repro.core import two_means as jtm
from repro.obs import emit as jemit
from repro.obs import telemetry as jtel
from repro_torch import interop
from repro_torch.core import engine as teng
from repro_torch.core import graph_build as tgb
from repro_torch.core.gkmeans import gk_means
from repro_torch.kernels import _build
from repro_torch.launch import obs_report, roofline
from repro_torch.obs import emit as temit
from repro_torch.obs import syncs as tsyncs
from repro_torch.obs import telemetry as ttel
from repro_torch.obs import timing as ttiming


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


def _epoch_words(key, iters):
    return interop.epoch_words([_bits(jax.random.fold_in(key, t), 4)
                                for t in range(iters)])


# ------------------------------------------------------------------ telemetry

def test_slot_registry_matches_reference():
    assert ttel.I32_SLOTS == jtel.I32_SLOTS
    assert ttel.F32_SLOTS == jtel.F32_SLOTS
    assert (ttel.N_I32, ttel.N_F32) == (jtel.N_I32, jtel.N_F32)
    t = ttel.init(3)
    assert t.i32.shape == (3, 8) and t.i32.dtype == torch.int32
    assert t.f32.shape == (3, 5) and t.f32.dtype == torch.float32
    assert t.rows == 3 and ttel.init(0).rows == 0


def test_record_helpers_match_reference():
    """record (row as an int and as a 0-d tensor), record_rows, column and
    to_dict on the same values give the reference's rows; None passes
    through; an unknown slot raises."""
    rows = 4
    j = jtel.init(rows)
    t = ttel.init(rows)
    j = jtel.record(j, 1, moves=7, proposed=9, distortion=2.5, hit_rate=0.75)
    ttel.record(t, 1, moves=7, proposed=torch.tensor(9),
                distortion=torch.tensor(2.5), hit_rate=0.75)
    j = jtel.record(j, jnp.int32(2), empty_clusters=3, graph_mean_dist=1.25)
    ttel.record(t, torch.tensor(2), empty_clusters=torch.tensor(3),
                graph_mean_dist=1.25)
    vals = np.array([1, 2, 3, 4], np.int32)
    dist = np.array([0.5, 0.25, 0.125, 4.0], np.float32)
    j = jtel.record_rows(j, overflow=vals, scan_frac=dist)
    ttel.record_rows(t, overflow=torch.from_numpy(vals), scan_frac=list(dist))
    np.testing.assert_array_equal(t.i32.numpy(), np.asarray(j.i32))
    np.testing.assert_array_equal(t.f32.numpy(), np.asarray(j.f32))
    for name in ("moves", "overflow", "distortion", "scan_frac"):
        np.testing.assert_array_equal(ttel.column(t, name).numpy(),
                                      np.asarray(jtel.column(j, name)))
    for kw in ({}, {"rows": 2}, {"slots": ["moves", "hit_rate"]}):
        assert ttel.to_dict(t, **kw) == jtel.to_dict(j, **kw)
    assert ttel.record(None, 0, moves=1) is None
    assert ttel.record_rows(None, moves=[1]) is None
    assert ttel.to_dict(None) == {} == jtel.to_dict(None)
    for bad in (lambda: ttel.record(t, 0, nope=1),
                lambda: ttel.column(t, "nope")):
        with pytest.raises(KeyError, match="unknown telemetry slot"):
            bad()
    packed = ttel.unpack(ttel.pack(t), rows)
    assert torch.equal(packed.i32, t.i32) and torch.equal(packed.f32, t.f32)


# ---------------------------------------------------------------------- emit

def _records(mod):
    return mod.run_record("engine", shapes={"n": 8}, config={"iters": 2},
                          metrics={"seconds": 1.5, "epochs": 2},
                          telemetry={"moves": [3, 1]}, notes=["cpu test"])


def test_records_interchange_with_reference(tmp_path):
    """A record written by either package loads and validates under the
    other, as one JSON file and as JSONL lines."""
    for writer, reader in ((temit, jemit), (jemit, temit)):
        rec = _records(writer)
        path = tmp_path / f"BENCH_{writer.__name__.split('.')[0]}.json"
        writer.write_json(str(path), rec)
        (back,) = reader.load_records(str(path))
        assert back == json.loads(json.dumps(rec))
        jl = str(tmp_path / f"{writer.__name__.split('.')[0]}.jsonl")
        writer.append_jsonl(jl, rec)
        writer.append_jsonl(jl, rec)
        assert len(reader.load_records(jl)) == 2
    assert temit.SCHEMA == jemit.SCHEMA
    assert temit.ANALYSIS_SCHEMA == jemit.ANALYSIS_SCHEMA
    assert temit.REQUIRED_KEYS == jemit.REQUIRED_KEYS
    env = _records(temit)["env"]
    assert env["backend"] in ("cpu", "cuda") and "torch" in env
    assert "jax" not in env
    assert set(temit.load_dir(str(tmp_path))) == {"engine"}


@pytest.mark.parametrize("drift", ["not_a_dict", "missing_metrics",
                                   "wrong_schema", "shapes_not_dict"])
def test_both_packages_reject_the_same_drift(drift):
    rec = _records(temit)
    if drift == "not_a_dict":
        rec = [rec]
    elif drift == "missing_metrics":
        del rec["metrics"]
    elif drift == "wrong_schema":
        rec["schema"] = "repro.bench.v0"
    else:
        rec["shapes"] = [1, 2]
    for mod in (temit, jemit):
        with pytest.raises(ValueError):
            mod.validate_record(rec)


# --------------------------------------------------------------------- syncs

def test_sync_counter_counts_get_block_and_read():
    X = torch.arange(6.0)
    assert tsyncs.read(X) is not None          # no counter: a plain read
    with tsyncs.sync_counter() as sc:
        a, (b,), d = sc.get((X, [X * 2], {"x": X}))
        sc.block(X)
        c = tsyncs.read(X + 1)
        with tsyncs.sync_counter() as inner:   # counters nest: innermost
            tsyncs.read(X)
    assert sc.syncs == 3 and inner.syncs == 1
    assert torch.equal(b, X * 2) and torch.equal(d["x"], X)
    assert torch.equal(c, X + 1) and a.device.type == "cpu"
    assert tsyncs._active == []


# -------------------------------------------------------------------- engine

def _engine_case(blobs, mode, iters):
    X = blobs
    k = 64
    g = jknn.build_knn_graph(jnp.asarray(X), 16, xi=32, tau=2,
                             key=jax.random.PRNGKey(1))
    assign = np.asarray(jtm.two_means_tree(jnp.asarray(X), k,
                                           jax.random.PRNGKey(2)))
    return X, k, g, assign, jax.random.PRNGKey(3)


def _port_state(X, assign, k):
    js = jeng.init_state(jnp.asarray(X), jnp.asarray(assign), k)
    return interop.bkm_state(np.asarray(js.assign), np.asarray(js.D),
                             np.asarray(js.cnt), device="cpu")


@pytest.mark.parametrize("mode", ["bkm", "lloyd"])
def test_engine_run_telemetry_matches(blobs, mode):
    """engine.run(telemetry=True) from the reference's state and epoch
    words: moves, proposed and empty_clusters exact; distortion and
    hit_rate within rtol 1e-4; rows past the epochs run 0.  Telemetry off
    gives bit-identical assignments, D and cnt, and no rows."""
    iters = 6
    X, k, g, assign, kb = _engine_case(blobs, mode, iters)
    cfg = jeng.EngineConfig(batch_size=256, mode=mode, iters=iters,
                            min_move_frac=0.01, telemetry=True)
    st = jeng.init_state(jnp.asarray(X), jnp.asarray(assign), k)
    _, _, _, ep, _, jt = jeng.run(jnp.asarray(X), st,
                                  jeng.graph_source(g.ids), kb, cfg)
    ep = int(ep)
    graph = interop.knn_graph(np.asarray(g.ids), np.asarray(g.dist),
                              device="cpu")
    words = _epoch_words(kb, iters)
    runs = {}
    for tel in (True, False):
        tcfg = teng.EngineConfig(batch_size=256, mode=mode, iters=iters,
                                 min_move_frac=0.01, telemetry=tel)
        runs[tel] = teng.run(torch.from_numpy(X), _port_state(X, assign, k),
                             teng.graph_source(graph.ids), tcfg,
                             epoch_words=words)
    res = runs[True]
    assert res.epochs == ep and res.telemetry.rows == iters
    ti, tf = res.telemetry.i32.numpy(), res.telemetry.f32.numpy()
    ji, jf = np.asarray(jt.i32), np.asarray(jt.f32)
    exact = [ttel.I32_SLOTS[s] for s in ("moves", "proposed",
                                         "empty_clusters")]
    np.testing.assert_array_equal(ti[:, exact], ji[:, exact])
    for s in ("distortion", "hit_rate"):
        c = ttel.F32_SLOTS[s]
        np.testing.assert_allclose(tf[:ep, c], jf[:ep, c], rtol=1e-4)
    assert not ti[ep:].any() and not tf[ep:].any()
    assert (ti[:ep, 1] >= ti[:ep, 0]).all()
    np.testing.assert_array_equal(ti[:ep, 0], res.moves)
    np.testing.assert_array_equal(tf[:ep, 0], np.float32(res.history))
    off = runs[False]
    assert off.telemetry is None and off.host_syncs == res.host_syncs == ep
    for f in ("assign", "D", "cnt"):
        assert torch.equal(getattr(off.state, f), getattr(res.state, f)), f
    assert off.history == res.history


def test_epoch_proposed_side_tensor(blobs):
    """epoch's side tensor receives the pre-guard proposals and leaves the
    state bit-identical to an epoch without it."""
    X = torch.from_numpy(blobs[:1024])
    a = torch.from_numpy(np.random.default_rng(4).integers(
        0, 32, 1024).astype(np.int32))
    G = torch.from_numpy(np.random.default_rng(5).integers(
        0, 1024, (1024, 8)).astype(np.int32))
    cfg = teng.EngineConfig(batch_size=128, telemetry=True)
    prop = torch.full((), 99, dtype=torch.int32)
    outs = []
    for side in (prop, None):
        st = teng.init_state(X, a, 32)
        outs.append(teng.epoch(X, st, teng.graph_source(G), [5, 6, 7, 8],
                               cfg, side))
    for f in ("assign", "D", "cnt", "moves"):
        assert torch.equal(getattr(outs[0], f), getattr(outs[1], f)), f
    assert int(prop) >= int(outs[0].moves) > 0


def test_gk_means_telemetry_under_sync_counter(blobs):
    """gk_means(telemetry=True) on the CPU: the counter counts epochs + 1
    reads, as the result documents, and the rows agree with the result's
    moves and history."""
    X = blobs[:1024]
    with tsyncs.sync_counter() as sc:
        r = gk_means(X, 16, kappa=8, xi=32, tau=2, iters=5, batch_size=256,
                     min_move_frac=0.0, telemetry=True, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    epochs = len(r.history)
    assert sc.syncs == r.host_syncs == epochs + 1
    tel = r.telemetry
    assert tel.i32.device.type == "cpu" and tel.rows == 5
    d = ttel.to_dict(tel, rows=epochs)
    assert d["moves"] == r.moves
    np.testing.assert_array_equal(np.float32(d["distortion"]),
                                  np.float32(r.history))
    assert all(p >= m for p, m in zip(d["proposed"], d["moves"]))
    np.testing.assert_allclose(
        d["hit_rate"], [m / max(p, 1) for m, p in zip(d["moves"],
                                                      d["proposed"])],
        rtol=1e-6)
    assert all(0 <= e < 16 for e in d["empty_clusters"])
    with tsyncs.sync_counter() as sc:
        r2 = gk_means(X, 16, kappa=8, xi=32, tau=2, iters=5, batch_size=256,
                      min_move_frac=0.0, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    assert r2.telemetry is None and sc.syncs == r2.host_syncs
    assert torch.equal(r2.assign, r.assign)


# --------------------------------------------------------------- graph build

def _integer_data(n, d, seed):
    """Small-integer coordinates: every distance exact in float32."""
    return np.random.default_rng(seed).integers(0, 4, (n, d)).astype(
        np.float32)


def _descent_draws(key, n, kappa, s, tau):
    """The reference's draws of one descent build (graph_build.py:
    _build_single, _build_rounds, _descent_round)."""
    _, kb = jax.random.split(key)
    kinit, kloop = jax.random.split(kb)
    init = np.array(jgb._random_ids(kinit, jnp.arange(n, dtype=jnp.int32),
                                    n, kappa))
    p1, p2, sl = [], [], []
    for t in range(tau):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(kloop, t), 3)
        p1.append(np.array(jax.random.randint(k1, (n, s), 0, kappa)))
        p2.append(np.array(jax.random.randint(k2, (n, s), 0, kappa)))
        sl.append(np.array(jax.random.randint(k3, (n, kappa), 0, s)))
    return tgb.DescentDraws(init, np.stack(p1), np.stack(p2), np.stack(sl))


def _partition_draws(key, n, cfg):
    """The reference's draws of one partition build: phantom rows, random
    init ids, each round's tree salts and guided-pass words
    (graph_build.py: _build_single, _build_rounds, _partition_round;
    two_means_dist's salts)."""
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


def test_descent_build_telemetry_bit_exact():
    """source='descent', the reference's draws injected, integer data: every
    telemetry slot equal to the reference's, overflow and guided_moves 0."""
    n, kappa, s, tau = 400, 8, 12, 3
    X = _integer_data(n, 8, 11)
    key = jax.random.PRNGKey(5)
    kw = dict(kappa=kappa, source="descent", tau=tau, sample=s,
              telemetry=True)
    _, jd = jgb.build_graph(jnp.array(X), key, jgb.GraphBuildConfig(
        chunk=256, **kw))
    _, td = tgb.build_graph(torch.from_numpy(X), tgb.GraphBuildConfig(
        chunk=100, **kw), draws=_descent_draws(key, n, kappa, s, tau))
    np.testing.assert_array_equal(td.telemetry.i32.numpy(),
                                  np.asarray(jd.telemetry.i32))
    np.testing.assert_array_equal(td.telemetry.f32.numpy(),
                                  np.asarray(jd.telemetry.f32))
    upd = ttel.column(td.telemetry, "graph_updates")
    assert int(upd[0]) > 0
    assert not ttel.column(td.telemetry, "overflow").any()


def test_partition_build_telemetry_matches(blobs):
    """source='partition' (random init, guided pass), the reference's draws
    injected, float data: overflow exact, graph_mean_dist within rtol 1e-5;
    the rows agree with the build's own diagnostics, the mean distance
    falls round to round, and telemetry off builds the same graph."""
    n = 1000
    X = blobs[:n]
    key = jax.random.PRNGKey(6)
    kw = dict(kappa=8, xi=32, tau=3, chunk=256)
    jcfg = jgb.GraphBuildConfig(telemetry=True, **kw)
    _, jd = jgb.build_graph(jnp.array(X), key, jcfg)
    draws = _partition_draws(key, n, jcfg)
    graphs = {}
    for tel in (True, False):
        graphs[tel] = tgb.build_graph(
            torch.from_numpy(X), tgb.GraphBuildConfig(telemetry=tel, **kw),
            draws=draws)
    (tg, td), (og, od) = graphs[True], graphs[False]
    t = td.telemetry
    np.testing.assert_array_equal(ttel.column(t, "overflow").numpy(),
                                  np.asarray(jtel.column(jd.telemetry,
                                                         "overflow")))
    np.testing.assert_allclose(
        ttel.column(t, "graph_mean_dist").numpy(),
        np.asarray(jtel.column(jd.telemetry, "graph_mean_dist")), rtol=1e-5)
    assert torch.equal(ttel.column(t, "overflow"), td.overflow)
    assert torch.equal(ttel.column(t, "guided_moves"), td.guided_moves)
    mdist = ttel.column(t, "graph_mean_dist")
    assert bool((mdist[1:] <= mdist[:-1] * (1 + 1e-6)).all())
    assert int(ttel.column(t, "graph_updates")[0]) > 0
    assert od.telemetry is None
    assert torch.equal(og.ids, tg.ids) and torch.equal(og.dist, tg.dist)


# --------------------------------------------------------- roofline, report

# PERF.md §6's bounds (ms) at chip_smoke.py's shapes
BOUNDS = [
    ("gather_score", dict(B=1024, C=50, d=128, k=16384), None, 0.002804),
    ("gather_score", dict(B=1024, C=50, d=960, k=10000), None, 0.01277),
    ("gather_score", dict(B=1024, C=17, d=128, k=16384), None, 0.002723),
    ("gather_score", dict(B=1024, C=93, d=128, k=16384), None, 0.002909),
    ("assign_centroids", dict(n=10_000, k=16384, d=128), None, 0.2542),
    ("assign_centroids", dict(n=1_000_000, k=16384, d=128), None, 25.42),
    ("assign_centroids", dict(n=1_010_000, k=256, d=16), None, 0.05014),
    ("assign_centroids", dict(n=1_000_000, k=10_000, d=128), None, 15.52),
    ("assign_centroids", dict(n=10_000, k=16384, d=128),
     roofline.FP32_FLOPS, 0.6260),
    ("assign_centroids", dict(n=1_000_000, k=10_000, d=128),
     roofline.FP32_FLOPS, 38.21),
    ("probe_centroids", dict(n=10_000, k=16384, d=128, p=16), None, 0.6260),
    ("probe_centroids", dict(n=1024, k=16384, d=128, p=16), None, 0.0641),
    ("pairwise_sq", dict(B=15_625, m=64, d=128, itemsize=4), None, 0.2293),
    ("pairwise_sq", dict(B=2048, m=64, d=512, itemsize=4), None, 0.09015),
    ("pairwise_sq", dict(B=2048, m=64, d=512, itemsize=2), None, 0.05008),
    ("pairwise_sq", dict(B=1024, m=64, d=960, itemsize=4), None, 0.08013),
    ("pairwise_sq", dict(B=7812, m=128, d=128, itemsize=4), None, 0.3057),
]


@pytest.mark.parametrize("name,shape,peak,want_ms", BOUNDS,
                         ids=[f"{b[0]}-{i}" for i, b in enumerate(BOUNDS)])
def test_inventory_gives_the_recorded_bounds(name, shape, peak, want_ms):
    got = roofline.kernel_terms(name, peak=peak, **shape)["bound_s"] * 1e3
    np.testing.assert_allclose(got, want_ms, rtol=5e-4)


# the data-dependent counts as chip_smoke.py wrote them inline before they
# moved to the inventory: (nbytes, flops, peak) from the shape's values
_INLINE = {
    "refine_merge": lambda B, C, kappa, d, uniq_rows, pairs: (
        B * d * 4 + B * C * 4 + B * C * 4 + B * kappa * 4 + B * kappa * 4
        + uniq_rows * (d * 4 + 4) + 2 * B * kappa * 4,
        2 * pairs * d + 3 * pairs + kappa * (kappa + C) * B, 67e12),
    "ivf_scan": lambda nq, rows, d, topk: (
        4 * (nq * d + rows * d + 2 * nq * topk), 2 * rows * d, 67e12),
    "ivf_scan_adc": lambda nq, rows, M, W, topk: (
        4 * nq * M * W + rows * (M + 4) + 12 * nq * topk, 2 * rows * M,
        67e12),
    "ivf_scan_grouped": lambda nq, union_rows, pairs, d, topk: (
        4 * (nq * d + union_rows * d + 2 * nq * topk), 2 * pairs * d, 67e12),
}


@pytest.mark.parametrize("name,shape", [
    ("refine_merge", dict(B=1024, C=136, kappa=50, d=128, uniq_rows=58_636,
                          pairs=65_000)),
    ("refine_merge", dict(B=4096, C=200, kappa=50, d=128, uniq_rows=291_101,
                          pairs=700_000)),
    ("ivf_scan", dict(nq=10_000, rows=9_870_000, d=128, topk=10)),
    ("ivf_scan", dict(nq=64, rows=60_000, d=128, topk=10)),
    ("ivf_scan_adc", dict(nq=10_000, rows=9_870_000, M=8, W=256, topk=40)),
    ("ivf_scan_adc", dict(nq=10_000, rows=9_870_000, M=128, W=1, topk=40)),
    ("ivf_scan_grouped", dict(nq=10_000, union_rows=4_900_000,
                              pairs=9_870_000, d=128, topk=10))])
def test_inventory_keeps_the_inline_counts(name, shape):
    """The data-dependent bounds equal the inline formulas they replaced."""
    nbytes, flops, peak = _INLINE[name](**shape)
    want = max(nbytes / 3.35e12, flops / peak)
    t = roofline.kernel_terms(name, **shape)
    np.testing.assert_allclose([t["hbm_bytes"], t["flops"], t["bound_s"]],
                               [nbytes, flops, want], rtol=1e-12)


def test_inventory_covers_every_kernel():
    assert set(roofline.KERNEL_INVENTORY) == set(_build.KERNELS)
    for inv in roofline.KERNEL_INVENTORY.values():
        assert {"desc", "flops", "hbm_bytes", "peak"} <= set(inv)
    t = roofline.roofline_terms(67e12, 0.0, peak=roofline.FP32_FLOPS)
    assert t["bottleneck"] == "compute" and t["compute_s"] == 1.0
    assert roofline.roofline_terms(0.0, 1.0)["bottleneck"] == "memory"


def _kernels_record(entries):
    return temit.run_record("kernels", metrics={"kernels": entries})


def _write(tmp_path, rec):
    temit.write_json(str(tmp_path / f"BENCH_{rec['name']}.json"), rec)


def test_obs_report_renders_and_gates(tmp_path, capsys):
    """Kernel roofline and per-phase tables; rc 1 on a kernel missing from
    the inventory, a shape that does not name its arguments, schema drift
    and a missing --require."""
    entries = [{"kernel": "gather_score",
                "shape": dict(B=1024, C=50, d=128, k=16384), "us": 7.6},
               {"kernel": "pairwise_sq",
                "shape": dict(B=15_625, m=64, d=128, itemsize=4),
                "us": 507.4}]
    _write(tmp_path, _kernels_record(entries))
    _write(tmp_path, temit.run_record(
        "engine", metrics={"iter_s": 20.5},
        telemetry={"moves": [9, 3], "distortion": [2.5, 2.25]}))
    d = str(tmp_path)
    assert obs_report.main(["--dir", d, "--require", "kernels", "engine",
                            "gather_score", "pairwise_sq"]) == 0
    out = capsys.readouterr().out
    assert "kernel roofline" in out and "per-phase telemetry" in out
    assert "gather_score" in out and "iter_s = 20.5" in out
    rows = obs_report.kernel_rows(_kernels_record(entries))
    np.testing.assert_allclose(rows[0]["achieved_frac"], 2.804 / 7.6,
                               rtol=5e-4)
    assert rows[1]["bottleneck"] == "memory"
    assert obs_report.main(["--dir", d, "--require", "ivf_scan"]) == 1
    assert "required records missing" in capsys.readouterr().err
    for bad in ({"kernel": "nope", "shape": {}, "us": 1.0},
                {"kernel": "ivf_scan", "shape": {"q": 1}, "us": 1.0}):
        _write(tmp_path, _kernels_record(entries + [bad]))
        assert obs_report.main(["--dir", d]) == 1
        assert "obs_report:" in capsys.readouterr().err
    _write(tmp_path, _kernels_record(entries))
    drift = temit.run_record("graph_build")
    drift["schema"] = "repro.bench.v0"
    (tmp_path / "BENCH_graph_build.json").write_text(json.dumps(drift))
    assert obs_report.main(["--dir", d]) == 1
    assert "schema error" in capsys.readouterr().err
    empty = tmp_path / "empty"
    empty.mkdir()
    assert obs_report.main(["--dir", str(empty)]) == 1


# -------------------------------------------------------------- kernel scope

def test_kernel_scope_is_null_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert ttiming.kernel_scope("gather_score") is ttiming._NULL
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ttiming.kernel_scope("gather_score"):
            torch.ones(3).sum()
    names = [ev.name for ev in prof.events()]
    assert names.count("repro_torch.kernels.gather_score") == 1


class _Recorder:
    def __init__(self, calls, *tag):
        self.calls, self.tag = calls, tag
        calls.append(tag)

    def __enter__(self):
        self.calls.append(("enter",) + self.tag)
        return self

    def __exit__(self, *exc):
        self.calls.append(("exit",) + self.tag)
        return False


def test_launch_enters_the_kernel_scope(monkeypatch):
    """``_build.launch`` enters ``kernel_scope(name)`` before the device
    and leaves it after, around the C function."""
    calls = []

    class Stream:
        cuda_stream = 7
    monkeypatch.setattr(_build, "kernel_scope",
                        lambda name: _Recorder(calls, "scope", name))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: _Recorder(calls, "device"))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: Stream())
    dev = torch.device("cuda", 0)
    before = _build.launch_counts["refine_merge"]
    _build.launch("refine_merge", lambda *a: calls.append(("fn",)) or 0, dev)
    assert calls == [("scope", "refine_merge"), ("enter", "scope",
                                                 "refine_merge"),
                     ("device",), ("enter", "device"), ("fn",),
                     ("exit", "device"), ("exit", "scope", "refine_merge")]
    assert _build.launch_counts["refine_merge"] == before + 1


def test_device_span_needs_no_more_than_events(monkeypatch):
    """device_span records two events around the block and files their
    elapsed milliseconds (CUDA events stubbed on the CPU)."""
    log = []

    class Event:
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self):
            log.append("record")
            self.t = len(log)

        def synchronize(self):
            log.append("sync")

        def elapsed_time(self, other):
            return float(other.t - self.t)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    out = {}
    with ttiming.device_span("x", out):
        log.append("work")
    assert log == ["record", "work", "record", "sync"] and out["x"] == 2.0
