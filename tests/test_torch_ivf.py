"""The port's IVF index, its plain kernels and its launcher vs the JAX
package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages; the JAX
side runs its plain versions (``force="ref"``) and, in a few small cases,
its Pallas bodies in interpret mode.  Tolerances: distances rtol 1e-5 plus
1e-6 of the largest squared norm (the terms that cancel in ``||v||² − 2q·v``
and ``||c||² − 2x·c``); ids exactly, except at a slot where the two
selected distances agree within that tolerance (a near-tie whose order
float rounding decides); packed layouts (starts, caps, ids, vecs) exactly.
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import index as jivf
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import index as tivf
from repro_torch import interop
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


def _case(n=512, d=16, k=8, seed=0):
    """(X, centroids, nearest-centroid assign) from numpy."""
    X = _blobs(n, d, k, seed)
    C = _blobs(k, d, k, seed + 1)
    a = np.argmin(((X[:, None] - C[None]) ** 2).sum(-1), 1).astype(np.int32)
    return X, C, a


def _both(X, C, a, k, block_rows):
    """The same index built by both packages."""
    j = jivf.build_ivf(X, FakeResult(a, C, k), block_rows=block_rows)
    t = tivf.build_ivf(X, FakeResult(a, C, k), block_rows=block_rows,
                       device="cpu")
    return j, t


def _to_port(j):
    return interop.ivf_index(
        *(np.asarray(getattr(j, f)) for f in
          ("centroids", "vecs", "ids", "starts", "caps")),
        j.block_rows, j.repack_threshold, device="cpu")


def _assert_same_layout(t, j):
    assert t.block_rows == j.block_rows
    assert t.max_list_tiles == j.max_list_tiles
    for name in ("starts", "caps", "ids", "vecs", "centroids"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)


def _owned(a) -> torch.Tensor:
    """A writable torch copy of a (read-only) JAX array."""
    return torch.from_numpy(np.array(a))


def _tol(*mats):
    return 1e-6 * max(float((np.asarray(m, np.float64) ** 2).sum(-1).max())
                      for m in mats)


def _assert_topk(got, want, tol):
    """Distances within rtol 1e-5 + tol; ids equal but at near-ties; the
    -1 / +inf tail equal."""
    gi, gd = (np.asarray(a) for a in got)
    wi, wd = (np.asarray(a) for a in want)
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    np.testing.assert_array_equal(gi[~fin], wi[~fin])
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-5, atol=tol)
    gap = np.abs(np.where(fin, gd, 0.0) - np.where(fin, wd, 0.0))
    near = fin & (gap <= 1e-5 * np.abs(np.where(fin, wd, 0.0)) + tol)
    assert ((gi == wi) | near).all()


# ------------------------------------------------------- plain kernels vs JAX

@pytest.mark.parametrize("n,k,d,p", [(100, 37, 16, 5), (256, 48, 24, 8),
                                     (64, 5, 8, 5)])
def test_centroid_kernels_ref_match_jax(n, k, d, p):
    X = _blobs(n, d, 8, n + k)
    C = _blobs(k, d, 8, n + k + 1)
    tol = _tol(X, C)
    _assert_topk(tref.probe_centroids(torch.from_numpy(X),
                                      torch.from_numpy(C), p),
                 jref.probe_centroids(jnp.asarray(X), jnp.asarray(C), p), tol)
    ga, gd = tref.assign_centroids(torch.from_numpy(X), torch.from_numpy(C))
    wa, wd = jref.assign_centroids(jnp.asarray(X), jnp.asarray(C))
    _assert_topk((ga[:, None], gd[:, None]),
                 (np.asarray(wa)[:, None], np.asarray(wd)[:, None]), tol)


def test_centroid_kernels_match_pallas_interpret():
    X = _blobs(100, 16, 8, 3)
    C = _blobs(37, 16, 8, 4)
    tol = _tol(X, C)
    want = jops.probe_centroids(jnp.asarray(X), jnp.asarray(C), 5,
                                force="interpret", bn=64, bk=16)
    _assert_topk(tops.probe_centroids(torch.from_numpy(X),
                                      torch.from_numpy(C), 5), want, tol)
    wa, wd = jops.assign_centroids(jnp.asarray(X), jnp.asarray(C),
                                   force="interpret", bn=64, bk=16)
    ga, gd = tops.assign_centroids(torch.from_numpy(X), torch.from_numpy(C))
    _assert_topk((ga[:, None], gd[:, None]),
                 (np.asarray(wa)[:, None], np.asarray(wd)[:, None]), tol)


def test_stable_topk_ties_and_exhaustion_match_jax():
    """Integer distances tie everywhere: the first-minimum rule decides,
    exactly; +inf slots come out -1 when k exceeds the finite entries."""
    rng = np.random.default_rng(5)
    d = rng.integers(0, 4, size=(16, 12)).astype(np.float32)
    d[:, 8:] = np.inf
    ids = rng.integers(0, 50, size=(16, 12)).astype(np.int32)
    ids[:, 8:] = -1
    for k in (3, 8, 12):
        wd, wi = jref.stable_topk(jnp.asarray(d), jnp.asarray(ids), k)
        gd, gi = tref.stable_topk(torch.from_numpy(d), torch.from_numpy(ids),
                                  k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def _scan_inputs(nq, nprobe, seed=0, n=512, d=16, k=8, block_rows=16):
    X, C, a = _case(n, d, k, seed)
    j = jivf.build_ivf(X, FakeResult(a, C, k), block_rows=block_rows)
    rng = np.random.default_rng(seed + 7)
    Q = (X[:nq] + 0.1 * rng.standard_normal((nq, d))).astype(np.float32)
    cids, _ = jref.probe_centroids(jnp.asarray(Q), j.centroids, nprobe)
    tm = jivf.build_tile_map(cids, j.starts, j.caps,
                             max_tiles=j.max_list_tiles,
                             block_rows=j.block_rows, null_tile=j.null_tile)
    return Q, j, np.asarray(tm)


@pytest.mark.parametrize("nprobe,topk,raw", [(4, 10, False), (1, 100, False),
                                             (3, 7, True)])
def test_ivf_scan_ref_matches_jax(nprobe, topk, raw):
    """Holes, null-tile padding (T = nprobe · max_list_tiles), topk above
    the live candidates (nprobe=1, topk=100) and raw partials."""
    Q, j, tm = _scan_inputs(24, nprobe)
    want = jref.ivf_scan(jnp.asarray(Q), j.vecs, j.ids, jnp.asarray(tm),
                         block_rows=j.block_rows, topk=topk, raw=raw)
    got = tref.ivf_scan(torch.from_numpy(Q), _owned(j.vecs), _owned(j.ids),
                        _owned(tm), block_rows=j.block_rows, topk=topk,
                        raw=raw)
    _assert_topk(got, want, _tol(Q, np.asarray(j.vecs)))
    if topk == 100:
        assert (np.asarray(got[0]) == -1).any()


def test_ivf_scan_matches_pallas_interpret():
    Q, j, tm = _scan_inputs(6, 2)
    want = jops.ivf_scan(jnp.asarray(Q), j.vecs, j.ids, jnp.asarray(tm),
                         block_rows=j.block_rows, topk=10, force="interpret")
    got = tops.ivf_scan(torch.from_numpy(Q), _owned(j.vecs), _owned(j.ids),
                        _owned(tm), block_rows=j.block_rows, topk=10)
    _assert_topk(got, want, _tol(Q, np.asarray(j.vecs)))


# --------------------------------------------------------- layout and updates

@pytest.mark.parametrize("n,k,block_rows", [(512, 8, 32), (300, 13, 16)])
def test_build_ivf_layout_matches_jax(n, k, block_rows):
    X, C, a = _case(n, 16, k, n)
    a[a == 0] = 1                          # an empty list
    j, t = _both(X, C, a, k, block_rows)
    _assert_same_layout(t, j)
    np.testing.assert_array_equal(t.list_sizes().numpy(), j.list_sizes())
    assert t.size == j.size and t.null_tile == j.null_tile


@pytest.mark.parametrize("m", [5, 300])
def test_add_matches_jax(m):
    """m=5 fills holes in place; m=300 overflows lists and repacks."""
    X, C, a = _case(512, 16, 8, 1)
    j, t = _both(X, C, a, 8, 32)
    Xn = _blobs(m, 16, 8, 77)
    j2 = jivf.add(j, Xn)
    t2 = tivf.add(t, torch.from_numpy(Xn))
    _assert_same_layout(t2, j2)
    assert (t2.n_rows > t.n_rows) == (m == 300)
    _assert_same_layout(t, j)              # the argument is left as it was


def test_remove_and_repack_match_jax():
    X, C, a = _case(512, 16, 8, 2)
    j, t = _both(X, C, a, 8, 32)
    for rm in (np.arange(0, 100), np.arange(0, 400)):   # tombstones; repack
        _assert_same_layout(tivf.remove(t, torch.from_numpy(rm)),
                            jivf.remove(j, rm))
    jr = jivf.remove(j, np.arange(0, 100))
    _assert_same_layout(tivf.repack(_to_port(jr)), jivf.repack(jr))


def test_build_tile_map_matches_jax():
    X, C, a = _case(300, 8, 13, 4)
    a[a == 3] = 4                          # an empty list: all null slots
    j, t = _both(X, C, a, 13, 16)
    cids = np.random.default_rng(0).integers(0, 13, size=(9, 4))
    want = jivf.build_tile_map(jnp.asarray(cids, jnp.int32), j.starts,
                               j.caps, max_tiles=j.max_list_tiles,
                               block_rows=16, null_tile=j.null_tile)
    got = tivf.build_tile_map(torch.from_numpy(cids).int(), t.starts, t.caps,
                              max_tiles=t.max_list_tiles, block_rows=16,
                              null_tile=t.null_tile)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ search end to end

@pytest.mark.parametrize("nprobe", [1, 4, 99])
def test_search_on_jax_index_matches_jax(nprobe):
    """A JAX-built index carried over by interop.ivf_index searches to the
    same ids; nprobe above k clamps to exhaustive."""
    X, C, a = _case(512, 16, 8, 5)
    j = jivf.build_ivf(X, FakeResult(a, C, 8), block_rows=16)
    t = _to_port(j)
    _assert_same_layout(t, j)
    rng = np.random.default_rng(6)
    Q = (X[:32] + 0.1 * rng.standard_normal((32, 16))).astype(np.float32)
    want = jivf.search(j, jnp.asarray(Q), topk=10, nprobe=nprobe,
                       force="ref")
    got = tivf.search(t, torch.from_numpy(Q), topk=10, nprobe=nprobe)
    _assert_topk(got, want, _tol(Q, X))
    assert tivf.scan_fraction(t, Q, nprobe=nprobe) == pytest.approx(
        jivf.scan_fraction(j, jnp.asarray(Q), nprobe=nprobe, force="ref"),
        rel=1e-6)


def test_exhaustive_search_matches_brute_force():
    X, C, a = _case(512, 16, 8, 8)
    _, t = _both(X, C, a, 8, 16)
    Q = X[:16] + 0.1 * np.random.default_rng(9).standard_normal(
        (16, 16)).astype(np.float32)
    ids, d2 = tivf.exhaustive_search(t, torch.from_numpy(Q), topk=10)
    dd = ((Q[:, None].astype(np.float64) - X[None]) ** 2).sum(-1)
    gt = np.argsort(dd, axis=1, kind="stable")[:, :10]
    want_d = np.take_along_axis(dd, gt, 1)
    _assert_topk((ids, d2), (gt, want_d), _tol(Q, X))


def test_search_all_lists_empty():
    X, C, _ = _case(16, 8, 4, 3)
    t = tivf.build_ivf(X[:0], FakeResult(np.zeros(0, np.int32), C, 4),
                       block_rows=8, device="cpu")
    for fn in (lambda Q: tivf.search(t, Q, topk=4, nprobe=2),
               lambda Q: tivf.exhaustive_search(t, Q, topk=4)):
        ids, d2 = fn(torch.from_numpy(X[:3]))
        assert (ids == -1).all() and torch.isinf(d2).all()


# ------------------------------------------------------------- persistence

@pytest.mark.parametrize("fname", ["index.ivf", "index.npz"])
def test_jax_saved_index_loads_in_port(tmp_path, fname):
    X, C, a = _case(256, 16, 8, 10)
    j = jivf.build_ivf(X, FakeResult(a, C, 8), block_rows=16)
    path = os.path.join(tmp_path, fname)
    jivf.save_index(j, path)
    t = tivf.load_index(path, device="cpu")
    _assert_same_layout(t, j)
    Q = X[:8] + 0.05
    want = jivf.search(j, jnp.asarray(Q), topk=5, nprobe=4, force="ref")
    got = tivf.search(t, torch.from_numpy(Q), topk=5, nprobe=4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("fname", ["index.ivf", "index.npz"])
def test_port_saved_index_loads_in_jax(tmp_path, fname):
    X, C, a = _case(256, 16, 8, 11)
    t = tivf.add(tivf.build_ivf(X, FakeResult(a, C, 8), block_rows=16,
                                device="cpu"), _blobs(20, 16, 8, 12))
    path = os.path.join(tmp_path, fname)
    tivf.save_index(t, path)
    _assert_same_layout(t, jivf.load_index(path))
    _assert_same_layout(tivf.load_index(path, device="cpu"),
                        jivf.load_index(path))


def test_codec_index_file_is_refused(tmp_path):
    """A codec file loads (tests/test_torch_ivf_codec.py), also memory-
    mapped onto the host (``mmap=True``); what is refused is a codec kind
    neither package knows."""
    X, C, a = _case(256, 16, 8, 13)
    j = jivf.quantize_index(
        jivf.build_ivf(X, FakeResult(a, C, 8), block_rows=16), "int8")
    for fname in ("q.ivf", "q.npz"):
        path = os.path.join(tmp_path, fname)
        jivf.save_index(j, path)
        assert tivf.load_index(path, device="cpu").codec_kind == "int8"
        mapped = tivf.load_index(path, device="cpu", mmap=True)
        assert mapped.codec_kind == "int8" and mapped.device.type == "cpu"
        np.testing.assert_array_equal(mapped.codes.numpy(),
                                      np.asarray(j.codes))
        del mapped
        if fname.endswith(".npz"):
            with np.load(path) as z:
                arrays = dict(z)
            arrays["meta"] = str(arrays["meta"]).replace('"int8"', '"opq8"')
            np.savez(path, **arrays)
        else:
            raw = open(path, "rb").read()
            open(path, "wb").write(raw.replace(b'"codec": "int8"',
                                               b'"codec": "opq8"', 1))
        with pytest.raises(ValueError, match="unknown codec kind"):
            tivf.load_index(path, device="cpu")


# ----------------------------------------------------------------- launcher

def test_serve_index_runs_on_cpu(tmp_path, capsys):
    path = os.path.join(tmp_path, "ix.ivf")
    args = ["--device", "cpu", "--n", "2048", "--d", "16", "--k", "16",
            "--components", "32", "--nq", "64", "--batch", "32",
            "--rounds", "1", "--tau", "2", "--iters", "3",
            "--probes", "1,4,16"]
    rows = tserve.main(args + ["--save", path])
    recs = [r["recall"] for r in rows]
    assert recs[0] <= recs[1] <= recs[2] and recs[-1] > 0.9
    assert all(r["p50_ms"] > 0 and r["qps"] > 0 for r in rows)
    again = tserve.main(args + ["--load", path])
    assert [r["recall"] for r in again] == recs
    out = capsys.readouterr().out
    assert "recall@10" in out and "[build] saved" in out
