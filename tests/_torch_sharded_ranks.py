"""Rank bodies of the process-group tests in ``tests/test_torch_sharded.py``.

Each case runs on R gloo ranks on the CPU, spawned with a ``FileStore`` in
the test's temporary directory; rank 0 saves what the ranks computed and
the test holds it against the port's one-device runs on the same inputs.
This module imports PyTorch and the port only, so a rank starts quickly.
"""
from __future__ import annotations

import os
import time
import traceback
from typing import Dict

import numpy as np
import torch
import torch.multiprocessing as mp

N, D, K, KAPPA = 480, 12, 24, 6     # 480 = 4·120; 481 % 3 != 0 below
WORDS = [[11, 22, 33, 44], [55, 66, 77, 88], [99, 111, 122, 133]]
KINDS = (("graph", True, False, "bkm"), ("graph", True, True, "bkm"),
         ("graph", False, False, "lloyd"), ("dense", True, False, "lloyd"),
         ("dense", False, False, "bkm"), ("probe", True, False, "bkm"))
IVF = dict(n=1200, d=16, k=20, nq=40, topk=5, nprobe=4, block_rows=8)


def engine_inputs(n: int = N, k: int = K, seed: int = 0):
    """(X (n, D), assign (n,), G (n, κ)) made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((16, D)) * 3.0
    X = (means[rng.integers(0, 16, n)]
         + rng.standard_normal((n, D))).astype(np.float32)
    a = (np.arange(n) % k).astype(np.int32)
    rng.shuffle(a)
    G = rng.integers(0, n, (n, KAPPA)).astype(np.int32)
    return torch.from_numpy(X), torch.from_numpy(a), torch.from_numpy(G)


def engine_cfg(sparse, bf16, mode, shards=1):
    from repro_torch.core.engine import EngineConfig
    return EngineConfig(batch_size=24, mode=mode, iters=3,
                        sparse_updates=sparse, payload_bf16=bf16,
                        shards=shards, min_move_frac=-1.0, telemetry=True)


def ivf_indexes():
    """{'f32', 'int8', 'pq'}: one packed index over numpy-made data, its
    lists skewed, and the same index with each codec; and the queries."""
    from repro_torch.index import build_ivf, quantize_index
    c = IVF
    rng = np.random.default_rng(5)
    cent = rng.standard_normal((c["k"], c["d"])).astype(np.float32) * 4
    w = 1.0 / np.arange(1, c["k"] + 1)           # skewed list sizes
    X = (cent[rng.choice(c["k"], c["n"], p=w / w.sum())]
         + rng.standard_normal((c["n"], c["d"]))).astype(np.float32)
    d2 = ((X[:, None, :] - cent[None]) ** 2).sum(-1)

    class Clustering:
        assign = torch.from_numpy(d2.argmin(1).astype(np.int32))
        centroids = torch.from_numpy(cent)
        k = c["k"]
    base = build_ivf(X, Clustering, block_rows=c["block_rows"], device="cpu")
    out = {"f32": base, "int8": quantize_index(base, "int8"),
           "pq": quantize_index(base, "pq", nsub=4,
                                generator=torch.Generator().manual_seed(3),
                                iters=3)}
    Q = torch.from_numpy((X[:c["nq"]] + 0.1 * rng.standard_normal(
        (c["nq"], c["d"]))).astype(np.float32))
    return out, Q


IVF_PATHS = (("f32", None, None), ("f32", 4, None), ("int8", None, 0),
             ("pq", None, 0), ("int8", None, None), ("pq", None, None))


def _fsum_owned(comm) -> torch.Tensor:
    """(R,) bool on every rank: whether each rank's ``fsum_owned`` of its
    (R·k_loc, d) block equals ``fsum(x)[rank·k_loc:(rank+1)·k_loc]`` bit for
    bit (values from numpy, different on every rank)."""
    R, r, k_loc = comm.size, comm.rank, 5
    x = torch.from_numpy(np.random.default_rng(10 + r).standard_normal(
        (R * k_loc, 7)).astype(np.float32) * 10.0 ** r)
    ok = torch.equal(comm.fsum_owned(x, k_loc),
                     comm.fsum(x)[r * k_loc:(r + 1) * k_loc])
    return comm.all_gather(torch.tensor([ok]))


def _dense_sync_bytes(X, G, st):
    """A dense group run under ``collective_counter``: the dense sync's
    summary, the steps it took and the number of all-to-alls."""
    from repro_torch.core.comm import collective_counter
    from repro_torch.core.distributed import ShardedEngine
    eng = ShardedEngine(None, engine_cfg(False, False, "bkm"), kind="graph")
    with collective_counter() as cc:
        res = eng.run(X, G, st.assign, st.D, st.cnt, epoch_words=WORDS)
    steps = res.epochs * (X.shape[0] // eng.shards // 24)
    return cc.summary("dense_sync"), steps, cc.counts().get("all-to-all", 0)


def _case_main(rank: int, world: int) -> Dict:
    from repro_torch.core import graph_build as tgb
    from repro_torch.core.distributed import (ShardedEngine, ShardedIvf,
                                              sharded_graph_builder)
    from repro_torch.core.engine import init_state
    from repro_torch.core.two_means import two_means_dist
    from repro_torch.core.comm import Comm
    out = {}
    X, a, G = engine_inputs()
    st = init_state(X, a, K)
    for kind, sparse, bf16, mode in KINDS:
        eng = ShardedEngine(None, engine_cfg(sparse, bf16, mode), kind=kind,
                            probe_p=3)
        res = eng.run(X, G, st.assign, st.D, st.cnt, epoch_words=WORDS)
        out[("run", kind, sparse, bf16, mode)] = res
    eng = ShardedEngine(None, engine_cfg(True, False, "bkm"))
    out["epoch"] = eng.epoch(X, G, st.assign, st.D, st.cnt, WORDS[0])
    out["distortion"] = eng.distortion(X, st.assign, st.D, st.cnt)
    out["dense_sync"] = _dense_sync_bytes(X, G, st)
    comm = Comm()
    out["fsum_owned"] = _fsum_owned(comm)
    B = X.shape[0] // world
    rows = torch.arange(rank * B, (rank + 1) * B)
    salts = [[7, 8], [9, 10], [11, 12], [13, 14]]
    out["tree"] = comm.all_gather(two_means_dist(
        X[rows], rows, 16, salts=salts, comm=comm))
    for source in ("partition", "descent"):
        cfg = tgb.GraphBuildConfig(kappa=KAPPA, source=source, xi=16, tau=3,
                                   chunk=50, telemetry=True)
        out[("build", source)] = sharded_graph_builder(None, cfg).build(
            X, generator=torch.Generator().manual_seed(4))
    out.update(_ivf(ShardedIvf))
    return out


def _ivf(ShardedIvf) -> Dict:
    c = IVF
    out = {}
    indexes, Q = ivf_indexes()
    for codec, qgroup, rerank in IVF_PATHS:
        sh = ShardedIvf(indexes[codec])
        out[("ivf", codec, qgroup, rerank)] = sh.search(
            Q, topk=c["topk"], nprobe=c["nprobe"], qgroup=qgroup,
            codec=codec, rerank=rerank, telemetry=True)
    return out


def _case_pad(rank: int, world: int) -> Dict:
    from repro_torch.core.comm import Comm
    from repro_torch.core.distributed import ShardedEngine, ShardedIvf
    from repro_torch.core.engine import init_state
    X, a, G = engine_inputs(N + 1)
    st = init_state(X, a, K)
    out = {}
    for kind, sparse, bf16, mode in KINDS[:1] + KINDS[3:4]:
        eng = ShardedEngine(None, engine_cfg(sparse, bf16, mode), kind=kind)
        out[("run", kind)] = eng.run(X, G, st.assign, st.D, st.cnt,
                                     epoch_words=WORDS)
    out["fsum_owned"] = _fsum_owned(Comm())
    out.update(_ivf(ShardedIvf))
    return out


CASES = {"main": _case_main, "pad": _case_pad}


def _rank(rank: int, world: int, case: str, store: str, result: str):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import close_group, init_group
    try:
        init_group("cpu", rank=rank, world_size=world, store_path=store)
        out = CASES[case](rank, world)
        if rank == 0:
            torch.save(out, result)
    except BaseException:
        with open(f"{result}.rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        close_group()


def spawn(case: str, world: int, tmp, timeout: float) -> Dict:
    """Run ``case`` on ``world`` gloo ranks; rank 0's results.  A rank
    that fails, or a run past ``timeout`` seconds, fails the caller (every
    rank is stopped first)."""
    ctx = mp.get_context("spawn")
    store = os.path.join(str(tmp), f"{case}.store")
    result = os.path.join(str(tmp), f"{case}.pt")
    procs = [ctx.Process(target=_rank, args=(r, world, case, store, result))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(5)
    errs = [open(os.path.join(str(tmp), f)).read()
            for f in sorted(os.listdir(str(tmp)))
            if f.startswith(case) and f.endswith(".err")]
    if hung or errs or any(p.exitcode for p in procs):
        raise RuntimeError(f"case {case!r}: {len(hung)} rank(s) past "
                           f"{timeout} s, exit codes "
                           f"{[p.exitcode for p in procs]}\n"
                           + "\n".join(errs))
    return torch.load(result, weights_only=False)
