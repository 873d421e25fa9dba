"""Large-scale clustering over a process group (paper Table 2, scaled).

Counterpart of ``examples/cluster_large.py``: cluster n=131,072 vectors into
k=8,192 clusters (16 samples a cluster) with the sharded engine, one rank a
card (NCCL) or one rank a process on the CPU (gloo):

    torchrun --nproc-per-node R -m repro_torch.launch.cluster_large \\
        [--device cpu] [--n 131072] [--k 8192] [--emit PATH]

Run without ``torchrun`` it is a group of one.  The flow is the
reference's: every rank makes the same data and builds the same KNN graph
(``build_knn_graph``, with per-round diagnostics and telemetry), the 2M
tree initialises the clusters (rows padded by ``pad_plan``'s wrap rows,
whose assignments are dropped), and ``ShardedEngine.run`` clusters every
row across the group, with per-epoch telemetry, under
``obs.sync_counter``: one host sync an epoch plus the final distortion's
read.  When k does not divide by the group size, every rank runs the
single-device engine instead, as the reference does, and says so.  Rank 0
prints the epochs and a ``repro.bench.v1`` run record (or writes it to
``--emit``).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.core import engine
from repro_torch.core.distributed import ShardedEngine
from repro_torch.core.knn_graph import build_knn_graph
from repro_torch.core.two_means import pad_plan, two_means_tree
from repro_torch.data import gmm_blobs
from repro_torch.launch.mesh import close_group, init_group
from repro_torch.obs import emit, syncs, sync_counter
from repro_torch.obs import telemetry as obs_tel

ENGINE_SLOTS = ["moves", "proposed", "empty_clusters", "distortion",
                "hit_rate"]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--k", type=int, default=8192)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs gloo ranks; default: the card (NCCL)")
    ap.add_argument("--emit", default=None, metavar="PATH",
                    help="write the run record to PATH instead of stdout")
    args = ap.parse_args(argv)
    n2, k2 = pad_plan(args.n, args.k)
    if k2 != args.k:
        raise SystemExit(f"k={args.k} must be a power of two")
    if args.n < args.k:
        raise SystemExit(f"n={args.n} must be at least k={args.k}")
    with tempfile.TemporaryDirectory() as tmp:
        if "RANK" in os.environ:
            dev = init_group(args.device)
        else:
            dev = init_group(args.device, rank=0, world_size=1,
                             store_path=os.path.join(tmp, "store"))
        try:
            return _run(args, dev, n2)
        finally:
            close_group()


def _run(args, dev: torch.device, n2: int) -> int:
    R, rank = dist.get_world_size(), dist.get_rank()

    def say(msg):
        if rank == 0:
            print(msg, flush=True)
    say(f"[data] generating n={args.n} d={args.d} on {R} rank(s), {dev}")
    X = gmm_blobs(args.n, args.d, 1024, generator=torch.Generator(
        dev).manual_seed(args.seed))
    # the sharded engine needs equal cluster blocks (k % R == 0); otherwise
    # the single-device engine runs on every rank: the same loop, not split
    sharded = R > 1 and args.k % R == 0
    if R > 1 and not sharded:
        say(f"[group] k={args.k} not divisible by {R} ranks — running the "
            "single-device engine")

    t0 = time.perf_counter()
    g, gdiag = build_knn_graph(X, 16, xi=64, tau=4, device=dev,
                               generator=torch.Generator().manual_seed(
                                   args.seed), return_diagnostics=True,
                               telemetry=True)
    t_graph = _synced(t0, dev)
    say(f"[graph] built in {t_graph:.1f}s")

    t0 = time.perf_counter()
    Xi = X if n2 == args.n else torch.cat([X, X[:n2 - args.n]])
    a0 = two_means_tree(Xi, args.k, generator=torch.Generator().manual_seed(
        args.seed + 1))[:args.n]
    t_init = _synced(t0, dev)
    say(f"[init] 2M tree ({args.k} clusters) in {t_init:.1f}s")

    st = engine.init_state(X, a0, args.k)
    xsq = (X ** 2).sum()
    d_init = float(engine.stats_distortion(xsq, st.D, st.cnt, args.n))
    say(f"[init] distortion {d_init:.4f}")
    cfg = engine.EngineConfig(batch_size=1024, iters=args.iters,
                              min_move_frac=1e-4, telemetry=True)
    gen = torch.Generator().manual_seed(args.seed + 2)
    t0 = time.perf_counter()
    with sync_counter() as sc:
        if sharded:
            res = ShardedEngine(None, cfg).run(X, g.ids, st.assign, st.D,
                                               st.cnt, generator=gen)
        else:
            res = engine.run(X, st, engine.graph_source(g.ids), cfg,
                             generator=gen)
        d_last = float(syncs.read(res.final))
    dt = _synced(t0, dev)
    if sc.syncs != res.epochs + 1:
        raise SystemExit(f"host syncs {sc.syncs}, want {res.epochs + 1}")
    where = f"{R} ranks" if sharded else "1 device"
    for t in range(res.epochs):
        say(f"[iter {t}] moves={res.moves[t]} dist={res.history[t]:.4f}")
    say(f"[run] {res.epochs} epochs in {dt:.1f}s ({where}, {sc.syncs} host "
        "syncs: one an epoch and the final distortion)")
    cnt_total = int(res.state.cnt.sum())
    if res.state.assign.shape != (args.n,) or cnt_total != args.n:
        raise SystemExit(f"rows assigned {cnt_total}, want {args.n}")
    say(f"[run] all {args.n} rows assigned in-engine")
    if not d_last < d_init:
        raise SystemExit(f"distortion rose: {d_init} -> {d_last}")
    say(f"[done] distortion {d_init:.4f} -> {d_last:.4f} (converging)")

    rec = emit.run_record(
        "cluster_large",
        shapes={"n": args.n, "d": args.d, "k": args.k,
                "devices": R if sharded else 1,
                "init_pad_rows": n2 - args.n},
        config={"iters": args.iters, "batch_size": 1024,
                "min_move_frac": 1e-4, "telemetry": True,
                "backend": dist.get_backend()},
        metrics={
            "graph_build_s": t_graph, "init_s": t_init, "run_s": dt,
            "epochs": res.epochs, "host_syncs_run": sc.syncs,
            "distortion_init": d_init, "distortion_final": d_last,
            "rows_assigned": cnt_total,
            "graph_overflow_per_round": gdiag.overflow.tolist(),
            "graph_guided_moves_per_round": gdiag.guided_moves.tolist(),
        },
        telemetry=obs_tel.to_dict(res.telemetry, rows=res.epochs,
                                  slots=ENGINE_SLOTS))
    if rank == 0:
        if args.emit:
            emit.write_json(args.emit, rec)
            print(f"[emit] run record -> {args.emit}")
        else:
            emit.emit_stdout([rec])
    return 0


def _synced(t0: float, dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


if __name__ == "__main__":
    raise SystemExit(main())
