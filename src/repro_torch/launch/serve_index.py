"""IVF index query-serving launcher: recall, scan share, latency, QPS.

Counterpart of ``repro.launch.serve_index``.  Builds an index over
synthetic data (``gk_means`` -> ``build_ivf``) or loads a saved one, then
sweeps ``nprobe`` to map the recall-vs-throughput frontier, with the same
flags and the same table.  Runs on the card unless ``--device cpu``; each
batch is timed to ``torch.cuda.synchronize()``.  The ground truth is a
chunked brute-force product, never the whole (nq, n) distance matrix.

``--qgroup G`` serves through the query-grouped scan.  ``--codec int8|pq``
trains the codec on the index's rows at build time (``--nsub`` PQ
subspaces), saves it with ``--save`` (a ``--load`` run serves it without
retraining), and serves through the compressed-list scan with an exact
rerank of the top ``--rerank`` candidates (default 4·topk; 0 disables).
``--codec`` is per-query only and refuses ``--qgroup``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_index --n 32768 --d 64
  PYTHONPATH=src python -m repro_torch.launch.serve_index --save /tmp/ix.ivf
  PYTHONPATH=src python -m repro_torch.launch.serve_index --load /tmp/ix.ivf
  PYTHONPATH=src python -m repro_torch.launch.serve_index --qgroup 8
  PYTHONPATH=src python -m repro_torch.launch.serve_index --codec pq --nsub 8
  PYTHONPATH=src python -m repro_torch.launch.serve_index --device cpu \\
      --n 4096 --d 24 --k 32 --nq 96 --batch 32 --tau 2 --iters 4
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import index as ivf
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.gkmeans import gk_means
from repro_torch.data import gmm_blobs
from repro_torch.obs.syncs import sync_counter


def _data(n: int, d: int, components: int, seed: int,
          dev: torch.device) -> torch.Tensor:
    return gmm_blobs(n, d, components,
                     generator=torch.Generator(dev).manual_seed(seed))


def build(args, device: DeviceLike = None):
    """(index, X): a loaded index and its regenerated data, or a fresh
    ``gk_means`` clustering of synthetic data packed by ``build_ivf``."""
    dev = resolve_device(device)
    if args.load:
        index = ivf.load_index(args.load, device=dev)
        # regenerate the data the index was built over: shapes come from
        # the index itself; --components/--seed must match the build run
        size = index.size
        if (args.n, args.d) != (size, index.dim):
            print(f"[load] overriding --n/--d with the index's "
                  f"n={size} d={index.dim}")
        if args.codec != "f32" and index.codec_kind != args.codec:
            raise SystemExit(f"--codec {args.codec} but the saved index "
                             f"carries {index.codec_kind!r}")
        return index, _data(size, index.dim, args.components, args.seed, dev)
    X = _data(args.n, args.d, args.components, args.seed, dev)
    t0 = time.perf_counter()
    res = gk_means(X, args.k, kappa=args.kappa, xi=64, tau=args.tau,
                   iters=args.iters, device=dev,
                   generator=torch.Generator().manual_seed(args.seed + 1))
    t_cluster = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = ivf.build_ivf(X, res, block_rows=args.block_rows, device=dev)
    _sync(dev)
    print(f"[build] gk_means k={res.k} in {t_cluster:.1f}s, "
          f"pack {index.n_rows} rows in {time.perf_counter() - t0:.2f}s")
    if args.codec != "f32":
        t0 = time.perf_counter()
        index = ivf.quantize_index(
            index, args.codec, nsub=args.nsub,
            generator=torch.Generator().manual_seed(args.seed + 2))
        _sync(dev)
        print(f"[build] {args.codec} codec in {time.perf_counter() - t0:.2f}s"
              f" ({ivf.bytes_per_row(index.codec, index.dim)} B/row vs "
              f"{4 * index.dim} f32)")
    if args.save:
        ivf.save_index(index, args.save)
        print(f"[build] saved -> {args.save} "
              f"({ivf.index_nbytes(args.save) / 1e6:.1f} MB)")
    return index, X


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_queries(X: torch.Tensor, nq: int, seed: int) -> torch.Tensor:
    """``X[:nq] + 0.05 * noise``, the noise drawn on X's device."""
    g = torch.Generator(X.device).manual_seed(seed)
    noise = torch.randn((nq, X.shape[1]), generator=g, device=X.device)
    return (X[:nq] + 0.05 * noise).contiguous()


def ground_truth(Q: torch.Tensor, X: torch.Tensor, topk: int, *,
                 chunk: int = 1024) -> torch.Tensor:
    """(nq, topk) int64 exact nearest rows of X by squared L2, one chunk of
    queries at a time (``||x||² − 2q·x`` ranks as the distance does)."""
    xsq = (X * X).sum(-1)
    out = []
    for a in range(0, Q.shape[0], chunk):
        part = xsq[None, :] - 2.0 * (Q[a:a + chunk] @ X.T)
        out.append(torch.topk(part, topk, dim=1, largest=False).indices)
    return torch.cat(out)


def recall(ids: torch.Tensor, gt: torch.Tensor) -> float:
    """Share of the true top-k ids found among the returned ids."""
    hits = (ids.long()[:, :, None] == gt[:, None, :]).any(-1)
    return float(hits.float().mean())


def sweep(index: ivf.IvfIndex, Q: torch.Tensor, gt: torch.Tensor, *,
          topk: int, probes, batch: int, rounds: int,
          qgroup: Optional[int] = None, codec: str = "f32",
          rerank: Optional[int] = None) -> List[dict]:
    """Serve Q in batches at each nprobe; print and return one row each:
    recall@topk (all of Q at once), scan share, p50/p90/p99 ms per batch,
    QPS, the host syncs counted inside the timed ``search`` calls (each runs
    under ``obs.syncs.sync_counter``, where a stray sync raises; 0 expected)
    and the bytes a scan streams per candidate row.  ``qgroup``, ``codec`` and ``rerank`` go to
    ``search``."""
    dev = index.device
    nq = Q.shape[0]
    batch = min(batch, nq)
    kw = dict(topk=topk, qgroup=qgroup, codec=codec, rerank=rerank)
    bpr = ivf.bytes_per_row(index.codec if codec != "f32" else "f32",
                            index.dim)
    print(f"{'nprobe':>6} {'recall@%d' % topk:>10} {'scan%':>7} "
          f"{'p50_ms':>8} {'p90_ms':>8} {'p99_ms':>8} {'QPS':>10}")
    rows = []
    for p in probes:
        ids, _ = ivf.search(index, Q, nprobe=p, **kw)          # for recall
        ivf.search(index, Q[:batch], nprobe=p, **kw)            # warm batch
        _sync(dev)
        lat, syncs = [], 0
        for _ in range(rounds):
            for b0 in range(0, nq - batch + 1, batch):
                qb = Q[b0:b0 + batch]
                t0 = time.perf_counter()
                with sync_counter() as sc:
                    ivf.search(index, qb, nprobe=p, **kw)
                syncs += sc.syncs
                _sync(dev)
                lat.append(time.perf_counter() - t0)
        lat = np.sort(np.array(lat)) * 1e3                      # ms/batch
        rec = recall(ids, gt)
        frac = ivf.scan_fraction(index, Q, nprobe=p)
        qps = batch / (lat.mean() / 1e3)
        pct = [float(lat[int(q * (len(lat) - 1))]) for q in (0.5, 0.9, 0.99)]
        print(f"{p:>6} {rec:>10.3f} {100 * frac:>6.1f}% "
              f"{pct[0]:>8.2f} {pct[1]:>8.2f} {pct[2]:>8.2f} {qps:>10.0f}")
        rows.append({"nprobe": p, "recall": rec, "scan_frac": frac,
                     "p50_ms": pct[0], "p90_ms": pct[1], "p99_ms": pct[2],
                     "qps": qps, "batches": len(lat), "host_syncs": syncs,
                     "bytes_per_row": bpr})
    return rows


def serve_sweep(index: ivf.IvfIndex, X: torch.Tensor, *, nq: int, topk: int,
                probes, batch: int, rounds: int, seed: int,
                **search_kw) -> List[dict]:
    """Queries ``X[:nq]`` plus noise, served at each nprobe (see ``sweep``,
    which takes ``search_kw``); recall is against brute force over X, whose
    row i holds id i."""
    batch = min(batch, nq)
    nq -= nq % batch              # whole batches only, as the reference
    Q = make_queries(X, nq, seed)
    gt = ground_truth(Q, X, topk)
    return sweep(index, Q, gt, topk=topk, probes=probes, batch=batch,
                 rounds=rounds, **search_kw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--components", type=int, default=512)
    ap.add_argument("--kappa", type=int, default=16)
    ap.add_argument("--tau", type=int, default=3)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--block-rows", type=int, default=128)
    ap.add_argument("--nq", type=int, default=256)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--probes", default="1,2,4,8,16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default=None, help="write index after build")
    ap.add_argument("--load", default=None, help="serve a saved index")
    ap.add_argument("--qgroup", type=int, default=None,
                    help="query-grouped scan layout: queries per group")
    ap.add_argument("--codec", default="f32", choices=["f32", "int8", "pq"],
                    help="compressed-list ADC scan path (exact-rerank tail)")
    ap.add_argument("--rerank", type=int, default=None,
                    help="codec rerank depth (default 4*topk; 0 disables)")
    ap.add_argument("--nsub", type=int, default=8,
                    help="pq subspaces (code bytes per vector)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    if args.codec != "f32" and args.qgroup:
        raise SystemExit("--codec is per-query only (drop --qgroup)")

    index, X = build(args, args.device)
    probes = [int(p) for p in args.probes.split(",") if int(p) <= index.k]
    return serve_sweep(index, X, nq=args.nq, topk=args.topk, probes=probes,
                       batch=args.batch, rounds=args.rounds,
                       seed=args.seed + 9, qgroup=args.qgroup,
                       codec=args.codec, rerank=args.rerank)


if __name__ == "__main__":
    main()
