"""Dry run of the paper's own workload on a sharded group: what one rank of
the port holds and sends in one engine epoch.

Counterpart of ``repro.launch.dryrun_cluster``.  The reference lowers and
compiles its sharded epoch for the production TPU meshes and reads HLO;
here ONE rank's ``engine.sharded_epoch`` runs on ``torch.device("meta")``
(shapes and dtypes, no data, no memory) through the plain versions
(``force="ref"``), with a ``core.comm.RecordingComm`` of R ranks in place
of the group.  Each cell records:

* ``collectives``: per kind the calls, operand bytes and wire bytes of the
  epoch, from ``core.comm.collective_counter`` (the reference's ring
  model), and ``by_label`` the same per call site (``exchange``: the
  candidate-row exchange; ``dense_sync`` / ``sparse_sync``: the statistic
  updates);
* ``flops_analytic`` / ``hbm_bytes_analytic``: the reference's formula
  (``repro/launch/dryrun_cluster.py``), copied as it is;
* ``memory``: ``argument_bytes`` (the rank's resident X, G as the engine
  holds it (int64), assignment, D block and cnt), ``temp_bytes`` (the peak
  of the bytes the epoch's ops allocate on the device and still hold,
  counted by ``MemoryTally``, a dispatch mode that adds each new output
  storage's bytes and takes them off when the last tensor on it is freed)
  and ``peak_bytes``, their sum; ``fits_80gb`` is ``peak_bytes <= 80e9``;
* ``roofline``: ``launch.roofline.roofline_terms`` with the collective
  term at ``link_rate(R)`` (R > 8: one NDR port a GPU).

A cell that does not fit is a result (``fits_80gb: false``), not an error.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_cluster \\
      [--workload vlad10m|sift1m|both] [--mode dense|sparse|sparse_bf16|both]
      [--ranks 256|512|both] [--cluster-mode bkm|lloyd|both]
      [--out results/dryrun_cluster.json]

The workloads are the reference's (n padded to a multiple of 512 ranks,
batch 4,096 a rank, κ = 50); R = 256 and 512 are the ranks of its 16×16
and 2×16×16 meshes.  ``run_cell(..., device="cuda")`` runs the same body
for real on random data (``chip_smoke.py`` phase 10 holds the card's peak
memory against the tally).
"""
from __future__ import annotations

import argparse
import json
import os
import traceback
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core import engine
from repro_torch.core.comm import RecordingComm, collective_counter
from repro_torch.launch import roofline as rl

WORKLOADS = {
    # n is padded to a 512-rank multiple; k, kappa follow the paper
    "vlad10m": dict(n=10_485_760, d=512, k=1 << 20, kappa=50, batch=4096),
    "sift1m": dict(n=1_048_576, d=128, k=16_384, kappa=50, batch=4096),
}
RANKS = (256, 512)
MODES = ("dense", "sparse", "sparse_bf16")
CLUSTER_MODES = ("bkm", "lloyd")
DEVICE_BYTES = 80e9          # one H100's 80 GB, counted in decimal bytes
WORDS = (1, 2, 3, 4)         # the epoch's Feistel words (any will do)


class MemoryTally(TorchDispatchMode):
    """Bytes that ops inside the block allocate on ``device``'s type and
    still hold: ``current`` and its ``peak``.  An op whose schema returns a
    fresh tensor adds its storage's bytes; views and in-place results
    add none.  The bytes leave when the last tensor object on the storage
    seen here is freed."""

    def __init__(self, device) -> None:
        super().__init__()
        self.dev_type = torch.device(device).type
        self.live: Dict[int, list] = {}
        self.current = 0
        self.peak = 0

    def _release(self, key: int) -> None:
        e = self.live[key]
        e[1] -= 1
        if e[1] == 0:
            self.current -= e[0]
            del self.live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        aliasing = any(r.alias_info is not None
                       for r in func._schema.returns)
        for t in tree_flatten(out)[0]:
            if (not isinstance(t, torch.Tensor)
                    or t.device.type != self.dev_type):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key not in self.live:
                if aliasing:
                    continue          # a view of a tensor made before
                self.live[key] = [st.nbytes(), 0]
                self.current += st.nbytes()
                self.peak = max(self.peak, self.current)
            self.live[key][1] += 1
            weakref.finalize(t, self._release, key)
        return out


def analytic(w: Dict[str, int], ranks: int, mode: str):
    """The reference's per-rank flops and HBM bytes of one epoch
    (``repro/launch/dryrun_cluster.py``, the same formula)."""
    n, d, k, kappa = w["n"], w["d"], w["k"], w["kappa"]
    n_loc = n // ranks
    fl = 4.0 * n_loc * kappa * d  # dots + norms of gathered candidates
    hb = (n_loc * d * 4                     # local X read
          + k * d * 4                        # D resident read per batch
          * (n_loc / w["batch"]) * (2 if mode == "dense" else 1)
          + n_loc * kappa * d * 4)           # candidate gather traffic
    return fl, hb


def engine_cfg(w: Dict[str, int], mode: str,
               cluster_mode: str) -> engine.EngineConfig:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return engine.EngineConfig(batch_size=w["batch"], mode=cluster_mode,
                               sparse_updates=mode.startswith("sparse"),
                               payload_bf16=mode == "sparse_bf16",
                               force="ref")


def rank_inputs(w: Dict[str, int], ranks: int, device,
                generator: Optional[torch.Generator] = None):
    """Rank 0's resident tensors: X (n_loc, d) f32, the graph source
    (n_loc, κ) int64, the state (assignment (n_loc,) int32, D block
    (k_loc, d) f32, cnt (k,) f32, moves) — empty on ``meta``, random
    values from ``generator`` (on the device) elsewhere."""
    n, d, k, kappa = w["n"], w["d"], w["k"], w["kappa"]
    n_loc, k_loc = n // ranks, k // ranks
    dev = torch.device(device)
    if dev.type == "meta":
        X = torch.empty((n_loc, d), device=dev)
        G = torch.empty((n_loc, kappa), dtype=torch.int64, device=dev)
        a = torch.empty((n_loc,), dtype=torch.int32, device=dev)
        D = torch.empty((k_loc, d), device=dev)
        cnt = torch.empty((k,), device=dev)
    else:
        g = generator
        X = torch.randn((n_loc, d), device=dev, generator=g)
        G = torch.randint(0, n, (n_loc, kappa), device=dev, generator=g)
        a = torch.randint(0, k, (n_loc,), device=dev, generator=g,
                          dtype=torch.int32)
        D = torch.randn((k_loc, d), device=dev, generator=g)
        cnt = torch.full((k,), float(n // k), device=dev)
    src = engine.graph_source(G)
    del G
    st = engine.BKMState(a, D, cnt, torch.zeros((), dtype=torch.int32,
                                                 device=dev))
    return X, src, st


def argument_bytes(X, src, st) -> int:
    return sum(t.numel() * t.element_size()
               for t in (X, src.G, st.assign, st.D, st.cnt))


def run_cell(workload: str, mode: str, ranks: int, cluster_mode: str = "bkm",
             *, device="meta", workloads=None,
             generator: Optional[torch.Generator] = None) -> dict:
    """One rank's epoch at ``workloads[workload]`` with R = ``ranks``
    (see the module doc); ``device="meta"`` traces it."""
    w = (workloads or WORKLOADS)[workload]
    rec = {"workload": workload, "mode": mode, "cluster_mode": cluster_mode,
           "ranks": ranks, "shape": dict(w)}
    try:
        n_loc = w["n"] // ranks
        bs = min(w["batch"], n_loc)
        rec["steps"] = max(n_loc // bs, 1)
        rec["rows_per_step"] = ranks * bs
        cfg = engine_cfg(w, mode, cluster_mode)
        X, src, st = rank_inputs(w, ranks, device, generator)
        args = argument_bytes(X, src, st)
        comm = RecordingComm(0, ranks, device)
        tally = MemoryTally(device)
        with torch.no_grad(), collective_counter() as cc, tally:
            engine.sharded_epoch(X, st, src, WORDS, cfg, comm, 0)
        coll = cc.summary()
        coll["by_label"] = cc.by_label()
        coll["per_step_wire_bytes"] = {
            lab: v["wire_bytes"] / rec["steps"]
            for lab, v in coll["by_label"].items() if lab}
        fl, hb = analytic(w, ranks, mode)
        peak = args + tally.peak
        rec.update(
            status="ok", flops_analytic=fl, hbm_bytes_analytic=hb,
            collectives=coll,
            memory={"argument_bytes": args, "temp_bytes": tally.peak,
                    "peak_bytes": peak},
            fits_80gb=peak <= DEVICE_BYTES,
            roofline=rl.roofline_terms(fl, hb, coll["total_wire_bytes"],
                                       link=rl.link_rate(ranks)),
            link_bytes_per_s=rl.link_rate(ranks))
    except Exception as e:  # noqa: BLE001  (a cell that fails is reported)
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-1500:]
    return rec


def _pick(arg: str, choices, cast=str):
    return list(choices) if arg == "both" else [cast(arg)]


def run_all(workloads=("vlad10m", "sift1m"), modes=MODES,
            cluster_modes=CLUSTER_MODES, ranks=RANKS, out=None,
            quiet=False):
    """Every cell, in order; written to ``out`` (JSON list) as it goes."""
    results = []
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    for wl in workloads:
        for m in modes:
            for cm in cluster_modes:
                for R in ranks:
                    rec = run_cell(wl, m, R, cm)
                    results.append(rec)
                    if not quiet:
                        wire = rec.get("collectives", {}).get(
                            "total_wire_bytes", 0)
                        peak = rec.get("memory", {}).get("peak_bytes", 0)
                        print(f"[cluster-dryrun] {wl}/{m}/{cm}/R={R}: "
                              f"{rec['status']} wire={wire / 1e9:.2f} GB "
                              f"peak={peak / 1e9:.2f} GB "
                              f"fits={rec.get('fits_80gb')} bottleneck="
                              f"{rec.get('roofline', {}).get('bottleneck')}",
                              flush=True)
                    if out:
                        with open(out, "w") as f:
                            json.dump(results, f, indent=1)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="both",
                    choices=list(WORKLOADS) + ["both"])
    ap.add_argument("--mode", default="both", choices=list(MODES) + ["both"])
    ap.add_argument("--ranks", default="both",
                    choices=[str(r) for r in RANKS] + ["both"])
    ap.add_argument("--cluster-mode", default="both",
                    choices=list(CLUSTER_MODES) + ["both"])
    ap.add_argument("--out", default="results/dryrun_cluster.json")
    args = ap.parse_args(argv)
    results = run_all(_pick(args.workload, WORKLOADS),
                      _pick(args.mode, MODES),
                      _pick(args.cluster_mode, CLUSTER_MODES),
                      _pick(args.ranks, RANKS, int), args.out)
    return 1 if any(r["status"] != "ok" for r in results) else 0


if __name__ == "__main__":
    raise SystemExit(main())
