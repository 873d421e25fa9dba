"""Checked-in autotune table of the CUDA wrappers' split plans.

Counterpart of ``repro.kernels.autotune`` (schema ``repro.autotune.v1``,
the same ``load_table``/``save``/``record``/``best_tile``/``resolve`` and
nearest-batch lookup in log space); entries carry ``backend="cuda"``.

The port's kernels have no row tile to tune: what a wrapper chooses at
launch is its host-side split plan, and the plan decides nothing in the
result, because every merge ranks by (value, position).  Each tunable
wrapper reads one knob of its plan through ``resolve`` at launch (an
explicit argument overrides it):

  ``ivf_scan_grouped``  ``CTAS_PER_SM`` of ``ivf_scan_grouped.split_plan``
  ``probe_centroids``   ``_CTAS_PER_SM`` of ``centroid_assign.split_plan``
                        (resident CTAs an SM in its cost model)

``DEFAULT_TILE`` holds today's constants: without a table entry a wrapper
launches the plan it launched before the table existed.  The other
kernels carry an exempt comment in their modules: ``gather_score``,
``refine_merge`` and ``pairwise_sq`` have no host-side plan (their layouts
are compile-time); ``assign_centroids``' plan is the same for every
candidate at the shapes its traffic gives it; and ``ivf_scan`` and
``ivf_scan_adc`` have one plan for every candidate from 1,000 queries on,
while at the served batch no candidate beat their default.

The table is written on the card by

    PYTHONPATH=src python -m repro_torch.kernels.autotune --sweep \\
        [--out src/repro_torch/kernels/autotune_table.json]

at ``chip_smoke.py``'s shapes (SIFT1M's n = 10^6, d = 128, k = 16,384
coarse cells, block_rows 128).  Candidates that give the same split plan
are timed once, and a shape at which every candidate gives the default's
plan is not swept.  Each candidate's outputs must equal the default's
(``torch.equal``: a difference is a kernel fault, and the sweep raises).
A candidate is recorded only if its gain over the default exceeds the
spread between rounds (CUDA-event times, interleaved rounds); otherwise
the default holds there, and the shape gets an entry only where the
nearest-batch lookup over the other entries would launch another plan.

Table schema (``repro.autotune.v1``)::

    {"schema": "repro.autotune.v1",
     "entries": [{"kernel": "ivf_scan_grouped", "backend": "cuda",
                  "shape": {"q": 64, "U": 1280, "topk": 10},
                  "tile": 8, "us": 104.1, "us_default": 215.3}, ...]}
"""
from __future__ import annotations

import functools
import json
import math
import os
from typing import Any, Dict, List, Optional

SCHEMA = "repro.autotune.v1"
TABLE_FILE = os.path.join(os.path.dirname(__file__), "autotune_table.json")
BACKEND = "cuda"

# today's constants: the knob when the table has no entry for the kernel
DEFAULT_TILE = {"ivf_scan_grouped": 2, "probe_centroids": 2}
KNOBS = {"ivf_scan_grouped": "CTAS_PER_SM", "probe_centroids": "_CTAS_PER_SM"}

# sweep grids per kernel (the default first)
SWEEP_TILES = {
    "ivf_scan_grouped": (2, 1, 4, 8, 16),
    "probe_centroids": (2, 1, 3, 4),
}

# the batch-like dim used for nearest-shape matching, per kernel
_BATCH_DIM = ("B", "n", "q")


@functools.lru_cache(maxsize=1)
def load_table(path: Optional[str] = None) -> tuple:
    """Parsed table entries (cached; ``save`` clears the cache).

    ``path=None`` reads the module-level ``TABLE_FILE`` at call time, so
    tests can repoint the table by patching that attribute.
    """
    if path is None:
        path = TABLE_FILE
    if not os.path.exists(path):
        return ()
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"{path}: expected schema {SCHEMA!r}, "
                         f"got {doc.get('schema')!r}")
    return tuple(doc.get("entries", ()))


def save(entries: List[Dict[str, Any]], path: str = TABLE_FILE) -> None:
    """Write the table (sorted for stable diffs) and drop the lookup cache."""
    def key(e):
        return (e["kernel"], e["backend"], sorted(e["shape"].items()))
    doc = {"schema": SCHEMA, "entries": sorted(entries, key=key)}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    load_table.cache_clear()


def record(entries: List[Dict[str, Any]], kernel: str, backend: str,
           shape: Dict[str, int], tile: int, us: float,
           us_default: float) -> None:
    """Insert/replace one sweep winner in an entry list (same-shape dedupe)."""
    entries[:] = [e for e in entries
                  if not (e["kernel"] == kernel and e["backend"] == backend
                          and e["shape"] == shape)]
    entries.append({"kernel": kernel, "backend": backend, "shape": shape,
                    "tile": int(tile), "us": float(us),
                    "us_default": float(us_default)})


def _batch_of(shape: Dict[str, Any]) -> Optional[int]:
    for k in _BATCH_DIM:
        if k in shape:
            return int(shape[k])
    return None


def _lookup(entries, shape: Dict[str, int]) -> int:
    b = _batch_of(shape)

    def dist(e):
        if e["shape"] == dict(shape):
            return -1.0                        # exact shape match wins
        eb = _batch_of(e["shape"])
        if b is None or eb is None or b <= 0 or eb <= 0:
            return math.inf
        return abs(math.log(b / eb))

    return int(min(entries, key=dist)["tile"])


# best_tile's answers for the table they were read from: a launch looks its
# (kernel, backend, shape) up once, not the table's entries
_MEMO: Dict[str, Any] = {"table": None, "tiles": {}}


def best_tile(kernel: str, backend: str, shape: Dict[str, int]) -> int:
    """Tuned knob for the nearest recorded shape, else the default."""
    table = load_table()
    if _MEMO["table"] is not table:
        _MEMO["table"], _MEMO["tiles"] = table, {}
    key = (kernel, backend, tuple(sorted(shape.items())))
    tile = _MEMO["tiles"].get(key)
    if tile is None:
        entries = [e for e in table
                   if e["kernel"] == kernel and e["backend"] == backend]
        tile = (_lookup(entries, shape) if entries
                else DEFAULT_TILE.get(kernel, 0))
        _MEMO["tiles"][key] = tile
    return tile


def resolve(kernel: str, backend: str, shape: Dict[str, int],
            tile: Optional[int]) -> int:
    """Launch-time knob: the explicit override if given, else the table."""
    if tile is not None:
        return int(tile)
    return best_tile(kernel, backend, shape)


# ---------------------------------------------------------------------------
# the sweep (on the card)
# ---------------------------------------------------------------------------

def sweep_cases(device, *, n: int = 1_000_000, d: int = 128,
                k: int = 16_384, nq: int = 10_000, batch: int = 64,
                source_batch: int = 1024, seed: int = 0):
    """``[(kernel, shape, plan(knob), call(knob) -> outputs)]`` at
    ``chip_smoke.py``'s shapes: ``sift_like`` data, k rows of it as the
    coarse cells, the f32 IVF index over their assignment (block_rows
    128), nq queries near the rows; the probe at nq, at one served batch
    and at the engine's probe-source batch (``source_batch`` rows), the
    grouped scan at one served batch (nprobe 16, groups of 8)."""
    import torch

    from repro_torch.data import sift_like
    from repro_torch.index import build_ivf
    from repro_torch.index.probe import build_group_map, build_tile_map
    from repro_torch.kernels import _build
    from repro_torch.kernels import assign_centroids as _ac
    from repro_torch.kernels import centroid_assign as _ca
    from repro_torch.kernels import ivf_scan_grouped as _grp

    sms = _build.sm_count(torch.device(device).index)
    g = torch.Generator(device=device).manual_seed(seed)
    X = sift_like(n, d, 256, generator=g)
    C = X[::n // k][:k].contiguous()
    a, _ = _ac.assign_centroids(X, C)

    class Clustering:
        assign, centroids = a, C
    Clustering.k = k
    index = build_ivf(X, Clustering, block_rows=128, device=device)
    Q = (X[:nq] + 0.05 * torch.randn((nq, d), device=device, generator=g)
         ).contiguous()
    Qb = Q[:batch].contiguous()
    Qs = Q[:source_batch].contiguous()
    cids, _ = _ca.probe_centroids(Qb, C, 16)
    tm = build_tile_map(cids, index.starts, index.caps,
                        max_tiles=index.max_list_tiles, block_rows=128,
                        null_tile=index.null_tile)
    order, union, qmask = build_group_map(tm, group=8,
                                          null_tile=index.null_tile)
    Qg = Qb[order.clamp(max=batch - 1).long()].contiguous()
    U = union.shape[1]

    def probe(rows):
        return (("probe_centroids", {"n": rows.shape[0], "k": k, "p": 16},
                 lambda c: _ca.split_plan(rows.shape[0], k, 16, sms, c),
                 lambda c: _ca.probe_centroids(rows, C, 16, ctas_per_sm=c)))
    return [
        probe(Q), probe(Qb), probe(Qs),
        ("ivf_scan_grouped", {"q": Qg.shape[0], "U": U, "topk": 10},
         lambda c: _grp.split_plan(union.shape[0], U, 10, sms, c),
         lambda c: _grp.ivf_scan_grouped(Qg, index.vecs, index.ids, union,
                                         qmask, block_rows=128, topk=10,
                                         raw=True, ctas_per_sm=c)),
    ]


def _equal(a, b) -> bool:
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def time_us(call, knob, reps: int = 30) -> float:
    """Mean device us per call of ``call(knob)`` over ``reps`` calls
    (CUDA events, after two warm-up calls)."""
    import torch

    from repro_torch.obs.timing import device_span
    for _ in range(2):
        call(knob)
    torch.cuda.synchronize()
    ms: Dict[str, float] = {}
    with device_span("calls", ms):
        for _ in range(reps):
            call(knob)
    return 1e3 * ms["calls"] / reps


def distinct_plans(kernel: str, plan) -> List[int]:
    """The sweep grid's candidates, one for each distinct split plan (the
    first in grid order, so the default comes first)."""
    first: Dict[Any, int] = {}
    for c in SWEEP_TILES[kernel]:
        first.setdefault(plan(c), c)
    return list(first.values())


def sweep(device="cuda", *, rounds: int = 5, reps: int = 30,
          cases=None, log=print) -> List[Dict[str, Any]]:
    """Sweep every case's grid -> table entries; one summary per case
    (``log``).  A shape at which every candidate gives the default's plan is
    skipped.  A candidate whose outputs differ from the default's raises
    (the plan must not change the result).  At each shape the fastest
    candidate (best round) is chosen only if its gain over the default
    exceeds the spread between rounds, the larger of the two's max − min,
    and the default otherwise.  A chosen candidate is recorded; so is a
    chosen default where the nearest-batch lookup over the other entries
    would launch another plan."""
    cases = sweep_cases(device) if cases is None else cases
    entries: List[Dict[str, Any]] = []
    held = []          # (kernel, shape, plan, default's best us) kept
    for kernel, shape, plan, call in cases:
        default = DEFAULT_TILE[kernel]
        grid = distinct_plans(kernel, plan)
        summary = {"autotune": kernel, "knob": KNOBS[kernel],
                   "shape": shape, "candidates": grid}
        if len(grid) == 1:
            log(json.dumps({**summary, "skipped": "one plan"}))
            continue
        want = call(default)
        differs = [c for c in grid[1:] if not _equal(call(c), want)]
        if differs:
            raise AssertionError(f"{kernel} at {shape}: knobs {differs} "
                                 f"change the outputs of knob {default}")
        times: Dict[int, List[float]] = {c: [] for c in grid}
        for _ in range(rounds):
            for c in grid:
                times[c].append(time_us(call, c, reps))
        best = {c: min(t) for c, t in times.items()}
        spread = {c: max(t) - min(t) for c, t in times.items()}
        win = min(grid, key=lambda c: (best[c], c != default))
        gain = best[default] - best[win]
        noise = max(spread[default], spread[win])
        kept = win != default and gain > noise
        if kept:
            record(entries, kernel, BACKEND, shape, win, best[win],
                   best[default])
        else:
            held.append((kernel, shape, plan, best[default]))
        log(json.dumps({**summary, "winner": win, "kept": kept,
                        "gain_us": gain, "spread_us": noise,
                        "us_rounds": times}))
    pinned = True
    while pinned:
        pinned = False
        for kernel, shape, plan, us in held:
            mine = [e for e in entries if e["kernel"] == kernel]
            if any(e["shape"] == shape for e in mine) or not mine:
                continue
            if plan(_lookup(mine, shape)) != plan(DEFAULT_TILE[kernel]):
                record(entries, kernel, BACKEND, shape, DEFAULT_TILE[kernel],
                       us, us)
                log(json.dumps({"autotune": kernel, "shape": shape,
                                "pinned": DEFAULT_TILE[kernel]}))
                pinned = True
    return entries


def main(argv=None) -> int:
    import argparse
    import subprocess

    ap = argparse.ArgumentParser(description="the CUDA wrappers' split-plan "
                                 "autotune sweep")
    ap.add_argument("--sweep", action="store_true", required=True)
    ap.add_argument("--out", default=TABLE_FILE)
    args = ap.parse_args(argv)
    import torch

    from repro_torch import resolve_device
    from repro_torch.kernels import _build
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    _build.build()
    entries = sweep(dev, log=lambda s: print(s, flush=True))
    save(entries, args.out)
    print(f"autotune: wrote {len(entries)} entries to {args.out} ({smi})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
