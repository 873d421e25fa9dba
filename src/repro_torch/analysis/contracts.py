"""Layer 2 — runtime contract audit of the port's device-resident claims.

Counterpart of ``repro.analysis.contracts``.  The reference compiles each
entry point on a 4-device CPU mesh and reads its HLO; torch has no
compiled program to read, so this audit runs each entry point at the
reference's audit shapes (N=384, D=16, K=40, Q=28, 4 ranks) and watches it
run:

  * **host syncs** under ``obs.syncs.sync_counter`` equal the declared
    count: ``epochs + 1`` for a clustering run (one designed read an epoch,
    the caller's read of the final distortion), 0 for a graph build and
    for a search; a host read outside ``obs.syncs.read`` (an op reading one
    value to the host, ``aten._local_scalar_dense``, on a tensor that is
    not a designed read's host copy) is a problem of its own;
  * **collectives** by kind, from ``core.comm.collective_counter``, equal
    the entry point's declared budget (``_engine_dense_budget`` and the
    others below, each derived from the port's code, its difference from
    the reference's stated beside it);
  * **dtypes**, from a dispatch mode that sees every op: no op makes f64;
    bf16 appears only where the sparse payload is declared
    (``payload_bf16``), and no matmul takes a bf16 operand;
  * **replication report**: op outputs in a rank's run whose leading
    dimension is a global size (n, n_pad, k, k0, q) and whose minor
    dimension is at least D, rendered symbolically (``f32[n,d]``) and held
    EXACTLY against ``baseline.json``: a new one fails, and so does a stale
    entry.

The sharded entry points run in process through a ``RecordingComm`` (rank
0 of 4, each collective recorded, nothing moved), and, with ``--gloo``, on
a spawned gloo group of 4 CPU processes, whose counts must equal the
in-process ones.  The audit runs on the card unless told otherwise
(``device="cpu"``, ``--device cpu``), and raises where there is none;
``run_audit(comm=...)`` runs it over an NCCL group (``chip_smoke.py``
phase 10, a group of one, with CUDA sync-debug mode "error").  The result
is written as a ``repro.analysis.v1`` record through ``obs.emit``.

CLI: ``python -m repro_torch.analysis audit [--device cpu] [--gloo]
[--out PATH]``.
"""
from __future__ import annotations

import linecache
import os
import sys
import tempfile
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch._device import DeviceLike, resolve_device

# problem sizes: distinct so a leading dim identifies its role in the
# replication report (n_loc = 96 at 4 ranks; d+1 = 17 stays distinct)
N, D, K, Q, ITERS, KAPPA, TAU = 384, 16, 40, 28, 3, 8, 2
DEVICES = 4
BATCH = 96

_SHORT = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16",
          torch.float16: "f16", torch.int32: "s32", torch.int64: "s64",
          torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
          torch.bool: "pred"}
_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "dot",
            "mv", "addmv", "vdot", "linear", "_scaled_mm", "einsum",
            "tensordot", "convolution"}


@dataclass
class AuditResult:
    name: str
    problems: List[str] = field(default_factory=list)
    collectives: Dict[str, int] = field(default_factory=dict)
    replication: List[str] = field(default_factory=list)
    syncs: int = 0

    @property
    def ok(self) -> bool:
        return not self.problems


def _marked(filename: str, lineno: int) -> bool:
    """The line, or the comment line above it, carries the lint's
    ``# lint: boundary(...)`` mark."""
    from repro_torch.analysis.astlint import BOUNDARY_MARK
    line = linecache.getline(filename, lineno)
    prev = linecache.getline(filename, lineno - 1).strip()
    return BOUNDARY_MARK in line or (prev.startswith("#")
                                     and BOUNDARY_MARK in prev)


def _port_frames():
    f = sys._getframe(2)
    while f is not None:
        if f"{os.sep}repro_torch{os.sep}" in f.f_code.co_filename:
            yield f
        f = f.f_back


def _issuer():
    """The innermost frame of the port's code outside this package: the
    line that issues the op."""
    for f in _port_frames():
        if f"{os.sep}analysis{os.sep}" not in f.f_code.co_filename:
            return f
    return None


def _at_boundary() -> bool:
    """The port's line that issues the read is one the linter sanctions as
    a boundary crossing (a host value read on purpose).  Only that line
    counts: a marked caller does not cover the reads of what it calls."""
    f = _issuer()
    return f is not None and _marked(f.f_code.co_filename, f.f_lineno)


def _caller() -> str:
    """file:line of the innermost port frame outside this package."""
    f = _issuer()
    if f is None:
        return "?"
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


class OpAudit(TorchDispatchMode):
    """Every op's output dtypes and shapes, the dtypes of every matmul's
    operands, and every host read (``_local_scalar_dense``) on a tensor
    that is not a designed read's host copy (``host`` storages), unless the
    port's line that issues it is one the linter sanctions
    (``# lint: boundary(...)``: a host value read on purpose)."""

    def __init__(self, roles: Dict[int, str], min_minor: int = D):
        super().__init__()
        self.roles = roles
        self.min_minor = min_minor
        self.f64: List[str] = []
        self.bf16: List[str] = []
        self.bf16_matmul: List[str] = []
        self.stray_reads: List[str] = []
        self.replicated = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        if name == "_local_scalar_dense":
            from repro_torch.obs import syncs
            host = syncs.host_storages()
            if (any(t.untyped_storage()._cdata not in host for t in ins)
                    and not _at_boundary()):
                self.stray_reads.append(_caller())
        if name in _MATMULS and any(t.dtype == torch.bfloat16 for t in ins):
            self.bf16_matmul.append(name)
        out = func(*args, **kwargs)
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            if t.dtype == torch.float64:
                self.f64.append(name)
            elif t.dtype == torch.bfloat16:
                self.bf16.append(name)
            if (t.dim() == 2 and t.shape[0] in self.roles
                    and t.shape[1] >= self.min_minor):
                names = {D: "d", D + 1: "d+1", **self.roles}
                sym = ",".join(names.get(int(s), str(int(s)))
                               for s in t.shape)
                self.replicated.add(f"{_SHORT.get(t.dtype, t.dtype)}[{sym}]")
        return out


def audit_call(name: str, fn: Callable[[], object], *, syncs: Callable,
               collectives: Dict[str, int], allow_bf16: bool = False,
               roles: Optional[Dict[int, str]] = None) -> AuditResult:
    """Run ``fn()`` under the sync counter, the collective counter and the
    op audit; ``syncs(result)`` is the declared host-sync count."""
    from repro_torch.core.comm import collective_counter
    from repro_torch.obs import syncs as obs_syncs
    res = AuditResult(name)
    ops = OpAudit(roles or {})
    with obs_syncs.sync_counter() as sc, collective_counter() as cc:
        with torch.no_grad(), ops:
            out = fn()
    res.syncs = sc.syncs
    want_syncs = syncs(out)
    if sc.syncs != want_syncs:
        res.problems.append(f"host syncs {sc.syncs} != declared "
                            f"{want_syncs}")
    if ops.stray_reads:
        res.problems.append(f"{len(ops.stray_reads)} host read(s) outside "
                            "obs.syncs.read and the lint's boundaries (a "
                            f"stray .item() or conversion) at "
                            f"{sorted(set(ops.stray_reads))}")
    if ops.f64:
        res.problems.append(f"f64 made by {sorted(set(ops.f64))} "
                            "(contract: no f64)")
    if ops.bf16 and not allow_bf16:
        res.problems.append(f"bf16 made by {sorted(set(ops.bf16))} outside "
                            "a declared payload path")
    if allow_bf16 and not ops.bf16:
        res.problems.append("declared bf16 payload path made no bf16 at all "
                            "(claim is stale)")
    if ops.bf16_matmul:
        res.problems.append(f"bf16 into {sorted(set(ops.bf16_matmul))} — "
                            "the payload is wire compression only")
    res.collectives = cc.counts()
    if res.collectives != {k: v for k, v in collectives.items() if v}:
        res.problems.append(f"collective counts {res.collectives} != "
                            f"declared budget {collectives}")
    if roles:
        res.replication = sorted(f"{name}: {e}" for e in ops.replicated)
    return res


# --------------------------------------------------------------------------
# the declared budgets, derived from the port's code (R ranks)
# --------------------------------------------------------------------------

def _steps(rows_loc: int, batch: int) -> int:
    return max(rows_loc // min(batch, rows_loc), 1)


def _engine_dense_budget(R: int) -> Dict[str, int]:
    """``ShardedEngine.run``, graph source, dense updates, telemetry off.

    all-gather: 1 (Σ||x||², added in rank order) + per epoch 1 (the
    assignment, the candidate lookup) + per step 1 (the candidate ids of
    the row exchange) + per epoch 1 (the distortion's per-block
    objectives, in rank order) + 1 (the final distortion) + 2 (the full
    assignment and D the entry point returns).
    all-reduce: 1 (the valid row count) + per step 3 (the exchanged rows,
    the leaver counts, the count deltas) + per epoch 1 (the moves).
    all-to-all: per step 1 (the (k, d) deltas, ``fsum_owned``).

    The reference (``_ENGINE_DENSE_BUDGET``) has no all-to-all: its
    deltas travel as one f32[d, k] psum and its count and weight partials
    as two more psums a step; its scalar totals and the distortion are
    psums (2 before the loop, 1 an epoch, 1 after) where the port adds the
    float ones in rank order through all-gathers; and its entry point
    keeps the state sharded, where the port's gathers it back (2).
    """
    nb = _steps(N // R, BATCH)
    return {"all-gather": 1 + ITERS * (2 + nb) + 1 + 2,
            "all-reduce": 1 + ITERS * (3 * nb + 1),
            "all-to-all": ITERS * nb}


def _engine_sparse_budget(R: int) -> Dict[str, int]:
    """``ShardedEngine.run``, graph source, sparse updates, bf16 payload.

    As the dense budget, with each step's update as 3 all-gathers (the
    moves' old and new clusters, the payload rows) and no leaver, count or
    delta collectives: all-reduce 1 + per step 1 (the exchanged rows) + per
    epoch 1.  The reference (``_ENGINE_SPARSE_BUDGET``) gathers the same
    three per step; its other differences are the dense budget's.
    """
    nb = _steps(N // R, BATCH)
    return {"all-gather": 1 + ITERS * (2 + 4 * nb) + 1 + 2,
            "all-reduce": 1 + ITERS * (nb + 1)}


def _ivf_budget(telemetry: bool) -> Dict[str, int]:
    """``ShardedIvf.search``: 2 all-gathers of the ranks' probe lists
    (distances, cells) and 2 of their top-k lists (ids, partials): the
    reference's ``_IVF_BUDGET``.  Telemetry adds its 2 all-reduces (the
    scanned rows' sum and maximum), as the reference's does."""
    return {"all-gather": 4, "all-reduce": 2 if telemetry else 0}


def _graph_build_budget(R: int, k0: int, n_pad: int, bkm_batch: int,
                        refine: int = 4) -> Dict[str, int]:
    """``GraphBuilder.build``, partition source, guided, telemetry off.

    Per round the 2M tree (``two_means_dist``) runs L = log2(k0) levels,
    each: all-gather 1 (the level's segment sums, in rank order) + per
    refine iteration 1 (the left sums); all-reduce 1 (counts) + 4 (two
    seed rows, each 2 segment minimums) + 2 (the two seed vectors) + per
    refine iteration 8 (radix histogram rounds) + 1 (left counts) + 8 (the
    final split's radix rounds).  From round 1 on, the guided engine
    epoch: all-gather 1 (its per-shard (k0, d) sums) + 1 (lookup) + per
    step 4 (row exchange ids, sparse update's three); all-reduce 1 (k0
    counts) + per step 1 (exchanged rows) + 1 (moves).  Each round's
    member table: all-gather 2 (table slices, spill lists), all-reduce 1
    (overflow).  Per build: X gathered once (1) and the graph gathered
    back (ids, distances: 2).

    The reference (``_GRAPH_BUILD_BUDGET``) counts its guided branch once
    (a ``lax.cond``), psums its float sums where the port gathers them in
    rank order, and rotates candidates by collective-permute; the port's
    refinement reads the gathered X.
    """
    L = k0.bit_length() - 1
    nb = _steps(n_pad // R, bkm_batch)
    tree_ag, tree_ar = L * (1 + refine), L * (15 + 9 * refine)
    return {"all-gather": 1 + TAU * (tree_ag + 2) + (TAU - 1) * (2 + 4 * nb)
            + 2,
            "all-reduce": TAU * (tree_ar + 1) + (TAU - 1) * (2 + nb)}


# --------------------------------------------------------------------------
# inputs (numpy, from a seed)
# --------------------------------------------------------------------------

def _data(device):
    rng = np.random.default_rng(0)
    means = rng.standard_normal((8, D)) * 3.0
    X = (means[rng.integers(0, 8, N)]
         + rng.standard_normal((N, D))).astype(np.float32)
    G = rng.integers(0, N, (N, KAPPA)).astype(np.int32)
    a = (np.arange(N) % K).astype(np.int32)
    rng.shuffle(a)
    return tuple(torch.from_numpy(v).to(device) for v in (X, G, a))


def _index(device):
    """The f32 IVF index over the audit data (K cells at the first K rows,
    block_rows 16), its int8 and PQ (nsub 4) codecs, and Q queries."""
    from repro_torch.index import build_ivf, quantize_index
    from repro_torch.kernels import ref
    X, _, _ = _data("cpu")
    C = X[:K].clone()
    a, _ = ref.assign_centroids(X, C)

    class Clustering:
        assign, centroids = a, C
    Clustering.k = K
    base = build_ivf(X, Clustering, block_rows=16, device=device)
    return {"f32": base, "int8": quantize_index(base, "int8"),
            "pq": quantize_index(base, "pq", nsub=4, iters=2,
                                 generator=torch.Generator().manual_seed(2))
            }, X[:Q].to(device)


# --------------------------------------------------------------------------
# the contracts
# --------------------------------------------------------------------------

def _final_read(res) -> None:
    """The caller's read of a run's final distortion (as ``gk_means``
    makes it)."""
    from repro_torch.obs import syncs
    float(syncs.read(res.final))


def contract_engine_run(device: DeviceLike = None, comm=None
                        ) -> List[AuditResult]:
    """``engine.run`` on one device, telemetry off and on: ITERS epochs
    (no early stop) and the final read, ``epochs + 1`` host syncs, no
    collective, no f64 or bf16."""
    from repro_torch.core import engine
    X, G, a = _data(resolve_device(device))
    out = []
    for tel in (False, True):
        cfg = engine.EngineConfig(batch_size=BATCH, iters=ITERS,
                                  min_move_frac=-1.0, telemetry=tel)

        def call(cfg=cfg):
            st = engine.init_state(X, a, K)
            res = engine.run(X, st, engine.graph_source(G), cfg,
                             epoch_words=[[t, 1, 2, 3] for t in range(ITERS)])
            _final_read(res)
            return res
        out.append(audit_call(
            f"engine.run[telemetry={'on' if tel else 'off'}]", call,
            syncs=lambda r: r.host_syncs + 1, collectives={}))
    return out


def contract_engine_sharded(device: DeviceLike = None, comm=None
                            ) -> List[AuditResult]:
    """``ShardedEngine.run``, dense and sparse with the bf16 payload:
    ``epochs + 1`` host syncs with the final read, the declared budgets,
    bf16 only on the sparse payload."""
    from repro_torch.core import engine
    from repro_torch.core.distributed import ShardedEngine
    device = resolve_device(device)
    comm = comm if comm is not None else _recording(device)
    X, G, a = _data(device)
    st = engine.init_state(X, a, K)
    out = []
    for label, sparse, bf16, budget in (
            ("dense", False, False, _engine_dense_budget(comm.size)),
            ("sparse,bf16", True, True, _engine_sparse_budget(comm.size))):
        cfg = engine.EngineConfig(batch_size=BATCH, iters=ITERS,
                                  min_move_frac=-1.0, sparse_updates=sparse,
                                  payload_bf16=bf16)
        eng = ShardedEngine(comm, cfg, kind="graph")

        def call(eng=eng):
            res = eng.run(X, G, st.assign, st.D, st.cnt,
                          epoch_words=[[t, 1, 2, 3] for t in range(ITERS)])
            _final_read(res)
            return res
        out.append(audit_call(
            f"ShardedEngine.run[{label}]", call,
            syncs=lambda r: r.host_syncs + 1, collectives=budget,
            allow_bf16=bf16, roles={N: "n", K: "k"}))
    return out


def contract_graph_build(device: DeviceLike = None, comm=None
                         ) -> List[AuditResult]:
    """``GraphBuilder`` over the group (partition source, guided): 0 host
    syncs and the declared budget."""
    from repro_torch.core.graph_build import (GraphBuildConfig, GraphBuilder,
                                              _plan)
    device = resolve_device(device)
    comm = comm if comm is not None else _recording(device)
    X, _, _ = _data(device)
    cfg = GraphBuildConfig(kappa=KAPPA, tau=TAU, chunk=BATCH)
    k0, n_pad = _plan(N, cfg)
    roles = {N: "n", K: "k", n_pad: "n_pad"}
    roles.setdefault(k0, "k0")
    gb = GraphBuilder(cfg, group=comm)
    return [audit_call(
        "GraphBuilder.build[partition]",
        lambda: gb.build(X, generator=torch.Generator().manual_seed(4)),
        syncs=lambda r: 0,
        collectives=_graph_build_budget(comm.size, k0, n_pad, cfg.bkm_batch),
        roles=roles)]


def contract_ivf_search(device: DeviceLike = None, comm=None
                        ) -> List[AuditResult]:
    """``ShardedIvf.search``: 0 host syncs and one merge point a batch
    (the declared budget) on every path: f32 with telemetry off and on,
    int8 and PQ with the rerank tail."""
    from repro_torch.core.distributed import ShardedIvf
    device = resolve_device(device)
    comm = comm if comm is not None else _recording(device)
    indexes, Qr = _index(device)
    roles = {N: "n", K: "k", Q: "q"}
    out = []
    for label, codec, tel in (("telemetry=off", "f32", False),
                              ("telemetry=on", "f32", True),
                              ("codec=int8", "int8", False),
                              ("codec=pq", "pq", False)):
        sh = ShardedIvf(indexes[codec], comm)
        out.append(audit_call(
            f"ShardedIvf.search[{label}]",
            lambda sh=sh, codec=codec, tel=tel: sh.search(
                Qr, topk=10, nprobe=4, codec=codec, telemetry=tel),
            syncs=lambda r: 0, collectives=_ivf_budget(tel), roles=roles))
    return out


CONTRACTS: Dict[str, Callable[..., List[AuditResult]]] = {
    "engine_run": contract_engine_run,
    "engine_sharded": contract_engine_sharded,
    "graph_build": contract_graph_build,
    "ivf_search": contract_ivf_search,
}
SHARDED = ("engine_sharded", "graph_build", "ivf_search")


def _recording(device):
    from repro_torch.core.comm import RecordingComm
    return RecordingComm(0, DEVICES, device)


def run_audit(names: Optional[List[str]] = None, *,
              device: DeviceLike = None, comm=None) -> List[AuditResult]:
    """The named contracts (all by default) on ``device`` (default
    ``cuda``, which raises where there is none; pass ``device="cpu"`` for
    the CPU); the sharded ones through ``comm``, or a ``RecordingComm`` of
    4 ranks."""
    device = resolve_device(device)
    results: List[AuditResult] = []
    for name, fn in CONTRACTS.items():
        if names and name not in names:
            continue
        try:
            results.extend(fn(device, comm))
        except Exception as e:        # a contract that cannot run fails
            results.append(AuditResult(
                name, problems=[f"contract raised: {type(e).__name__}: {e}",
                                traceback.format_exc()[-800:]]))
    return results


# --------------------------------------------------------------------------
# the gloo group of 4
# --------------------------------------------------------------------------

def _gloo_rank(rank: int, world: int, store: str, result: str) -> None:
    torch.set_num_threads(1)
    from repro_torch.core.comm import Comm
    from repro_torch.launch.mesh import close_group, init_group
    try:
        init_group("cpu", rank=rank, world_size=world, store_path=store)
        res = run_audit(list(SHARDED), device="cpu", comm=Comm())
        torch.save([(r.name, r.collectives, r.syncs, r.problems)
                    for r in res], f"{result}.{rank}")
    except BaseException:
        with open(f"{result}.{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        close_group()


def run_gloo(world: int = DEVICES, timeout: float = 120.0
             ) -> List[List[tuple]]:
    """The sharded contracts on ``world`` spawned gloo ranks on the CPU ->
    each rank's ``[(name, collectives, syncs, problems)]``.  A rank that
    fails, or a run past ``timeout`` seconds, raises (every rank is
    stopped first)."""
    import time

    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="audit_gloo_")
    store, result = os.path.join(tmp, "store"), os.path.join(tmp, "res")
    procs = [ctx.Process(target=_gloo_rank, args=(r, world, store, result))
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
    errs = [open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp))
            if f.endswith(".err")]
    if hung or errs or any(p.exitcode for p in procs):
        raise RuntimeError(f"gloo audit: {len(hung)} rank(s) past {timeout} "
                           f"s, exit codes {[p.exitcode for p in procs]}\n"
                           + "\n".join(errs))
    return [torch.load(f"{result}.{r}", weights_only=False)
            for r in range(world)]


def gloo_problems(inproc: List[AuditResult],
                  ranks: List[List[tuple]]) -> List[str]:
    """Where a gloo rank's audit differs from the in-process one (counts
    and syncs) or failed."""
    want = {r.name: (r.collectives, r.syncs) for r in inproc
            if r.name.split("[")[0] in ("ShardedEngine.run",
                                        "GraphBuilder.build",
                                        "ShardedIvf.search")}
    out = []
    for rank, rows in enumerate(ranks):
        got = {name: (coll, syncs) for name, coll, syncs, _ in rows}
        if got != want:
            out.append(f"gloo rank {rank}: {got} != in-process {want}")
        for name, _, _, probs in rows:
            out += [f"gloo rank {rank}: {name}: {p}" for p in probs]
    return out


# --------------------------------------------------------------------------
# report
# --------------------------------------------------------------------------

def report(results: List[AuditResult], *, extra_problems=(), baseline=None,
           out: Optional[str] = None, log=print) -> int:
    """Print the results, compare the replication with the baseline, write
    the ``repro.analysis.v1`` record to ``out``; -> the number of
    failures (contracts failed + baseline and extra problems)."""
    from repro_torch.analysis import baseline as bl
    from repro_torch.obs import emit
    replication = sorted({e for r in results for e in r.replication})
    failures = 0
    for r in results:
        log(f"audit: {r.name}: {'ok' if r.ok else 'FAIL'} syncs={r.syncs} "
            f"collectives={r.collectives}")
        for p in r.problems:
            log(f"  - {p}")
        failures += not r.ok
    log("audit: replication report (op outputs with a global leading dim):")
    for e in replication:
        log(f"  {e}")
    base = bl.load(baseline)
    problems = bl.compare(replication, base.get("replication", []),
                          section="replication") + list(extra_problems)
    for p in problems:
        log(p)
    if out:
        rec = emit.run_record(
            "analysis_static", schema=emit.ANALYSIS_SCHEMA,
            shapes={"n": N, "d": D, "k": K, "q": Q, "iters": ITERS,
                    "kappa": KAPPA, "tau": TAU, "devices": DEVICES},
            config={"contracts": sorted(CONTRACTS)},
            metrics={
                "contracts_audited": len(results),
                "contracts_failed": sum(not r.ok for r in results),
                "replication_entries": len(replication),
                "replication_baseline": len(base.get("replication", [])),
                "collectives": {r.name: r.collectives for r in results},
                "syncs": {r.name: r.syncs for r in results},
                "replication": replication,
                "problems": [p for r in results for p in r.problems]
                + problems,
            })
        emit.write_json(out, rec)
        log(f"audit: wrote {out}")
    return failures + len(problems)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="runtime contract audit of the port (repro_torch."
                    "analysis layer 2)")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON (default: the checked-in one)")
    ap.add_argument("--out", default="",
                    help="repro.analysis.v1 record path ('' writes none)")
    ap.add_argument("--contract", nargs="*", default=None,
                    help="subset of contracts to audit")
    ap.add_argument("--gloo", action="store_true",
                    help="also run the sharded contracts on 4 spawned gloo "
                         "ranks, which must count the same")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    results = run_audit(args.contract, device=args.device)
    extra: List[str] = []
    if args.gloo:
        try:
            extra = gloo_problems(results, run_gloo())
        except RuntimeError as e:
            extra = [str(e)]
    bad = report(results, extra_problems=extra, baseline=args.baseline,
                 out=args.out or None)
    print("audit: FAIL" if bad else "audit: OK")
    return 1 if bad else 0
