"""Plain PyTorch versions of the port's kernels.

Counterparts of ``repro.kernels.ref`` (``scores_from_dots``,
``gather_score``, ``merge_lists``, ``refine_merge``, ``stable_topk``,
``finalize_d2``, ``probe_centroids``, ``assign_centroids``, ``ivf_scan``,
``ivf_scan_grouped``, ``ivf_scan_adc``, ``pairwise_sq``).
They run on any device: ``kernels.ops`` sends CPU tensors here, and
``chip_smoke.py`` holds the CUDA kernels against them on the card
(``force="ref"``).  Every op is elementwise per row or a batched product,
so a batch may be cut anywhere: the centroid and scan versions chunk their
row axis to bound the (rows, k) and gathered working sets.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

INF = float("inf")


def scores_from_dots(dots: torch.Tensor, nv: torch.Tensor, dsq: torch.Tensor,
                     xsq: torch.Tensor, mode: str) -> torch.Tensor:
    """Move scores from inner products (``repro.kernels.ref.scores_from_dots``).

    dots/nv/dsq: (B, C+1), slot 0 the source cluster u and slots 1..C the
    candidates (x·D[row], cnt[row], ||D[row]||²); xsq: (B,).  mode='bkm'
    gives ΔI (paper Eqn. 3, self-moves not masked); mode='lloyd' gives the
    candidate-centroid distance minus ||x||², +inf for empty clusters.
    """
    nv_c, dsq_c, xd_c = nv[:, 1:], dsq[:, 1:], dots[:, 1:]
    if mode == "lloyd":
        inv = 1.0 / torch.clamp(nv_c, min=1.0)
        d2 = dsq_c * (inv * inv) - 2.0 * (xd_c * inv)
        return torch.where(nv_c > 0, d2, torch.full_like(d2, INF))
    if mode != "bkm":
        raise ValueError(f"mode must be 'bkm' or 'lloyd', got {mode!r}")
    nu, dsq_u, xd_u = nv[:, 0], dsq[:, 0], dots[:, 0]
    gain = (dsq_c + 2.0 * xd_c + xsq[:, None]) / (nv_c + 1.0)
    gain = gain - torch.where(nv_c > 0, dsq_c / torch.clamp(nv_c, min=1.0),
                              torch.zeros_like(dsq_c))
    num_u = dsq_u - 2.0 * xd_u + xsq
    resid = torch.where(nu > 1, num_u / torch.clamp(nu - 1.0, min=1.0),
                        torch.zeros_like(num_u))
    loss_u = resid - dsq_u / torch.clamp(nu, min=1.0)
    return gain + loss_u[:, None]


def gather_dots(x: torch.Tensor, rows: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """``dots[i, j] = x[i] · src[rows[i, j]]`` through a (B, R, d) gather."""
    G = src[rows.long()]                                   # (B, R, d)
    return torch.bmm(G, x.unsqueeze(2)).squeeze(2)


def gather_score(x: torch.Tensor, u: torch.Tensor, cand: torch.Tensor,
                 D: torch.Tensor, cnt: torch.Tensor, *,
                 mode: str = "bkm") -> torch.Tensor:
    """Candidate-move scores (``repro.kernels.ref.gather_score``).

    x (B, d) f32; u (B,) int32 source clusters; cand (B, C) int32 candidate
    clusters; D (k, d) f32 composite vectors; cnt (k,) f32 counts -> (B, C).
    """
    xf = x.float()
    Df = D.float()
    rows = torch.cat([u[:, None], cand], dim=1).long()     # (B, C+1)
    dsq_k = (Df * Df).sum(-1)                              # (k,)
    dots = gather_dots(xf, rows, Df)
    nv = cnt.float()[rows]
    dsq = dsq_k[rows]
    xsq = (xf * xf).sum(-1)
    return scores_from_dots(dots, nv, dsq, xsq, mode)


def score_scale(x: torch.Tensor, u: torch.Tensor, cand: torch.Tensor,
                D: torch.Tensor, cnt: torch.Tensor, *,
                mode: str = "bkm") -> torch.Tensor:
    """(B, C) sum of the magnitudes of the terms each move score adds up.

    ΔI is a small difference of large terms (``||D_v||²/(n_v+1)`` against
    ``||D_v||²/n_v``, and so on), so the rounding error of a score scales
    with these terms, not with the score.  ``|x·D_row|`` is bounded by
    ``||x||·||D_row||`` (Cauchy–Schwarz).  A kernel-vs-plain limit is a small
    multiple of this scale, element by element.
    """
    xf, Df = x.float(), D.float()
    rows = torch.cat([u[:, None], cand], dim=1).long()
    dsq = (Df * Df).sum(-1)[rows]
    nv = cnt.float()[rows]
    xsq = (xf * xf).sum(-1)[:, None]
    m = torch.sqrt(dsq * xsq)                  # bounds |x·D_row|
    nv_c, dsq_c, m_c = nv[:, 1:], dsq[:, 1:], m[:, 1:]
    if mode == "lloyd":
        inv = 1.0 / torch.clamp(nv_c, min=1.0)
        return dsq_c * (inv * inv) + 2.0 * m_c * inv
    if mode != "bkm":
        raise ValueError(f"mode must be 'bkm' or 'lloyd', got {mode!r}")
    nu, dsq_u, m_u = nv[:, :1], dsq[:, :1], m[:, :1]
    zero = torch.zeros_like(dsq_c)
    gain = (dsq_c + 2.0 * m_c + xsq) / (nv_c + 1.0) + torch.where(
        nv_c > 0, dsq_c / torch.clamp(nv_c, min=1.0), zero)
    resid = torch.where(nu > 1, (dsq_u + 2.0 * m_u + xsq)
                        / torch.clamp(nu - 1.0, min=1.0), zero[:, :1])
    return gain + resid + dsq_u / torch.clamp(nu, min=1.0)


def merge_lists(old_ids: torch.Tensor, old_d: torch.Tensor,
                cand_ids: torch.Tensor, cd: torch.Tensor, kappa: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-κ merge with id-dedupe (``repro.kernels.ref.merge_lists``).

    κ passes of first-minimum selection over the concatenated
    ``[old, cand]`` entries; each pass retires every copy of the selected id.
    Entries with id -1 count as +inf; exhausted slots come out -1/inf.
    """
    ent_d = torch.cat([old_d.float(), cd.float()], dim=-1)
    ent_i = torch.cat([old_ids, cand_ids], dim=-1).to(torch.int32)
    ent_d = torch.where(ent_i < 0, torch.full_like(ent_d, INF), ent_d)
    L = ent_d.shape[-1]
    col = torch.arange(L, device=ent_d.device)[None, :]
    out_d, out_i = [], []
    for _ in range(kappa):
        mv = ent_d.min(dim=-1).values                      # (B,)
        hit = ent_d == mv[:, None]
        pos = torch.where(hit, col, L).min(dim=-1).values  # first minimum
        at = col == pos[:, None]
        sid = torch.where(at, ent_i, 0).sum(dim=-1, dtype=torch.int32)
        valid = mv < INF
        out_d.append(torch.where(valid, mv, INF))
        out_i.append(torch.where(valid, sid, -1))
        ent_d = torch.where((ent_i == sid[:, None]) | at, INF, ent_d)
    return (torch.stack(out_i, dim=-1).to(torch.int32),
            torch.stack(out_d, dim=-1))


def refine_merge(x: torch.Tensor, rows: torch.Tensor, cand_ids: torch.Tensor,
                 old_ids: torch.Tensor, old_d: torch.Tensor,
                 Xsrc: torch.Tensor, *, ysq: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate distances merged into top-κ lists (``repro.kernels.ref``).

    x (B, d); rows (B, C) int32 indices into Xsrc (pre-clamped >= 0);
    cand_ids (B, C) int32 ids, -1 = invalid; old_ids/old_d (B, κ) sorted
    lists; Xsrc (N, d); ysq (N,) the hoisted ``||Xsrc||²`` (computed here
    when omitted).  Distances are ``max(||y||² + ||x||² − 2x·y, 0)``.
    """
    kappa = old_ids.shape[1]
    xf = x.float()
    Xf = Xsrc.float()
    r = rows.long()
    if ysq is None:
        ysq = (Xf * Xf).sum(-1)
    ysq_c = ysq[r]                                         # (B, C)
    xsq = (xf * xf).sum(-1)
    dots = gather_dots(xf, r, Xf)
    cd = torch.clamp(ysq_c + xsq[:, None] - 2.0 * dots, min=0.0)
    return merge_lists(old_ids.to(torch.int32), old_d, cand_ids, cd, kappa)


# ------------------------------------------------------------ top-k selection

# entries per chunk of the (rows, candidates) matrices below: 2^24 floats is
# 64 MB per matrix, small beside a card and harmless on the CPU
CHUNK_ENTRIES = 1 << 24


def stable_topk(d: torch.Tensor, ids: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis, ties to the lowest position
    (``repro.kernels.ref.stable_topk``).

    A stable ascending sort gives exactly the reference's k passes of
    first-minimum selection (``torch.topk``'s tie order is unspecified).  A
    slot whose distance is +inf — exhausted, fewer candidates than k — comes
    out id -1 / +inf.  d, ids: (..., L) -> (d (..., k), ids (..., k)).
    """
    L = d.shape[-1]
    if k > L:
        pad = list(d.shape[:-1]) + [k - L]
        d = torch.cat([d, d.new_full(pad, INF)], dim=-1)
        ids = torch.cat([ids, ids.new_full(pad, -1)], dim=-1)
    sd, order = torch.sort(d, dim=-1, stable=True)
    sd = sd[..., :k]
    si = torch.gather(ids, -1, order[..., :k]).to(torch.int32)
    return sd, torch.where(sd == INF, torch.full_like(si, -1), si)


def first_min_merge(gd: torch.Tensor, gi: torch.Tensor, p: int
                    ) -> torch.Tensor:
    """Merge per-shard candidate lists by iterated first minimum.

    gd, gi: (L, q) candidate values and ids, shard-major along L.  The
    reference takes p passes of ``argmin`` over L (the first minimum) and
    retires each winner's value to +inf (``repro/core/engine.py::
    _probe_sharded``, ``repro.index.probe.merge_probe_cells``): the
    entries below +inf come out in stable ascending order, and a pass past
    them finds an all-inf column and takes its row 0.  Returns (q, p) ids.
    """
    L, q = gd.shape
    order = torch.sort(gd, dim=0, stable=True).indices
    ids = gi.gather(0, order[:min(p, L)])
    if p > L:
        ids = torch.cat([ids, gi[:1].expand(p - L, q)])
    live = (gd < INF).sum(0)
    r = torch.arange(p, device=gd.device)[:, None]
    return torch.where(r < live[None, :], ids,
                       gi[:1].expand(p, q)).T.contiguous()


def finalize_d2(ids: torch.Tensor, od: torch.Tensor, Q: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw scan partials (``||v||² − 2q·v``) -> exact squared L2
    (``repro.kernels.ref.finalize_d2``): ``max(od + ||q||², 0)`` in that op
    order, +inf where the id is -1."""
    qsq = (Q.float() ** 2).sum(-1)
    d2 = torch.clamp(od + qsq[:, None], min=0.0)
    return ids, torch.where(ids < 0, torch.full_like(d2, INF), d2)


def _row_chunks(n: int, width: int):
    step = max(1, CHUNK_ENTRIES // max(width, 1))
    return range(0, n, step), step


def _centroid_partials(x: torch.Tensor, Cf: torch.Tensor,
                       csq: torch.Tensor) -> torch.Tensor:
    """(c, k) ``||c||² − 2x·c`` — the squared distance less ``||x||²``."""
    return csq[None, :] - 2.0 * (x @ Cf.T)


def probe_centroids(X: torch.Tensor, C: torch.Tensor, p: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-p nearest centroids per row (``repro.kernels.ref``).

    X (n, d), C (k, d) -> (ids (n, p) int32 ascending by distance, ties to
    the lower centroid index; d2 (n, p) f32 = ``max(part + ||x||², 0)``).
    """
    if not 0 < p <= C.shape[0]:
        raise ValueError(f"need 0 < p <= k, got p={p}, k={C.shape[0]}")
    Xf, Cf = X.float(), C.float()
    csq = (Cf * Cf).sum(-1)
    cols = torch.arange(C.shape[0], dtype=torch.int32, device=X.device)
    starts, step = _row_chunks(X.shape[0], C.shape[0])
    out_i, out_d = [], []
    for a in starts:
        x = Xf[a:a + step]
        part = _centroid_partials(x, Cf, csq)
        d, ids = stable_topk(part, cols.expand(part.shape[0], -1), p)
        xsq = (x * x).sum(-1)
        out_i.append(ids)
        out_d.append(torch.clamp(d + xsq[:, None], min=0.0))
    if not out_i:
        return (torch.empty((0, p), dtype=torch.int32, device=X.device),
                torch.empty((0, p), device=X.device))
    return torch.cat(out_i), torch.cat(out_d)


def assign_centroids(X: torch.Tensor, C: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest centroid per row (``repro.kernels.ref.assign_centroids``).

    X (n, d), C (k, d) -> (assign (n,) int32, the first minimum's index;
    d2 (n,) f32 = ``max(min part + ||x||², 0)``).
    """
    Xf, Cf = X.float(), C.float()
    csq = (Cf * Cf).sum(-1)
    starts, step = _row_chunks(X.shape[0], C.shape[0])
    out_a, out_d = [], []
    for a in starts:
        x = Xf[a:a + step]
        part = _centroid_partials(x, Cf, csq)
        am = torch.argmin(part, dim=-1)            # first minimum
        dmin = torch.gather(part, 1, am[:, None])[:, 0]
        out_a.append(am.to(torch.int32))
        out_d.append(torch.clamp(dmin + (x * x).sum(-1), min=0.0))
    if not out_a:
        return (torch.empty((0,), dtype=torch.int32, device=X.device),
                torch.empty((0,), device=X.device))
    return torch.cat(out_a), torch.cat(out_d)


def _empty_topk(topk: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, d) of zero queries."""
    return (torch.empty((0, topk), dtype=torch.int32, device=device),
            torch.empty((0, topk), device=device))


def ivf_scan(Q: torch.Tensor, vecs: torch.Tensor, pids: torch.Tensor,
             tile_map: torch.Tensor, *, block_rows: int, topk: int = 10,
             raw: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverted-list scan over the packed layout (``repro.kernels.ref``).

    Q (q, d); vecs (n_pad, d) packed rows; pids (n_pad,) int32, -1 at holes;
    tile_map (q, T) int32 packed-tile indices.  Each query's candidates are
    the rows of its T tiles in slot order, scored ``||v||² − 2q·v`` (+inf at
    holes), and the top-k is taken with the first-minimum rule.  Returns
    (ids (q, topk) int32, -1 past the candidate count; d2 (q, topk) f32
    through ``finalize_d2``, or the raw partials with ``raw=True``).

    The query axis is chunked (as the reference's ``tile``), and only live
    rows are gathered: a hole scores +inf whatever its vector, so skipping
    its dot changes no result.
    """
    nq, T = tile_map.shape
    L = T * block_rows
    Qf = Q.float()
    dev = Q.device
    offs = torch.arange(block_rows, device=dev)
    starts, step = _row_chunks(nq, L)
    out_i, out_d = [], []
    for a in starts:
        tm = tile_map[a:a + step].long()
        c = tm.shape[0]
        pos = (tm[:, :, None] * block_rows + offs).reshape(c, L)
        cids = pids[pos]
        part = torch.full((c, L), INF, device=dev)
        qi, li = torch.nonzero(cids >= 0, as_tuple=True)
        v = vecs[pos[qi, li]].float()
        part[qi, li] = (v * v).sum(-1) - 2.0 * (v * Qf[a:a + step][qi]).sum(-1)
        d, ids = stable_topk(part, cids, topk)
        out_i.append(ids)
        out_d.append(d)
    if out_i:
        ids, d = torch.cat(out_i), torch.cat(out_d)
    else:
        ids, d = _empty_topk(topk, dev)
    if raw:
        return ids, torch.where(ids < 0, torch.full_like(d, INF), d)
    return finalize_d2(ids, d, Q)


def ivf_scan_grouped(Qg: torch.Tensor, vecs: torch.Tensor,
                     pids: torch.Tensor, union_tiles: torch.Tensor,
                     qmask: torch.Tensor, *, block_rows: int, topk: int = 10,
                     raw: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query-grouped scan (``repro.kernels.ref.ivf_scan_grouped``).

    Qg (ngroups·G, d) queries permuted into groups; union_tiles (ngroups,
    U) int32 deduped tile indices per group; qmask (ngroups·G, U) nonzero
    where the query probed that union slot.  Query j of group g takes the
    rows of the slots it probed, in union slot order then row order, scored
    ``||v||² − 2q·v`` (+inf at holes and at slots it did not probe), and
    the top-k is taken with the first-minimum rule.  Returns (ids, d2) of
    shape (ngroups·G, topk) in the grouped order, d2 as ``ivf_scan``'s.

    Groups are chunked, and only the (query, row) pairs that count are
    computed: a pair a query did not probe, or a hole, scores +inf whatever
    its vector.
    """
    ngroups, U = union_tiles.shape
    nqg = Qg.shape[0]
    G = nqg // ngroups if ngroups else 0
    L = U * block_rows
    Qf = Qg.float()
    dev = Qg.device
    offs = torch.arange(block_rows, device=dev)
    starts, step = _row_chunks(ngroups, G * L)
    out_i, out_d = [], []
    for a in starts:
        ut = union_tiles[a:a + step].long()
        c = ut.shape[0]
        pos = (ut[:, :, None] * block_rows + offs).reshape(c, L)
        cids = pids[pos]                                       # (c, L)
        probed = qmask[a * G:(a + c) * G].reshape(c, G, U) != 0
        ok = probed.repeat_interleave(block_rows, dim=2) & (
            cids[:, None, :] >= 0)                             # (c, G, L)
        ids = torch.where(ok, cids[:, None, :], -1)
        part = torch.full((c, G, L), INF, device=dev)
        gi, ji, li = torch.nonzero(ok, as_tuple=True)
        v = vecs[pos[gi, li]].float()
        q = Qf[(a + gi) * G + ji]
        part[gi, ji, li] = (v * v).sum(-1) - 2.0 * (v * q).sum(-1)
        d, sel = stable_topk(part.reshape(c * G, L), ids.reshape(c * G, L),
                             topk)
        out_i.append(sel)
        out_d.append(d)
    if out_i:
        ids, d = torch.cat(out_i), torch.cat(out_d)
    else:
        ids, d = _empty_topk(topk, dev)
    if raw:
        return ids, torch.where(ids < 0, torch.full_like(d, INF), d)
    return finalize_d2(ids, d, Qg)


def ivf_scan_adc(lut: torch.Tensor, qconst: torch.Tensor,
                 vnorm: torch.Tensor, codes: torch.Tensor,
                 pids: torch.Tensor, tile_map: torch.Tensor, *,
                 block_rows: int, topk: int = 10
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Asymmetric-distance scan of compressed lists
    (``repro.kernels.ref.ivf_scan_adc``).

    lut (q, M, W) per-query table and qconst (q,)
    (``index.quantize.build_lut``); vnorm (n_pad,) reconstruction norms;
    codes (n_pad, M) uint8; pids/tile_map as in ``ivf_scan``.  A live row
    scores ``vnorm + sum_m lut[m, code[m]]`` (W > 1; a code >= W adds 0,
    as the reference's one-hot) or ``vnorm + sum_m lut[m, 0] · code[m]``
    (W = 1), +inf at holes; candidates in slot order then row order, top-k
    by the first-minimum rule with the packed row position as payload
    (-1 at holes).  Returns (ids, pos, part) of shape (q, topk): ids
    gathered by position, the raw partials with ``qconst`` added to the
    selected values only, +inf and -1 at empty slots.
    """
    nq, M, W = lut.shape
    T = tile_map.shape[1]
    L = T * block_rows
    dev = lut.device
    lf = lut.float().reshape(-1)
    cols = torch.arange(M, device=dev)
    offs = torch.arange(block_rows, device=dev)
    starts, step = _row_chunks(nq, L * M)
    out = ([], [], [])
    for a in starts:
        tm = tile_map[a:a + step].long()
        c = tm.shape[0]
        pos = (tm[:, :, None] * block_rows + offs).reshape(c, L)
        cids = pids[pos]
        part = torch.full((c, L), INF, device=dev)
        qi, li = torch.nonzero(cids >= 0, as_tuple=True)
        rows = pos[qi, li]
        cd = codes[rows].long()                                # (n, M)
        if W == 1:
            cross = (lut[a + qi, :, 0].float() * cd.float()).sum(-1)
        else:
            at = ((a + qi)[:, None] * M + cols) * W + cd.clamp(max=W - 1)
            cross = torch.where(cd < W, lf[at], 0.0).sum(-1)
        part[qi, li] = vnorm[rows] + cross
        ppos = torch.where(cids < 0, -1, pos).to(torch.int32)
        d, psel = stable_topk(part, ppos, topk)
        empty = psel < 0
        out[0].append(torch.where(empty, -1, pids[psel.clamp(min=0).long()]))
        out[1].append(psel)
        out[2].append(torch.where(empty, INF,
                                  d + qconst[a:a + step, None].float()))
    if not out[0]:
        ids, d = _empty_topk(topk, dev)
        return ids, ids.clone(), d
    return tuple(torch.cat(o) for o in out)


def pairwise_sq(Xb: torch.Tensor) -> torch.Tensor:
    """Batched within-cluster squared L2 (``repro.kernels.ref.pairwise_sq``).

    Xb: (B, m, d) float32 or bfloat16 -> (B, m, m) float32 with
    ``D[b,i,j] = max(||x_i||² + ||x_j||² − 2 x_i·x_j, 0)``, computed in
    float32.  The reference's ``tile`` only chunks its ``lax.map`` over
    clusters and never changes the result, so it has no counterpart here.
    """
    Xf = Xb.to(torch.float32)
    sq = (Xf * Xf).sum(-1)                                  # (B, m)
    dots = torch.einsum("bid,bjd->bij", Xf, Xf)             # (B, m, m)
    return torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * dots, min=0.0)
