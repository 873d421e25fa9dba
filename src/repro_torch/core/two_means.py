"""Two-means (2M) tree: equal-size recursive bisection (paper Alg. 1).

Counterpart of ``repro.core.two_means``.  Both trees bisect level by level:
at level l every cluster is a segment, two seeds per segment are refined by
``refine_iters`` 2-means steps split at the segment's median, and the final
median split of the discriminant ``||x-c1||² − ||x-c2||²`` halves every
segment exactly.

* ``two_means_tree`` (gk_means' initialisation; the reference's
  ``two_means_scan`` and its jitted wrapper ``two_means_tree`` in one, as
  eager torch has no trace to split) keeps clusters as contiguous blocks of
  a permutation and splits with a stable sort on (segment, delta) — two
  stable ``argsort`` passes, delta then segment.
* ``two_means_dist`` (the graph build's tree) keeps a segment id per row,
  seeds by a salted min-hash of the row id, and splits at an exact
  radix-select median on the composite (monotone-u32(delta) ‖ row id) key,
  whose running counts are an integer ``cumsum`` (exact at any n).  Its
  rows may be sharded over a ``torch.distributed`` group (``comm``), or
  blocked on one device as R shards would hold them (``shards=R``): the
  only cross-shard combines are integer sums and minimums (all-reduces)
  and float sums of per-shard partials added in shard order
  (``TreeTopo.fsum_blocks``), so both forms give the same tree.

Where the reference multiplies (B, k) one-hot matrices (64 GB each at
n = 2**20, k = 2**14), the port takes ``index_add_`` segment sums and gathers
the seed vectors directly; values are the same up to summation order.
uint32 hashing runs in int64 with 32-bit masks (``core.permute.mix32``).

Random draws: each function takes its draws explicitly (``seeds`` for the
tree, ``salts`` for the distributed tree — the reference's per-level
``jax.random`` draws), or draws them from a CPU ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch._device import to_device
from repro_torch.core.comm import Comm, ordered_sum
from repro_torch.core.permute import MASK32, mix32

UMAX = MASK32


def _is_pow2(v: int) -> bool:
    return v > 0 and (v & (v - 1)) == 0


def pad_plan(n: int, k: int) -> Tuple[int, int]:
    """(n_padded, k_rounded): k up to a power of two, n up to a multiple."""
    k2 = 1
    while k2 < k:
        k2 *= 2
    return ((n + k2 - 1) // k2) * k2, k2


def _segsum(vals: torch.Tensor, seg: torch.Tensor, k: int) -> torch.Tensor:
    out = torch.zeros((k,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, seg, vals)


def _stable_sort_by(seg: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Permutation sorting rows by (seg, key), ties by position (stable)."""
    o1 = torch.argsort(key, stable=True)
    o2 = torch.argsort(seg[o1], stable=True)
    return o1[o2]


def draw_tree_seeds(n: int, k: int, generator: torch.Generator
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-level seed offsets (i1, i2), each (levels, k) int64 (CPU).

    At level l (segment length m = n >> l) i1 is uniform in [0, m) and i2 a
    different offset: (i1 + 1 + uniform[0, m-1)) mod m — the reference's
    ``two_means.py:70-75``.
    """
    i1s, i2s = [], []
    for lvl in range(k.bit_length() - 1):
        m = n >> lvl
        i1 = torch.randint(0, max(m, 1), (k,), generator=generator)
        r2 = torch.randint(0, max(m - 1, 1), (k,), generator=generator)
        i1s.append(i1)
        i2s.append((i1 + 1 + r2) % max(m, 1))
    return torch.stack(i1s), torch.stack(i2s)


def two_means_tree(X: torch.Tensor, k: int, *,
                   seeds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None,
                   refine_iters: int = 4) -> torch.Tensor:
    """Partition X (n, d) into k equal-size clusters; returns assign (n,) int32.

    k must be a power of two and divide n (see ``pad_plan``).  ``seeds`` =
    (i1, i2), each (log2 k, k): the per-level in-segment seed offsets (see
    ``draw_tree_seeds``); drawn from ``generator`` when omitted.

    Slice-batched form: X (P, n, d) holds P independent problems (the
    per-(batch, kv-head) key caches of ``core.kv_cluster``); ``seeds`` are
    then each (P, log2 k, k), or drawn per slice from ``generator``, and
    assign is (P, n).  Every level runs once over all P·n rows, with
    segment ids ``s·k + pos // m`` and one stable (segment, delta) sort per
    refine step; slice s equals ``two_means_tree(X[s], k, seeds=(i1[s],
    i2[s]))`` bit for bit on the CPU (its segment sums add the same rows in
    the same order).
    """
    sliced = X.dim() == 3
    Xs = X if sliced else X[None]
    P, n, d = Xs.shape
    if not _is_pow2(k):
        raise ValueError(f"k={k} must be a power of two (see pad_plan)")
    if n % k:
        raise ValueError(f"n={n} must be divisible by k={k} (see pad_plan)")
    dev = X.device
    levels = k.bit_length() - 1
    if levels == 0:
        out = torch.zeros((P, n), dtype=torch.int32, device=dev)
        return out if sliced else out[0]
    if seeds is None:
        if generator is None:
            raise ValueError("pass seeds or a generator")
        drawn = [draw_tree_seeds(n, k, generator) for _ in range(P)]
        seeds = tuple(torch.stack([s[j] for s in drawn]) for j in (0, 1))
    elif not sliced:
        seeds = tuple(torch.as_tensor(s)[None] for s in seeds)
    i1s, i2s = (to_device(torch.as_tensor(s).long(), dev) for s in seeds)
    Xf = Xs.float().reshape(P * n, d)
    pos = torch.arange(P * n, device=dev)
    local = pos % n
    seg0 = (pos // n) * k                      # each row's slice's segment 0
    first = torch.arange(P, device=dev)[:, None] * n
    perm = pos.clone()
    for lvl in range(levels):
        m = n >> lvl
        seg = seg0 + local // m
        Xp = Xf[perm]
        tot = _segsum(Xp, seg, P * k)
        start = torch.arange(k, device=dev) * m

        def seed_rows(i):
            return Xp[(first + torch.clamp(start + i, 0, n - 1)).reshape(-1)]
        c1, c2 = seed_rows(i1s[:, lvl]), seed_rows(i2s[:, lvl])

        def delta(c1, c2):
            a = c2[seg] - c1[seg]
            off = ((c1 * c1).sum(-1) - (c2 * c2).sum(-1))[seg]
            return 2.0 * (Xp * a).sum(-1) + off

        half = (local % m) < (m // 2)
        for _ in range(refine_iters):
            srt = _stable_sort_by(seg, delta(c1, c2))
            w = torch.zeros((P * n,), dtype=torch.float32, device=dev)
            w[srt] = half.float()
            s1 = _segsum(Xp * w[:, None], seg, P * k)
            n1 = _segsum(w, seg, P * k)
            c1 = s1 / torch.clamp(n1, min=1.0)[:, None]
            c2 = (tot - s1) / torch.clamp(float(m) - n1, min=1.0)[:, None]
        perm = perm[_stable_sort_by(seg, delta(c1, c2))]
    assign = torch.empty((P * n,), dtype=torch.int32, device=dev)
    assign[perm] = (local // (n // k)).to(torch.int32)
    return assign.view(P, n) if sliced else assign


# ---------------------------------------------------------------------------
# the distributed tree (histogram medians), on one device or over a group
# ---------------------------------------------------------------------------

class TreeTopo:
    """Cross-shard combines of the distributed tree (the reference's
    ``_TreeTopo``).

    ``comm`` set: the group's collectives.  None: one device, where
    ``shards=R`` emulates R ranks holding contiguous row blocks.  Integer
    sums and minimums are order-invariant, so the emulation takes them over
    all rows at once; float sums go through ``fsum_blocks``, which adds the
    same per-block partials in block order in both topologies
    (``core.comm.ordered_sum``)."""

    def __init__(self, shards: int = 1, comm: Optional[Comm] = None):
        self.comm = comm
        self.R = comm.size if comm is not None else shards

    def isum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.comm is None else self.comm.psum(x)

    def umin(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.comm is None else self.comm.pmin(x)

    def owner_fsum(self, x: torch.Tensor) -> torch.Tensor:
        """A float sum whose every element is one owner's value plus
        zeros (exact in any order)."""
        return x if self.comm is None else self.comm.psum(x)

    def fsum_blocks(self, partial_fn, *rows: torch.Tensor) -> torch.Tensor:
        """Ordered float combine of per-shard partials of ``rows``."""
        if self.comm is not None:
            return self.comm.fsum(partial_fn(*rows))
        if self.R == 1:
            return partial_fn(*rows)
        blocked = [a.reshape((self.R, -1) + a.shape[1:]) for a in rows]
        return ordered_sum([partial_fn(*(a[s] for a in blocked))
                            for s in range(self.R)])


def monotone_u32(f: torch.Tensor) -> torch.Tensor:
    """Order-preserving f32 -> uint32 key (as int64), IEEE total-order trick."""
    b = f.float().contiguous().view(torch.int32).long() & MASK32
    return torch.where((b >> 31) == 0, b | 0x80000000, (~b) & MASK32)


def _radix_left(ukey, pos_u, seg, k, r, active, topo: TreeTopo):
    """Mark the r[c] smallest composite (ukey ‖ pos_u) keys of every segment.

    8 rounds of a (256, k) digit histogram, high byte first, summed over
    the shards.  Row ids are unique, so the key is a total order and exactly
    r[c] rows come back.
    """
    left = torch.zeros_like(active)
    cols = torch.arange(k, device=seg.device)
    for rnd in range(8):
        word = ukey if rnd < 4 else pos_u
        digit = (word >> (8 * (3 - rnd % 4))) & 0xFF
        hist = torch.zeros((256 * k,), dtype=torch.int64, device=seg.device)
        hist.index_add_(0, digit * k + seg, active.long())
        hist = topo.isum(hist.view(256, k))
        cum = torch.cumsum(hist, dim=0)
        dstar = (cum > r[None, :]).to(torch.int8).argmax(dim=0)
        below = (cum - hist)[dstar, cols]
        ds_row = dstar[seg]
        left = left | (active & (digit < ds_row))
        active = active & (digit == ds_row)
        r = r - below
    return left


def _seg_min(vals, seg, k, topo: TreeTopo):
    out = torch.full((k,), UMAX, dtype=torch.int64, device=vals.device)
    return topo.umin(out.scatter_reduce_(0, seg, vals, reduce="amin"))


def _seed_rows(h, pos_u, seg, k, topo: TreeTopo, exclude=None):
    """Global row id of each segment's min-hash member (row-id tie-break),
    and its local row index (-1 where this shard does not hold it)."""
    hx = h if exclude is None else torch.where(pos_u == exclude[seg], UMAX, h)
    hmin = _seg_min(hx, seg, k, topo)
    cand = torch.where(hx == hmin[seg], pos_u, UMAX)
    if exclude is not None:
        cand = torch.where(pos_u == exclude[seg], UMAX, cand)
    pos_c = _seg_min(cand, seg, k, topo)                  # (k,) row ids
    hit = pos_u == pos_c[seg]
    local = torch.where(hit, torch.arange(seg.shape[0], device=seg.device),
                        -1)
    idx = torch.full((k,), -1, dtype=torch.int64, device=seg.device)
    return pos_c, idx.scatter_reduce_(0, seg, local, reduce="amax")


def _rows_or_zero(Xf, idx):
    return torch.where((idx >= 0)[:, None], Xf[torch.clamp(idx, min=0)],
                       torch.zeros((), device=Xf.device))


def draw_salts(levels: int, generator: torch.Generator) -> torch.Tensor:
    """(levels, 2) uniform uint32 salts as int64 (CPU)."""
    return torch.randint(0, 1 << 32, (levels, 2), generator=generator,
                         dtype=torch.int64)


def two_means_dist(X: torch.Tensor, row_ids: torch.Tensor, k: int, *,
                   salts: Optional[Sequence] = None,
                   generator: Optional[torch.Generator] = None,
                   shards: int = 1, comm: Optional[Comm] = None,
                   refine_iters: int = 4) -> torch.Tensor:
    """Equal-size 2M tree with radix-select medians; returns assign (B,) int32.

    X (B, d) / row_ids (B,) (unique ids < 2**32) are all rows, or with
    ``comm`` this rank's rows of a group (B on every rank); k a power of two
    dividing the global row count.  ``shards=R`` (one device) emulates an
    R-rank group whose ranks hold contiguous blocks of B / R rows: the
    result equals the group's, bit for bit on the CPU.  ``salts`` (log2 k,
    2) are the per-level hash salts (the reference's
    ``jax.random.bits(fold_in(key, lvl), (2,))``), drawn from ``generator``
    when omitted; every rank must use the same.
    """
    if not _is_pow2(k):
        raise ValueError(f"k={k} must be a power of two (see pad_plan)")
    topo = TreeTopo(shards, comm)
    B = X.shape[0]
    if comm is None and B % topo.R:
        raise ValueError(f"n={B} rows do not divide into {topo.R} shards")
    n = B * (topo.R if comm is not None else 1)
    if n % k:
        raise ValueError(f"padded n={n} must be divisible by k={k}")
    dev = X.device
    levels = k.bit_length() - 1
    if levels == 0:
        return torch.zeros((B,), dtype=torch.int32, device=dev)
    if salts is None:
        if generator is None:
            raise ValueError("pass salts or a generator")
        salts = draw_salts(levels, generator)
    salts = [[int(s) & MASK32 for s in row] for row in
             (salts.tolist() if isinstance(salts, torch.Tensor) else salts)]
    Xf = X.float()
    pos_u = row_ids.long() & MASK32
    seg = torch.zeros((B,), dtype=torch.int64, device=dev)
    ones = torch.ones((B,), dtype=torch.int64, device=dev)
    all_rows = torch.ones((B,), dtype=torch.bool, device=dev)
    for lvl in range(levels):
        m = n >> lvl
        tot = topo.fsum_blocks(lambda xb, sb: _segsum(xb, sb, k), Xf, seg)
        cntc = topo.isum(_segsum(ones, seg, k))
        pos1, i1 = _seed_rows(mix32(pos_u ^ salts[lvl][0]), pos_u, seg, k,
                              topo)
        _, i2 = _seed_rows(mix32(pos_u ^ salts[lvl][1]), pos_u, seg, k, topo,
                           exclude=pos1)
        c1 = topo.owner_fsum(_rows_or_zero(Xf, i1))
        c2 = topo.owner_fsum(_rows_or_zero(Xf, i2))
        r_half = torch.full((k,), m >> 1, dtype=torch.int64, device=dev)

        def delta_of(c1, c2):
            dir_rows = (c2 - c1)[seg]
            off = (c1 * c1).sum(-1) - (c2 * c2).sum(-1)
            return 2.0 * (Xf * dir_rows).sum(-1) + off[seg]

        for _ in range(refine_iters):
            w = _radix_left(monotone_u32(delta_of(c1, c2)), pos_u, seg, k,
                            r_half, all_rows, topo)
            s1 = topo.fsum_blocks(
                lambda xb, sb, wb: _segsum(xb * wb[:, None], sb, k), Xf,
                seg, w.float())
            n1 = topo.isum(_segsum(w.long(), seg, k))
            c1 = s1 / torch.clamp(n1, min=1).float()[:, None]
            c2 = (tot - s1) / torch.clamp(cntc - n1, min=1).float()[:, None]
        left = _radix_left(monotone_u32(delta_of(c1, c2)), pos_u, seg, k,
                           r_half, all_rows, topo)
        seg = seg * 2 + torch.where(left, 0, 1)
    return seg.to(torch.int32)
