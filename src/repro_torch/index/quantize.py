"""List-payload codecs: int8 affine and PQ codebooks, kernel-ready packing.

Counterpart of ``repro.index.quantize``.  Two ways to compress the packed
(n_rows, d) slab to u8 codes that ``ivf_scan_adc`` scores without decoding:

- ``int8``: per-dimension affine ``x ~ zero[j] + scale[j] * c[j]``, c in
  [0, 255].  Codes are (n_rows, d) u8; the per-query constant
  ``-2 q . zero`` is the same for every candidate of a query, so it is added
  to the selected partials after the scan (``qconst``).
- ``pq``: product quantization — d splits into ``nsub`` subspaces, each
  with a 256-entry codebook trained by the engine's own k-means
  (``engine.run`` on ``dense_source()``, mode='lloyd').  Codes are
  (n_rows, nsub) u8; the per-query table holds ``-2 q_m . codebook[m, v]``.

Both score with ``ivf_scan``'s partial-distance convention: ``pack_codes``
stores ``vnorm = ||decode(c)||²`` per row, and ``build_lut`` gives a
per-query ``(lut (q, M, W), qconst (q,))`` with
``part = vnorm + sum_m lut[m, code[m]] + qconst``; int8 is the W=1 case
(the lookup is a multiply).  Packing is a pure function of the f32 slab,
row by row: ``codes == encode(vecs)`` holds through add, remove and repack
(holes encode the zero vector; the scan masks them by id).

Every function works on the tensors' own device; the encoders chunk their
rows so the (rows, nsub, 256) distance table stays small.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import engine, permute
from repro_torch.kernels import ops as kops

PQ_VOCAB = 256          # codebook entries per subspace (one u8 code)
_CHUNK_ENTRIES = 1 << 24


@dataclass(frozen=True)
class Int8Codec:
    """Per-dimension affine codec: ``x ~ zero + scale * code``."""
    kind: ClassVar[str] = "int8"
    scale: torch.Tensor       # (d,) f32, strictly positive
    zero: torch.Tensor        # (d,) f32

    def to(self, device) -> "Int8Codec":
        return Int8Codec(self.scale.to(device), self.zero.to(device))


@dataclass(frozen=True)
class PqCodec:
    """Product quantizer: ``x ~ concat_m codebook[m, code[m]]``."""
    kind: ClassVar[str] = "pq"
    codebook: torch.Tensor    # (nsub, PQ_VOCAB, dsub) f32

    @property
    def nsub(self) -> int:
        return self.codebook.shape[0]

    @property
    def dsub(self) -> int:
        return self.codebook.shape[2]

    def to(self, device) -> "PqCodec":
        return PqCodec(self.codebook.to(device))


Codec = Union[Int8Codec, PqCodec]


def train_int8(X: torch.Tensor) -> Int8Codec:
    """Fit the per-dimension [min, max] -> [0, 255] affine over rows X."""
    X = X.float()
    mn = X.min(dim=0).values
    mx = X.max(dim=0).values
    # a strictly positive scale keeps encode monotone on constant dims
    scale = torch.clamp((mx - mn) / 255.0, min=1e-12)
    return Int8Codec(scale=scale, zero=mn)


def train_pq(X: torch.Tensor, nsub: int, *,
             generator: Optional[torch.Generator] = None, iters: int = 8,
             batch_size: int = 1024,
             seed_rows: Optional[Sequence[torch.Tensor]] = None,
             epoch_words: Optional[Sequence] = None) -> PqCodec:
    """Train one 256-entry codebook per subspace with the engine's k-means.

    Subspace m seeds its codebook with ``ksub = min(256, n)`` distinct rows,
    assigns every row to its nearest seed (``assign_centroids``), and runs
    ``engine.run`` (mode='lloyd', ``dense_source()``) for ``iters`` epochs.
    Fewer than 256 rows pad the codebook by repeating row 0: exact
    duplicates, which ``encode``'s first-minimum argmin never picks.

    The draws: the seed rows of subspace m are ``seed_rows[m]`` and its
    epoch words ``epoch_words[m]`` ((iters, 4) words, as ``engine.run``
    takes them) where given; otherwise the first ``ksub`` entries of a
    Feistel visit order of words drawn from ``generator``, and epoch words
    from ``generator`` (a CPU ``torch.Generator``).  The reference draws
    ``epoch_order(fold_in(key, m), n)[:ksub]`` and the run's subkeys from
    ``fold_in(fold_in(key, m), 1)``; the tests pass those in.
    """
    X = X.float()
    n, d = X.shape
    if nsub < 1 or d % nsub:
        raise ValueError(f"nsub must divide d: nsub={nsub}, d={d}")
    if (seed_rows is None or epoch_words is None) and generator is None:
        raise ValueError("pass a generator, or seed_rows and epoch_words")
    dsub = d // nsub
    ksub = min(PQ_VOCAB, n)
    cfg = engine.EngineConfig(batch_size=min(batch_size, n), mode="lloyd",
                              iters=iters)
    books = []
    for m in range(nsub):
        Xm = X[:, m * dsub:(m + 1) * dsub].contiguous()
        if seed_rows is not None:
            rows = torch.as_tensor(seed_rows[m]).to(X.device).long()
        else:
            order = permute.epoch_order(permute.draw_words(generator), n,
                                        X.device)
            rows = order[:ksub]
        seeds = Xm[rows].contiguous()
        assign0, _ = kops.assign_centroids(Xm, seeds)
        state = engine.init_state(Xm, assign0, ksub)
        engine.run(Xm, state, engine.dense_source(), cfg,
                   epoch_words=None if epoch_words is None
                   else epoch_words[m], generator=generator)
        book = state.D / torch.clamp(state.cnt, min=1.0)[:, None]
        if ksub < PQ_VOCAB:
            book = torch.cat([book, book[:1].expand(PQ_VOCAB - ksub, dsub)])
        books.append(book)
    return PqCodec(codebook=torch.stack(books).contiguous())


# ------------------------------------------------------------ encode / decode

def code_width(codec: Codec, d: int) -> int:
    """Stored code columns per row (the scan's M)."""
    return d if codec.kind == "int8" else codec.nsub


def lut_width(codec: Codec) -> int:
    """Table entries per code column W: 256 for pq, 1 for int8."""
    return 1 if codec.kind == "int8" else PQ_VOCAB


def _chunks(n: int, width: int):
    step = max(1, _CHUNK_ENTRIES // max(width, 1))
    return range(0, n, step), step


def encode(codec: Codec, X: torch.Tensor) -> torch.Tensor:
    """f32 rows (n, d) -> u8 codes (n, code_width).

    int8: ``round((X − zero) / scale)`` (half to even, as ``jnp.round``),
    clamped to [0, 255].  pq: per subspace the code of the nearest codebook
    entry by ``||c||² − 2x·c``, ties to the lowest code.
    """
    X = X.float()
    if codec.kind == "int8":
        c = torch.round((X - codec.zero[None, :]) / codec.scale[None, :])
        return torch.clamp(c, 0.0, 255.0).to(torch.uint8)
    nsub, dsub = codec.nsub, codec.dsub
    cb = codec.codebook
    csq = (cb * cb).sum(-1)                                  # (nsub, V)
    starts, step = _chunks(X.shape[0], nsub * PQ_VOCAB)
    out = torch.empty((X.shape[0], nsub), dtype=torch.uint8, device=X.device)
    for a in starts:
        Xs = X[a:a + step].reshape(-1, nsub, dsub)
        d2 = csq[None] - 2.0 * torch.einsum("nmd,mvd->nmv", Xs, cb)
        out[a:a + step] = torch.argmin(d2, dim=-1).to(torch.uint8)
    return out


def decode(codec: Codec, codes: torch.Tensor) -> torch.Tensor:
    """u8 codes (n, code_width) -> reconstructed f32 rows (n, d)."""
    if codec.kind == "int8":
        return codec.zero[None, :] + codec.scale[None, :] * codes.float()
    m = torch.arange(codec.nsub, device=codes.device)
    return codec.codebook[m, codes.long()].reshape(codes.shape[0], -1)


def pack_codes(codec: Codec, vecs: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode a slab: (codes (n, M) u8, vnorm (n,) f32).

    ``vnorm[i] = ||decode(codes[i])||²``, the reconstruction's own norm, so
    a scan's partials are exact distances to the reconstructions.
    """
    codes = encode(codec, vecs)
    vnorm = torch.empty((codes.shape[0],), device=codes.device)
    starts, step = _chunks(codes.shape[0], vecs.shape[1])
    for a in starts:
        rec = decode(codec, codes[a:a + step])
        vnorm[a:a + step] = (rec * rec).sum(-1)
    return codes, vnorm


def build_lut(codec: Codec, Q: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query table: (lut (q, M, W), qconst (q,)) with
    ``part = vnorm + sum_m lut[m, c[m]] + qconst``.

    ``qconst`` is the term that is the same for every candidate of a query
    (int8's ``-2 q . zero``; zero for pq), so the scan never sees it.
    """
    Q = Q.float()
    if codec.kind == "int8":
        lut = (-2.0 * Q * codec.scale[None, :])[:, :, None]
        return lut.contiguous(), -2.0 * (Q @ codec.zero)
    Qs = Q.reshape(Q.shape[0], codec.nsub, codec.dsub)
    lut = -2.0 * torch.einsum("qmd,mvd->qmv", Qs, codec.codebook)
    return lut.contiguous(), torch.zeros((Q.shape[0],), device=Q.device)


def bytes_per_row(codec: Union[Codec, str], d: int) -> int:
    """Bytes a scan streams per candidate row (codes + vnorm, or f32)."""
    kind = codec if isinstance(codec, str) else codec.kind
    if kind == "f32":
        return 4 * d
    if kind == "int8":
        return d + 4
    if kind == "pq":
        if isinstance(codec, str):
            raise ValueError("pq bytes need the codec's nsub")
        return codec.nsub + 4
    raise ValueError(f"unknown codec kind: {kind!r}")
