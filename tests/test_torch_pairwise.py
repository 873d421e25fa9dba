"""The port's ``pairwise_sq`` against the JAX package's, on the CPU.

(The CUDA kernel is held against the port's plain version on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.)

Inputs are made with numpy from a seed and fed to three functions: the JAX
oracle ``repro.kernels.ref.pairwise_sq``, the Pallas body in interpret mode
``repro.kernels.pairwise_topk.pairwise_sq(..., interpret=True)``, and the
port's ``ops.pairwise_sq`` on CPU tensors (its plain version).  Limit per
element: ``|got − want| <= 1e-5·|want| + 1e-5·(||x_i||² + ||x_j||²)`` — the
distance is a difference of terms of size ``||x_i||² + ||x_j||²``, and an
f32 sum of d products rounds by about √d·2⁻²⁴ of it in practice.  bf16
inputs are rounded once (both frameworks round to nearest even, checked
here) and both sides cast them to f32 identically, so bf16 is held to the
same limit.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import pairwise_topk as jpt
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them as fast and
    leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(B, m, d, seed, bf16):
    """(jax input, torch input, the f32 values both sides compute on)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((4, d)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 4, B * m)]
         + rng.standard_normal((B * m, d)).astype(np.float32))
    x = x.reshape(B, m, d)
    if not bf16:
        return jnp.asarray(x), torch.from_numpy(x), x
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xf = np.asarray(xj.astype(jnp.float32))
    np.testing.assert_array_equal(xf, xt.float().numpy())
    return xj, xt, xf


def _limit(xf, want):
    sq = (xf.astype(np.float64) ** 2).sum(-1)
    return RTOL * np.abs(want) + RTOL * (sq[:, :, None] + sq[:, None, :])


def _assert_close(got, want, xf):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    ratio = np.abs(got - want) / _limit(xf, want)
    assert float(ratio.max()) <= 1.0, float(ratio.max())


SHAPES = [(4, 32, 16), (2, 64, 128), (1, 128, 256), (8, 16, 8)]


@pytest.mark.parametrize("B,m,d", SHAPES)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_pairwise_sq_matches_jax_oracle_and_pallas(B, m, d, bf16):
    xj, xt, xf = _case(B, m, d, B * m + d, bf16)
    got = tops.pairwise_sq(xt)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, m, m)
    got = got.numpy()
    _assert_close(got, jref.pairwise_sq(xj), xf)
    _assert_close(got, jpt.pairwise_sq(xj, interpret=True), xf)
    _assert_close(got, jops.pairwise_sq(xj), xf)


def test_pairwise_sq_d_streaming_matches_pallas():
    """The Pallas body's feature-dim streaming (d > d_tile) against the
    port, which takes the whole d at once."""
    xj, xt, xf = _case(2, 32, 384, 0, False)
    got = tops.pairwise_sq(xt).numpy()
    _assert_close(got, jpt.pairwise_sq(xj, d_tile=128, interpret=True), xf)
    _assert_close(got, jref.pairwise_sq(xj), xf)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_pairwise_sq_nonnegative_and_symmetric(bf16):
    _, xt, xf = _case(3, 48, 40, 11, bf16)
    xt[1, 7] = xt[1, 3]                           # a duplicate row: distance 0
    xf = xt.float().numpy()
    got = tops.pairwise_sq(xt, force="ref")
    assert torch.equal(got, tref.pairwise_sq(xt))
    got = got.numpy()
    assert (got >= 0).all() and np.isfinite(got).all()
    ratio = np.abs(got - got.transpose(0, 2, 1)) / _limit(xf, got)
    assert float(ratio.max()) <= 1.0
    sq = (xf.astype(np.float64) ** 2).sum(-1)
    assert (np.diagonal(got, axis1=1, axis2=2) <= RTOL * 2 * sq).all()
    assert got[1, 7, 3] <= RTOL * 2 * sq[1, 3]


# ------------------------------------------------------- the kernel's plan
#
# The CUDA kernel (``csrc/pairwise_sq.cu``) runs one CTA per cluster and
# unordered pair of 64-row tiles, computes each element once and writes it
# to both of its places.  These tests hold its host-side map and its sums,
# emulated in torch, against the JAX package.

@pytest.mark.parametrize("nt", range(1, 9))
def test_tile_pair_map_enumerates_every_unordered_pair_once(nt):
    from repro_torch.kernels import pairwise_sq as kpw
    pairs = [kpw.tile_pair(p, nt) for p in range(kpw.pair_count(nt))]
    assert len(pairs) == nt * (nt + 1) // 2
    assert sorted(pairs) == [(i, j) for i in range(nt)
                             for j in range(i, nt)]
    assert all(0 <= i <= j < nt for i, j in pairs)


def _emulate_pairwise(xt: torch.Tensor) -> torch.Tensor:
    """The kernel's sums, emulated: each unordered pair (i <= j) once, then
    mirrored.  f32: four partial dots over the 4-feature chunks c with
    c % 4 == q, summed ((p0 + p1) + (p2 + p3)), the norms from the diagonal
    of those dots (a diagonal tile pair takes them from its diagonal
    blocks).  bf16: exact products summed in 16-feature k-steps in order,
    the norms summed in feature order.  D = max(n_i + n_j − 2·dot, 0)."""
    B, m, d = xt.shape
    x = xt.float()
    if xt.dtype == torch.bfloat16:
        dots = torch.zeros((B, m, m))
        for e in range(0, d, 16):
            s = x[..., e:e + 16]
            dots = dots + s @ s.mT
        sq = torch.zeros((B, m))
        for f in range(d):
            sq = sq + x[..., f] * x[..., f]
    else:
        chunk = torch.arange(d) // 4
        part = [torch.zeros((B, m, m)) for _ in range(4)]
        for q in range(4):
            s = x[..., chunk % 4 == q]
            part[q] = s @ s.mT
        dots = (part[0] + part[1]) + (part[2] + part[3])
        sq = torch.diagonal(dots, dim1=1, dim2=2)
    full = torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * dots, min=0.0)
    upper = torch.triu(torch.ones((m, m), dtype=torch.bool))
    tri = torch.where(upper, full, torch.zeros_like(full))
    return tri + torch.where(upper.T & ~upper, tri.mT, torch.zeros_like(full))


@pytest.mark.parametrize("B,m,d", [(3, 64, 128), (2, 48, 37), (1, 130, 64),
                                   (4, 16, 8)])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_pairwise_emulation_symmetric_and_close_to_jax(B, m, d, bf16):
    xj, xt, xf = _case(B, m, d, B * m + d + 7, bf16)
    got = _emulate_pairwise(xt)
    assert torch.equal(got, got.mT)                 # exactly symmetric
    assert bool((got >= 0).all())
    _assert_close(got.numpy(), jref.pairwise_sq(xj), xf)
