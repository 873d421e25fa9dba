"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels build at first
use) and skips without one; the decision is taken inside each test.  This
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: scores within 1e-5·``ref.score_scale`` element by element (the
size of the terms that cancel in each score); distances rtol 1e-5 +
1e-6·max squared norm; ids exact.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc there)")
    return torch.device("cuda")


def _gs_case(B, d, k, C, seed, dev, empty=3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, d, generator=g)
    D = torch.randn(k, d, generator=g) * 5
    cnt = torch.randint(1, 9, (k,), generator=g).float()
    cnt[:empty] = 0.0
    u = torch.randint(0, k, (B,), generator=g, dtype=torch.int32)
    cand = torch.randint(0, k, (B, C), generator=g, dtype=torch.int32)
    return [t.to(dev) for t in (x, u, cand, D, cnt)]


def _rm_case(B, d, C, kappa, N, seed, dev, integer=False):
    g = torch.Generator().manual_seed(seed)
    if integer:        # integer coordinates: exact distances, many ties
        Xsrc = torch.randint(0, 3, (N, d), generator=g).float()
        x = torch.randint(0, 3, (B, d), generator=g).float()
    else:
        Xsrc = torch.randn(N, d, generator=g)
        x = torch.randn(B, d, generator=g)
    rows = torch.randint(0, N, (B, C), generator=g, dtype=torch.int32)
    cand = torch.where(torch.rand(B, C, generator=g) < 0.2, -1, rows)
    cand[:, 1] = cand[:, 0]
    old_ids = torch.randint(0, N, (B, kappa), generator=g, dtype=torch.int32)
    old_ids[:, -2:] = -1
    old_d = torch.sort(torch.rand(B, kappa, generator=g) * 40, 1).values
    old_d[:, -2:] = float("inf")
    if integer:
        old_d = old_d.round()
    return [t.contiguous().to(dev) for t in
            (x, rows, cand.to(torch.int32), old_ids, old_d, Xsrc)]


def _assert_scores(got, want, args, mode):
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(got[~fin], want[~fin])
    limit = 1e-5 * ref.score_scale(*args, mode=mode)
    ratio = float(((got - want).abs() / limit)[fin].max())
    assert ratio <= 1.0, ratio


def _assert_refine(got, want, x, Xsrc):
    gi, gd = got
    wi, wd = want
    assert torch.equal(gi, wi)
    scale = float((x * x).sum(1).max()) + float((Xsrc * Xsrc).sum(1).max())
    fin = torch.isfinite(wd)
    assert torch.equal(torch.isfinite(gd), fin)
    assert bool(((gd[fin] - wd[fin]).abs()
                 <= 1e-5 * wd[fin].abs() + 1e-6 * scale).all())


@pytest.mark.parametrize("mode", ["bkm", "lloyd"])
@pytest.mark.parametrize("d", [128, 100, 37, 1100])
def test_gather_score_kernel_matches_plain(dev, mode, d):
    args = _gs_case(257, d, 64, 11, d, dev)
    before = _build.launch_counts["gather_score"]
    got = ops.gather_score(*args, mode=mode)
    want = ops.gather_score(*args, mode=mode, force="ref")
    torch.cuda.synchronize()
    assert _build.launch_counts["gather_score"] == before + 1
    _assert_scores(got, want, args, mode)


@pytest.mark.parametrize("d,C,kappa", [(128, 136, 50), (37, 9, 12),
                                       (960, 40, 64), (1100, 5, 3)])
def test_refine_merge_kernel_matches_plain(dev, d, C, kappa):
    args = _rm_case(129, d, C, kappa, 2000, d + C, dev)
    before = _build.launch_counts["refine_merge"]
    got = ops.refine_merge(*args)
    want = ops.refine_merge(*args, force="ref")
    torch.cuda.synchronize()
    assert _build.launch_counts["refine_merge"] == before + 1
    _assert_refine(got, want, args[0], args[-1])


def test_refine_merge_kernel_ties_exact(dev):
    """Integer data: every distance is exact and ties are everywhere, so the
    first-minimum rule and the dedupe decide, bit for bit."""
    args = _rm_case(200, 16, 40, 20, 300, 7, dev, integer=True)
    gi, gd = ops.refine_merge(*args)
    wi, wd = ops.refine_merge(*args, force="ref")
    torch.cuda.synchronize()
    assert torch.equal(gi, wi) and torch.equal(gd, wd)


def test_gk_means_kernels_match_ref_on_card(dev):
    from repro_torch.core.gkmeans import gk_means
    from repro_torch.data import gmm_blobs
    X = gmm_blobs(4096, 32, 64, generator=torch.Generator(dev).manual_seed(1))
    out = []
    for force in (None, "ref"):
        out.append(gk_means(X, 64, kappa=16, xi=32, tau=3, iters=8,
                            generator=torch.Generator().manual_seed(0),
                            force=force, device=dev))
    a, b = out
    assert abs(a.distortion - b.distortion) <= 0.01 * b.distortion
    assert np.isfinite(a.history).all()
