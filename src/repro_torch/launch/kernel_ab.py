"""Time this checkout's ``assign_centroids`` and ``pairwise_sq`` kernels
beside another commit's, on one card, in turns (other, this, this, other).

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C <dir>
    python -m repro_torch.launch.kernel_ab \\
        --other <dir>/src/repro_torch/kernels/csrc

The other commit's ``centroid_assign.cu`` (or ``assign_centroids.cu``, if it
has one) and ``pairwise_sq.cu`` are compiled with this checkout's nvcc flags
beside them.  An other assign launcher with the one-pass C interface
``(X, C, csq, xsq, out_i, out_d, n, k, d, stream)`` is called as such; one
with this checkout's interface gets this checkout's split plan.  Each side is
timed with CUDA events over back-to-back launches of its C launcher, the
norms computed once beforehand, at the shapes ``chip_smoke.py`` checks:
assign at n=10,000 and n=1,000,000 (k=16,384, d=128) and at PQ training's
1,010,000 x 16 (k=256); pairwise at SIFT1M's graph-build shape, VLAD10M's
width in f32 and bf16, GIST1M's width and m=128.  Prints one JSON line a
shape (ms per call for each side, and whether the two sides agree within
1e-5 of the terms that cancel) and the card's ``nvidia-smi`` line.  Needs a
CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from repro_torch import resolve_device
from repro_torch.data import sift_like
from repro_torch.kernels import _build
from repro_torch.kernels import assign_centroids as kac

ROUNDS = ("other", "this", "this", "other")


def _compile(src: Path) -> ctypes.CDLL:
    out = src.with_suffix(".ab.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _assign_caller(lib: ctypes.CDLL, one_pass: bool):
    f = lib.assign_centroids_launch
    f.restype = ctypes.c_int
    if one_pass:
        f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
    else:
        f.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]

    def call(X, C, csq, xsq, out_i, out_d, part_v, part_i):
        n, d = X.shape
        k = C.shape[0]
        ptrs = (X.data_ptr(), C.data_ptr(), csq.data_ptr(), xsq.data_ptr(),
                out_i.data_ptr(), out_d.data_ptr())
        if one_pass:
            rc = f(*ptrs, n, k, d, _stream())
        else:
            plan = kac.split_plan(n, k, _build.sm_count(X.device.index))
            rc = f(*ptrs, part_v.data_ptr(), part_i.data_ptr(), n, k, d,
                   plan.rows, plan.chunk, plan.splits, _stream())
        if rc != 0:
            raise RuntimeError(f"assign launch failed: {rc}")
    return call


def _pairwise_caller(lib: ctypes.CDLL):
    f = lib.pairwise_sq_launch
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]

    def call(Xb, out):
        B, m, d = Xb.shape
        rc = f(Xb.data_ptr(), out.data_ptr(), B, m, d,
               int(Xb.dtype == torch.bfloat16), _stream())
        if rc != 0:
            raise RuntimeError(f"pairwise launch failed: {rc}")
    return call


def _ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def _turns(calls, reps):
    """{side: [ms, ms]} timed in the order of ROUNDS."""
    times = {"other": [], "this": []}
    for side in ROUNDS:
        times[side].append(_ms(calls[side], reps))
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other commit's kernels/csrc directory")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    own = args.other / "assign_centroids.cu"
    assign_src = own if own.is_file() else args.other / "centroid_assign.cu"
    other = {"assign": _assign_caller(_compile(assign_src),
                                      one_pass=not own.is_file()),
             "pairwise": _pairwise_caller(
                 _compile(args.other / "pairwise_sq.cu"))}
    this = {"assign": _assign_caller(_build.library("assign_centroids"),
                                     one_pass=False),
            "pairwise": _pairwise_caller(_build.library("pairwise_sq"))}

    g = torch.Generator(device=dev).manual_seed(args.seed)
    X = sift_like(1_000_000, 128, 256, generator=g)
    C = X[torch.randperm(X.shape[0], generator=g, device=dev)[:16_384]]
    Q = X[:10_000] + 0.05 * torch.randn(10_000, 128, device=dev, generator=g)
    Xpq = torch.cat([X, Q])[:, :16].contiguous()
    Cpq = Xpq[torch.randperm(Xpq.shape[0], generator=g, device=dev)[:256]]
    for label, A, Ck, reps in (("assign n=10000 k=16384 d=128", Q, C, 20),
                               ("assign n=1000000 k=16384 d=128", X, C, 3),
                               ("assign n=1010000 k=256 d=16", Xpq,
                                Cpq.contiguous(), 20)):
        n, k = A.shape[0], Ck.shape[0]
        csq, xsq = (Ck * Ck).sum(-1), (A * A).sum(-1)
        outs = {s: (torch.empty(n, dtype=torch.int32, device=dev),
                    torch.empty(n, device=dev)) for s in ("other", "this")}
        part = (torch.empty((n, 64), device=dev),
                torch.empty((n, 64), dtype=torch.int32, device=dev))
        calls = {s: (lambda s=s: (other if s == "other" else this)["assign"](
            A, Ck, csq, xsq, *outs[s], *part)) for s in ("other", "this")}
        times = _turns(calls, reps)
        scale = xsq + csq[outs["other"][0].long()]
        agree = bool(((outs["this"][1] - outs["other"][1]).abs()
                      <= 1e-5 * scale).all())
        print(json.dumps({"shape": label, "ms": times,
                          "d2_agree_1e-5": agree}), flush=True)
    del Xpq, Cpq

    vlad = sift_like(2048 * 64, 512, 256, generator=g)
    gist = sift_like(1024 * 64, 960, 256, generator=g)
    shapes = {"sift1m B=15625 m=64 d=128": X.view(15_625, 64, 128),
              "vlad10m width B=2048 m=64 d=512 f32": vlad.view(2048, 64, 512),
              "vlad10m width bf16": vlad.view(2048, 64, 512).to(
                  torch.bfloat16),
              "gist1m width B=1024 m=64 d=960": gist.view(1024, 64, 960),
              "m=128 B=7812 d=128": X[:7812 * 128].view(7812, 128, 128)}
    for label, Xb in shapes.items():
        B, m, _ = Xb.shape
        outs = {s: torch.empty((B, m, m), device=dev)
                for s in ("other", "this")}
        calls = {s: (lambda s=s: (other if s == "other" else this)[
            "pairwise"](Xb, outs[s])) for s in ("other", "this")}
        times = _turns(calls, 20)
        sq = (Xb.float() ** 2).sum(-1)
        lim = 1e-5 * (sq[:, :, None] + sq[:, None, :])
        agree = bool(((outs["this"] - outs["other"]).abs() <= lim).all())
        print(json.dumps({"shape": f"pairwise {label}", "ms": times,
                          "agree_1e-5": agree}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
