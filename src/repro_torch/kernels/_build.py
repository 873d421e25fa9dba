"""Build the hand-written CUDA kernels with ``nvcc`` and load them by ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

into ``kernels/build/`` (git-ignored), at first use.  The file name carries a
hash of the sources and flags, so an edited kernel rebuilds and an unchanged
one loads at once; ``ptxas``'s register and spill report is kept beside it
as ``<name>-<hash>.log``.  ``build()`` starts one ``nvcc`` per source, all at
once, and waits for them: eight sources, eight kernels.
``csrc/common.cuh`` holds the helpers they share (warp sums, row loads, the
sorted top-k list of the scans, ``cp.async`` copies, and the merge pass of
the split kernels).  Nothing here runs at import: the CPU
tests import every module, on machines that may have no ``nvcc``.

Every wrapper launches through ``launch``, which names the launch
``repro_torch.kernels.<name>`` for a running profiler
(``obs.timing.kernel_scope``), makes the tensors' device current, takes its
current stream, raises on a failed launch and only then adds one to the
kernel's entry of ``launch_counts``.  The counts are
wrapper calls: the split kernels (``probe_centroids``,
``assign_centroids``, ``ivf_scan``, ``ivf_scan_adc``, ``ivf_scan_grouped``)
make one or two device launches per call (a partial
pass, and a merge pass when the split plan cuts the work into more than one
chunk).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

from repro_torch.obs.timing import kernel_scope

SOURCES = ("gather_score", "refine_merge", "centroid_assign",
           "assign_centroids", "ivf_scan", "ivf_scan_adc", "ivf_scan_grouped",
           "pairwise_sq")
KERNELS = ("gather_score", "refine_merge", "probe_centroids",
           "assign_centroids", "ivf_scan", "ivf_scan_adc", "ivf_scan_grouped",
           "pairwise_sq")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the default
    toolkit location; raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    h.update((CSRC / "common.cuh").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources that are not built yet, all in parallel.

    Returns {name: seconds} for the ones compiled (0.0 for cached ones).
    Raises with nvcc's output if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    secs: Dict[str, float] = {}
    for name in names:
        out = _target(name)
        if out.is_file():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       out, tmp, log, time.perf_counter())
    failed = []
    for name, (proc, out, tmp, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        secs[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, out)        # atomic: readers never see a partial
        else:
            failed.append(f"{name} (rc {rc}):\n"
                          f"{out.with_suffix('.log').read_text()}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs


def build_log(name: str) -> Optional[str]:
    """ptxas's report of the built source (registers, spills), if built
    here."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.is_file() else None


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of source ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device ``device_index`` (read once;
    the split plans size their grids by it)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def launch(name: str, fn, dev: torch.device, *args) -> None:
    """Launch kernel ``name`` through its C function ``fn`` on CUDA device
    ``dev``.

    The launch runs inside ``kernel_scope(name)`` (a profiler range while a
    profiler runs, else nothing).  ``dev`` is made current first (the C
    launchers' ``cudaFuncSetAttribute`` calls and launches act on the
    current device), then its current stream is taken and passed as
    ``fn``'s last argument.  A nonzero return code (a ``cudaError_t``, or -1
    for arguments the launcher refuses) raises ``RuntimeError``; only a
    launch that returned 0 is counted.
    """
    with kernel_scope(name), torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    launch_counts[name] += 1


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
                 dev: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    the CUDA device ``dev`` (the kernels take nothing else)."""
    if not t.is_cuda or t.device != dev:
        raise ValueError(f"{name}: expected a tensor on {dev}, got {t.device}"
                         " (CPU tensors dispatch to kernels.ref via ops)")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
