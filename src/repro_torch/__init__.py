"""PyTorch/CUDA port of the GK-means system (``repro``) for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its module
layout and names.  It imports ``torch`` only — never ``jax`` or ``repro``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Kernels on the main path are hand-written CUDA C++ (``kernels/csrc``), built
with ``nvcc`` at first use; on CPU tensors ``kernels.ops`` dispatches to the
plain PyTorch versions in ``kernels.ref``.
"""
from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
