"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), their
ctypes wrappers, plain PyTorch versions (``ref``) and dispatch (``ops``)."""
