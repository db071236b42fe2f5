"""Solver kernels of the port: CUDA sources (csrc/), their build and ctypes
binding (build.py), plain PyTorch versions (ref.py) and the dispatchers
(ops.py). Importing this package builds and loads nothing."""
