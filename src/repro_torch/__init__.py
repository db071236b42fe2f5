"""PCDN in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package `repro` (the reference), module for module:
`data` -> `core` (losses, bundles, design matrices, problem, line searches,
the PCDN bundle step) -> `kernels` (CUDA sources, their ctypes binding and
plain PyTorch versions) -> `engine` (host loop, local backend) -> `launch`
(the solve CLI). It imports torch and numpy only, never jax or `repro`.

Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`; with no card they raise instead of falling back.
"""
