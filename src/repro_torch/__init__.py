"""PyTorch + CUDA port of the CHIME serving stack (the JAX package
``repro`` is the reference it is held against).

The port keeps the reference's module names and public layouts —
(B, S, H, D) activations, (D, H, Dh) projection weights, the tiered
store dicts {"hot", "cold_q", "cold_scale", "writes"} and parameter
trees with the same leaf paths — so `bridge.params_from_jax` carries the
reference's own weights across and the tests compare like with like.

Every TPU Pallas kernel on the serving path is a hand-written Hopper
kernel under `kernels/` (CUDA C++ for sm_90a, built with nvcc at first
use and bound with ctypes). Each kernel wrapper launches its kernel for
CUDA tensors and runs its plain PyTorch twin only for CPU tensors, which
is how the CPU tests reach the same dispatch the card runs.

Importing this package never imports ``jax`` or ``repro``.
"""
