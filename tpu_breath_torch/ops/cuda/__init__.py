"""Wrappers of the hand-written CUDA kernels (sources in ../../csrc/).

Each wrapper module mirrors one file of tpu_breath/ops/pallas/ and holds:
the plain PyTorch version (used for CPU tensors only), the launch of the
kernel for CUDA tensors (no fallback), and a launch counter LAUNCHES.
"""
