"""Pallas kernels for the GPU (Triton route), interpreted on the CPU."""
