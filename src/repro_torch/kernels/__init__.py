"""Kernel registry, the CUDA kernel build and the kernels of the serving path."""
