"""symmetric_contraction kernels: plain versions, CUDA wrappers and autograd ops."""
