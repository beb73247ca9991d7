"""channelwise_tp kernels: plain versions, CUDA wrappers and autograd ops."""
