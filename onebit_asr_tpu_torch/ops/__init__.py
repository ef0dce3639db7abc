"""Kernels and tensor functions of the port: packed-ternary matrix products
and the fused conv subsampler (CUDA C++ for Hopper, csrc/), the weight
projection and the log-mel frontend."""
