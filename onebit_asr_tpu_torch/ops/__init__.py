"""Kernels and tensor functions of the port: packed-ternary matrix products
(CUDA C++ for Hopper, csrc/), the weight projection and the log-mel frontend."""
