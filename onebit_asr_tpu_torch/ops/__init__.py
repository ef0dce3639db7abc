"""Kernels and tensor functions of the port: packed-ternary matrix products,
the fused conv subsampler, the fused rel-pos attention and the CTC lattices
(CUDA C++ for Hopper, csrc/), the weight quantizer and the log-mel frontend."""
