"""onebit_asr_tpu_torch — PyTorch/CUDA port of onebit_asr_tpu for NVIDIA Hopper.

The JAX package `onebit_asr_tpu` beside it is the reference; this package
imports none of it (nor JAX) and keeps its own copies of what it needs. It
mirrors the JAX package's layout and names. So far it serves packed-ternary
offline transcription (`python -m onebit_asr_tpu_torch.transcribe`), with the
two packed-ternary matrix products (csrc/ternary_matmul.cu) and, under
`fused_subsampler`, the fused conv subsampler (csrc/subsampler.cu) as CUDA
C++ kernels for sm_90a, built with nvcc at first use.
"""

__version__ = "0.1.0"

from onebit_asr_tpu_torch.utils.config import (  # noqa: F401
    FrontendConfig,
    ModelConfig,
    SpecialTokens,
    TrainConfig,
)
