"""onebit_asr_tpu_torch — PyTorch/CUDA port of onebit_asr_tpu for NVIDIA Hopper.

The JAX package `onebit_asr_tpu` beside it is the reference; this package
imports none of it (nor JAX) and keeps its own copies of what it needs. It
mirrors the JAX package's layout and names. So far it serves packed-ternary
offline transcription (`python -m onebit_asr_tpu_torch.transcribe`), with the
two packed-ternary matrix products (csrc/ternary_matmul.cu), under
`fused_subsampler` the fused conv subsampler (csrc/subsampler.cu) and under
`fused_attention` the fused rel-pos attention (csrc/attention.cu), and it
trains the 3-branch QAT model (`python -m onebit_asr_tpu_torch.train`), with
the CTC alpha and beta lattices (csrc/ctc_lattice.cu) and, under
`fused_attention`, the fused attention's backward (csrc/attention_bwd.cu);
all are CUDA C++
kernels for sm_90a, built with nvcc at first use. It serves and evaluates
the runs it trains (`transcribe --checkpoint`, `python -m
onebit_asr_tpu_torch.eval`), packed or unpacked, greedy or with the prefix
beam on the device and an n-gram LM, and long recordings in windows. It
exports serving artifacts with `torch.export` (`export.py`, `python -m
onebit_asr_tpu_torch.cli.export`), which load and run without the model's
modules (one program per device: `--platforms cuda,cpu`), and streams them
behind `python -m onebit_asr_tpu_torch.serve`. It trains data-parallel,
with ZeRO-2, tensor-parallel or pipelined over `torch.distributed`
(`parallel/`).
"""

__version__ = "0.1.0"

from onebit_asr_tpu_torch.utils.config import (  # noqa: F401
    FrontendConfig,
    ModelConfig,
    SpecialTokens,
    TrainConfig,
)
