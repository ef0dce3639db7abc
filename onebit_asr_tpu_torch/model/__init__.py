"""Conformer CTC model, serving form (packed-ternary projections)."""

from onebit_asr_tpu_torch.model.asr import ConformerASR  # noqa: F401
from onebit_asr_tpu_torch.model.conformer import ConformerEncoder  # noqa: F401
from onebit_asr_tpu_torch.model.layers import QuantDense  # noqa: F401
