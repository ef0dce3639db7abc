"""CTC decoding and error rates."""

from onebit_asr_tpu_torch.decode.greedy import greedy_ctc_decode  # noqa: F401
from onebit_asr_tpu_torch.decode.wer import compute_cer, compute_wer  # noqa: F401
