"""CTC decoding (greedy on the device, prefix beam search) and error rates."""

from onebit_asr_tpu_torch.decode.greedy import greedy_ctc_decode  # noqa: F401
from onebit_asr_tpu_torch.decode.beam import ctc_beam_search_batch  # noqa: F401
from onebit_asr_tpu_torch.decode.wer import (  # noqa: F401
    compute_cer,
    compute_wer,
    levenshtein_distance,
)
