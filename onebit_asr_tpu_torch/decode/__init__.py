"""CTC decoding."""

from onebit_asr_tpu_torch.decode.greedy import greedy_ctc_decode  # noqa: F401
