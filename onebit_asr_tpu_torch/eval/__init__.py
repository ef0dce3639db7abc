"""Multi-precision evaluation: loss and WER at 32, 2 and 1 bits."""

from onebit_asr_tpu_torch.eval.evaluate import build_eval_steps, evaluate_stream  # noqa: F401
