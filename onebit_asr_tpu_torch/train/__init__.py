"""Training: optimizer and schedule, train state, the 3-branch QAT step,
the no-QAT control step and the K-step form."""

from onebit_asr_tpu_torch.train.optim import AdamW, warmup_cosine_schedule  # noqa: F401
from onebit_asr_tpu_torch.train.state import TrainState, create_train_state  # noqa: F401
from onebit_asr_tpu_torch.train.step import (  # noqa: F401
    make_batch_loss,
    make_eval_step,
    make_fp32_train_step,
    make_multi_train_step,
    make_train_step,
    sample_sp_mask,
    stack_batches,
)
