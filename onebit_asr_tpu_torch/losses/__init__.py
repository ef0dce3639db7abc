"""Losses: CTC (on the lattice kernels), masked label-smoothed CE, KL distillation."""

from onebit_asr_tpu_torch.losses.attention import (  # noqa: F401
    att_ce_loss,
    kl_logits,
    make_att_targets,
)
from onebit_asr_tpu_torch.losses.ctc import ctc_loss  # noqa: F401
