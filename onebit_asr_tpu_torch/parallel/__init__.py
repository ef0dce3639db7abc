"""Parallelism on torch.distributed: process meshes and data parallelism
(`mesh.py`), ZeRO-2 state sharding (`fsdp.py`), and the tensor-parallel
layout (`sharding_rules.py`)."""

from onebit_asr_tpu_torch.parallel.fsdp import (  # noqa: F401
    fsdp_state_specs,
    gather_state_fsdp,
    make_fsdp_train_step,
    shard_state_fsdp,
)
from onebit_asr_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    make_multislice_mesh,
    replicate,
    shard_batch,
)
from onebit_asr_tpu_torch.parallel.sharding_rules import (  # noqa: F401
    gather_state_tp,
    shard_params_tp,
    shard_state_tp,
    tp_param_shardings,
    tp_state_shardings,
)
