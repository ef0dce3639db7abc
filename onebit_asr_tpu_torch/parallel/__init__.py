"""Parallelism on torch.distributed: process meshes and data parallelism
(`mesh.py`), ZeRO-2 state sharding (`fsdp.py`), the tensor-parallel
layout (`sharding_rules.py`) and GPipe pipeline parallelism
(`pipeline.py`)."""

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
from onebit_asr_tpu_torch.parallel.pipeline import (  # noqa: F401
    gather_state_pipeline,
    make_pipeline_train_step,
    pipeline_state_specs,
    shard_state_pipeline,
)
from onebit_asr_tpu_torch.parallel.sharding_rules import (  # noqa: F401
    gather_state_tp,
    shard_params_tp,
    shard_state_tp,
    tp_param_shardings,
    tp_state_shardings,
)
