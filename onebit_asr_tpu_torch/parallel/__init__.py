"""Parallelism on torch.distributed: process meshes and data parallelism
(`mesh.py`), and ZeRO-2 state sharding (`fsdp.py`)."""

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
