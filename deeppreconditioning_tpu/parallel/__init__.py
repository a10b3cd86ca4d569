"""Distributed execution: mesh partitioning, sharded SpMV, distributed PCG.

The reference is strictly single-GPU (SURVEY.md §2.4: no torch.distributed
anywhere; CUDA single-device asserted at data_set.py:53).  This package is
therefore new capability of this rebuild: scale the linear
system dimension across devices (row-partitioned SpMV + halo exchange +
psum'd CG scalars) and the training batch across devices (data parallelism),
all via jax.sharding.Mesh + shard_map so the same code runs on a virtual
CPU mesh in tests and on several GPUs in production.
"""

from deeppreconditioning_tpu.parallel.partition import (
    ShardedELL,
    shard_ell_rows,
)
from deeppreconditioning_tpu.parallel.pcg import (
    sharded_matvec,
    pcg_sharded,
)

__all__ = [
    "ShardedELL",
    "shard_ell_rows",
    "sharded_matvec",
    "pcg_sharded",
]
