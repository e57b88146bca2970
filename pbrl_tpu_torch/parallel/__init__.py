"""Data parallelism over ``torch.distributed`` (counterpart of
``pbrl_tpu/parallel``): one process per card, the env batch split into
contiguous rows across the ranks, the learner replicated."""

from pbrl_tpu_torch.parallel.distributed import (  # noqa: F401
    DistributedConfig,
    initialize_distributed,
    is_initialized,
    is_primary_host,
    process_count,
    shutdown,
)
from pbrl_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    make_mesh,
    mesh_of,
    shard_batch,
)
