"""The mesh (data x expert x tensor), one process per GPU: the mesh record
and its groups, batch placement, the differentiable all-gather and the
gradient all-reduce, Megatron's copy / reduce functions, the tensor and
expert splits of the model, and optimizer-state sharding over the data
axis. Counterpart of `contrastors_tpu/parallel/`."""

from contrastors_tpu_torch.parallel.collectives import (  # noqa: F401
    all_gather_rows,
    all_reduce_grads,
    group_rank,
    group_size,
    reduce_metrics,
)
from contrastors_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    data_axis_size,
    divisor_chunk,
    make_mesh,
    replicate,
    shard_batch,
)
