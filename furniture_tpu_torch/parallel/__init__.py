"""Data parallelism over several devices: one process a device, joined by
``torch.distributed``.

The port's counterpart of ``furniture_tpu.parallel``. The JAX package
shards a batch axis over a device mesh from one process; here each rank
steps its own rows of the batch (env lanes for PPO, samples for MPPI), and
the gradient and statistic reductions are ``all_reduce`` calls.
"""

from .mesh import (  # noqa: F401
    Mesh,
    broadcast_module,
    fold_seed,
    gather_batch,
    make_mesh,
    mpi_average,
    mpi_min,
    mpi_sum,
    shard_batch,
)
