"""The multi-process layer of the port (``ekf_slam_tpu/parallel``'s
counterpart on torch.distributed): meshes, the data-parallel ensemble,
the row-sharded covariance step and the capacity-sharded loop DB."""

from ekf_slam_tpu_torch.parallel.mesh import (Mesh, make_mesh, replicate,
                                              run_ensemble, shard_batch,
                                              spawn)

__all__ = ["Mesh", "make_mesh", "replicate", "run_ensemble", "shard_batch",
           "spawn"]
