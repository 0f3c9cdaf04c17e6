"""Distributed layer: shard mesh, collective query scatter / top-k merge.

Realization of the reference's MPI prototype (C16, SURVEY.md §5.8).
"""

from gpann_tpu.dist.mesh import (
    DistributedIVF,
    DistributedServingEngine,
    shard_mesh,
    sharded_lloyd_round,
)

__all__ = [k for k in dir() if not k.startswith("_")]
