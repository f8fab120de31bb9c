"""Fleet execution on one host: sharded SpMM dispatch, slot placement of
partition plans and hot-plan replication.

* :mod:`repro_torch.distributed.shard_spmm` — feature sharding (column
  split, no cross-slot sums) and block sharding (round-robin blocks, the
  partials summed in slot order) over a slot list from
  :func:`repro_torch.launch.mesh.graph_mesh`, each slot on the kernel its
  share routes to;
* :mod:`repro_torch.distributed.placement` — :class:`FleetPlanCache`,
  per-slot ``PlanCache`` shards behind consistent-hash + load-aware
  placement;
* :mod:`repro_torch.distributed.replication` — :class:`ReplicaManager`,
  EWMA request rates driving hot-plan replica promotion/demotion.

The serving entry point is :class:`repro_torch.serve.fleet.FleetGraphEngine`.
The placement directory, the multi-host plane and ``FrontierExchange``
follow in a later slice.
"""
from .placement import ConsistentHashRing, FleetPlanCache
from .replication import EwmaRate, ReplicaManager
from .shard_spmm import (
    prepare_block_shards,
    prepare_feature_shards,
    round_robin_block_order,
    spmm_block_sharded,
    spmm_feature_sharded,
)

__all__ = [
    "ConsistentHashRing",
    "EwmaRate",
    "FleetPlanCache",
    "ReplicaManager",
    "prepare_block_shards",
    "prepare_feature_shards",
    "round_robin_block_order",
    "spmm_block_sharded",
    "spmm_feature_sharded",
]
