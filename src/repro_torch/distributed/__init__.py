"""Fleet execution: sharded SpMM dispatch, slot placement of partition
plans, hot-plan replication, and the multi-host layer above them.

* :mod:`repro_torch.distributed.shard_spmm` — feature sharding (column
  split, no cross-slot sums) and block sharding (round-robin blocks, the
  partials summed in slot order) over a slot list from
  :func:`repro_torch.launch.mesh.graph_mesh`, each slot on the kernel its
  share routes to; block sharding also over the GLOBAL slots of a
  multi-host fleet (the partials gathered over gloo, folded in global slot
  order);
* :mod:`repro_torch.distributed.placement` — :class:`FleetPlanCache`,
  per-slot ``PlanCache`` shards behind consistent-hash + load-aware
  placement;
* :mod:`repro_torch.distributed.directory` — :class:`PlacementDirectory`,
  the level above: ``plan_key -> (host, slot)`` across a multi-process
  fleet (consistent hash over every host's slots, epoch-stamped entries,
  stale-host eviction, replica sets, version chains);
* :mod:`repro_torch.distributed.replication` — :class:`ReplicaManager`,
  EWMA request rates driving hot-plan replica promotion/demotion;
* :mod:`repro_torch.distributed.multihost` — ``torch.distributed``
  rendezvous (gloo), the TCP forwarding data plane
  (:class:`PeerServer`/:class:`PeerClient`), :class:`FrontierExchange`
  (sampling's cross-partition hops) and the multi-process harness
  (:func:`run_fleet`).

The serving entry points sit in :mod:`repro_torch.serve.fleet`
(:class:`~repro_torch.serve.fleet.FleetGraphEngine` per host,
:class:`~repro_torch.serve.fleet.MultihostGraphEngine` across hosts). The
directory and the multi-host layer were ported in a later slice than the
single-host fleet.
"""
from .directory import HostInfo, Placement, PlacementDirectory
from .multihost import (
    FrontierExchange,
    MultihostContext,
    PeerClient,
    PeerServer,
    free_port,
    initialize_multihost,
    peer_ports,
    run_fleet,
)
from .placement import ConsistentHashRing, FleetPlanCache
from .replication import EwmaRate, ReplicaManager
from .shard_spmm import (
    commit_block_shards_global,
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
    "FrontierExchange",
    "HostInfo",
    "MultihostContext",
    "PeerClient",
    "PeerServer",
    "Placement",
    "PlacementDirectory",
    "ReplicaManager",
    "commit_block_shards_global",
    "free_port",
    "initialize_multihost",
    "peer_ports",
    "prepare_block_shards",
    "prepare_feature_shards",
    "round_robin_block_order",
    "run_fleet",
    "spmm_block_sharded",
    "spmm_feature_sharded",
]
