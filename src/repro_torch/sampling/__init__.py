"""Neighbor-sampling service over a partitioned graph store.

ONE huge evolving graph (:class:`GraphStore`, both adjacency orientations
+ the ``EdgeDelta`` feed), seeded k-hop frontier sampling with
induced-subgraph compaction (:func:`sample_frontier`), and
:class:`SamplingService`, which feeds the compacted frontiers through the
plan-cache/batched-SpMM serving path — sampled frontiers are exactly the
recurring small-graph workload the engine is already fast at.
``GraphStore.partition`` + :class:`PartitionedStoreClient` spread the
store over shards with sampling routed by node ownership.
"""
from .sampler import Frontier, FrontierBlock, sample_frontier
from .service import SamplingService
from .store import GraphStore, PartitionedStoreClient

__all__ = [
    "Frontier",
    "FrontierBlock",
    "GraphStore",
    "PartitionedStoreClient",
    "SamplingService",
    "sample_frontier",
]
