"""GraphStore: ONE giant evolving graph behind the neighbor sampler.

The serving scenarios so far register many small-to-mid graphs; the
production GNN workload (recommendation, fraud, social) is a single huge
graph served by sampled inference. The store holds that graph in BOTH
orientations:

* ``out_adj`` — the edge-stream CSR (row ``u`` lists u's OUT-neighbors),
  the orientation :class:`~repro_torch.core.plan_repair.EdgeDelta` streams in;
* ``in_adj``  — :func:`~repro_torch.core.graph.csr_transpose` of it (row ``v``
  lists v's IN-neighbors), the orientation GCN aggregation reads and the
  sampler walks: sampling the k-hop receptive field of a seed means
  walking in-edges.

``apply_delta`` keeps the two views consistent (the delta applies directly
to ``out_adj`` and transposed to ``in_adj``) and notifies listeners with
the touched AGGREGATION rows — the hook the sampling service uses to
invalidate or mutate cached frontier plans instead of serving stale ones.

``partition(n_parts)`` splits the store into contiguous-node-range shards
for the fleet's hosts. Shards keep FULL-HEIGHT matrices (rows outside the
owned range are empty), so global node ids stay valid everywhere and a
cross-partition exchange never translates ids.

Sampling runs on the host in numpy, with one generator per sampled node
seeded ``[seed, hop, node]``: the same store, seeds and fanouts give the
same frontiers as the reference's store, bit for bit.
:class:`PartitionedStoreClient` takes any sampler callable per remote
shard: another shard's ``sample_in_neighbors`` in the same process, or
:class:`~repro_torch.distributed.multihost.FrontierExchange`'s sampler for
a shard on another host.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.graph import (
    CSRGraph, csr_transpose, gcn_normalize, _concat_ranges,
)
from ..core.plan_repair import EdgeDelta

__all__ = ["GraphStore", "PartitionedStoreClient", "SampleFn"]

# (nodes, fanout, seed, hop, replace) -> (src, dst, val); the shape every
# sampling backend shares: the local store method, a partition client, and
# a remote shard's sampler
SampleFn = Callable[..., Tuple[np.ndarray, np.ndarray, np.ndarray]]


def _sample_rows(rowptr: np.ndarray, colidx: np.ndarray,
                 values: np.ndarray, nodes: np.ndarray,
                 fanout: Optional[int], seed: int, hop: int,
                 replace: bool) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic per-node neighbor sampling over CSR rows.

    The rng for node ``v`` at hop ``k`` is ``default_rng([seed, k, v])`` —
    a pure function of (seed, hop, node), independent of batch composition
    and of which shard executes it, so a partitioned store samples
    bit-identically to the monolithic one and a numpy reference sampler
    can reproduce the service exactly. Chosen slots are sorted, keeping
    every row's edges in parent-CSR relative order (compaction stays
    stable). Nodes with degree <= fanout (without replacement) take ALL
    edges — full fanout (``fanout=None``) is the exact-aggregation path.
    """
    nodes = np.asarray(nodes, dtype=np.int64)
    starts, ends = rowptr[nodes], rowptr[nodes + 1]
    degs = ends - starts
    if fanout is None:
        total = int(degs.sum())
        idx = _concat_ranges(starts, degs, total)
        src = colidx[idx].astype(np.int64)
        dst = np.repeat(nodes, degs)
        return src, dst, values[idx]
    src_parts: List[np.ndarray] = []
    dst_parts: List[np.ndarray] = []
    val_parts: List[np.ndarray] = []
    for v, lo, d in zip(nodes, starts, degs):
        d = int(d)
        if d == 0:
            continue
        if not replace and d <= fanout:
            idx = np.arange(lo, lo + d)
        else:
            rng = np.random.default_rng([seed, hop, int(v)])
            idx = lo + np.sort(rng.choice(d, size=fanout, replace=replace))
        src_parts.append(colidx[idx].astype(np.int64))
        dst_parts.append(np.full(len(idx), v, dtype=np.int64))
        val_parts.append(values[idx])
    if not src_parts:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), np.zeros(0, dtype=np.float32)
    return (np.concatenate(src_parts), np.concatenate(dst_parts),
            np.concatenate(val_parts))


@dataclasses.dataclass
class GraphStore:
    """Both orientations of one (possibly sharded) graph + delta plumbing.

    ``node_range`` is the contiguous ``[lo, hi)`` range of aggregation
    rows this store owns. The monolithic store owns everything; shards
    from :meth:`partition` own their slice but keep full-height matrices.
    """

    out_adj: CSRGraph
    in_adj: CSRGraph
    node_range: Tuple[int, int]
    version: int = 0

    def __post_init__(self):
        self._listeners: List[Callable[[np.ndarray, EdgeDelta], None]] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------- building
    @classmethod
    def build(cls, g_out: CSRGraph, *, normalize: bool = False,
              add_self_loops: bool = True) -> "GraphStore":
        """Build from an edge-stream CSR (row u -> out-neighbors).

        With ``normalize=True`` the store holds the GCN-normalized
        operator: ``in_adj`` carries ``D^-1/2 (A+I) D^-1/2`` values (what
        aggregation dispatches), and ``out_adj`` is re-derived by
        transposing BACK so the two views stay exact mirrors — including
        the added self-loop edges.
        """
        in_adj = csr_transpose(g_out)
        if normalize:
            in_adj = gcn_normalize(in_adj, add_self_loops=add_self_loops)
        out_adj = csr_transpose(in_adj)
        return cls(out_adj=out_adj, in_adj=in_adj,
                   node_range=(0, in_adj.n_rows))

    @property
    def n_nodes(self) -> int:
        return self.in_adj.n_rows

    @property
    def n_edges(self) -> int:
        return self.in_adj.nnz

    def owns(self, nodes: np.ndarray) -> np.ndarray:
        lo, hi = self.node_range
        nodes = np.asarray(nodes)
        return (nodes >= lo) & (nodes < hi)

    def in_degrees(self, nodes: np.ndarray) -> np.ndarray:
        nodes = np.asarray(nodes, dtype=np.int64)
        return (self.in_adj.rowptr[nodes + 1]
                - self.in_adj.rowptr[nodes]).astype(np.int64)

    # ------------------------------------------------------------- sampling
    def sample_in_neighbors(self, nodes: np.ndarray,
                            fanout: Optional[int] = None, *,
                            seed: int = 0, hop: int = 0,
                            replace: bool = False
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sample up to ``fanout`` in-edges per node; returns the sampled
        COO triple ``(src, dst, val)`` grouped by ``dst`` in input-node
        order. Nodes outside this shard's owned range are a caller bug
        (they would silently sample an empty row) and raise.
        """
        nodes = np.asarray(nodes, dtype=np.int64)
        if len(nodes) and not self.owns(nodes).all():
            bad = nodes[~self.owns(nodes)][:5]
            raise ValueError(
                f"nodes {bad.tolist()} outside owned range "
                f"{self.node_range} — route via PartitionedStoreClient")
        a = self.in_adj
        return _sample_rows(a.rowptr, a.colidx, a.values, nodes,
                            fanout, seed, hop, replace)

    # ------------------------------------------------------------- mutation
    def add_listener(self, fn: Callable[[np.ndarray, EdgeDelta], None]
                     ) -> None:
        """``fn(touched_agg_rows, delta)`` runs after every applied delta
        (same thread, store already updated). The sampling service hangs
        its frontier invalidation here."""
        with self._lock:
            self._listeners.append(fn)

    def apply_delta(self, delta: EdgeDelta) -> int:
        """Apply an edge-stream delta (``u -> v`` orientation, exactly what
        engines' ``mutate()`` takes) to BOTH views and bump the version.

        The delta applies directly to ``out_adj`` and transposed to
        ``in_adj`` — the touched AGGREGATION rows are the delta's dst
        nodes, which is what listeners receive. Values ride verbatim (the
        streaming convention: a delta never re-normalizes).
        Returns the new version.
        """
        flipped = EdgeDelta(
            insert_src=delta.insert_dst, insert_dst=delta.insert_src,
            insert_val=delta.insert_val,
            delete_src=delta.delete_dst, delete_dst=delta.delete_src,
            on_duplicate=delta.on_duplicate, on_missing=delta.on_missing)
        with self._lock:
            # in_adj first: if the delta is invalid (strict policies), the
            # store is untouched; out_adj apply then cannot fail on policy
            self.in_adj = flipped.apply(self.in_adj)
            self.out_adj = delta.apply(self.out_adj)
            self.version += 1
            version = self.version
            listeners = list(self._listeners)
        touched = flipped.touched_rows()
        for fn in listeners:
            fn(touched, delta)
        return version

    # ---------------------------------------------------------- partitioning
    def partition(self, n_parts: int) -> List["GraphStore"]:
        """Contiguous-range shards, one per host: shard ``p`` owns rows
        ``[bounds[p], bounds[p+1])`` of ``in_adj``. Rows outside the range
        are EMPTY (full-height matrices), so global ids work unchanged on
        every shard and sampling an owned node returns bit-identical
        results to the monolithic store.
        """
        n = self.n_nodes
        bounds = np.linspace(0, n, n_parts + 1).astype(np.int64)
        shards = []
        for p in range(n_parts):
            lo, hi = int(bounds[p]), int(bounds[p + 1])
            in_shard = _slice_rows(self.in_adj, lo, hi)
            shards.append(GraphStore(
                out_adj=csr_transpose(in_shard), in_adj=in_shard,
                node_range=(lo, hi), version=self.version))
        return shards


def _slice_rows(g: CSRGraph, lo: int, hi: int) -> CSRGraph:
    """Full-height copy of ``g`` keeping only rows ``[lo, hi)``. O(E_kept).

    Row slices of a CSR are one contiguous nnz slice, so the new rowptr is
    a single clip-and-shift.
    """
    s, e = int(g.rowptr[lo]), int(g.rowptr[hi])
    rowptr = (np.clip(g.rowptr, s, e) - s).astype(np.int64)
    return CSRGraph(rowptr, g.colidx[s:e].copy(), g.values[s:e].copy(),
                    g.n_cols)


class PartitionedStoreClient:
    """Ownership-routed sampling over a partitioned store.

    One per querying host: samples nodes the local shard owns directly and
    sends each remote run to its owner's sampler (an in-process shard or a
    :class:`~repro_torch.distributed.multihost.FrontierExchange` channel —
    anything matching :data:`SampleFn`). Because node ranges are
    contiguous and ascending by rank, concatenating per-owner results in
    rank order restores the dst-grouped order of the monolithic store, and
    the deterministic per-(seed, hop, node) rng makes the merged result
    BIT-IDENTICAL to sampling the whole graph locally.
    """

    def __init__(self, local: GraphStore,
                 bounds: Sequence[int],
                 remote: "dict[int, SampleFn]",
                 local_rank: int):
        self.local = local
        self.bounds = np.asarray(bounds, dtype=np.int64)  # len n_parts + 1
        self.remote = dict(remote)
        self.local_rank = local_rank
        self.remote_edges = 0    # edges sampled on peers' shards
        self.local_edges = 0
        lo, hi = local.node_range
        if (int(self.bounds[local_rank]) != lo
                or int(self.bounds[local_rank + 1]) != hi):
            raise ValueError(f"local shard range {local.node_range} != "
                             f"bounds slot {local_rank}")

    @property
    def n_nodes(self) -> int:
        return self.local.n_nodes

    def owner_of(self, nodes: np.ndarray) -> np.ndarray:
        return (np.searchsorted(self.bounds, np.asarray(nodes),
                                side="right") - 1).astype(np.int64)

    def in_degrees(self, nodes: np.ndarray) -> np.ndarray:
        return self.local.in_degrees(nodes)

    def sample_in_neighbors(self, nodes: np.ndarray,
                            fanout: Optional[int] = None, *,
                            seed: int = 0, hop: int = 0,
                            replace: bool = False
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        nodes = np.asarray(nodes, dtype=np.int64)
        owners = self.owner_of(nodes)
        src_parts, dst_parts, val_parts = [], [], []
        # nodes arrive ascending (frontier layers are sorted-unique), so
        # owner runs are contiguous and rank order == dst order
        for rank in np.unique(owners):
            sub = nodes[owners == rank]
            if int(rank) == self.local_rank:
                s, d, v = self.local.sample_in_neighbors(
                    sub, fanout, seed=seed, hop=hop, replace=replace)
                self.local_edges += len(s)
            else:
                fn = self.remote.get(int(rank))
                if fn is None:
                    raise KeyError(f"no channel to shard owner {int(rank)}")
                s, d, v = fn(sub, fanout, seed=seed, hop=hop,
                             replace=replace)
                self.remote_edges += len(s)
            src_parts.append(np.asarray(s, dtype=np.int64))
            dst_parts.append(np.asarray(d, dtype=np.int64))
            val_parts.append(np.asarray(v, dtype=np.float32))
        if not src_parts:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), np.zeros(0, dtype=np.float32)
        return (np.concatenate(src_parts), np.concatenate(dst_parts),
                np.concatenate(val_parts))
