"""Seeded k-hop neighbor sampling + frontier -> induced-subgraph compaction.

A sampled frontier is the layered receptive field of a seed batch:

    layers[0]   sorted-unique seed nodes (global ids)
    layers[k+1] layers[k]  UNION  sampled in-neighbors of layers[k]
    blocks[k]   the bipartite aggregation graph for hop k:
                  rows    = layers[k]        (destinations)
                  columns = layers[k+1]      (sources)

Layers NEST (every destination is also a source of its own hop), so
self-loop edges from GCN normalization always translate, and feature
gathering needs only the outermost layer. A GCN layer ``l`` of an
``L``-layer model aggregates over ``blocks[L - l]`` — process the blocks
list in REVERSE, outermost first (see
:meth:`repro_torch.sampling.service.SamplingService.infer`).

Compaction is a stable relabel: block-local ids are positions in the
sorted-unique ``dst_nodes`` / ``src_nodes`` arrays (the inverse maps), so
``searchsorted`` translates global -> local and plain indexing translates
back. Rows keep the parent graph's within-row edge order (the sampler
sorts chosen slots; the relabel is order-preserving), which is what makes
full-fanout block aggregation BIT-identical to the full-graph SpMM.

Everything here is a pure function of (sampler backend, seeds, fanouts,
seed, replace): the same call is bit-deterministic across processes and
identical to the reference package's sampler, which the partitioned store
and the parity tests rely on.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.graph import CSRGraph

__all__ = ["FrontierBlock", "Frontier", "sample_frontier"]


@dataclasses.dataclass
class FrontierBlock:
    """One hop's induced bipartite subgraph, compacted to local ids."""

    graph: CSRGraph          # [len(dst_nodes), len(src_nodes)] local CSR
    dst_nodes: np.ndarray    # sorted-unique global ids; row i <-> dst_nodes[i]
    src_nodes: np.ndarray    # sorted-unique global ids; col j <-> src_nodes[j]

    def to_local_dst(self, nodes: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.dst_nodes, nodes)

    def to_local_src(self, nodes: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.src_nodes, nodes)

    @property
    def n_edges(self) -> int:
        return self.graph.nnz


@dataclasses.dataclass
class Frontier:
    """A sampled k-hop receptive field; ``blocks[k]`` aggregates hop k."""

    seeds: np.ndarray              # caller's seed batch, original order
    layers: List[np.ndarray]       # nested sorted-unique global id sets
    blocks: List[FrontierBlock]

    @property
    def num_hops(self) -> int:
        return len(self.blocks)

    @property
    def input_nodes(self) -> np.ndarray:
        """Global ids whose features feed the outermost hop."""
        return self.layers[-1]

    def seed_rows(self) -> np.ndarray:
        """Rows of the final (hop-0) output holding the caller's seeds,
        in the caller's original seed order."""
        return np.searchsorted(self.layers[0], self.seeds)

    def content_key(self) -> str:
        """Content hash over every block's arrays + id maps — two
        frontiers with equal keys induce identical computations."""
        h = hashlib.blake2b(digest_size=16)
        for b in self.blocks:
            for a in (b.graph.rowptr, b.graph.colidx, b.graph.values,
                      b.dst_nodes, b.src_nodes):
                h.update(np.ascontiguousarray(a).tobytes())
            h.update(str(b.graph.n_cols).encode())
        return h.hexdigest()


def _compact_block(dst_layer: np.ndarray, src_layer: np.ndarray,
                   src: np.ndarray, dst: np.ndarray,
                   val: np.ndarray) -> FrontierBlock:
    """Relabel a sampled COO triple into a local bipartite CSR.

    ``dst`` arrives grouped by destination in ``dst_layer`` order (the
    sampler contract) with within-row edges in parent-CSR order; counting
    rows per destination keeps both, so no sort happens here at all.
    """
    n_dst, n_src = len(dst_layer), len(src_layer)
    dst_local = np.searchsorted(dst_layer, dst)
    src_local = np.searchsorted(src_layer, src)
    counts = np.bincount(dst_local, minlength=n_dst)
    rowptr = np.zeros(n_dst + 1, dtype=np.int64)
    np.cumsum(counts, out=rowptr[1:])
    graph = CSRGraph(rowptr, src_local.astype(np.int64),
                     np.asarray(val, dtype=np.float32), n_cols=n_src)
    return FrontierBlock(graph=graph, dst_nodes=dst_layer,
                         src_nodes=src_layer)


def sample_frontier(sample_fn, seeds: np.ndarray,
                    fanouts: Sequence[Optional[int]], *, seed: int = 0,
                    replace: bool = False) -> Frontier:
    """Sample a ``len(fanouts)``-hop frontier for one seed batch.

    ``sample_fn`` is any :data:`~repro_torch.sampling.store.SampleFn` — the
    local store method, a :class:`PartitionedStoreClient`, or a test
    double. ``fanouts[k]`` caps hop k's per-node in-degree (``None`` =
    take every in-edge: exact aggregation). Hop k's rng derives from
    ``(seed, k, node)`` only, so the frontier is bit-deterministic in
    (seeds-as-a-set, fanouts, seed, replace).
    """
    seeds = np.asarray(seeds, dtype=np.int64)
    if seeds.ndim != 1 or len(seeds) == 0:
        raise ValueError("seeds must be a non-empty 1-D node-id array")
    layers = [np.unique(seeds)]
    sampled: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    for hop, fanout in enumerate(fanouts):
        src, dst, val = sample_fn(layers[hop], fanout, seed=seed,
                                  hop=hop, replace=replace)
        sampled.append((src, dst, val))
        layers.append(np.union1d(layers[hop], src))
    blocks = [_compact_block(layers[k], layers[k + 1], *sampled[k])
              for k in range(len(fanouts))]
    return Frontier(seeds=seeds, layers=layers, blocks=blocks)
