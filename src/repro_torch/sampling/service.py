"""SamplingService: sampled GCN inference through the serving engine.

The bridge between the store/sampler layers and the plan-cache/SpMM
serving path. Per seed batch:

1. the k-hop frontier is sampled (or found in the frontier LRU — seed
   batches recur heavily in production streams, so the sampled frontier
   AND its partition plans amortize);
2. every hop's induced bipartite block registers with the engine under a
   CONTENT-derived id (:meth:`GraphServeEngine.register_subgraph`), so
   identical frontiers — across batches, callers, or service restarts —
   partition exactly once;
3. inference runs the blocks outermost-first through
   ``engine.submit()``: each hop is one batched-SpMM dispatch, fused by
   the engine with whatever else is in flight; the final hop uses the
   gather epilogue (:meth:`GraphServeEngine.submit_gather`) to return
   per-seed rows only.

Liveness: the service subscribes to the store's delta feed. A delta whose
touched aggregation rows intersect a cached frontier's receptive field
either RIDES THE REPAIR PATH — for full-fanout frontiers whose id maps
can express every changed edge, the delta is relabeled per block and
routed through ``engine.mutate()``, incrementally repairing the cached
plans — or, when the change cannot be expressed (capped fanout, or an
insert from a node outside the frontier), the entry is dropped and
resampled on next use. Either way the service never serves a stale
frontier. Untouched frontiers are untouched.

Sampling and the frontier bookkeeping stay on the host (numpy); the
features of a call go to the engine's device once, and every hop's dense
product (``torch.matmul``) and aggregation (the engine's dispatch: K1, K2
or K3 on the card) runs there. Answers are tensors on the engine's device.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.plan_repair import EdgeDelta
from .sampler import Frontier, sample_frontier

__all__ = ["SamplingService"]


def _intersects(a: np.ndarray, b: np.ndarray) -> bool:
    """Do two sorted-unique id arrays share an element?"""
    if len(a) == 0 or len(b) == 0:
        return False
    idx = np.searchsorted(b, a)
    idx = np.clip(idx, 0, len(b) - 1)
    return bool((b[idx] == a).any())


def _gather_inputs(x, nodes: np.ndarray,
                   device: torch.device) -> torch.Tensor:
    """``x[nodes]`` as fp32 on ``device``: a host array is indexed on the
    host and copied once; a tensor is indexed where it lives."""
    if isinstance(x, torch.Tensor):
        idx = torch.as_tensor(nodes, dtype=torch.int64, device=x.device)
        return x[idx].to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, dtype=np.float32)[nodes])).to(device)


def _member(sorted_ids: np.ndarray, nodes: np.ndarray) -> np.ndarray:
    """Membership mask of ``nodes`` in a sorted-unique id array."""
    if len(sorted_ids) == 0:
        return np.zeros(len(nodes), dtype=bool)
    idx = np.clip(np.searchsorted(sorted_ids, nodes), 0,
                  len(sorted_ids) - 1)
    return sorted_ids[idx] == nodes


class SamplingService:
    """Serve seed-node batches of ONE huge graph by sampled inference.

    ``sampler`` is anything with the store's ``sample_in_neighbors``
    signature: a :class:`~repro_torch.sampling.store.GraphStore`, a
    :class:`~repro_torch.sampling.store.PartitionedStoreClient` routing remote
    hops over the peer data plane, or a test double. When it exposes
    ``add_listener`` (the local store case), the service subscribes for
    frontier invalidation; a partitioned client's LOCAL shard can be
    passed as ``store=`` to get the same liveness.

    ``fanouts[k]`` caps hop k (``None`` = all in-edges). The frontier LRU
    holds ``max_cached_frontiers`` entries keyed by the SET of seed nodes
    (order-insensitive — per-call seed order is restored by the gather
    epilogue), the fanout spec and the sampling seed.
    """

    def __init__(self, engine, sampler, fanouts: Sequence[Optional[int]],
                 *, sample_seed: int = 0, replace: bool = False,
                 max_cached_frontiers: int = 64,
                 store=None):
        if not len(fanouts):
            raise ValueError("need at least one hop")
        self.engine = engine
        self.sampler = sampler
        self.fanouts = tuple(fanouts)
        self.sample_seed = int(sample_seed)
        self.replace = bool(replace)
        self.max_cached_frontiers = int(max_cached_frontiers)
        # key -> {"frontier": Frontier, "gids": [gid per block]}
        self._cache: "OrderedDict[tuple, Dict]" = OrderedDict()
        self._lock = threading.Lock()
        self.frontier_hits = 0
        self.frontier_misses = 0
        self.frontiers_evicted = 0
        self.frontiers_invalidated = 0
        self.frontier_mutations = 0
        self.sampled_edges = 0
        listen_on = store if store is not None else sampler
        if hasattr(listen_on, "add_listener"):
            listen_on.add_listener(self._on_delta)

    # ------------------------------------------------------------- frontier
    def _key(self, seed_set: np.ndarray) -> tuple:
        return (seed_set.tobytes(), self.fanouts, self.replace,
                self.sample_seed)

    def frontier_for(self, seeds: np.ndarray) -> Frontier:
        """The (cached) frontier serving this seed batch. Public so
        benchmarks/tests can inspect layer sizes and content keys."""
        return self._lookup(np.asarray(seeds, dtype=np.int64))["frontier"]

    def _lookup(self, seeds: np.ndarray) -> Dict:
        seed_set = np.unique(seeds)
        key = self._key(seed_set)
        with self._lock:
            entry = self._cache.get(key)
            if entry is not None:
                self._cache.move_to_end(key)
                self.frontier_hits += 1
                return entry
            self.frontier_misses += 1
        # sample outside the lock: slow, touches the (possibly remote)
        # store; a racing duplicate miss just re-registers idempotently
        frontier = sample_frontier(
            self.sampler.sample_in_neighbors, seed_set, self.fanouts,
            seed=self.sample_seed, replace=self.replace)
        gids = [self.engine.register_subgraph(b.graph, prefix="frontier")
                for b in frontier.blocks]
        entry = {"frontier": frontier, "gids": gids}
        evicted: List[Dict] = []
        with self._lock:
            self.sampled_edges += sum(b.n_edges for b in frontier.blocks)
            self._cache[key] = entry
            self._cache.move_to_end(key)
            while len(self._cache) > self.max_cached_frontiers:
                _, old = self._cache.popitem(last=False)
                evicted.append(old)
                self.frontiers_evicted += 1
            live = {g for e in self._cache.values() for g in e["gids"]}
        for old in evicted:
            for gid in old["gids"]:
                if gid not in live:   # content-derived ids can be shared
                    self.engine.unregister_graph(gid)
        return entry

    # ------------------------------------------------------------ inference
    def aggregate(self, seeds: np.ndarray, x) -> torch.Tensor:
        """Pure k-hop aggregation (no weights): ``(A'^k x)[seeds]`` under
        full fanout, its sampled estimate otherwise. One engine dispatch
        per hop, outermost block first; the last hop gathers seed rows.
        ``x`` (``[n_nodes, F]``, a numpy array or a tensor) is gathered at
        the frontier's input nodes and sent to the engine's device once.
        """
        seeds = np.asarray(seeds, dtype=np.int64)
        entry = self._lookup(seeds)
        frontier: Frontier = entry["frontier"]
        h = _gather_inputs(x, frontier.input_nodes, self.engine.device)
        for k in range(frontier.num_hops - 1, 0, -1):
            h = self.engine.submit(entry["gids"][k], h).result()
        rows = np.searchsorted(frontier.layers[0], seeds)
        return self.engine.submit_gather(
            entry["gids"][0], h, rows).result()

    def infer(self, seeds: np.ndarray, x, params: List[Dict],
              *, act=torch.relu) -> torch.Tensor:
        """Sampled GCN forward pass, mirroring the full-graph layer
        semantics exactly (``h = aggr(h @ W) + b``, activation between
        layers; ``params[i]["w"]`` and ``["b"]`` are tensors on the
        engine's device): under full fanout the result equals running the
        full graph and gathering seed rows. ``len(params)`` must equal the
        hop count. Returns ``[len(seeds), out_dim]`` in the caller's seed
        order, on the engine's device.
        """
        seeds = np.asarray(seeds, dtype=np.int64)
        entry = self._lookup(seeds)
        frontier: Frontier = entry["frontier"]
        L = frontier.num_hops
        if len(params) != L:
            raise ValueError(f"{len(params)} layers for {L} sampled hops")
        rows = np.searchsorted(frontier.layers[0], seeds)
        h = _gather_inputs(x, frontier.input_nodes, self.engine.device)
        for i, p in enumerate(params):
            gid = entry["gids"][L - 1 - i]
            z = torch.matmul(h, p["w"])
            if i == L - 1:
                agg = self.engine.submit_gather(gid, z, rows).result()
            else:
                agg = self.engine.submit(gid, z).result()
            h = agg + p["b"]
            if i < L - 1:
                h = act(h)
        return h

    # ---------------------------------------------------------- invalidation
    def _on_delta(self, touched: np.ndarray, delta: EdgeDelta) -> None:
        """Store-delta hook: repair or drop every cached frontier whose
        receptive field the delta touches (see module docstring)."""
        with self._lock:
            items = list(self._cache.items())
        mutated_gids: set = set()
        for key, entry in items:
            frontier: Frontier = entry["frontier"]
            # layers nest, so the union of all destination sets is the
            # second-outermost layer
            receptive = frontier.layers[frontier.num_hops - 1]
            if not _intersects(touched, receptive):
                continue
            if self._repairable(frontier, delta):
                self._mutate_entry(entry, delta, mutated_gids)
                with self._lock:
                    self.frontier_mutations += 1
            else:
                self._drop(key)

    def _repairable(self, frontier: Frontier, delta: EdgeDelta) -> bool:
        """Can every changed edge be expressed inside the cached frontier?

        Only full-fanout frontiers qualify (a capped frontier is a sample
        of the pre-delta graph; its edge set must be redrawn). An insert
        ``u -> v`` qualifies iff ``u`` already sits in the source layer of
        v's FIRST hop — then every deeper hop already aggregates u's own
        neighborhood (layers nest), so no cascade is needed. Deletes
        always qualify (a frontier can only lose edges it has).
        """
        if any(f is not None for f in self.fanouts):
            return False
        for u, v in zip(delta.insert_src, delta.insert_dst):
            for k in range(frontier.num_hops):
                if _member(frontier.layers[k], np.asarray([v]))[0]:
                    if not _member(frontier.layers[k + 1],
                                   np.asarray([u]))[0]:
                        return False
                    break
        return True

    def _mutate_entry(self, entry: Dict, delta: EdgeDelta,
                      mutated_gids: set) -> None:
        """Relabel the delta per block and route it through the
        ``engine.mutate()`` repair path; the cached block graphs advance
        in lockstep so later repairs see current content."""
        frontier: Frontier = entry["frontier"]
        for k, block in enumerate(frontier.blocks):
            local = self._localize(block, delta)
            if local is None:
                continue
            gid = entry["gids"][k]
            if gid not in mutated_gids:   # shared-content id: apply once
                mutated_gids.add(gid)
                self.engine.mutate(gid, local).result()
            block.graph = local.apply(block.graph)

    @staticmethod
    def _localize(block, delta: EdgeDelta) -> Optional[EdgeDelta]:
        """The delta in one block's local coordinates (aggregation rows =
        destinations), keeping only edges both id maps can express.
        Returns None when nothing translates."""
        def pick(src, dst):
            keep = (_member(block.dst_nodes, dst)
                    & _member(block.src_nodes, src))
            return (block.to_local_dst(dst[keep]),
                    block.to_local_src(src[keep]), keep)

        ins_r, ins_c, ins_keep = pick(delta.insert_src, delta.insert_dst)
        del_r, del_c, _ = pick(delta.delete_src, delta.delete_dst)
        if len(ins_r) == 0 and len(del_r) == 0:
            return None
        val = (delta.insert_val[ins_keep]
               if delta.insert_val is not None else None)
        # on_missing is forgiving here by design: an edge the frontier
        # never sampled simply isn't there to delete
        return EdgeDelta(insert_src=ins_r, insert_dst=ins_c,
                         insert_val=val, delete_src=del_r,
                         delete_dst=del_c,
                         on_duplicate=delta.on_duplicate,
                         on_missing="ignore")

    def _drop(self, key: tuple) -> None:
        with self._lock:
            entry = self._cache.pop(key, None)
            if entry is None:
                return
            self.frontiers_invalidated += 1
            live = {g for e in self._cache.values() for g in e["gids"]}
        for gid in entry["gids"]:
            if gid not in live:
                self.engine.unregister_graph(gid)

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict[str, float]:
        with self._lock:
            lookups = self.frontier_hits + self.frontier_misses
            return {
                "frontier_hits": self.frontier_hits,
                "frontier_misses": self.frontier_misses,
                "frontier_hit_rate": (self.frontier_hits / lookups
                                      if lookups else 0.0),
                "frontiers_cached": len(self._cache),
                "frontiers_evicted": self.frontiers_evicted,
                "frontiers_invalidated": self.frontiers_invalidated,
                "frontier_mutations": self.frontier_mutations,
                "sampled_edges": self.sampled_edges,
            }
