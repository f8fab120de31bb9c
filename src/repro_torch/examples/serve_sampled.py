"""Serve seed-node batches of ONE giant evolving graph by sampled inference.

    PYTHONPATH=src python -m repro_torch.examples.serve_sampled --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_sampled

A single big graph lives in a :class:`GraphStore` (both adjacency
orientations, fed by streaming ``EdgeDelta``\\ s) and
:class:`SamplingService` answers per-seed-batch queries:

1. sample a k-hop frontier for the seed batch on the host (deterministic
   per ``(seed, hop, node)`` — the same seeds always draw the same
   frontier),
2. compact it into per-hop bipartite blocks and register them with the
   serving engine under CONTENT-derived ids (recurring frontiers
   partition exactly once),
3. run the GCN layers through the plan-cache/batched-SpMM path on
   ``--device`` (``cuda`` by default; ``--backend auto`` routes each hop
   to K1, K2 or K3), gathering only the seed rows at the end.

Under FULL fanout the sampled result equals running the whole graph: bit
for bit on the CPU, and on the card within the fp32 rounding bound of
:func:`gcn_bound` (split rows are summed with fp32 atomics in arrival
order there). Capped fanouts bound per-batch work no matter how big the
graph gets. The final sections stream edge deltas into the live store
(cached frontiers repair through ``engine.mutate()`` or drop — never
stale) and shard the store into two partitions with sampling routed by
ownership.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.graph import CSRGraph
from ..core.plan_cache import resolve_device
from ..core.plan_repair import EdgeDelta
from ..data.graphs import (
    make_power_law_graph, node_features, seed_batches, seed_splits,
)
from ..kernels.ref import csr_spmm_ref
from ..models.gcn import init_gcn
from ..sampling import (GraphStore, PartitionedStoreClient, SamplingService,
                        sample_frontier)
from ..serve import GraphServeEngine

U = 2.0 ** -24      # fp32 unit roundoff


def gcn_bound(g: CSRGraph, x: torch.Tensor, params: List[Dict],
              C: int) -> torch.Tensor:
    """Elementwise bound on the gap between two fp32 evaluations of the
    GCN ``h = A'(h W) + b`` (ReLU between layers) that differ only in
    summation order: ``2 u c M``, where ``M`` is the same forward pass on
    absolute values in fp64 and ``c`` sums, over the layers, the GEMM depth
    ``K``, the largest per-row depth of the slab SpMM ``min(deg, C) +
    ceil(deg / C) + 1`` and 1 for the bias. (ReLU and a row gather add no
    error; every term of the first-order bound scales with ``M``.)"""
    deg = np.diff(g.rowptr)
    k_spmm = int((np.minimum(deg, C) + -(-deg // C) + 1).max())
    m = x.double().abs()
    c = 0
    for p in params:
        m = csr_spmm_ref(g.rowptr, g.colidx, np.abs(g.values.astype(
            np.float64)), m @ p["w"].double().abs()) + p["b"].double().abs()
        c += int(p["w"].shape[0]) + k_spmm + 1
    return 2 * U * c * m


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=3000)
    ap.add_argument("--edges", type=int, default=18000)
    ap.add_argument("--dims", type=int, nargs="+", default=[32, 64, 16])
    ap.add_argument("--fanout", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="auto")
    args = ap.parse_args(argv)
    n = args.nodes
    dev = resolve_device(args.device)

    store = GraphStore.build(make_power_law_graph(n, args.edges, seed=0),
                             normalize=True)
    engine = GraphServeEngine(device=dev, backend=args.backend)
    x = node_features(n, args.dims[0], seed=1)
    params = init_gcn(torch.Generator().manual_seed(0), args.dims,
                      device=dev)
    n_hops = len(args.dims) - 1
    print(f"[serve_sampled] store: {store.n_nodes} nodes "
          f"{store.n_edges} edges (normalized, both orientations); "
          f"{args.backend} on {dev}")

    # ---- full fanout == the full graph ------------------------------------
    svc_full = SamplingService(engine, store, fanouts=[None] * n_hops,
                               store=store)
    engine.register_graph("full", store.in_adj)
    xd = torch.from_numpy(x).to(dev)
    h = xd
    for i, p in enumerate(params):
        h = engine.submit("full", h @ p["w"]).result() + p["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    seeds = np.random.default_rng(2).choice(n, 32, replace=False)
    out = svc_full.infer(seeds, x, params)
    want = h[torch.as_tensor(seeds, device=dev)]
    if dev.type == "cpu":
        assert torch.equal(out, want)
        how = "BIT-identical to"
    else:
        bound = gcn_bound(store.in_adj, xd, params,
                          engine.config.deg_bound)[
            torch.as_tensor(seeds, device=dev)]
        assert bool(((out.double() - want.double()).abs() <= bound).all())
        how = "within the fp32 summation bound of"
    f = svc_full.frontier_for(seeds)
    print(f"[serve_sampled] full fanout: frontier layers "
          f"{[len(l) for l in f.layers]} -> output {how} the full graph "
          f"on {len(seeds)} seeds  OK")

    # ---- capped fanout: bounded frontiers, recurring batches amortize ----
    svc = SamplingService(engine, store, fanouts=[args.fanout] * n_hops,
                          store=store)
    train, _val = seed_splits(n, [0.5, 0.2], seed=3)
    batches = [b for _, b in zip(range(8), seed_batches(
        train, args.batch_size, seed=4))]
    t0 = time.perf_counter()
    for _epoch in range(3):                 # epochs revisit the same batches
        for b in batches:
            svc.infer(b, x, params)
    dt = time.perf_counter() - t0
    st, est = svc.stats(), engine.stats()
    print(f"[serve_sampled] fanout={args.fanout}: "
          f"{3 * len(batches)} batches in {dt:.2f}s — frontier hit rate "
          f"{st['frontier_hit_rate']:.2f} ({st['frontier_misses']} sampled, "
          f"{st['frontier_hits']} reused), plan cache hit rate "
          f"{est['cache_hit_rate']:.2f}; dispatches resident "
          f"{est['routed_resident']}, windowed {est['routed_windowed']}, "
          f"hbm {est['routed_hbm']}")

    # ---- the graph is ALIVE: stream a delta into the store ---------------
    rng = np.random.default_rng(5)
    delta = EdgeDelta(insert_src=rng.integers(0, n, 4),
                      insert_dst=batches[0][:4],   # aimed at a cached
                      #                              frontier's seeds
                      insert_val=rng.random(4).astype(np.float32),
                      on_duplicate="replace")
    store.apply_delta(delta)                # both orientations + listeners
    st = svc.stats()
    print(f"[serve_sampled] delta applied (store v{store.version}): "
          f"{st['frontier_mutations']} cached frontiers repaired via "
          f"mutate(), {st['frontiers_invalidated']} dropped for resampling "
          f"— nothing stale survives")
    svc.infer(batches[0], x, params)        # serves the post-delta graph

    # ---- partition the store: sampling routed by node ownership ----------
    shards = store.partition(2)
    bounds = [s.node_range[0] for s in shards] + [n]
    # an in-process stand-in for the remote side
    remote = {1: shards[1].sample_in_neighbors}
    client = PartitionedStoreClient(shards[0], bounds, remote, 0)
    fp = sample_frontier(store.sample_in_neighbors, seeds,
                         [None] * n_hops, seed=0)   # monolithic reference
    fq = sample_frontier(client.sample_in_neighbors, seeds,
                         [None] * n_hops, seed=0)
    assert fq.content_key() == fp.content_key()
    print(f"[serve_sampled] partitioned store: {client.local_edges} local "
          f"+ {client.remote_edges} cross-partition edges sampled — "
          f"frontier identical to the monolithic store  OK")
    engine.close()
    return {"frontier_hit_rate": svc.stats()["frontier_hit_rate"],
            "frontier_mutations": st["frontier_mutations"],
            "frontiers_invalidated": st["frontiers_invalidated"]}


if __name__ == "__main__":
    main()
