"""Serve GCN inference over a fleet of graphs through GraphServeEngine.

    PYTHONPATH=src python -m repro_torch.examples.serve_gcn --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_gcn

Several distinct graphs, repeated inference traffic: every layer's
aggregation A'.(XW) for ALL graphs in flight goes through ONE fused
multi-graph SpMM dispatch (``--backend``, K1 by default, on ``--device``,
``cuda`` by default); partition plans are built once per graph and then
always hit the cache. The engine's answer is checked against the direct
single-graph ``GraphOp`` path.

Then: N caller threads submit single requests (``engine.submit ->
Future``) and the background scheduler coalesces them into fused
cross-caller dispatches; a batched edge delta through ``mutate()``; and
the online partition autotuner — ``tuner=PlanTuner(...)`` at engine
construction, so hot graphs get their partition config searched in the
background. A fraction of live dispatches is duplicated onto candidate
plans OFF the critical path (reads always answer from the incumbent; on
the card the shadows run on a stream of their own), and a candidate that
wins a streak of paired shadow measurements is promoted through the plan
version chain. ``tune_offline`` is the same search as a one-shot ranking.
"""
from __future__ import annotations

import argparse
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.graph import gcn_normalize
from ..core.plan_cache import PartitionConfig, resolve_device
from ..core.plan_repair import EdgeDelta
from ..data.graphs import make_power_law_graph, node_features
from ..models.gcn import GraphOp
from ..models.layers import dense_init
from ..serve.graph_engine import GraphRequest, GraphServeEngine
from ..tuning import PlanTuner, tune_offline


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graphs", type=int, default=4)
    ap.add_argument("--nodes", type=int, default=600)
    ap.add_argument("--edges", type=int, default=3600)
    ap.add_argument("--dims", type=int, nargs="+", default=[32, 64, 16])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="accel")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # tuner quickstart, part 1: attach a PlanTuner and any graph whose
    # request rate crosses hot_rate gets shadow-tuned in the background
    tuner = PlanTuner(hot_rate=5.0, shadow_fraction=0.5, win_streak=2,
                      min_improvement=0.01, max_trials=4)
    engine = GraphServeEngine(device=dev, config=PartitionConfig(),
                              tuner=tuner, backend=args.backend,
                              max_graphs_per_batch=4)
    graphs = {}
    for i in range(args.graphs):
        gid = f"g{i}"
        g = gcn_normalize(make_power_law_graph(
            args.nodes + 37 * i, args.edges + 101 * i, seed=i))
        engine.register_graph(gid, g)
        graphs[gid] = g
    print(f"[serve_gcn] registered {args.graphs} graphs on {dev} "
          f"({args.backend}); cache builds={engine.cache.builds}")

    # one shared GCN weight stack (dims[0] -> ... -> dims[-1])
    gen = torch.Generator().manual_seed(0)
    weights = [dense_init(gen, a, b, torch.float32, device=dev)
               for a, b in zip(args.dims[:-1], args.dims[1:])]

    def engine_forward(feats):  # {gid: [N, F]} -> logits per graph
        h = dict(feats)
        for li, w in enumerate(weights):
            reqs = [GraphRequest(gid, h[gid] @ w) for gid in h]
            for r in engine.serve(reqs):
                h[r.graph_id] = (torch.relu(r.out)
                                 if li < len(weights) - 1 else r.out)
        return h

    feats = {gid: torch.from_numpy(node_features(g.n_rows, args.dims[0],
                                                 seed=i)).to(dev)
             for i, (gid, g) in enumerate(graphs.items())}

    t0 = time.perf_counter()
    for _rnd in range(args.rounds):
        logits = engine_forward(feats)
    dt = time.perf_counter() - t0

    # cross-check one graph against the direct (unbatched) operator path
    gid0 = next(iter(graphs))
    aggr = GraphOp.build(graphs[gid0], backend=args.backend,
                         plan_cache=engine.cache)
    h = feats[gid0]
    for li, w in enumerate(weights):
        h = aggr(h @ w)
        if li < len(weights) - 1:
            h = torch.relu(h)
    err = float((h - logits[gid0]).abs().max())
    assert err < 1e-3, f"engine vs direct mismatch: {err}"

    st = engine.stats()
    print(f"[serve_gcn] {args.rounds} rounds x {len(weights)} layers x "
          f"{args.graphs} graphs in {dt:.2f}s")
    print(f"[serve_gcn] batches={st['batches_dispatched']} "
          f"requests={st['requests_served']} "
          f"requests/batch={st['requests_per_batch']:.1f} "
          f"rows/s={st['rows_per_s']:.3g}")
    print(f"[serve_gcn] plan cache: builds={st['cache_builds']} "
          f"hits={st['cache_hits']} hit_rate={st['cache_hit_rate']:.3f} "
          f"(partitioned each graph exactly once)")
    print(f"[serve_gcn] engine vs direct GraphOp max|err| = {err:.2e}  OK")

    # ---- concurrent submitters: cross-caller continuous batching ---------
    base_batches = engine.batches_dispatched
    base_graphs = engine.graphs_dispatched
    n_threads, per_thread = 4, 6

    def caller(t):
        futs = []
        for k in range(per_thread):
            gid = f"g{(t + k) % args.graphs}"
            futs.append(engine.submit(gid, feats[gid] @ weights[0]))
        for f in futs:
            f.result()

    threads = [threading.Thread(target=caller, args=(t,))
               for t in range(n_threads)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    dt = time.perf_counter() - t0
    d_batches = engine.batches_dispatched - base_batches
    d_graphs = engine.graphs_dispatched - base_graphs
    sst = engine.scheduler.stats()
    print(f"[serve_gcn] concurrent: {n_threads} threads x {per_thread} "
          f"submits in {dt:.2f}s -> {d_batches} fused dispatches "
          f"({d_graphs / max(d_batches, 1):.1f} graphs/dispatch, "
          f"flushes: size={sst['flush_size']:.0f} "
          f"deadline={sst['flush_deadline']:.0f}, "
          f"p99 latency {sst['p99_latency_s'] * 1e3:.1f}ms)")

    # ---- streaming edge updates: mutate() + incremental plan repair ------
    # A batched edge delta against a LIVE graph: deletes a few edges,
    # inserts a few (with weights), and publishes the repaired plan as the
    # next version of g0's chain — reads in flight keep the old version.
    g0 = graphs[gid0]
    rng = np.random.default_rng(0)
    eids = rng.choice(g0.nnz, 8, replace=False)
    rows = rng.integers(0, g0.n_rows, 8)
    delta = EdgeDelta(
        delete_src=np.searchsorted(g0.rowptr, eids, side="right") - 1,
        delete_dst=g0.colidx[eids],
        insert_src=rows, insert_dst=rng.integers(0, g0.n_cols, 8),
        insert_val=rng.random(8).astype(np.float32),
        on_duplicate="replace", on_missing="ignore")
    info = engine.mutate(gid0, delta).result()   # Future, like submit()
    y = engine.submit(gid0, feats[gid0]).result()  # serves the NEW version
    g1 = delta.apply(g0)
    ref = GraphOp.build(g1, backend="blocked", device=dev)(feats[gid0])
    merr = float((y - ref).abs().max())
    assert merr < 1e-3, f"post-mutation mismatch: {merr}"
    print(f"[serve_gcn] mutate: v{info['version']} published via "
          f"{'repair' if info['repaired'] else 'rebuild'} "
          f"({info['dirty_rows']} dirty rows), post-delta max|err| = "
          f"{merr:.2e}  OK")

    # ---- online partition autotuner quickstart ---------------------------
    # Part 2: a hot burst on one graph. The tuner duplicates every other
    # dispatch onto a candidate plan in a background worker (live answers
    # always come from the incumbent — shadows never touch the read path);
    # a candidate that wins 2 consecutive paired measurements by >= 1% is
    # published as the graph's next plan version.
    x_hot = feats[gid0] @ weights[0]
    for _ in range(60):
        engine.serve_one(gid0, x_hot)
        time.sleep(0.005)       # paced so shadows measure on an idle host
    ts = engine.stats()
    tuned = engine.plan_for(gid0).tuned
    print(f"[serve_gcn] tuner: {ts['shadow_dispatches']:.0f} shadow "
          f"measurements, {ts['shadow_skipped']:.0f} skipped (worker busy), "
          f"promotions={ts['tuned_promotions']:.0f}"
          + (f" -> '{tuned['label']}' now serving" if tuned else
             " (incumbent still best on this mix)"))
    # Part 3: the same search as a one-shot offline ranking
    off = tune_offline(graphs[gid0], feat_dim=8, repeats=1,
                       backend=args.backend, device=dev)
    best = off["best"]
    if best is not None:
        print(f"[serve_gcn] tune_offline: best candidate "
              f"'{best['label']}' at {best['speedup_vs_base']:.2f}x vs "
              f"the default config")
    engine.close()
    return {"err": err, "mutate_err": merr,
            "shadow_dispatches": ts["shadow_dispatches"],
            "tuned_promotions": ts["tuned_promotions"]}


if __name__ == "__main__":
    main()
