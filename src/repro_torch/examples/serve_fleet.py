"""Fleet serving demo: plan placement, per-slot dispatch, a block-sharded
giant graph.

    PYTHONPATH=src python -m repro_torch.examples.serve_fleet --device cpu --slots 8
    PYTHONPATH=src python -m repro_torch.examples.serve_fleet

The FleetGraphEngine places each registered graph's partition plan on one
slot (consistent hash + load-aware override), groups every flush by owning
slot, and launches the per-slot fused dispatches concurrently. A narrow
giant graph takes the block-sharded path instead — its partition blocks
deal round-robin across every slot and the partials sum back together.
``--device`` defaults to ``cuda`` (``--backend`` to ``accel``, K1);
``--slots`` defaults to one slot per visible card (one on the CPU), and
``--device cpu --slots 8`` is the reference's 8-device demo.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.graph import gcn_normalize
from ..core.plan_cache import resolve_device
from ..data.graphs import make_power_law_graph
from ..launch.mesh import graph_mesh
from ..serve.fleet import FleetGraphEngine
from ..serve.graph_engine import GraphRequest, GraphServeEngine


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graphs", type=int, default=12)
    ap.add_argument("--nodes", type=int, default=300)
    ap.add_argument("--edges", type=int, default=2000)
    ap.add_argument("--feat", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--slots", type=int, default=None)
    ap.add_argument("--backend", default="accel")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and args.slots is not None \
            and args.slots > torch.cuda.device_count():
        slots = [dev] * args.slots          # several slots per card
    else:
        slots = graph_mesh(args.slots, dev)

    fleet = FleetGraphEngine(devices=slots, backend=args.backend,
                             max_graphs_per_batch=4)
    print(f"[serve_fleet] {fleet.n_devices} slots: "
          f"{[str(s) for s in fleet.devices]}")
    rng = np.random.default_rng(0)

    feats = {}
    for i in range(args.graphs):
        gid = f"g{i}"
        g = gcn_normalize(make_power_law_graph(
            args.nodes + 23 * i, args.edges + 77 * i, seed=i))
        fleet.register_graph(gid, g)
        feats[gid] = torch.as_tensor(
            rng.normal(size=(g.n_cols, args.feat)).astype(np.float32),
            device=dev)
    cs = fleet.cache.stats()
    print(f"[serve_fleet] {args.graphs} plans placed over "
          f"{cs['devices']} slots; shard sizes={cs['shard_sizes']} "
          f"(overrides={cs['placement_overrides']})")

    # mixed recurring traffic: flushes group by owning slot, slots fire
    # concurrently
    for _ in range(args.rounds):
        fleet.serve([GraphRequest(gid, x) for gid, x in feats.items()])
    st = fleet.stats()
    print(f"[serve_fleet] {st['requests_served']:.0f} requests in "
          f"{st['fleet_rounds']:.0f} fleet rounds "
          f"(graphs/round={st['fleet_graphs_per_round']:.1f}); "
          f"per-slot dispatches={st['fleet_device_dispatches']} "
          f"occupancy={st['fleet_occupancy']:.2f}")

    # one giant narrow graph: block-sharded across every slot
    # ("giant" = past the reference's 4096-row resident threshold)
    big = gcn_normalize(make_power_law_graph(6000, 40000, seed=99))
    plan = fleet.register_graph("big", big)
    xb = torch.as_tensor(
        rng.normal(size=(big.n_cols, args.feat)).astype(np.float32),
        device=dev)
    out = fleet.serve_one("big", xb)
    st = fleet.stats()
    print(f"[serve_fleet] giant graph: {plan.num_blocks} blocks, "
          f"block-sharded {st['fleet_block_sharded']}x -> per-slot counts="
          f"{st['fleet_block_counts']} (balance="
          f"{st['fleet_block_balance']:.3f}, 1.0 = perfect)")

    # cross-check against a single-device engine
    single = GraphServeEngine(device=dev, backend=args.backend)
    single.register_graph("big", big)
    ref = single.serve_one("big", xb)
    err = float((out - ref).abs().max())
    print(f"[serve_fleet] fleet vs single-device max|diff| = {err:.2e}")
    assert err < 1e-4, err
    fleet.close()
    single.close()
    print("[serve_fleet] OK")
    return {"err": err, "slots": len(slots),
            "block_sharded": st["fleet_block_sharded"],
            "block_balance": st["fleet_block_balance"],
            "busy_slots": sum(1 for n in st["fleet_device_dispatches"] if n)}


if __name__ == "__main__":
    main()
