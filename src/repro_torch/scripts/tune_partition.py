"""Offline one-shot partition tuning for a saved graph.

Thin CLI over :func:`repro_torch.tuning.tune_offline`: builds the
incumbent partition plan plus every candidate config (warp_nzs tables,
slab capacity, row-packing cap; see ``repro_torch/tuning/search.py``),
times one batched SpMM dispatch per candidate on ``--device`` (1 warm-up +
best of N; CUDA events on a card) and prints the ranking as JSON. The
best candidate's config is what you would pass as
``PartitionConfig(**...)`` when registering the graph, or let the online
tuner (``GraphServeEngine(tuner=PlanTuner())``) find it from live traffic.

Graph input: an .npz with ``rowptr``/``colidx``/``values`` (and optional
``n_cols``), or ``--synthetic N,M,SEED`` for a power-law demo graph.
``--backend`` defaults to ``accel`` (K1), the port's engine default (the
reference's CLI defaults to ``blocked``); ``--device`` to ``cuda``.

    PYTHONPATH=src python -m repro_torch.scripts.tune_partition --graph g.npz
    PYTHONPATH=src python -m repro_torch.scripts.tune_partition \\
        --synthetic 20000,100000,0 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Sequence

import numpy as np

from ..core.graph import CSRGraph
from ..core.plan_cache import PartitionConfig
from ..data.graphs import make_power_law_graph
from ..tuning import tune_offline


def load_graph(args) -> CSRGraph:
    if args.graph:
        with np.load(args.graph) as z:
            rowptr = z["rowptr"]
            colidx = z["colidx"]
            values = (z["values"] if "values" in z
                      else np.ones(len(colidx), dtype=np.float32))
            n_cols = (int(z["n_cols"]) if "n_cols" in z
                      else int(colidx.max()) + 1 if len(colidx) else 0)
        return CSRGraph(rowptr=rowptr, colidx=colidx,
                        values=np.asarray(values, np.float32),
                        n_cols=n_cols)
    n, m, seed = (int(v) for v in args.synthetic.split(","))
    return make_power_law_graph(n, m, seed=seed)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--graph", help=".npz with rowptr/colidx[/values/n_cols]")
    src.add_argument("--synthetic", metavar="N,M,SEED",
                     help="power-law graph: nodes,edges,seed")
    ap.add_argument("--feat-dim", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed runs per candidate (best is kept)")
    ap.add_argument("--backend", default="accel",
                    help="measurement backend (accel|auto|pallas|windowed|"
                         "hbm|blocked); per-candidate overrides still apply")
    ap.add_argument("--mode", default="tpu", choices=["tpu", "paper"])
    ap.add_argument("--max-block-warps", type=int, default=64)
    ap.add_argument("--max-warp-nzs", type=int, default=4)
    ap.add_argument("--out", help="also write the JSON report here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    g = load_graph(args)
    base = PartitionConfig(mode=args.mode,
                           max_block_warps=args.max_block_warps,
                           max_warp_nzs=args.max_warp_nzs)
    report = tune_offline(g, base, feat_dim=args.feat_dim,
                          repeats=args.repeats, backend=args.backend,
                          device=args.device)
    report["graph"] = {"n_rows": g.n_rows, "n_cols": g.n_cols, "nnz": g.nnz}
    text = json.dumps(report, indent=2, default=str)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    best = report["best"]
    if best is not None:
        print(f"\nbest: {best['label']} "
              f"({best['speedup_vs_base']:.2f}x vs base)", file=sys.stderr)
    return report


if __name__ == "__main__":
    main()
