"""Where do collective bytes come from? Rank 0's collectives of one probe
cell grouped by (kind, dtype, source):

    PYTHONPATH=src python -m repro_torch.scripts.coll_breakdown \\
        --arch dbrx-132b --shape train_4k [--variant bf16_attn] [--layers 2]

The cell is the arch cut to ``--layers`` layers at the reference's probe
chunks (with the variant's microbatch, where it has one), rank 0's share
of its partitioned program on ``pod16x16`` traced on ``meta`` under a
``fake`` process group (``launch.dryrun.trace_partitioned``) with each
collective's source recorded: the innermost ``repro_torch`` function
outside the sharding rules that ran it (``analysis.counters``). Bytes are
``Counts.coll_bytes``' rule (the reference's), so the rows of each kind
sum to the dry run's count. The 25 largest rows are printed.
"""
from __future__ import annotations

import argparse
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from ..analysis.counters import Counts
from ..configs import SHAPES_BY_NAME, get_config
from ..configs.base import ArchConfig, ShapeConfig
from ..launch import dryrun as D
from ..launch.mesh import make_production_mesh
from .hillclimb import VARIANTS, apply_flags

Row = Tuple[Tuple[str, str, str], int]


def rows_of(counts: Counts) -> List[Row]:
    """((kind, dtype, source), bytes) of every group of ``counts``'
    collectives, largest first."""
    agg: Dict[Tuple[str, str, str], int] = defaultdict(int)
    for (kind, *_, n), (dtype, src) in zip(counts.collectives,
                                           counts.collective_origins):
        agg[(kind, dtype, src)] += n
    return sorted(agg.items(), key=lambda kv: (-kv[1], kv[0]))


def breakdown(cfg: ArchConfig, shape: ShapeConfig, variant: str = "baseline",
              sizes: Optional[Dict[str, int]] = None
              ) -> Tuple[List[Row], Counts]:
    """Every (kind, dtype, source) row of rank 0's collectives of ``cfg``
    on ``shape`` under the variant's flags, and the trace's counts;
    ``sizes`` defaults to ``pod16x16``."""
    flags = VARIANTS[variant]
    sizes = sizes or make_production_mesh(multi_pod=False)
    chunks = D.probe_chunks(shape, flags.get("microbatch_div"))
    restore = apply_flags(flags)
    try:
        counts, _ = D.trace_partitioned(cfg, shape, sizes, chunks=chunks)
    finally:
        restore()
    return rows_of(counts), counts


def main(argv: Optional[Sequence[str]] = None) -> List[Row]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline", choices=sorted(VARIANTS))
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch).replace(n_layers=args.layers)
    rows, counts = breakdown(cfg, SHAPES_BY_NAME[args.shape], args.variant)
    print(f"# {args.arch} x {args.shape} x {args.variant} "
          f"({args.layers} layers, rank 0 of pod16x16, meta) "
          f"trace={counts.seconds:.0f}s")
    for (kind, dtype, src), b in rows[:25]:
        print(f"{b/1e9:10.3f} GB  {kind:18s} {dtype:5s} {src}")
    return rows


if __name__ == "__main__":
    main()
