"""Quickstart: the Accel-GCN SpMM operator end to end.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.examples.quickstart

Builds a power-law graph, runs the paper's O(n) preprocessing (degree sort +
block-level partition), executes SpMM through ``--backend`` (K1 by
default) and the baselines on ``--device`` (``cuda`` by default), and
prints the structural quantities the paper reports: metadata ratio (Eq. 1)
and workload balance. Each backend's answer is held to ``1e-4`` against
the fp64 CSR oracle.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.graph import degree_sort_csr, gcn_normalize
from ..core.partition import (balance_stats, block_level_partition,
                              get_partition_patterns, metadata_bytes,
                              warp_level_partition)
from ..core.plan_cache import resolve_device
from ..core.spmm import make_accel_spmm
from ..data.graphs import make_power_law_graph
from ..kernels.ref import csr_spmm_ref


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="accel")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n, e, F = 2000, 16000, 96
    print(f"== building power-law graph: {n} nodes, {e} edges ==")
    g = gcn_normalize(make_power_law_graph(n, e, seed=0))
    deg = np.diff(g.rowptr)
    print(f"degrees: mean={deg.mean():.1f} max={deg.max()} "
          f"(max/mean={deg.max()/deg.mean():.0f}x — the paper's Fig. 2 skew)")

    print("\n== O(n) preprocessing: degree sort + block-level partition ==")
    gs = degree_sort_csr(g)
    for mode, mbw, mwn in [("paper", 12, 32), ("tpu", 64, 4)]:
        bp = block_level_partition(gs, get_partition_patterns(mbw, mwn, mode))
        wp = warp_level_partition(g, 32)
        st = balance_stats(bp)
        print(f"[{mode:5s}] blocks={bp.num_blocks} "
              f"metadata={metadata_bytes(bp)}B "
              f"(ratio vs warp-level={metadata_bytes(bp)/metadata_bytes(wp):.3f}, "
              f"paper Eq.1) slab_util={st['utilization']:.2f}")

    print(f"\n== SpMM through every backend on {dev} ==")
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(n, F))
                         .astype(np.float32)).to(dev)
    ref = csr_spmm_ref(g.rowptr, g.colidx, g.values.astype(np.float64),
                       x.double())
    op = make_accel_spmm(g, with_baselines=True, device=dev)
    errs = {}
    for be in dict.fromkeys([args.backend, "blocked", "segment", "warp"]):
        out = op(x, backend=be)
        errs[be] = float((out.double() - ref).abs().max())
        print(f"  {be:8s} max|err| vs oracle = {errs[be]:.2e}")
        assert errs[be] < 1e-4, f"{be}: {errs[be]}"
    print("\nDone — see chip_smoke.py for the kernels' times on the card.")
    return errs


if __name__ == "__main__":
    main()
