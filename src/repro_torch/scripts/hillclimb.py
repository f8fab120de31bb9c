"""The roofline of the LM's named flag bundles, one (cell x variant) at a
time, appended to ``--out``:

    PYTHONPATH=src python -m repro_torch.scripts.hillclimb --arch dbrx-132b \\
        --shape train_4k --variant microbatch4 [--hw "NVIDIA H100 80GB HBM3"]

The record is rank 0's share of the partitioned program on the
reference's production mesh (``pod16x16``), traced on ``meta`` under a
``fake`` process group (``launch.dryrun.trace_partitioned``) at the
reference's probe chunks: the ``_probe_plan`` probes are traced and
extrapolated to full depth as the reference's
``probe_roofline_with_chunks`` does. The terms are the card's
(``analysis.roofline``: ``peak_flops``, ``hbm_bw``, ``link_bw`` of
``--hw``, the card this process runs on when not named). ``VARIANTS``
are the reference's bundles: attention precision, microbatching, head
sharding, ZeRO-1 for experts, grouped MoE dispatch; they do not touch the
graph-serving stack (see ``repro_torch.scripts.tune_partition`` and
``tuning.PlanTuner`` for that).
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import Callable, Dict, List, Optional, Sequence

from ..analysis.roofline import HwLike, hw_row, model_flops_estimate
from ..configs import SHAPES_BY_NAME, get_config
from ..configs.base import ArchConfig, ShapeConfig
from ..launch import dryrun as D
from ..launch.mesh import make_production_mesh

VARIANTS = {
    # paper-faithful production program as lowered for the baseline table
    "baseline": {},
    # attention/KV math in bf16 with fp32 accumulation (no fp32 copies)
    "bf16_attn": {"bf16_attn": True},
    # gradient accumulation over 4 microbatches (memory lever)
    "microbatch4": {"microbatch_div": 4},
    # drop the explicit q/k/v head-sharding constraint
    "headshard_off": {"headshard_off": True},
    # ZeRO-1 for expert weights: MoE params replicated over "data" in
    # compute, only the optimizer state sharded there
    "zero1_moe": {"zero1_moe": True},
    # GShard-style grouped MoE dispatch: per-data-shard capacity + local
    # scatter
    "moe_grouped": {"dispatch_groups": 16},
    # combined levers
    "bf16_attn+microbatch4": {"bf16_attn": True, "microbatch_div": 4},
    "bf16_attn+headshard_off": {"bf16_attn": True, "headshard_off": True},
    "bf16_attn+zero1_moe": {"bf16_attn": True, "zero1_moe": True},
    "moe_grouped+headshard_off": {"dispatch_groups": 16,
                                  "headshard_off": True},
}


def _no_head_sharding(x, head_axis=2, dim_axis=3):
    return x


def apply_flags(flags: Dict) -> Callable[[], None]:
    """Sets the port's flags for a bundle: ``attention.BF16_EINSUMS``,
    ``sharding.rules.ZERO1_MOE``, ``moe.DISPATCH_GROUPS`` and, for
    ``headshard_off``, ``shard_heads`` as a no-op wherever it is bound
    (``models.attention`` binds the name at import, so patching the rules
    module alone would not reach it). Returns a function that restores
    every flag."""
    from .. import sharding as S
    from ..models import attention as A
    from ..models import moe as MO
    from ..sharding import rules as R
    saved = (A.BF16_EINSUMS, R.ZERO1_MOE, MO.DISPATCH_GROUPS,
             A.shard_heads, R.shard_heads, S.shard_heads)
    A.BF16_EINSUMS = bool(flags.get("bf16_attn"))
    if flags.get("zero1_moe"):
        R.ZERO1_MOE = True
    if flags.get("dispatch_groups"):
        MO.DISPATCH_GROUPS = int(flags["dispatch_groups"])
    if flags.get("headshard_off"):
        A.shard_heads = R.shard_heads = S.shard_heads = _no_head_sharding

    def restore():
        (A.BF16_EINSUMS, R.ZERO1_MOE, MO.DISPATCH_GROUPS, A.shard_heads,
         R.shard_heads, S.shard_heads) = saved
    return restore


def extrapolate(kind: str, vecs: List[Dict[str, float]],
                full) -> Dict[str, float]:
    """The probes' cost vectors at full depth, the reference's solve:
    linear in the layer units (two probes) or, for a hybrid, in (fixed,
    shared, mamba) from three."""
    keys = sorted(set().union(*[set(v) for v in vecs]))
    out = {}
    if kind == "linear":
        (ca, ua), (cb, ub) = (vecs[0], 1), (vecs[1], 2)
        for k in keys:
            per = (cb.get(k, 0.0) - ca.get(k, 0.0)) / (ub - ua)
            out[k] = ca.get(k, 0.0) + (full - ua) * per
    else:  # hybrid: cA = f + s + 3m ; cB = f + s + 6m ; cC = f + 2s + 6m
        cA, cB, cC = vecs
        n_shared, n_mamba = full
        for k in keys:
            m = (cB.get(k, 0.0) - cA.get(k, 0.0)) / 3.0
            s = cC.get(k, 0.0) - cB.get(k, 0.0)
            f = cA.get(k, 0.0) - s - 3 * m
            out[k] = f + n_shared * s + n_mamba * m
    return out


def probe_partitioned(cfg: ArchConfig, shape: ShapeConfig,
                      sizes: Dict[str, int],
                      chunks: Dict[str, int]) -> Dict[str, float]:
    """Rank 0's full-depth cost vector (``flops``, ``bytes``, ``coll``,
    ``coll_<kind>``) on a mesh of ``sizes``, extrapolated from the
    ``_probe_plan`` probes, each traced by ``trace_partitioned``."""
    kind, probes, full = D._probe_plan(cfg)
    vecs = [D.cost_vector(D.trace_partitioned(pc, shape, sizes,
                                              chunks=chunks)[0])
            for pc in probes]
    return extrapolate(kind, vecs, full)


def measure(cfg: ArchConfig, shape: ShapeConfig, variant: str, *,
            sizes: Optional[Dict[str, int]] = None, hw: HwLike = None,
            with_memory: bool = False) -> Dict:
    """One (cell x variant) record: the extrapolated cost, the three terms
    against ``hw``'s row, the bottleneck and ``useful`` (model FLOPs over
    rank 0's FLOPs times the ranks); ``sizes`` defaults to ``pod16x16``.
    ``with_memory``: rank 0's argument, temporary and peak bytes of the
    full-depth program as well (one trace of every layer)."""
    flags = VARIANTS[variant]
    row = hw_row(hw)
    sizes = sizes or make_production_mesh(multi_pod=False)
    chunks = D.probe_chunks(shape, flags.get("microbatch_div"))
    restore = apply_flags(flags)
    try:
        full = probe_partitioned(cfg, shape, sizes, chunks)
        rec = {"arch": cfg.name, "shape": shape.name, "variant": variant,
               "mesh": sizes, "chunks": chunks, "hw": row.get("name"),
               "cost": full}
        if with_memory:
            c, _ = D.trace_partitioned(cfg, shape, sizes, chunks=chunks)
            rec["memory"] = {"argument_bytes_per_dev": c.argument_bytes,
                             "temp_bytes_per_dev": c.temp_bytes,
                             "peak_bytes_per_dev": c.peak_live_bytes}
    finally:
        restore()
    rec["terms"] = {"compute_s": full["flops"] / row["peak_flops"],
                    "memory_s": full["bytes"] / row["hbm_bw"],
                    "collective_s": full.get("coll", 0.0) / row["link_bw"]}
    rec["bottleneck"] = max(rec["terms"], key=rec["terms"].get)
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind in ("train", "prefill") else shape.global_batch)
    mf = model_flops_estimate(D.active_param_count(cfg), tokens,
                              "train" if shape.kind == "train" else "infer")
    rec["useful"] = mf / max(full["flops"] * math.prod(sizes.values()), 1.0)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True, choices=sorted(VARIANTS))
    ap.add_argument("--out", default="benchmarks/results/hillclimb_torch.json")
    ap.add_argument("--hw", default=None,
                    help="a row of repro_torch.analysis.roofline.HARDWARE "
                         "(default: the card this process runs on)")
    ap.add_argument("--with-memory", action="store_true",
                    help="also trace the full-depth program for rank 0's "
                         "argument, temporary and peak bytes (slower)")
    args = ap.parse_args(argv)
    rec = measure(get_config(args.arch), SHAPES_BY_NAME[args.shape],
                  args.variant, hw=args.hw, with_memory=args.with_memory)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    hist = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            hist = json.load(f)
    hist.append(rec)
    with open(args.out, "w") as f:
        json.dump(hist, f, indent=1)
    print(json.dumps({k: rec[k] for k in ("arch", "shape", "variant",
                                          "terms", "bottleneck", "useful")},
                     indent=1))
    return rec


if __name__ == "__main__":
    main()
