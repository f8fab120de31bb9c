"""Candidate space for the partition autotuner.

A candidate is a full dispatch recipe: a :class:`PartitionConfig` variant
(which changes the partition/slab STRUCTURE and therefore the plan cache
key) plus kernel-launch knobs (backend, grid order) that don't. All
generated configs are admissible by construction — every ``warp_nzs``
table passes :func:`repro_torch.core.partition.validate_warp_nzs_override`,
so a candidate plan always covers each row with one block and the kernels
(K1, K2, K3) need no changes.

Why these axes move the needle:

* ``max_rows_per_block`` — the default tpu-mode cap (``max_block_warps``)
  leaves a degree-1 slab only ``max_block_warps / deg_bound`` full; lifting
  the cap to ``deg_bound`` packs low-degree rows densely and can cut the
  block count several-fold on power-law graphs.
* ``warp_nzs`` table — a per-degree budget below ``max_warp_nzs`` splits a
  degree class over MORE, smaller blocks: worse density, more parallelism.
* ``max_warp_nzs`` (slab capacity ``C = max_block_warps * max_warp_nzs``)
  — trades per-block work against padding waste and the split-row
  threshold.
* ``grid_order`` / ``backend`` — launch knobs of
  :func:`repro_torch.kernels.spmm_batched.spmm_batched`; a candidate may
  set them, :func:`default_candidates` leaves both at the engine's.

The list is the reference's, field for field (the tests hold it so). The
slab shapes were chosen around the TPU's matrix unit; on the card each is a
(C, R) shape of the live-row gather pipeline.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

from ..core.plan_cache import PartitionConfig

__all__ = ["TuningCandidate", "staircase_warp_nzs", "default_candidates"]


@dataclasses.dataclass(frozen=True)
class TuningCandidate:
    """One point in the tuner's search space.

    ``backend=None`` means "the engine's configured backend"; a concrete
    value pins the kernel regime for this plan's dispatches after
    promotion (recorded in ``plan.tuned``).
    """

    config: PartitionConfig
    backend: Optional[str] = None
    grid_order: str = "block_major"
    label: str = ""

    def tuned_hints(self) -> dict:
        """The JSON-able dispatch hints stored in ``plan.tuned``."""
        return {"backend": self.backend, "grid_order": self.grid_order,
                "label": self.label}


def staircase_warp_nzs(max_block_warps: int, max_warp_nzs: int,
                       base: int = 1) -> Tuple[int, ...]:
    """Smallest admissible per-degree warp_nzs table with a floor of ``base``.

    Entry ``d`` is ``clamp(ceil(d / max_block_warps), base, max_warp_nzs)``
    — the minimum budget that still satisfies ``max_block_warps *
    warp_nzs[d] >= d``, i.e. the most-parallel admissible table. With
    ``base == max_warp_nzs`` this degenerates to the default table.
    """
    deg_bound = max_block_warps * max_warp_nzs
    base = max(1, min(int(base), max_warp_nzs))
    return tuple(
        min(max_warp_nzs, max(base, math.ceil(d / max_block_warps)))
        for d in range(1, deg_bound + 1))


def default_candidates(base: PartitionConfig) -> List[TuningCandidate]:
    """The deterministic default candidate list for ``base``.

    Ordered best-guess-first: a SMALLER slab (``half-slab``) leads,
    capacity-preserving warp_nzs reshapes come next, then the dense
    row-packing and slab-doubling long shots. Candidates identical to
    ``base`` are filtered out, so the list is always a set of genuine
    alternatives.
    """
    mbw, mwn = base.max_block_warps, base.max_warp_nzs
    variants: List[Tuple[PartitionConfig, str]] = []
    # slab capacity: half the non-zero budget per block (best prior)
    if mwn > 1:
        variants.append((dataclasses.replace(
            base, max_warp_nzs=mwn // 2, warp_nzs_table=None),
            "half-slab"))
    # warp_nzs reshapes: a half-way budget, then the most-parallel table
    if mwn >= 4:
        variants.append((dataclasses.replace(
            base, warp_nzs_table=staircase_warp_nzs(mbw, mwn, base=mwn // 2)),
            f"wnz-{mwn // 2}"))
    variants.append((dataclasses.replace(
        base, warp_nzs_table=staircase_warp_nzs(mbw, mwn, base=1)),
        "wnz-min"))
    if base.mode == "tpu":
        # pack as many rows as fit the slab (lifts the row cap)
        variants.append((dataclasses.replace(
            base, max_rows_per_block=base.deg_bound), "dense-rows"))
    variants.append((dataclasses.replace(
        base, max_warp_nzs=mwn * 2, warp_nzs_table=None), "2x-slab"))

    return [TuningCandidate(config=cfg, label=label)
            for cfg, label in variants if cfg != base]
