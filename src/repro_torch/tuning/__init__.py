"""Online partition autotuning.

* :mod:`repro_torch.tuning.search` — the candidate space: per-degree
  ``warp_nzs`` override tables, slab capacity (``max_warp_nzs`` /
  ``deg_bound``), row-packing caps, grid order and backend — each an
  admissible :class:`~repro_torch.core.plan_cache.PartitionConfig` variant.
* :mod:`repro_torch.tuning.tuner` — :class:`PlanTuner`, the online policy:
  an EWMA request-rate tracker decides which graphs are hot enough to be
  worth tuning, a fraction of their live dispatches is SHADOWED onto a
  candidate plan off the critical path (the answer always comes from the
  incumbent; live reads share the host and the card with the shadow and
  pay for it only at the tail), and a candidate that wins
  K consecutive comparisons by at least X% is promoted through the plan
  cache's versioned ``publish``/``retire`` chain. ``tune_offline`` is the
  same measurement loop as a one-shot function.

Tuned configs live in the :class:`~repro_torch.core.plan_cache.PartitionPlan`
(``plan.tuned`` + the config inside ``plan.key``) and survive disk
spill/reload.
"""
from .search import (  # noqa: F401
    TuningCandidate,
    default_candidates,
    staircase_warp_nzs,
)
from .tuner import PlanTuner, tune_offline  # noqa: F401

__all__ = [
    "TuningCandidate",
    "default_candidates",
    "staircase_warp_nzs",
    "PlanTuner",
    "tune_offline",
]
