"""Online per-graph partition autotuning with shadow-measured rollout.

:class:`PlanTuner` is pure policy — it never touches the cache, kernels or
clocks on its own (the engine drives it from the dispatch path and a
shadow worker thread), which keeps it deterministic under a fake clock for
tests. Protocol, per registered graph id:

1.  ``observe(gid, n)`` on every live dispatch feeds the EWMA rate
    tracker; once the rate crosses ``hot_rate`` the graph enters tuning
    with a deterministic candidate list.
2.  ``next_shadow(gid)`` implements the shadow stride: every
    ``1/shadow_fraction``-th live dispatch of a hot graph returns the
    current candidate, asking the engine to DUPLICATE that dispatch onto
    the candidate plan off the critical path. The live answer always
    comes from the incumbent — a mistuned candidate can never hurt p99.
3.  ``record_shadow(gid, cand, incumbent_s, candidate_s)`` scores one
    shadow comparison. A win is ``candidate_s <= incumbent_s * (1 -
    min_improvement)``; ``win_streak`` CONSECUTIVE wins promote the
    candidate (returned to the engine, which publishes it through the plan
    cache's version chain); a loss resets the streak, and a candidate that
    burns ``max_trials`` comparisons without promoting is dropped for the
    next one. When the list is exhausted the graph is marked done and
    never shadowed again (until ``reset``).

The policy is the reference's, rule for rule: the same calls under the
same clock return the same candidates and the same ``stats()``.

``tune_offline`` is the same measurement applied exhaustively: build and
time every candidate against the incumbent config, no shadowing involved.
On ``cuda`` each dispatch is timed by CUDA events, on the CPU by the host
clock.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.graph import CSRGraph
from ..core.plan_cache import (DeviceLike, PartitionConfig,
                               build_partition_plan, resolve_device)
from ..distributed.replication import EwmaRate
from .search import TuningCandidate, default_candidates

__all__ = ["PlanTuner", "time_call", "tune_offline"]


@dataclasses.dataclass
class _GraphTuneState:
    """Per-graph search progress (guarded by the tuner lock)."""

    base: PartitionConfig
    candidates: List[TuningCandidate]
    idx: int = 0                  # current candidate
    trials: int = 0               # comparisons burned on current candidate
    streak: int = 0               # consecutive wins of current candidate
    dispatches: int = 0           # live dispatches seen while tuning
    status: str = "shadowing"     # shadowing | promoted | exhausted

    @property
    def current(self) -> Optional[TuningCandidate]:
        if self.status != "shadowing" or self.idx >= len(self.candidates):
            return None
        return self.candidates[self.idx]


class PlanTuner:
    """Decide WHICH graphs to tune, WHEN to shadow, and WHO wins.

    All methods are thread-safe and O(1); the engine calls ``observe`` /
    ``next_shadow`` on its flush path and ``record_shadow`` from the
    shadow worker. ``now_fn`` + a fixed ``candidates`` list make every
    decision reproducible in tests (no wall clock, no RNG — the shadow
    stride is a deterministic counter, not a coin flip).
    """

    def __init__(
        self,
        *,
        hot_rate: float = 20.0,
        shadow_fraction: float = 0.25,
        win_streak: int = 3,
        min_improvement: float = 0.02,
        max_trials: int = 12,
        halflife_s: float = 5.0,
        candidates: Optional[Sequence[TuningCandidate]] = None,
        now_fn: Callable[[], float] = time.monotonic,
    ):
        if not 0.0 < shadow_fraction <= 1.0:
            raise ValueError("shadow_fraction must be in (0, 1]")
        if win_streak < 1 or max_trials < win_streak:
            raise ValueError("need max_trials >= win_streak >= 1")
        self.hot_rate = float(hot_rate)
        self.stride = max(1, round(1.0 / shadow_fraction))
        self.win_streak = int(win_streak)
        self.min_improvement = float(min_improvement)
        self.max_trials = int(max_trials)
        self._fixed = list(candidates) if candidates is not None else None
        self.rates = EwmaRate(halflife_s=halflife_s, now_fn=now_fn)
        self._lock = threading.Lock()
        self._state: Dict[str, _GraphTuneState] = {}
        # monotone counters (snapshot via stats())
        self.comparisons = 0
        self.wins = 0
        self.promotions = 0
        self.exhausted = 0
        self.candidate_failures = 0

    # ------------------------------------------------------------ hot signal
    def observe(self, gid: str, n: int = 1) -> None:
        """Feed one live dispatch of ``n`` requests into the rate tracker."""
        self.rates.observe(gid, n)

    def next_shadow(self, gid: str,
                    base: PartitionConfig) -> Optional[TuningCandidate]:
        """The engine's one per-dispatch question: shadow this one?

        Starts tracking ``gid`` once its request rate crosses ``hot_rate``,
        then returns the current candidate every ``stride``-th dispatch.
        Returns None while cold, between strides, or once tuning finished.
        """
        with self._lock:
            st = self._state.get(gid)
            if st is None:
                if self.rates.rate(gid) < self.hot_rate:
                    return None
                cands = (list(self._fixed) if self._fixed is not None
                         else default_candidates(base))
                cands = [c for c in cands
                         if not (c.config == base and c.backend is None
                                 and c.grid_order == "block_major")]
                if not cands:
                    return None
                st = self._state[gid] = _GraphTuneState(
                    base=base, candidates=cands)
            if st.status != "shadowing":
                return None
            st.dispatches += 1
            if st.dispatches % self.stride:
                return None
            return st.current

    # ------------------------------------------------------------- scoring
    def record_shadow(self, gid: str, cand: TuningCandidate,
                      incumbent_s: float, candidate_s: float
                      ) -> Optional[TuningCandidate]:
        """Score one shadow comparison; returns the candidate to PROMOTE
        (the engine publishes it) after ``win_streak`` consecutive wins."""
        with self._lock:
            st = self._state.get(gid)
            if st is None or st.current is not cand:
                return None         # stale shadow (candidate moved on)
            self.comparisons += 1
            st.trials += 1
            if candidate_s <= incumbent_s * (1.0 - self.min_improvement):
                self.wins += 1
                st.streak += 1
                if st.streak >= self.win_streak:
                    st.status = "promoted"
                    return cand
            else:
                st.streak = 0
            if st.trials >= self.max_trials:
                self._advance_locked(st)
            return None

    def candidate_failed(self, gid: str, cand: TuningCandidate) -> None:
        """A shadow build/dispatch raised: drop this candidate entirely."""
        with self._lock:
            st = self._state.get(gid)
            if st is None or st.current is not cand:
                return
            self.candidate_failures += 1
            self._advance_locked(st)

    def _advance_locked(self, st: _GraphTuneState) -> None:
        st.idx += 1
        st.trials = 0
        st.streak = 0
        if st.idx >= len(st.candidates):
            st.status = "exhausted"
            self.exhausted += 1

    # ------------------------------------------------------------ lifecycle
    def confirm_promoted(self, gid: str) -> None:
        """The engine published the winner (version chain advanced)."""
        with self._lock:
            self.promotions += 1

    def reset(self, gid: str) -> None:
        """Forget a graph's search (promotion raced a mutation, graph
        replaced, ...). It re-enters tuning if it stays hot."""
        with self._lock:
            self._state.pop(gid, None)

    # ---------------------------------------------------------------- stats
    def describe(self, gid: str) -> Optional[Dict]:
        with self._lock:
            st = self._state.get(gid)
            if st is None:
                return None
            cur = st.current
            return {"status": st.status, "candidate": cur.label if cur else None,
                    "idx": st.idx, "trials": st.trials, "streak": st.streak,
                    "dispatches": st.dispatches,
                    "n_candidates": len(st.candidates)}

    def stats(self) -> Dict[str, float]:
        with self._lock:
            by_status: Dict[str, int] = {}
            for st in self._state.values():
                by_status[st.status] = by_status.get(st.status, 0) + 1
            return {
                "tracked": len(self._state),
                "shadowing": by_status.get("shadowing", 0),
                "promoted": by_status.get("promoted", 0),
                "exhausted_graphs": by_status.get("exhausted", 0),
                "comparisons": self.comparisons,
                "wins": self.wins,
                "promotions": self.promotions,
                "exhausted": self.exhausted,
                "candidate_failures": self.candidate_failures,
            }


# --------------------------------------------------------------------- timing
def time_call(fn: Callable[[], object], dev: torch.device) -> float:
    """Seconds one call of ``fn`` takes on ``dev``: CUDA events around it
    on the current stream (waiting for the end event) on ``cuda``, the
    host clock elsewhere."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


# --------------------------------------------------------------------- offline


def tune_offline(
    g: CSRGraph,
    base: Optional[PartitionConfig] = None,
    *,
    feat_dim: int = 32,
    repeats: int = 3,
    backend: str = "accel",
    candidates: Optional[Sequence[TuningCandidate]] = None,
    seed: int = 0,
    device: DeviceLike = None,
) -> Dict:
    """One-shot exhaustive tuning of a single graph (no shadowing).

    Builds the incumbent plan plus every candidate on ``device`` (``cuda``
    unless the caller passes another), times a batched SpMM dispatch for
    each (1 warm-up + best of ``repeats``) and returns a ranking.
    ``backend`` is the measurement default; a candidate with its own
    ``backend`` overrides it. A candidate whose build or dispatch raises is
    a result row with an ``error``, not a failure of the call.
    """
    from ..kernels.spmm_batched import spmm_batched

    dev = resolve_device(device)
    base = base or PartitionConfig()
    cands = (list(candidates) if candidates is not None
             else default_candidates(base))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(
        rng.standard_normal((g.n_cols, feat_dim)).astype(np.float32)).to(dev)

    def _measure(cfg: PartitionConfig, be: Optional[str],
                 grid_order: str) -> float:
        plan = build_partition_plan(g, cfg, device=dev)

        def run():
            spmm_batched([plan.slabs], [x], [plan.n_rows],
                         backend=be or backend, grid_order=grid_order)

        run()                   # warm-up: a first launch must not score
        return min(time_call(run, dev) for _ in range(repeats))

    base_s = _measure(base, None, "block_major")
    rows: List[Dict] = []
    for c in cands:
        try:
            t = _measure(c.config, c.backend, c.grid_order)
        except Exception as e:  # noqa: BLE001 — a broken candidate is a result
            rows.append({"label": c.label, "error": repr(e)})
            continue
        rows.append({"label": c.label, "time_s": t,
                     "speedup_vs_base": base_s / t if t else float("inf"),
                     "config": dataclasses.asdict(c.config),
                     "backend": c.backend, "grid_order": c.grid_order})
    ranked = sorted((r for r in rows if "time_s" in r),
                    key=lambda r: r["time_s"])
    best = ranked[0] if ranked else None
    return {
        "base": {"time_s": base_s, "config": dataclasses.asdict(base)},
        "candidates": rows,
        "best": best,
        "best_speedup": (best["speedup_vs_base"] if best else 0.0),
    }
