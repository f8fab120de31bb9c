"""Hot-plan replication: EWMA request rates drive replica promotion/demotion.

The fleet places each plan on exactly one slot — right for capacity, wrong
for zipf-skewed popularity, where a handful of hot graphs turn their one
owning slot into the whole fleet's ceiling (the workload imbalance
Accel-GCN's block-level partition fixes inside a kernel, one level up).
:class:`ReplicaManager` tracks each plan's request rate with a decayed
counter (:class:`EwmaRate`), replicates plans whose rate exceeds what one
slot should absorb onto the least-loaded slots, and drops replicas again
when the rate fades. :class:`EwmaRate` also tells the partition autotuner
(:mod:`repro_torch.tuning.tuner`) which graphs are hot enough to tune.

Engine-agnostic: the manager talks to the placement layer through
callables (list replicas / add / drop / per-slot load), so
:class:`~repro_torch.serve.fleet.FleetGraphEngine` wires it to
:class:`~repro_torch.distributed.placement.FleetPlanCache`.

Pure Python: the same observations under the same clock read the same
rates and take the same decisions as the reference's
``distributed/replication.py``.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["EwmaRate", "ReplicaManager"]

_LN2 = math.log(2.0)


class EwmaRate:
    """Per-key exponentially-decayed request counter -> rate estimate.

    Each observation adds ``n`` to a counter that halves every
    ``halflife_s`` seconds: ``c <- c * 0.5**(dt/halflife) + n``. Under a
    steady rate ``r`` the counter converges to ``r * halflife / ln2``, so
    :meth:`rate` divides back out and reads in requests/second. O(1) per
    observation, no sample buffers; thread-safe.
    """

    def __init__(self, halflife_s: float = 5.0,
                 now_fn: Callable[[], float] = time.monotonic):
        if halflife_s <= 0:
            raise ValueError("halflife_s must be > 0")
        self.halflife_s = float(halflife_s)
        self._now = now_fn
        self._lock = threading.Lock()
        self._counts: Dict[object, float] = {}
        self._stamps: Dict[object, float] = {}

    def observe(self, key, n: int = 1) -> None:
        now = self._now()
        with self._lock:
            c = self._counts.get(key, 0.0)
            t = self._stamps.get(key, now)
            c *= 0.5 ** ((now - t) / self.halflife_s)
            self._counts[key] = c + n
            self._stamps[key] = now

    def rate(self, key) -> float:
        """Estimated requests/second for ``key`` (0.0 if never seen)."""
        now = self._now()
        with self._lock:
            c = self._counts.get(key)
            if c is None:
                return 0.0
            c *= 0.5 ** ((now - self._stamps[key]) / self.halflife_s)
            return c * _LN2 / self.halflife_s

    def keys(self) -> List[object]:
        with self._lock:
            return list(self._counts)

    def prune(self, floor: float = 1e-3) -> int:
        """Forget keys whose decayed counter fell below ``floor``."""
        now = self._now()
        with self._lock:
            dead = [k for k, c in self._counts.items()
                    if c * 0.5 ** ((now - self._stamps[k])
                                   / self.halflife_s) < floor]
            for k in dead:
                del self._counts[k]
                del self._stamps[k]
            return len(dead)


class ReplicaManager:
    """Promote hot plans to extra slots, demote cold replicas.

    ``step()`` is the whole policy: for every tracked key the target
    replica count is ``clamp(ceil(rate / rate_per_replica), 1,
    max_replicas)`` — one replica per ``rate_per_replica`` req/s of
    demand. Promotion picks the least-loaded slots (by the caller's
    ``device_load_fn``) not already holding the plan; demotion drops the
    most recently added extras first and NEVER touches the primary.

    The engine calls :meth:`observe` per request on the hot path (O(1))
    and :meth:`maybe_step` at flush boundaries, so replication runs beside
    serving without a thread of its own. ``now_fn`` is the clock of both
    the rates and the step interval (tests drive it by hand).
    """

    def __init__(self, *,
                 replicas_fn: Callable[[object], Sequence[int]],
                 add_fn: Callable[[object, int], bool],
                 drop_fn: Callable[[object, int], bool],
                 device_load_fn: Callable[[], Sequence[float]],
                 rate_per_replica: float = 50.0,
                 max_replicas: int = 4,
                 halflife_s: float = 5.0,
                 interval_s: float = 0.25,
                 now_fn: Callable[[], float] = time.monotonic):
        if rate_per_replica <= 0:
            raise ValueError("rate_per_replica must be > 0")
        if max_replicas < 1:
            raise ValueError("max_replicas must be >= 1")
        self._replicas_fn = replicas_fn
        self._add_fn = add_fn
        self._drop_fn = drop_fn
        self._device_load_fn = device_load_fn
        self.rate_per_replica = float(rate_per_replica)
        self.max_replicas = int(max_replicas)
        self.interval_s = float(interval_s)
        self._now = now_fn
        self.rates = EwmaRate(halflife_s, now_fn=now_fn)
        self._lock = threading.Lock()
        self._last_step: Optional[float] = None
        self.promotions = 0
        self.demotions = 0
        self.steps = 0

    def observe(self, key, n: int = 1) -> None:
        self.rates.observe(key, n)

    def target_replicas(self, key) -> int:
        rate = self.rates.rate(key)
        return max(1, min(self.max_replicas,
                          math.ceil(rate / self.rate_per_replica)))

    def maybe_step(self) -> bool:
        """Run :meth:`step` if ``interval_s`` elapsed since the last run.
        Non-blocking for concurrent callers: one thread steps, the rest
        skip. Returns True when a step actually ran."""
        now = self._now()
        with self._lock:
            if (self._last_step is not None
                    and now - self._last_step < self.interval_s):
                return False
            self._last_step = now
        self.step()
        return True

    def step(self) -> Dict[str, int]:
        """One promotion/demotion sweep over every tracked key."""
        promoted = demoted = 0
        loads = list(self._device_load_fn())
        for key in self.rates.keys():
            target = self.target_replicas(key)
            current = list(self._replicas_fn(key))
            if not current:
                continue        # never placed (or already forgotten)
            if target > len(current):
                held = set(current)
                candidates = sorted(
                    (d for d in range(len(loads)) if d not in held),
                    key=loads.__getitem__)
                for dev in candidates[:target - len(current)]:
                    if self._add_fn(key, dev):
                        promoted += 1
                        # count the new copy so later keys in THIS sweep
                        # see the slot as more loaded
                        loads[dev] += 1.0
            elif target < len(current):
                # drop newest extras first; current[0] is the primary
                for dev in current[:target - len(current) - 1:-1]:
                    if self._drop_fn(key, dev):
                        demoted += 1
        self.rates.prune()
        with self._lock:
            self.promotions += promoted
            self.demotions += demoted
            self.steps += 1
        return {"promoted": promoted, "demoted": demoted}

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"promotions": self.promotions,
                    "demotions": self.demotions,
                    "replication_steps": self.steps}
