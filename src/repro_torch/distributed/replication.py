"""EWMA request rates: the tracker behind hot-graph decisions.

This module holds only :class:`EwmaRate`, which the partition autotuner
(:mod:`repro_torch.tuning.tuner`) uses to decide which graphs are hot
enough to tune. The rest of the reference's ``distributed/replication.py``
(``ReplicaManager``: hot-plan replica promotion and demotion across
devices) arrives with the distributed slice.

Pure Python: the same observations under the same clock read the same
rates as the reference's tracker.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict

__all__ = ["EwmaRate"]

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
