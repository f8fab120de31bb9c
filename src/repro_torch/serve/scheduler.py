"""Continuous-batching core of the graph serving engine.

Serving architecture::

    callers --- submit(payload) ----> [ admission queue (bounded) ]
                                             |
                     flush trigger: size >= max_batch OR oldest item
                     older than max_wait_ms OR drain on stop()
                                             |
                                     [ flush callback ]      (engine-owned)
                    graph engine: group by plan -> fuse feature axis
                                  -> fused block-slab kernel dispatch
                                             |
                            item.complete(result) resolves the future

The point of the core: *cross-caller* batching. A blocking
``serve(requests)`` API can only fuse work the caller already collected;
with an admission queue, requests from N concurrent callers land in one
flush and share a single fused dispatch — the partition-plan amortization
of the paper (degree sort + block partition built once, reused by every
request on that graph) pays off across the whole process, not per call
site. AWB-GCN's runtime-rebalancing argument is the hardware-side version
of the same point: balance whatever work is *in flight*, not per call.

Components:

* :class:`WorkItem` — one admitted request: payload + ``Future`` + enqueue
  timestamp. The flush callback answers items with ``complete(result)`` /
  ``fail(exc)``; the scheduler records enqueue->answer latency at that
  moment. Items a flush leaves unanswered are failed by the scheduler so
  no caller ever blocks forever.
* :class:`BatchScheduler` — the background flush thread. ``submit`` /
  ``submit_many`` enqueue (with backpressure: block, or raise
  :class:`QueueFullError` with ``block=False``); ``take_ready`` lets a
  running flush pull newly-arrived work mid-flight (the token engine's
  slot reuse); ``stats()`` reports queue depth, flush-reason counts and
  latency percentiles — one stats vocabulary for both engines.

Tuning knobs:

* ``max_batch`` — flush as soon as this many items are queued. Bound it by
  what one fused dispatch can absorb (the graph engine separately chunks a
  flush into dispatches of ``max_graphs_per_batch`` distinct graphs).
* ``max_wait_ms`` — deadline flush: the oldest queued item never waits
  longer than this for co-batchable traffic. Raise it to trade tail
  latency for larger fused batches; lower it toward 0 for latency-first
  serving (each flush then carries whatever arrived during the previous
  dispatch — still cross-caller batching under load).
* ``max_queue`` — admission bound. When the queue is full, ``submit``
  blocks (backpressure propagates to callers) or raises.

SLO classes (``classes=[ClassSpec(...)]``): every admitted item carries a
request class (and optionally a tenant tag). Classes add three behaviors on
top of the base FIFO scheduler — which is exactly what a single default
class degenerates to:

* **weighted-fair admission** — each class below the top priority tier gets
  an admission quota proportional to its weight, so a batch-job flood can
  fill at most its share of the queue and an interactive submitter always
  finds room (the top tier is bounded only by ``max_queue``).
* **priority + weighted-fair batch formation** — a flush batch drains the
  highest-priority non-empty tier first; classes sharing a tier interleave
  in proportion to their weights (deficit round-robin), FIFO within each
  class. A deep batch backlog therefore cannot starve interactive items
  that arrived later.
* **early-flush-for-deadline** — a class with ``deadline_ms`` flushes after
  ``min(max_wait_ms, deadline_ms/4)`` instead of the scheduler-wide wait,
  so an SLO-bound request never burns its latency budget waiting for
  co-batchable traffic. Misses are counted per class
  (``class_deadline_missed``) and per-class latency percentiles are
  reported next to the global ones.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

__all__ = ["QueueFullError", "ClassSpec", "WorkItem", "BatchScheduler",
           "percentile"]


class QueueFullError(RuntimeError):
    """Admission rejected: the queue is at ``max_queue`` (backpressure)."""


@dataclasses.dataclass(frozen=True)
class ClassSpec:
    """One request class (SLO tier) of a :class:`BatchScheduler`.

    ``priority`` orders tiers (higher drains first); ``weight`` sets both
    the admission quota and the fair share among classes of the SAME
    priority; ``deadline_ms`` is the class's enqueue->answer SLO target —
    it tightens the co-batching wait (early flush) and drives the
    ``class_deadline_missed`` counter. ``max_wait_ms`` overrides the
    derived co-batching wait outright.
    """

    name: str
    priority: int = 0
    weight: float = 1.0
    deadline_ms: Optional[float] = None
    max_wait_ms: Optional[float] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("class name must be non-empty")
        if self.weight <= 0:
            raise ValueError(f"class {self.name}: weight must be > 0")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(f"class {self.name}: deadline_ms must be > 0")
        if self.max_wait_ms is not None and self.max_wait_ms < 0:
            raise ValueError(f"class {self.name}: max_wait_ms must be >= 0")

    def effective_wait_ms(self, scheduler_wait_ms: float) -> float:
        """Co-batching wait for this class: an explicit override wins;
        otherwise a deadline-bearing class flushes after at most a quarter
        of its SLO budget (leaving the rest for dispatch + compute)."""
        if self.max_wait_ms is not None:
            return self.max_wait_ms
        if self.deadline_ms is not None:
            return min(scheduler_wait_ms, self.deadline_ms / 4.0)
        return scheduler_wait_ms


DEFAULT_CLASS = ClassSpec("default")


def percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted sequence (0 <= q <= 1).

    Nearest-rank index is ``ceil(q * n) - 1`` (clamped): the q-quantile is
    the smallest value with at least ``q * n`` values at or below it, so
    ``percentile([1, 2, 3, 4], 0.5) == 2.0`` (not 3.0 — the old ``int(q*n)``
    index sat one rank high for every q that is not an exact rank boundary).
    ``q=0`` returns the minimum, ``q=1`` the maximum, a singleton its only
    element.
    """
    if not sorted_vals:
        return 0.0
    n = len(sorted_vals)
    idx = min(n - 1, max(0, math.ceil(q * n) - 1))
    return float(sorted_vals[idx])


class WorkItem:
    """One admitted request: payload, future, and latency bookkeeping.

    A caller may ``.cancel()`` the returned future at any moment, including
    while the flush thread is mid-``complete``. Both answer paths therefore
    *claim* the future atomically first (``set_running_or_notify_cancel``,
    which holds the Future's own lock): whoever wins the race settles the
    item exactly once, the loser is a silent no-op, and a lost race against
    a cancel is recorded in the scheduler's ``cancelled`` counter — never an
    ``InvalidStateError`` that would poison the rest of the flush.
    """

    __slots__ = ("payload", "future", "t_enqueue", "t_done", "_sched",
                 "_settled", "klass", "tenant", "flush_at", "deadline_at")

    def __init__(self, payload: Any, sched: "BatchScheduler",
                 klass: str = "default", tenant: Optional[str] = None):
        self.payload = payload
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()
        self.t_done: Optional[float] = None
        self._sched = sched
        self._settled = False   # some claim attempt already concluded this
        #                         item (fast path only; the Future's own
        #                         lock remains the arbiter)
        self.klass = klass
        self.tenant = tenant
        spec = sched.classes.get(klass, DEFAULT_CLASS)
        self.flush_at = (self.t_enqueue
                         + spec.effective_wait_ms(sched.max_wait_ms) / 1e3)
        self.deadline_at = (None if spec.deadline_ms is None
                            else self.t_enqueue + spec.deadline_ms / 1e3)

    @property
    def deadline_missed(self) -> bool:
        """True once the item resolved later than its class SLO deadline."""
        return (self.deadline_at is not None and self.t_done is not None
                and self.t_done > self.deadline_at)

    @property
    def done(self) -> bool:
        return self.future.done()

    @property
    def latency_s(self) -> Optional[float]:
        """Enqueue -> answer wall time (queue wait included); None until done."""
        return None if self.t_done is None else self.t_done - self.t_enqueue

    def _claim(self) -> bool:
        """Atomically win (or lose) the settle race against ``Future.cancel``.

        Returns True when this thread now owns the only right to settle the
        future (``cancel()`` can no longer succeed). Returns False when the
        item is already settled/claimed, or when the caller's cancel won —
        the latter is counted exactly once (the CANCELLED -> NOTIFIED
        transition happens on one thread only).
        """
        # fast path: an already-concluded item (answered, or a cancel we
        # already recorded) — skips the stdlib's CRITICAL "unexpected
        # state" log that set_running_or_notify_cancel emits on settled
        # futures; pure optimization, the Future's lock decides below
        if self._settled or (self.future.done()
                             and not self.future.cancelled()):
            return False
        try:
            claimed = self.future.set_running_or_notify_cancel()
        except RuntimeError:
            self._settled = True
            return False            # already answered (double complete/fail)
        if not claimed:             # caller's cancel() won the race
            self._settled = True
            self._sched._record_cancelled(self)
            return False
        self._settled = True
        return True

    def complete(self, result: Any) -> None:
        """Resolve the item's future and record its latency (idempotent;
        swallows a lost race against a caller-side ``cancel()``)."""
        if not self._claim():
            return
        self.t_done = time.perf_counter()
        self._sched._record_done(self, failed=False)
        self.future.set_result(result)

    def fail(self, exc: BaseException) -> None:
        if not self._claim():
            return
        self.t_done = time.perf_counter()
        self._sched._record_done(self, failed=True)
        self.future.set_exception(exc)


class BatchScheduler:
    """Background-thread continuous batcher with size/deadline flush triggers.

    ``flush_fn(items)`` runs on the scheduler thread with a batch of up to
    ``max_batch`` :class:`WorkItem`; it must answer every item (via
    ``complete``/``fail``) — stragglers are failed by the scheduler, and a
    raising flush fails every unanswered item of that flush with the raised
    exception. ``flush_fn`` may call :meth:`take_ready` to pull extra
    queued items into the running flush (slot reuse); those pulled items
    join the flush's failure scope.

    The worker thread is a daemon and starts lazily on first submit, so
    constructing an engine never spawns a thread it won't use.
    """

    # latency ring size: enough for stable p99 without unbounded growth
    _LAT_WINDOW = 4096

    def __init__(
        self,
        flush_fn: Callable[[List[WorkItem]], None],
        *,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        max_queue: int = 256,
        name: str = "batch-scheduler",
        classes: Optional[Sequence[ClassSpec]] = None,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        self.flush_fn = flush_fn
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.max_queue = max_queue
        self.name = name

        # request classes: always at least "default" (pure FIFO semantics
        # when it is the only one). Listed specs may override "default".
        self.classes: Dict[str, ClassSpec] = {"default": DEFAULT_CLASS}
        for spec in classes or ():
            self.classes[spec.name] = spec
        self._quota = self._admission_quotas()

        self._cond = threading.Condition()
        self._queues: Dict[str, "deque[WorkItem]"] = {
            name: deque() for name in self.classes}
        # deficit-round-robin credits for weighted interleave inside one
        # priority tier (guarded by _cond; reset when a class drains)
        self._credits: Dict[str, float] = {name: 0.0 for name in self.classes}
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._closing = False     # stop() in progress: admissions raise
        self._current_extra: List[WorkItem] = []  # take_ready pulls, per flush

        # counters (guarded by _cond; all monotone)
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.cancelled = 0           # caller-side Future.cancel() wins;
        #                              completed + failed + cancelled
        #                              == settled submissions
        self.rejected = 0            # QueueFullError admissions (per ITEM)
        self.flushes = 0
        self.items_flushed = 0
        self.mid_flush_admissions = 0  # items pulled by take_ready
        self.flush_reasons: Dict[str, int] = {
            "size": 0, "deadline": 0, "drain": 0, "slo": 0}
        self.peak_queue_depth = 0
        self._latencies: "deque[float]" = deque(maxlen=self._LAT_WINDOW)
        self._total_latency_s = 0.0
        # per-class accounting (same lock): latency windows + SLO misses
        self._class_latencies: Dict[str, "deque[float]"] = {
            name: deque(maxlen=self._LAT_WINDOW) for name in self.classes}
        self.class_completed: Dict[str, int] = {n: 0 for n in self.classes}
        self.class_deadline_missed: Dict[str, int] = {
            n: 0 for n in self.classes}

    def _admission_quotas(self) -> Dict[str, int]:
        """Per-class admission bound. Top-priority classes may use the whole
        queue; every lower tier is capped at its weighted share, so a
        lower-priority flood can never fill the queue against the top tier
        (weighted-fair admission)."""
        top = max(spec.priority for spec in self.classes.values())
        total_w = sum(spec.weight for spec in self.classes.values())
        quotas = {}
        for name, spec in self.classes.items():
            if spec.priority >= top:
                quotas[name] = self.max_queue
            else:
                quotas[name] = max(1, int(self.max_queue
                                          * spec.weight / total_w))
        return quotas

    # ---------------------------------------------------------- queue helpers
    def _qsize_locked(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _class_of_locked(self, klass: str) -> "deque[WorkItem]":
        q = self._queues.get(klass)
        if q is None:
            raise KeyError(
                f"{self.name}: unknown request class {klass!r} "
                f"(known: {sorted(self.classes)})")
        return q

    def _admission_full_locked(self, klass: str, need: int = 1) -> bool:
        if self._qsize_locked() + need > self.max_queue:
            return True
        return len(self._queues[klass]) + need > self._quota[klass]

    def _pop_next_locked(self) -> Optional[WorkItem]:
        """Pop the next item under priority + weighted-fair (DRR) order:
        highest non-empty priority tier first; classes sharing that tier
        interleave proportionally to their weights; FIFO within a class."""
        active = [n for n, q in self._queues.items() if q]
        if not active:
            return None
        if len(active) == 1:
            return self._queues[active[0]].popleft()
        top = max(self.classes[n].priority for n in active)
        tier = [n for n in active if self.classes[n].priority == top]
        if len(tier) == 1:
            return self._queues[tier[0]].popleft()
        for n in tier:
            self._credits[n] += self.classes[n].weight
        pick = max(tier, key=lambda n: self._credits[n])
        self._credits[pick] -= sum(self.classes[n].weight for n in tier)
        return self._queues[pick].popleft()

    def _take_batch_locked(self, k: int) -> List[WorkItem]:
        items: List[WorkItem] = []
        while len(items) < k:
            item = self._pop_next_locked()
            if item is None:
                break
            items.append(item)
        # drained classes reset their credit so an idle class cannot bank
        # an unbounded claim on future flushes
        for n, q in self._queues.items():
            if not q:
                self._credits[n] = 0.0
        return items

    def _next_flush_at_locked(self) -> Optional[float]:
        """Earliest flush deadline over queued items. FIFO within a class
        and a constant per-class wait make each queue head the earliest of
        its class, so the scan is O(classes)."""
        heads = [q[0].flush_at for q in self._queues.values() if q]
        return min(heads) if heads else None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        with self._cond:
            self._ensure_started_locked()

    def _ensure_started_locked(self) -> None:
        """Guarantee a live worker exists for subsequently-enqueued items.

        Called (under the lock) immediately before EVERY enqueue — including
        after a backpressure wait, during which the scheduler may have been
        stopped — so no item can enter a queue nothing will drain. While a
        ``stop()`` is in progress admissions raise instead of resurrecting
        the worker out from under the join.
        """
        if self._closing:
            raise RuntimeError(f"{self.name}: scheduler is stopping")
        self._running = True
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._worker, name=self.name, daemon=True)
            self._thread.start()

    @property
    def running(self) -> bool:
        return self._running

    def stop(self, timeout: Optional[float] = None) -> None:
        """Stop the worker, draining (flushing) everything still queued.

        Concurrent ``submit`` calls racing a stop get ``RuntimeError``;
        after stop returns, a new submit restarts the scheduler cleanly.
        """
        with self._cond:
            self._running = False
            self._closing = True
            self._cond.notify_all()
            thread = self._thread
        try:
            if thread is not None:
                thread.join(timeout)
        finally:
            with self._cond:
                self._closing = False

    def __enter__(self) -> "BatchScheduler":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ admission
    def submit(self, payload: Any, *, block: bool = True,
               timeout: Optional[float] = None, klass: str = "default",
               tenant: Optional[str] = None) -> WorkItem:
        """Admit one payload; returns its :class:`WorkItem` (with ``.future``).

        A full queue blocks (backpressure) until a flush drains it, or
        raises :class:`QueueFullError` when ``block=False`` or ``timeout``
        expires. ``klass`` must name a configured :class:`ClassSpec`; a
        class at its weighted admission quota backpressures exactly like a
        full queue (other classes are unaffected).
        """
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cond:
            self._class_of_locked(klass)
            self._ensure_started_locked()
            while self._admission_full_locked(klass):
                if not block:
                    self.rejected += 1
                    raise QueueFullError(
                        f"{self.name}: queue full for class {klass!r} "
                        f"({len(self._queues[klass])}/{self._quota[klass]}, "
                        f"total {self._qsize_locked()}/{self.max_queue})")
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    self.rejected += 1
                    raise QueueFullError(
                        f"{self.name}: queue full for class {klass!r} "
                        f"after {timeout}s")
                self._cond.wait(remaining)
            # the wait may have outlived a stop(): re-ensure a live worker
            self._ensure_started_locked()
            return self._enqueue_locked(payload, klass, tenant)

    def submit_many(self, payloads: Sequence[Any], *, block: bool = True,
                    timeout: Optional[float] = None,
                    klass: Union[str, Sequence[str]] = "default",
                    tenant: Union[None, str, Sequence[Optional[str]]] = None,
                    ) -> List[WorkItem]:
        """Atomically admit several payloads: they enter the queue as one
        contiguous run, so a single flush sees them together (this is what
        keeps the synchronous ``serve(requests)`` wrapper's batching
        semantics). Blocks until the whole run fits — or, when the run is
        larger than ``max_queue``, until the queue is empty (the run is
        then admitted as an oversized burst rather than deadlocking).

        A rejection (``block=False`` or an expired ``timeout``, matching
        :meth:`submit`) rejects the whole run and counts EVERY item of it in
        ``rejected`` — the counter tracks items, not calls, so it stays
        comparable with ``submitted`` no matter how admissions were batched.
        """
        payloads = list(payloads)
        if not payloads:
            return []
        klasses = ([klass] * len(payloads) if isinstance(klass, str)
                   else list(klass))
        if len(klasses) != len(payloads):
            raise ValueError(
                f"{len(klasses)} classes for {len(payloads)} payloads")
        tenants = ([tenant] * len(payloads)
                   if tenant is None or isinstance(tenant, str)
                   else list(tenant))
        if len(tenants) != len(payloads):
            raise ValueError(
                f"{len(tenants)} tenants for {len(payloads)} payloads")
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cond:
            for k in set(klasses):
                self._class_of_locked(k)
            self._ensure_started_locked()
            need = len(payloads)
            while (self._qsize_locked() + need > self.max_queue
                   and self._qsize_locked() > 0):
                if not block:
                    self.rejected += need
                    raise QueueFullError(
                        f"{self.name}: no room for {need} items "
                        f"(queue {self._qsize_locked()}/{self.max_queue})")
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    self.rejected += need
                    raise QueueFullError(
                        f"{self.name}: no room for {need} items "
                        f"(queue {self._qsize_locked()}/{self.max_queue}) "
                        f"after {timeout}s")
                self._cond.wait(remaining)
            # the wait may have outlived a stop(): re-ensure a live worker
            self._ensure_started_locked()
            return [self._enqueue_locked(p, k, t)
                    for p, k, t in zip(payloads, klasses, tenants)]

    def _enqueue_locked(self, payload: Any, klass: str = "default",
                        tenant: Optional[str] = None) -> WorkItem:
        item = WorkItem(payload, self, klass, tenant)
        self._queues[klass].append(item)
        self.submitted += 1
        self.peak_queue_depth = max(self.peak_queue_depth,
                                    self._qsize_locked())
        self._cond.notify_all()
        return item

    def adopt(self, payload: Any, klass: str = "default",
              tenant: Optional[str] = None) -> WorkItem:
        """Create an item counted as submitted but NOT enqueued — the
        caller dispatches it directly on its own thread.

        This exists for work that must not wait behind the single flush
        worker: the multihost peer handler executes forwarded groups
        inline, because host A's worker blocks on B's answer while B's
        worker may be blocked on A's — two single-worker schedulers
        queueing each other's forwards through the data plane is a
        deadlock. Adopted items feed the same counters through
        ``complete``/``fail``/cancel, so ``completed + failed + cancelled
        == submitted`` still holds.
        """
        with self._cond:
            item = WorkItem(payload, self, klass, tenant)
            self.submitted += 1
            return item

    def take_ready(self, k: int) -> List[WorkItem]:
        """Non-blocking pop of up to ``k`` queued items into the RUNNING
        flush (call only from ``flush_fn``). Enables slot reuse: a decode
        loop refills freed slots with work that arrived after the flush
        started, instead of waiting for the next flush boundary. Items come
        out in the same priority/weighted-fair order a flush batch uses.
        """
        if k <= 0:
            return []
        with self._cond:
            items = self._take_batch_locked(k)
            if items:
                self.mid_flush_admissions += len(items)
                self._current_extra.extend(items)
                self._cond.notify_all()   # wake backpressured submitters
            return items

    # ------------------------------------------------------------ worker
    def _worker(self) -> None:
        while True:
            with self._cond:
                while self._running and not self._qsize_locked():
                    self._cond.wait()
                if not self._qsize_locked():
                    if not self._running:
                        # clear the handle under the SAME lock hold as the
                        # exit decision, so _ensure_started_locked can never
                        # see a live-but-doomed worker and skip the restart
                        self._thread = None
                        return
                    continue
                now = time.perf_counter()
                next_flush = self._next_flush_at_locked()
                if not self._running:
                    reason = "drain"
                elif self._qsize_locked() >= self.max_batch:
                    reason = "size"
                elif now >= next_flush:
                    # "slo": a deadline-bearing class tightened the wait
                    # below the scheduler-wide max_wait_ms (early flush)
                    plain = min(q[0].t_enqueue
                                for q in self._queues.values()
                                if q) + self.max_wait_ms / 1e3
                    reason = "slo" if next_flush < plain - 1e-9 else "deadline"
                else:
                    self._cond.wait(next_flush - now)
                    continue
                batch = self._take_batch_locked(self.max_batch)
                self.flushes += 1
                self.flush_reasons[reason] += 1
                self.items_flushed += len(batch)
                self._current_extra = []
                self._cond.notify_all()   # queue drained: wake submitters
            try:
                self.flush_fn(batch)
                exc: Optional[BaseException] = None
            except BaseException as e:     # noqa: BLE001 — must not kill the
                exc = e                    # worker; every waiter gets the exc
            fallback = exc or RuntimeError(
                f"{self.name}: flush returned without answering item")
            # unconditional fail (no done-check): fail() itself settles the
            # check-then-settle race atomically, so a cancel landing between
            # a guard and the settle can no longer raise InvalidStateError
            # here and kill the worker thread; already-answered items are
            # no-ops, cancelled-but-unanswered items are counted as such
            for item in batch + self._current_extra:
                item.fail(fallback)

    # ------------------------------------------------------------ stats
    def _record_done(self, item: WorkItem, *, failed: bool) -> None:
        with self._cond:
            if failed:
                self.failed += 1
            else:
                self.completed += 1
                self.class_completed[item.klass] = \
                    self.class_completed.get(item.klass, 0) + 1
            if item.latency_s is not None:
                self._latencies.append(item.latency_s)
                self._total_latency_s += item.latency_s
                self._class_latencies.setdefault(
                    item.klass, deque(maxlen=self._LAT_WINDOW)
                ).append(item.latency_s)
            if item.deadline_missed:
                self.class_deadline_missed[item.klass] = \
                    self.class_deadline_missed.get(item.klass, 0) + 1

    def _record_cancelled(self, item: WorkItem) -> None:
        """A caller's ``Future.cancel()`` beat the flush to this item.

        Called exactly once per cancelled item — from the one thread that
        observed the CANCELLED -> CANCELLED_AND_NOTIFIED transition — so
        ``completed + failed + cancelled`` accounts for every item a flush
        attempted to answer, without double counting.
        """
        with self._cond:
            self.cancelled += 1

    def queue_depth(self) -> int:
        with self._cond:
            return self._qsize_locked()

    def stats(self) -> Dict[str, float]:
        """Snapshot of the scheduling counters (shared engine vocabulary)."""
        with self._cond:
            lats = sorted(self._latencies)
            answered = self.completed + self.failed
            per_class_p50 = {}
            per_class_p99 = {}
            for name, window in self._class_latencies.items():
                cl = sorted(window)
                per_class_p50[name] = percentile(cl, 0.50)
                per_class_p99[name] = percentile(cl, 0.99)
            return {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "cancelled": self.cancelled,
                "rejected": self.rejected,
                "flushes": self.flushes,
                "items_flushed": self.items_flushed,
                "items_per_flush": (self.items_flushed / self.flushes
                                    if self.flushes else 0.0),
                "mid_flush_admissions": self.mid_flush_admissions,
                "flush_size": self.flush_reasons["size"],
                "flush_deadline": self.flush_reasons["deadline"],
                "flush_drain": self.flush_reasons["drain"],
                "flush_slo": self.flush_reasons["slo"],
                "queue_depth": self._qsize_locked(),
                "peak_queue_depth": self.peak_queue_depth,
                "class_queue_depth": {n: len(q)
                                      for n, q in self._queues.items()},
                "class_completed": dict(self.class_completed),
                "class_deadline_missed": dict(self.class_deadline_missed),
                "per_class_p50": per_class_p50,
                "per_class_p99": per_class_p99,
                "avg_latency_s": (self._total_latency_s / answered
                                  if answered else 0.0),
                "p50_latency_s": percentile(lats, 0.50),
                "p90_latency_s": percentile(lats, 0.90),
                "p99_latency_s": percentile(lats, 0.99),
            }
