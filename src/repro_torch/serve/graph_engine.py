"""Graph inference serving: continuous-batched, plan-cached SpMM dispatch.

Serving architecture (scheduler -> flush -> dispatch)::

    callers ----- submit(graph_id, x) -> Future ------.
    threads ----- submit(graph_id, x) -> Future ------+--> BatchScheduler
    serve(reqs) - submit_many (sync wrapper) ---------'    admission queue
                                                               |
                               flush (size >= max_batch_requests, or the
                               oldest request is max_wait_ms old)
                                                               |
                                  _flush: reads first, then mutations;
                                  _flush_reads: group requests BY PLAN
                                  (graph), fuse same-graph features along
                                  the F axis, chunk distinct graphs into
                                  dispatches of <= max_graphs_per_batch
                                                               |
                                  _dispatch: merge slabs on the device,
                                  bucket blocks, route the merged shape,
                                  ONE fused kernel launch (K1 | K2 | K3)
                                                               |
                                  un-permute rows, split feature columns,
                                  item.complete(out) resolves each Future

The background admission queue is what makes batching *cross-caller*:
requests on recurring graphs coalesce into fused dispatches no matter who
submitted them, and the (thread-safe) plan cache is read from the single
flush thread.

Tuning knobs:

* ``max_batch_requests`` / ``max_wait_ms`` — scheduler flush triggers.
* ``max_graphs_per_batch`` — distinct graphs fused into one kernel call
  (a flush larger than this becomes several dispatches, in arrival order).
* ``max_pending`` — admission bound; full queue blocks submitters
  (backpressure) or raises with ``submit(..., block=False)``.

Per-request (enqueue->answer) latency comes from the scheduler's WorkItem
clock; per-dispatch wall time accumulates separately in ``total_serve_s``.
``stats()`` merges engine counters, plan-cache counters (``cache_*``) and
scheduler counters (``sched_*``).

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``.
Backends: ``auto`` routes every fused dispatch by the reference's policy
(``kernels/router.py``) to K1 (resident), K2 (windowed) or K3 (hbm);
``pallas`` forces K1 and raises ``VmemBudgetError`` past the resident
threshold; ``windowed`` and ``hbm`` force K2 and K3; ``accel`` (the
default) is K1 with no routing; ``blocked`` is the PyTorch twin. Each
dispatch counts under the regime it ran (``routed_*`` in ``stats()``).

Live edge mutation (``mutate``) rides the same admission queue: a flush
dispatches its reads against the pinned pre-publish plan versions, then
applies its deltas per graph in arrival order, repairs the plan once
(``core/plan_repair.py``) and publishes the next version.

Online partition autotuning (``tuner=PlanTuner(...)``): after a dispatch
has answered, the tuner may ask for a SHADOW of it — the same features
through a candidate plan, measured against the incumbent in a paired ABBA
run on one worker thread. On the card the worker runs on its own CUDA
stream, so a live dispatch (which synchronizes its own stream before it
answers) does not wait for the shadow's kernels to finish. Reads still
pay at the tail while a shadow is in flight: its candidate plan is built
on the host in this process (the worker holds the GIL), and its launches
share the SMs with the live ones. A candidate that wins its streak is
published through the same version chain as a mutation.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.graph import CSRGraph, gcn_normalize
from ..core.plan_cache import (
    DeviceLike, PartitionConfig, PartitionPlan, PlanCache, _config_tag,
    build_partition_plan, graph_content_hash, resolve_device,
)
from ..core.plan_repair import EdgeDelta, delta_chain_hash, repair_plan
from ..kernels.router import RoutingDecision
from ..launch.mesh import resolve_slots
from ..kernels.spmm_batched import bucket_blocks, spmm_batched
from ..tuning.search import TuningCandidate
from ..tuning.tuner import PlanTuner, time_call
from .scheduler import BatchScheduler, ClassSpec, WorkItem

__all__ = ["GraphRequest", "GraphServeEngine"]

logger = logging.getLogger(__name__)

# the reference engine's backends plus the port's unrouted K1
_BACKENDS = ("auto", "pallas", "windowed", "hbm", "blocked", "accel")
# stats key of the backends that take no routing decision (K1 is the
# reference's resident kernel)
_UNROUTED = {"accel": "resident", "blocked": "blocked"}

# per-plan dispatch timing ring: last N wall times per plan key, bounded
# to the most recently dispatched keys so a graph-churn workload can't
# grow the map without bound
PLAN_TIMING_RING = 64
PLAN_TIMING_KEYS = 256


@dataclasses.dataclass
class GraphRequest:
    """One aggregation request: A'_graph_id @ x, answered in ORIGINAL row order."""

    graph_id: str
    x: torch.Tensor                        # [n_cols(graph), F]
    out: Optional[torch.Tensor] = None     # filled by serve()
    latency_s: Optional[float] = None  # enqueue -> answer wall time (includes
    #                                    queue wait behind earlier dispatches)
    klass: str = "default"             # SLO class (must name a ClassSpec)
    tenant: Optional[str] = None       # opaque owner tag (stats only)


class GraphServeEngine:
    """Continuous-batching multi-graph SpMM server over a partition-plan cache.

    ``submit`` is the native entry point (asynchronous, returns a
    ``Future``); ``serve``/``serve_one`` are thin synchronous wrappers that
    submit and wait — all three share the scheduler, so synchronous callers
    still coalesce with concurrent submitters.
    """

    def __init__(
        self,
        *,
        device: DeviceLike = None,
        config: Optional[PartitionConfig] = None,
        cache: Optional[PlanCache] = None,
        cache_capacity: int = 32,
        backend: str = "accel",
        max_graphs_per_batch: int = 8,
        block_bucket: Optional[int] = 8,
        max_batch_requests: Optional[int] = None,
        max_wait_ms: float = 2.0,
        max_pending: int = 256,
        feature_bucket: bool = True,
        classes: Optional[Sequence[ClassSpec]] = None,
        repair_churn_threshold: float = 0.25,
        tuner: Optional[PlanTuner] = None,
    ):
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {'|'.join(_BACKENDS)}")
        self.device = resolve_device(device)
        self.config = config or PartitionConfig()
        if cache is None:
            cache = PlanCache(cache_capacity, device=self.device)
        else:
            # a fleet's cache stages on several slots, the first of them
            # the engine's own device
            staged = getattr(cache, "devices", None) or [cache.device]
            if resolve_slots([self.device]) != resolve_slots(staged[:1]):
                raise ValueError(f"plan cache stages on {staged[0]}, engine "
                                 f"runs on {self.device}")
        self.cache = cache
        self.backend = backend
        self.max_graphs_per_batch = max_graphs_per_batch
        # min bucket tier: power-of-two tiers from here cap padding waste
        # below 2x the live blocks
        self.block_bucket = block_bucket
        # fused feature widths round up to powers of two: the width of a
        # same-graph group is (requests in flush) x F, which varies with
        # flush composition under concurrent traffic — bucketing keeps the
        # dispatched-shape set logarithmic instead of one shape per mix
        self.feature_bucket = feature_bucket
        # above this fraction of rows dirtied by a delta, incremental plan
        # repair falls back to a full rebuild (see core.plan_repair)
        self.repair_churn_threshold = repair_churn_threshold
        self._graphs: Dict[str, CSRGraph] = {}
        self._keys: Dict[str, tuple] = {}  # graph_id -> plan key (hashed once)
        self._versions: Dict[str, int] = {}  # graph_id -> published version
        # _bind_lock guards the three maps above as ONE atomic binding:
        # readers (plan_for, _validate-time lookups) must never observe a
        # graph from version v+1 paired with the key of version v
        self._bind_lock = threading.Lock()
        # serializes mutation application + publish per engine; reads never
        # take it (they pin a version instead)
        self._mutate_lock = threading.Lock()
        # one flush absorbs several dispatches' worth of requests so a
        # deadline-triggered flush under load still fills whole batches
        self.scheduler = BatchScheduler(
            self._flush,
            max_batch=max_batch_requests or 4 * max_graphs_per_batch,
            max_wait_ms=max_wait_ms,
            max_queue=max_pending,
            name="graph-serve",
            classes=classes,
        )
        # serving counters, updated on the flush thread under this lock
        self._counters_lock = threading.Lock()
        self.requests_served = 0
        self.batches_dispatched = 0
        self.graphs_dispatched = 0   # distinct graphs summed over dispatches
        self.rows_served = 0
        self.values_served = 0       # rows * feature columns
        self.total_serve_s = 0.0     # sum of per-DISPATCH wall times
        self.total_request_latency_s = 0.0  # sum of enqueue->answer times
        self.live_blocks = 0         # merged blocks carrying real slabs
        self.padded_blocks = 0       # blocks actually dispatched (bucketed)
        self.backend_dispatches: Dict[str, int] = {
            "resident": 0, "windowed": 0, "hbm": 0, "blocked": 0}
        self.last_decision: Optional[RoutingDecision] = None
        # mutation-path counters (versioned plan lifecycle)
        self.mutations_applied = 0   # mutate() requests resolved
        self.mutation_edges = 0      # edge inserts+deletes applied
        self.plan_repairs = 0        # publishes served by incremental repair
        self.plan_rebuilds = 0       # publishes that fell back to full build
        # per-plan dispatch wall times: key -> deque of (seconds, exact)
        # where exact=True means the dispatch held ONLY this plan (a fused
        # multi-graph dispatch records its per-plan SHARE, flagged inexact)
        self._plan_times: "OrderedDict[tuple, deque]" = OrderedDict()
        # --- online partition autotuning (shadow-measured rollout) -------
        # The tuner only ever acts on COPIES of live work: a shadow
        # duplicates one dispatch onto the candidate plan on a separate
        # single worker thread AFTER the live futures resolved, and on the
        # card on a stream of its own, so no live dispatch waits for a
        # candidate's kernels (it still shares the host and the SMs with
        # them). At most one shadow is in flight per engine; when the
        # worker is busy the opportunity is skipped, never queued.
        self.tuner = tuner
        self._shadow_pool: Optional[ThreadPoolExecutor] = None
        self._shadow_stream: Optional["torch.cuda.Stream"] = None
        self._shadow_lock = threading.Lock()
        self._shadow_inflight = False
        # tuned dispatch hints by graph id, re-attached to plans rebuilt
        # from scratch after an eviction (the structure comes back via the
        # config in the key; the backend/grid_order hints live here)
        self._tuned_hints: Dict[str, Dict] = {}
        self.shadow_dispatches = 0   # candidate measurements completed
        self.shadow_skipped = 0      # opportunities dropped (worker busy)
        self.shadow_failures = 0     # candidate build/dispatch raised
        self.shadow_time_s = 0.0     # wall time spent in shadow measurements
        self.tuned_promotions = 0    # tuned configs published

    # ------------------------------------------------------------------ admin
    def register_graph(self, graph_id: str, g: CSRGraph,
                       normalize: bool = False) -> PartitionPlan:
        """Register (and warm the plan for) a graph under ``graph_id``.

        Re-registering the same id with identical content is a no-op (cache
        hit); different content replaces the binding and continues the id's
        version chain. A same-content re-register keeps a TUNED binding
        (the autotuner may have promoted a non-default config for this
        graph — identical content must not silently reset it to
        ``self.config``).
        """
        if normalize:
            g = gcn_normalize(g)
        h = graph_content_hash(g)
        with self._bind_lock:
            prev_key = self._keys.get(graph_id)
        if prev_key is not None and prev_key[0] == h and \
                prev_key != (h, self.config):
            return self.plan_for(graph_id)  # tuned binding, same content
        key = (h, self.config)
        plan = self.cache.get_by_key(
            key, lambda: build_partition_plan(g, self.config, graph_hash=h,
                                              device=self.device))
        with self._bind_lock:
            prev_key = self._keys.get(graph_id)
            prev_ver = self._versions.get(graph_id)
            if prev_key == plan.key and prev_ver is not None:
                version = prev_ver          # idempotent re-register
            elif prev_ver is not None:
                # content replacement continues the id's version chain so
                # version invalidation stays monotone
                version = max(plan.version, prev_ver + 1)
            else:
                version = plan.version
            self._graphs[graph_id] = g
            self._keys[graph_id] = plan.key
            self._versions[graph_id] = version
        return plan

    def register_subgraph(self, g: CSRGraph, prefix: str = "sub",
                          normalize: bool = False) -> str:
        """Register an induced subgraph under a CONTENT-DERIVED id.

        The id is ``f"{prefix}:{content_hash[:16]}"`` — the same frontier
        sampled twice registers under the same id and partitions exactly
        once (registration is idempotent on identical content). Returns the
        graph id to pass to ``submit``.
        """
        if normalize:
            g = gcn_normalize(g)
        graph_id = f"{prefix}:{graph_content_hash(g)[:16]}"
        self.register_graph(graph_id, g)
        return graph_id

    def unregister_graph(self, graph_id: str) -> bool:
        """Drop a graph's binding (id -> graph, plan key, version and tuned
        hints).

        The plan itself stays in the LRU cache until evicted — a later
        ``register_subgraph`` of the same content re-binds without a
        rebuild. The caller must have drained in-flight work for the id;
        the engine does not fence racing submits. Returns whether the id
        was registered.
        """
        with self._bind_lock:
            known = graph_id in self._graphs
            self._graphs.pop(graph_id, None)
            self._keys.pop(graph_id, None)
            self._versions.pop(graph_id, None)
            self._tuned_hints.pop(graph_id, None)
        return known

    def submit_gather(self, graph_id: str, x: torch.Tensor,
                      rows: np.ndarray, *, block: bool = True,
                      klass: str = "default",
                      tenant: Optional[str] = None) -> Future:
        """``submit`` plus a gather epilogue: the returned ``Future``
        resolves to ``aggregation[rows]`` instead of the full ``[n_rows,
        F]`` output."""
        rows = torch.as_tensor(np.asarray(rows, dtype=np.int64),
                               device=self.device)
        inner = self.submit(graph_id, x, block=block, klass=klass,
                            tenant=tenant)
        outer: Future = Future()

        def _chain(f: Future) -> None:
            if f.cancelled():
                outer.cancel()
                return
            exc = f.exception()
            if exc is not None:
                outer.set_exception(exc)
                return
            try:
                outer.set_result(f.result()[rows])
            except BaseException as e:  # noqa: BLE001 — surfaced via future
                outer.set_exception(e)

        inner.add_done_callback(_chain)
        return outer

    def graph_ids(self) -> List[str]:
        with self._bind_lock:
            return list(self._graphs)

    def plan_for(self, graph_id: str) -> PartitionPlan:
        """Resolve a registered graph's plan WITHOUT rehashing its arrays —
        the content hash was paid once at registration; a rebuild only
        happens if the plan was LRU-evicted since. The rebuild uses the
        config EMBEDDED IN THE KEY (not ``self.config``): after the tuner
        promotes a non-default config, an evicted plan must rebuild with
        its tuned structure. Tuned dispatch hints are re-attached from the
        engine's hint map when the rebuild lost them."""
        with self._bind_lock:   # key and graph must belong together
            key = self._keys[graph_id]
            g = self._graphs[graph_id]
        plan = self.cache.get_by_key(
            key, lambda: build_partition_plan(
                g, key[1], graph_hash=key[0], device=self.device))
        if plan.tuned is None:
            hints = self._tuned_hints.get(graph_id)
            if hints is not None and plan.key[1] == hints["config"]:
                plan.tuned = hints["tuned"]
        return plan

    def graph_version(self, graph_id: str) -> int:
        """Current published version of a registered graph's plan chain."""
        with self._bind_lock:
            return self._versions[graph_id]

    def close(self) -> None:
        """Stop the background scheduler (drains anything still queued),
        then the shadow worker (waits for a measurement in flight)."""
        self.scheduler.stop()
        with self._shadow_lock:
            pool, self._shadow_pool = self._shadow_pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    # ------------------------------------------------------------------ serve
    def _validate(self, graph_id: str, x) -> None:
        """Cheap synchronous admission checks: registration + feature shape.

        Deliberately does NOT touch the plan cache — plan resolution (which
        can mean an O(n) rebuild after an eviction) happens on the flush
        thread where it belongs.
        """
        with self._bind_lock:
            g = self._graphs.get(graph_id)
            if g is None:
                raise KeyError(f"graph {graph_id!r} not registered "
                               f"(known: {sorted(self._graphs)})")
        shape = tuple(getattr(x, "shape", ()))
        if len(shape) != 2 or shape[0] != g.n_cols:
            raise ValueError(
                f"request for {graph_id!r} has features {shape}, "
                f"expected [{g.n_cols}, F]")

    def submit(self, graph_id: str, x: torch.Tensor, *,
               block: bool = True, klass: str = "default",
               tenant: Optional[str] = None) -> Future:
        """Admit one request; returns a ``Future`` of the ``[n_rows, F]``
        aggregation in ORIGINAL row order, on the engine's device.

        Validation (unknown graph, wrong feature shape, unknown SLO class)
        raises here, synchronously. A full admission queue blocks
        (backpressure) or, with ``block=False``, raises
        :class:`repro_torch.serve.scheduler.QueueFullError`.
        """
        self._validate(graph_id, x)
        return self.scheduler.submit((graph_id, x), block=block,
                                     klass=klass, tenant=tenant).future

    def mutate(self, graph_id: str, delta: EdgeDelta, *,
               block: bool = True, klass: str = "default",
               tenant: Optional[str] = None) -> Future:
        """Admit a batched edge delta against a registered graph.

        Returns a ``Future`` resolving to a dict
        ``{"graph_id", "version", "repaired", "reason", "dirty_rows"}``
        once the new plan version is PUBLISHED — later submits observe the
        mutated graph. Mutations ride the same admission queue as reads:
        a flush dispatches its reads first (against the pre-publish
        version, which they pin for the duration of the kernel call), then
        applies that flush's deltas per graph in arrival order and
        publishes once per graph. In-flight reads are therefore never
        blocked and never torn — every answer is consistent with either
        the pre- or post-publish version.
        """
        with self._bind_lock:
            if graph_id not in self._graphs:
                raise KeyError(f"graph {graph_id!r} not registered "
                               f"(known: {sorted(self._graphs)})")
        if not isinstance(delta, EdgeDelta):
            raise TypeError(f"delta must be an EdgeDelta, got {type(delta)!r}")
        return self.scheduler.submit((graph_id, delta, "mutate"), block=block,
                                     klass=klass, tenant=tenant).future

    def serve_one(self, graph_id: str, x: torch.Tensor) -> torch.Tensor:
        """Convenience single-request path (still goes through the batch code)."""
        return self.serve([GraphRequest(graph_id, x)])[0].out

    def serve(self, requests: Sequence[GraphRequest]) -> List[GraphRequest]:
        """Synchronous wrapper: submit every request and wait for all answers.

        Validates EVERY request before admitting ANY, so a malformed
        request cannot leave the call half-served with mutated counters.
        The requests enter the admission queue as one contiguous run and
        typically share flushes (and fused dispatches).
        """
        for r in requests:
            self._validate(r.graph_id, r.x)
        items = self.scheduler.submit_many(
            [(r.graph_id, r.x) for r in requests],
            klass=[r.klass for r in requests],
            tenant=[r.tenant for r in requests])
        first_exc: Optional[BaseException] = None
        for r, item in zip(requests, items):
            try:
                r.out = item.future.result()
                r.latency_s = item.latency_s
            except BaseException as e:  # noqa: BLE001 — re-raised below
                if first_exc is None:
                    first_exc = e
        if first_exc is not None:
            raise first_exc
        return list(requests)

    # ------------------------------------------------------------------ flush
    @staticmethod
    def _group_by_graph(items: List[WorkItem]
                        ) -> Tuple[List[str], Dict[str, List[WorkItem]]]:
        """Group a flush's items by graph id, in order of first appearance."""
        order: List[str] = []
        groups: Dict[str, List[WorkItem]] = {}
        for item in items:
            gid = item.payload[0]
            if gid not in groups:
                groups[gid] = []
                order.append(gid)
            groups[gid].append(item)
        return order, groups

    @staticmethod
    def _slice_answers(grp: List[WorkItem], widths: List[int],
                       out: torch.Tensor, now: float
                       ) -> Tuple[List[Tuple[WorkItem, torch.Tensor]], float]:
        """Split a fused group's output back per request: feature columns
        sliced by each item's width, plus the summed enqueue->now wait."""
        answers: List[Tuple[WorkItem, torch.Tensor]] = []
        col = 0
        wait_s = 0.0
        for item, w in zip(grp, widths):
            answers.append((item, out[:, col:col + w]))
            col += w
            wait_s += now - item.t_enqueue
        return answers, wait_s

    @staticmethod
    def _is_mutation(item: WorkItem) -> bool:
        """Mutation payloads are ``(graph_id, EdgeDelta, "mutate")`` — the
        marker is in slot 2 so read payloads are never mistaken for
        deltas."""
        p = item.payload
        return len(p) > 2 and p[2] == "mutate"

    def _flush(self, items: List[WorkItem]) -> None:
        """Scheduler flush callback: reads first, then mutations.

        Reads dispatch against the flush's pre-publish plan versions;
        mutations for the same graph coalesce and publish ONCE at the end
        of the flush, so a mutate never blocks the reads it arrived with.
        A failing read dispatch still lets this flush's mutations publish
        (and vice versa a bad delta fails only its own graph's mutation
        items, never the reads).
        """
        reads = [it for it in items if not self._is_mutation(it)]
        mutations = [it for it in items if self._is_mutation(it)]
        read_exc: Optional[BaseException] = None
        if reads:
            try:
                self._flush_reads(reads)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                read_exc = e
        if mutations:
            order, groups = self._group_by_graph(mutations)
            for gid in order:
                grp = groups[gid]
                try:
                    self._apply_mutation(gid, grp)
                except BaseException as e:  # noqa: BLE001 — isolate per graph
                    for it in grp:
                        it.fail(e)
        if read_exc is not None:
            raise read_exc

    def _flush_reads(self, items: List[WorkItem]) -> None:
        """Group reads by plan, fuse, dispatch in chunks.

        Requests naming the same graph fuse along the feature axis (one slab
        gather serves all of them); distinct graphs chunk into fused
        dispatches of up to ``max_graphs_per_batch`` in order of first
        appearance. Every plan used is version-pinned for the duration of
        its dispatches: a concurrent publish retires the old version but
        cannot reclaim it until the last in-flight dispatch unpins. Each
        dispatch synchronizes its stream before it answers, so no kernel
        still reads a version's tensors once its pin drains.
        """
        order, groups = self._group_by_graph(items)
        plans = {gid: self.plan_for(gid) for gid in order}
        pinned = [p.key for p in plans.values()]
        for k in pinned:
            self.cache.pin_version(k)
        try:
            # a raising dispatch aborts the remaining chunks: their items
            # are failed by the scheduler with the same exception, while
            # items of already-dispatched chunks keep their results
            for start in range(0, len(order), self.max_graphs_per_batch):
                chunk = order[start:start + self.max_graphs_per_batch]
                self._dispatch(
                    [(gid, groups[gid], plans[gid]) for gid in chunk])
        finally:
            for k in pinned:
                self.cache.unpin_version(k)

    # --------------------------------------------------------------- mutation
    def _apply_mutation(self, gid: str, grp: List[WorkItem]) -> None:
        """Apply one flush's coalesced deltas for ``gid`` and publish once.

        Deltas apply SEQUENTIALLY in arrival order (never merged: a delete
        in delta k must see the graph as delta k-1 left it), the plan is
        repaired once against the combined touched-row set, and the new
        version publishes atomically — the old version is retired and
        reclaimed when its last pinned reader drains. The repair's
        ``torch.cat`` of the slabs runs on this (the scheduler's) thread's
        current stream, the stream every dispatch of this engine runs on;
        a fleet's cache synchronizes that stream before it publishes, since
        its slots read plans on streams of their own.
        """
        with self._mutate_lock:
            with self._bind_lock:
                g_old = self._graphs[gid]
                old_key = self._keys[gid]
                cur_ver = self._versions[gid]
            plan_old = self.plan_for(gid)
            g_new = g_old
            touched: List[np.ndarray] = []
            n_edges = 0
            gh = plan_old.graph_hash
            for it in grp:
                delta: EdgeDelta = it.payload[1]
                g_new = delta.apply(g_new)
                touched.append(delta.touched_rows())
                n_edges += delta.size
                gh = delta_chain_hash(gh, delta)
            pv = repair_plan(
                plan_old, g_old, g_new,
                np.unique(np.concatenate(touched)) if touched
                else np.empty(0, np.int64),
                churn_threshold=self.repair_churn_threshold,
                graph_hash=gh)
            # the engine owns the id's version CHAIN; the repair stamp is
            # relative to the plan object, which may have been rebuilt (at
            # version 0) after an eviction
            pv.version = cur_ver + 1
            pv.plan.version = cur_ver + 1
            self._publish_version(gid, g_new, pv.plan, old_key)
            with self._counters_lock:
                self.mutations_applied += len(grp)
                self.mutation_edges += n_edges
                if pv.repaired:
                    self.plan_repairs += 1
                else:
                    self.plan_rebuilds += 1
        result = {"graph_id": gid, "version": pv.version,
                  "repaired": pv.repaired, "reason": pv.reason,
                  "dirty_rows": pv.dirty_rows}
        for it in grp:
            it.complete(dict(result))

    def _publish_version(self, gid: str, g_new: CSRGraph,
                         plan: PartitionPlan, old_key: tuple) -> None:
        """Cache publish first (so plan_for never misses), THEN atomically
        re-bind the id."""
        self.cache.publish(plan, retire_key=old_key)
        with self._bind_lock:
            self._graphs[gid] = g_new
            self._keys[gid] = plan.key
            self._versions[gid] = plan.version

    def _dispatch(self, batch: List[Tuple[str, List[WorkItem],
                                          PartitionPlan]],
                  device: Optional[torch.device] = None) -> None:
        """One fused kernel call over up to max_graphs_per_batch graphs, on
        ``device`` (the engine's own by default; a fleet slot's otherwise),
        on the thread's current stream there."""
        dev = device or self.device
        t0 = time.perf_counter()
        plans: List[PartitionPlan] = []
        xs: List[torch.Tensor] = []
        col_splits: List[List[int]] = []
        for _gid, grp, plan in batch:
            feats = [torch.as_tensor(it.payload[1], dtype=torch.float32,
                                     device=dev) for it in grp]
            plans.append(plan)
            x = feats[0] if len(feats) == 1 else torch.cat(feats, dim=1)
            if self.feature_bucket:
                w = int(x.shape[1])
                pad = bucket_blocks(w, 1) - w   # next power of two
                if pad:
                    x = torch.nn.functional.pad(x, (0, pad))
            xs.append(x)
            col_splits.append([int(f.shape[1]) for f in feats])

        b_total = sum(p.num_blocks for p in plans)
        pad_to = None
        if self.block_bucket:
            pad_to = bucket_blocks(b_total, self.block_bucket)
        backend, grid_order = self._effective_launch(plans)
        outs, decision = spmm_batched(
            [p.slabs for p in plans], xs, [p.n_rows for p in plans],
            backend=backend, pad_blocks_to=pad_to, return_decision=True,
            grid_order=grid_order)
        # callers read answers on the default stream: on another stream (a
        # fleet slot's) the default stream waits for the un-permutes below,
        # and each answer is marked as used there, so the allocator does
        # not hand its memory back to this stream while the caller's
        # kernels may still read it
        stream = foreign = None
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            stream.synchronize()
            if stream != torch.cuda.default_stream(dev):
                foreign = torch.cuda.default_stream(dev)
        dt = time.perf_counter() - t0         # this dispatch's wall time

        executed = (decision.backend if decision is not None
                    else _UNROUTED[backend])
        share = dt / len(batch)
        with self._counters_lock:
            self.backend_dispatches[executed] += 1
            self.last_decision = decision
            self.live_blocks += b_total
            self.padded_blocks += pad_to if pad_to else b_total
            for _, _, plan in batch:
                self._record_plan_time_locked(plan.key, share,
                                              len(batch) == 1)
        if logger.isEnabledFor(logging.DEBUG):
            logger.debug(
                "dispatch: graphs=%d blocks=%d->%d backend=%s (%s) %.1fms",
                len(batch), b_total, pad_to or b_total, executed,
                decision.reason if decision else self.backend, dt * 1e3)

        # update every counter BEFORE resolving any future: a synchronous
        # caller unblocks the moment its future resolves and may read
        # stats() immediately
        now = time.perf_counter()
        answers: List[Tuple[WorkItem, torch.Tensor]] = []
        n_req = n_rows = n_vals = 0
        wait_s = 0.0
        for (_gid, grp, plan), out, widths in zip(batch, outs, col_splits):
            out = plan.to_original_order(out)
            if foreign is not None:
                out.record_stream(foreign)
            sliced, wait = self._slice_answers(grp, widths, out, now)
            answers.extend(sliced)
            n_req += len(grp)
            n_rows += plan.n_rows * len(grp)
            n_vals += plan.n_rows * sum(widths)
            wait_s += wait
        if foreign is not None:
            foreign.wait_stream(stream)
        with self._counters_lock:
            self.requests_served += n_req
            self.rows_served += n_rows
            self.values_served += n_vals
            self.total_request_latency_s += wait_s
            self.batches_dispatched += 1
            self.graphs_dispatched += len(batch)
            self.total_serve_s += dt
        for item, result in answers:
            item.complete(result)
        # autotuning LAST: every live answer above already resolved, so
        # shadow work can never sit between a request and its result
        if self.tuner is not None:
            self._tuner_tick(batch, xs)

    # ------------------------------------------------------------ autotuning
    def _effective_launch(self, plans: List[PartitionPlan]
                          ) -> Tuple[str, str]:
        """Backend/grid_order for one fused dispatch: a plan's tuned hints
        apply when every plan in the batch agrees on the effective pair
        (trivially true for the single-graph dispatches that dominate hot
        traffic); a mixed batch falls back to the engine defaults."""
        pairs = {(((p.tuned or {}).get("backend")) or self.backend,
                  ((p.tuned or {}).get("grid_order")) or "block_major")
                 for p in plans}
        if len(pairs) == 1:
            return pairs.pop()
        return self.backend, "block_major"

    def _tuner_tick(self, batch, xs: List[torch.Tensor]) -> None:
        """Per-dispatch tuner hook (runs AFTER the live futures resolved):
        feeds the rate tracker, asks the tuner whether any graph in this
        batch is due a shadow measurement, and hands shadows to the single
        worker thread. Multihost engines skip shadowing — promotion would
        re-key the plan under the placement directory's feet; only
        single-host engines tune."""
        for gid, grp, _ in batch:
            self.tuner.observe(gid, len(grp))
        if getattr(self, "directory", None) is not None:
            return      # multihost: directory-owned keys don't tune yet
        for (gid, _grp, plan), x in zip(batch, xs):
            cand = self.tuner.next_shadow(gid, plan.config)
            if cand is None:
                continue
            self._submit_shadow(gid, plan, cand, x)

    def _submit_shadow(self, gid: str, plan_i: PartitionPlan,
                       cand: TuningCandidate, x: torch.Tensor) -> None:
        """Hand one shadow measurement to the worker; skip if it's busy
        (shadows are opportunistic — never queued, never blocking). On the
        card, an event on the live stream marks where ``x`` is ready; the
        shadow stream waits on it before it reads ``x``."""
        with self._shadow_lock:
            if self._shadow_inflight:
                busy = True
            else:
                busy = False
                self._shadow_inflight = True
                if self._shadow_pool is None:
                    self._shadow_pool = ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="plan-shadow")
                if self.device.type == "cuda" and self._shadow_stream is None:
                    self._shadow_stream = torch.cuda.Stream(self.device)
                pool = self._shadow_pool
        if busy:
            with self._counters_lock:
                self.shadow_skipped += 1
            return
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        pool.submit(self._run_shadow, gid, plan_i, cand, x, ready)

    def _run_shadow(self, gid: str, plan_i: PartitionPlan,
                    cand: TuningCandidate, x: torch.Tensor,
                    ready: Optional["torch.cuda.Event"]) -> None:
        """Worker-thread body: build the candidate plan (single-flight via
        the cache) and run a PAIRED A/B measurement — the incumbent and
        candidate plans dispatch the SAME features back-to-back in this
        thread (1 untimed candidate warm-up, then timed runs in ABBA order
        with the per-side min scored), so both sides see the same
        background load. A promotion signal publishes the candidate
        through the version chain."""
        t_start = time.perf_counter()
        old_key = plan_i.key
        try:
            with self._bind_lock:
                stale = self._keys.get(gid) != old_key
                g = self._graphs.get(gid)
            if stale or g is None:
                return              # graph mutated/replaced since the tick
            stream = self._shadow_stream        # None on the CPU
            if stream is not None:
                # read x only after the live stream wrote it; the allocator
                # keeps x until the shadow stream is done with it
                stream.wait_event(ready)
                x.record_stream(stream)
            with torch.cuda.stream(stream):     # no-op for None
                plan_c, incumbent_s, candidate_s = self._measure_shadow(
                    g, plan_i, cand, x)
            if stream is not None:
                # the candidate's slabs were staged on the shadow stream:
                # they must be complete before a live dispatch can read them
                stream.synchronize()
            with self._counters_lock:
                self.shadow_dispatches += 1
            winner = self.tuner.record_shadow(gid, cand, incumbent_s,
                                              candidate_s)
            if winner is not None:
                self._promote_tuned(gid, old_key, winner, plan_c)
        except Exception:  # noqa: BLE001 — a broken candidate must not
            logger.exception("shadow measurement failed for %r (%s)",
                             gid, cand.label)        # take down the worker
            with self._counters_lock:
                self.shadow_failures += 1
            self.tuner.candidate_failed(gid, cand)
        finally:
            with self._counters_lock:
                self.shadow_time_s += time.perf_counter() - t_start
            with self._shadow_lock:
                self._shadow_inflight = False

    def _measure_shadow(self, g: CSRGraph, plan_i: PartitionPlan,
                        cand: TuningCandidate, x: torch.Tensor
                        ) -> Tuple[PartitionPlan, float, float]:
        """Build the candidate plan and time both sides on the current
        stream (CUDA events on the card, the host clock on the CPU):
        1 untimed candidate warm-up, then incumbent, candidate, candidate,
        incumbent. Returns ``(plan_c, incumbent_s, candidate_s)``."""
        key = (plan_i.graph_hash, cand.config)
        plan_c = self.cache.get_by_key(
            key, lambda: build_partition_plan(
                g, cand.config, graph_hash=plan_i.graph_hash,
                device=self.device))
        hints_i = plan_i.tuned or {}
        launches = {
            "inc": (plan_i, hints_i.get("backend") or self.backend,
                    hints_i.get("grid_order") or "block_major"),
            "cand": (plan_c, cand.backend or self.backend, cand.grid_order),
        }

        def _once(which: str) -> float:
            plan, backend, grid_order = launches[which]
            pad_to = (bucket_blocks(plan.num_blocks, self.block_bucket)
                      if self.block_bucket else None)
            return time_call(lambda: spmm_batched(
                [plan.slabs], [x], [plan.n_rows], backend=backend,
                pad_blocks_to=pad_to, grid_order=grid_order), self.device)

        _once("cand")           # warm-up: a first launch must not score
        # ABBA order de-phases background load: a live dispatch that
        # overlaps the shadow window hits early and late slots alike
        samples = [(w, _once(w)) for w in ("inc", "cand", "cand", "inc")]
        incumbent_s = min(s for w, s in samples if w == "inc")
        candidate_s = min(s for w, s in samples if w == "cand")
        return plan_c, incumbent_s, candidate_s

    def _promote_tuned(self, gid: str, old_key: tuple,
                       cand: TuningCandidate, plan_c: PartitionPlan) -> None:
        """Publish a winning candidate as the graph's next plan version.

        Rides the same machinery as mutate(): under the mutation lock the
        binding is re-checked (a racing mutation aborts the promotion —
        the tuner forgets the graph and re-tunes if it stays hot), the
        plan gets its tuned hints + the next chain version, and
        ``_publish_version`` atomically publishes + re-binds. In-flight
        reads keep their pinned incumbent version until they drain.
        """
        with self._mutate_lock:
            with self._bind_lock:
                if self._keys.get(gid) != old_key:
                    aborted = True
                else:
                    aborted = False
                    cur_ver = self._versions[gid]
                    g = self._graphs[gid]
            if aborted:
                self.tuner.reset(gid)
                return
            plan_c.tuned = cand.tuned_hints()
            plan_c.version = cur_ver + 1
            self._publish_version(gid, g, plan_c, old_key)
            with self._bind_lock:
                self._tuned_hints[gid] = {"config": cand.config,
                                          "tuned": dict(plan_c.tuned)}
            with self._counters_lock:
                self.tuned_promotions += 1
        self.tuner.confirm_promoted(gid)
        logger.info("promoted tuned config for %r: %s (version %d)",
                    gid, cand.label, plan_c.version)

    def _record_plan_time_locked(self, key: tuple, seconds: float,
                                 exact: bool) -> None:
        ring = self._plan_times.get(key)
        if ring is None:
            ring = self._plan_times[key] = deque(maxlen=PLAN_TIMING_RING)
            while len(self._plan_times) > PLAN_TIMING_KEYS:
                self._plan_times.popitem(last=False)
        else:
            self._plan_times.move_to_end(key)
        ring.append((seconds, exact))

    def plan_timings(self) -> Dict[str, Dict[str, float]]:
        """Per-plan dispatch timing summary from the bounded ring buffers.

        Keyed ``<graph_hash[:12]>:<config_tag[:8]>`` (hash alone is
        ambiguous once the tuner publishes a re-configured plan of the same
        content). ``exact_n`` counts
        single-graph samples — fused multi-graph dispatches contribute their
        per-plan share only.
        """
        with self._counters_lock:
            snap = {k: list(ring) for k, ring in self._plan_times.items()}
        out: Dict[str, Dict[str, float]] = {}
        for key, samples in snap.items():
            times = [s for s, _ in samples]
            tag = f"{key[0][:12]}:{_config_tag(key[1])[:8]}"
            out[tag] = {
                "n": len(times),
                "exact_n": sum(1 for _, e in samples if e),
                "last_s": times[-1],
                "mean_s": float(np.mean(times)),
                "p50_s": float(np.median(times)),
            }
        return out

    # ------------------------------------------------------------------ stats
    def stats(self) -> Dict[str, float]:
        s = {f"cache_{k}": v for k, v in self.cache.stats().items()}
        s.update({f"sched_{k}": v
                  for k, v in self.scheduler.stats().items()})
        if self.tuner is not None:
            s.update({f"tuner_{k}": v
                      for k, v in self.tuner.stats().items()})
        s["plan_timings"] = self.plan_timings()
        # engine counters are one atomic snapshot (same guarantee as
        # PlanCache.stats()); cache/scheduler snapshots above are each
        # internally consistent but taken a moment earlier
        with self._counters_lock:
            return self._stats_locked(s)

    def _stats_locked(self, s: Dict[str, float]) -> Dict[str, float]:
        s.update(
            registered_graphs=len(self._graphs),
            requests_served=self.requests_served,
            batches_dispatched=self.batches_dispatched,
            rows_served=self.rows_served,
            values_served=self.values_served,
            total_serve_s=self.total_serve_s,
            requests_per_batch=(self.requests_served / self.batches_dispatched
                                if self.batches_dispatched else 0.0),
            # cross-caller coalescing: >1 means fused multi-graph dispatches
            graphs_per_dispatch=(self.graphs_dispatched
                                 / self.batches_dispatched
                                 if self.batches_dispatched else 0.0),
            rows_per_s=(self.rows_served / self.total_serve_s
                        if self.total_serve_s else 0.0),
            # which kernel each fused dispatch executed on: K1 resident,
            # K2 windowed, K3 hbm, the PyTorch twin blocked
            routed_resident=self.backend_dispatches["resident"],
            routed_windowed=self.backend_dispatches["windowed"],
            routed_hbm=self.backend_dispatches["hbm"],
            routed_blocked=self.backend_dispatches["blocked"],
            # block bucketing waste: padded/live == 1.0 means no dead steps
            live_blocks=self.live_blocks,
            padded_blocks=self.padded_blocks,
            block_pad_ratio=(self.padded_blocks / self.live_blocks
                             if self.live_blocks else 0.0),
            # latency: per-dispatch wall time vs per-request wait
            avg_dispatch_s=(self.total_serve_s / self.batches_dispatched
                            if self.batches_dispatched else 0.0),
            avg_request_latency_s=(
                self.total_request_latency_s / self.requests_served
                if self.requests_served else 0.0),
            # versioned plan lifecycle: streaming mutations
            mutations_applied=self.mutations_applied,
            mutation_edges=self.mutation_edges,
            plan_repairs=self.plan_repairs,
            plan_rebuilds=self.plan_rebuilds,
            # online autotuning: shadow measurements + promotions
            shadow_dispatches=self.shadow_dispatches,
            shadow_skipped=self.shadow_skipped,
            shadow_failures=self.shadow_failures,
            shadow_time_s=self.shadow_time_s,
            shadow_in_flight=int(self._shadow_inflight),   # gauge: 0 or 1
            tuned_promotions=self.tuned_promotions,
            tuned_graphs=len(self._tuned_hints),
        )
        return s
