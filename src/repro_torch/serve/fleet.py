"""Fleet serving: per-slot dispatch groups + sharded SpMM.

:class:`FleetGraphEngine` is the multi-device :class:`GraphServeEngine`.
Same admission path (the continuous-batching :class:`BatchScheduler`), same
request semantics (``submit(graph_id, x) -> Future`` answered in ORIGINAL
row order) — what changes is the flush:

1. requests group by graph (feature-axis fusion), exactly as before;
2. each graph group is routed by :func:`repro_torch.kernels.router.route_fleet`:

   * ``single``  — the graph's plan lives on ONE slot (consistent-hash
     placement via :class:`~repro_torch.distributed.placement.FleetPlanCache`);
     its group joins that slot's fused dispatch. Distinct slots'
     dispatches launch concurrently from a pool, one thread per slot —
     independent work never queues behind an unrelated slot's kernel.
   * ``feature`` — wide-feature dispatches split column-wise over every
     slot (no cross-slot sums: the combined-warp column parallelism at
     device granularity).
   * ``block``   — one giant narrow graph deals its partition blocks
     round-robin across the slots (X replicated, the partials summed in
     slot order on the first slot).

3. one flush == one *fleet round* of concurrent launches. ``stats()``
   reports per-slot dispatch/request/busy-time balance and the block-shard
   live-block counts next to the inherited ``sched_*`` / ``cache_*``
   counters.

**Slots.** The fleet runs over a list of ``torch.device``s
(:func:`~repro_torch.launch.mesh.graph_mesh`: every visible card by
default); one device may appear more than once, so ``["cuda:0"] * 4`` is a
4-device fleet on one card and ``["cpu"] * 8`` an 8-device one on the CPU,
the port's counterpart of the reference's forced host device count. Every
slot dispatches with the kernel its share routes to (K1 under ``accel``;
under ``auto`` whatever the router names for the share, K1, K2 or K3),
including each slot's share of a sharded dispatch.

**Streams.** On the card each slot owns one CUDA stream, and its pool
thread dispatches under it: a slot's ``synchronize`` waits only on its own
work (plus any sharded share enqueued on it), and slots of one card
overlap. Every tensor that crosses streams is ordered: a slot's stream
first waits for the default stream (the callers' features, and replica
copies staged from the scheduler thread); the shares of a sharded dispatch
are waited for by the first slot's stream before the combine; the fleet
cache synchronizes whatever it stages or publishes (a ``mutate()``'s
repaired plan) before a slot can read it; and each answer, made on a
slot's stream, is handed to the default stream, on which callers read it.

**Hot-plan replication** (``replicate_hot=True``): a per-plan EWMA request
rate (:class:`~repro_torch.distributed.replication.ReplicaManager`)
promotes hot plans onto the least-loaded slots and demotes cold replicas
at flush boundaries. A flush then (a) routes each single-slot group to the
least-loaded REPLICA of its plan and (b) SPLITS a hot fused group's
requests across all its replicas. ``hedge_ms`` optionally re-dispatches a
still-pending group on a second replica after that many milliseconds
(answers are idempotent, so the first result wins).

**Counting what ran.** The reference counts every sharded dispatch as
``routed_blocked``, because its shards run the jnp twin. Here a sharded
dispatch counts under the regime its slots ran (``routed_resident`` under
``accel``). ``slot_routed_<regime>`` (port only) counts dispatches per
slot: one per single dispatch, one per slot per sharded dispatch — the
kernel launches of the regime.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from ..core.plan_cache import DeviceLike, PartitionConfig, PartitionPlan
from ..distributed.placement import FleetPlanCache, _settle
from ..distributed.replication import ReplicaManager
from ..distributed.shard_spmm import (
    prepare_block_shards, prepare_feature_shards, spmm_block_sharded,
    spmm_feature_sharded,
)
from ..kernels.router import FleetDecision, route_fleet
from ..kernels.spmm_batched import spmm_batched
from ..launch.mesh import graph_mesh, resolve_slots
from .graph_engine import GraphServeEngine
from .scheduler import WorkItem

__all__ = ["FleetGraphEngine"]

# the regime a slot's share runs under each engine backend but ``auto``
# (which takes the router's per-slot decision)
_SLOT_REGIME = {"accel": "resident", "pallas": "resident",
                "windowed": "windowed", "hbm": "hbm", "blocked": "blocked"}
_REGIMES = ("resident", "windowed", "hbm", "blocked")


class FleetGraphEngine(GraphServeEngine):
    """Continuous-batching graph server over a fleet of slots.

    ``n_devices=None`` (and no ``devices``) takes every visible card and
    raises without CUDA; ``devices`` names the slots (``["cpu"] * 8``).
    ``capacity_per_device`` bounds each slot's plan-cache shard, so fleet
    plan capacity scales with the slot count.
    """

    def __init__(
        self,
        *,
        n_devices: Optional[int] = None,
        devices: Optional[Sequence[DeviceLike]] = None,
        capacity_per_device: int = 32,
        load_spread: int = 4,
        save_dir: Optional[str] = None,
        min_blocks_per_device: int = 4,
        config: Optional[PartitionConfig] = None,
        replicate_hot: bool = True,
        rate_per_replica: float = 200.0,
        max_replicas: int = 4,
        replica_halflife_s: float = 2.0,
        replication_interval_s: float = 0.05,
        split_min_requests: int = 2,
        hedge_ms: Optional[float] = None,
        **engine_kw,
    ):
        if devices is not None:
            if n_devices is not None:
                raise ValueError("pass n_devices or devices, not both")
            self.devices = resolve_slots(devices)
        else:
            self.devices = graph_mesh(n_devices)
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"slots must share one device type, got "
                             f"{[str(d) for d in self.devices]}")
        self.n_devices = len(self.devices)
        cache = engine_kw.pop("cache", None)
        if cache is None:
            cache = FleetPlanCache(self.devices,
                                   capacity_per_device=capacity_per_device,
                                   load_spread=load_spread,
                                   save_dir=save_dir)
        elif not hasattr(cache, "device_index_of"):
            # fail at construction, not with an AttributeError on the
            # scheduler thread at first flush
            raise TypeError(
                f"FleetGraphEngine needs a device-partitioned cache "
                f"(FleetPlanCache), got {type(cache).__name__}")
        super().__init__(device=self.devices[0], config=config, cache=cache,
                         **engine_kw)
        self.min_blocks_per_device = min_blocks_per_device
        self._streams: Optional[List["torch.cuda.Stream"]] = (
            [torch.cuda.Stream(d) for d in self.devices]
            if self.devices[0].type == "cuda" else None)
        self._pool = ThreadPoolExecutor(max_workers=self.n_devices,
                                        thread_name_prefix="fleet-dev")
        # memoized sharded-dispatch preparations (per-slot slab shards and
        # the first slot's inv_perm), keyed by (plan key, strategy): a
        # recurring sharded graph pays the reorder once, not per request.
        # Small LRU — entries are per GIANT/wide graph only.
        self._shard_prep: "OrderedDict[Tuple, Dict]" = OrderedDict()
        self._shard_prep_cap = 16
        self._prep_lock = threading.Lock()
        # fleet counters (all under the inherited _counters_lock)
        self.fleet_rounds = 0
        self.device_dispatches = [0] * self.n_devices
        self.device_requests = [0] * self.n_devices
        self.device_busy_s = [0.0] * self.n_devices
        self.sharded_dispatches = {"feature": 0, "block": 0}
        self.sharded_busy_s = 0.0    # whole-fleet launch time, kept separate
        #                              from the per-slot busy clocks
        # sharded dispatches by the regime their slots ran
        self.sharded_regimes = dict.fromkeys(_REGIMES, 0)
        self.last_fleet_decision: Optional[FleetDecision] = None
        self.last_block_counts: Optional[List[int]] = None
        self._t_first_launch: Optional[float] = None
        self._t_last_done: Optional[float] = None
        self.hedge_ms = hedge_ms
        # a split sub-group below this many requests costs more in fixed
        # dispatch overhead than its replica parallelism buys back
        self.split_min_requests = max(1, split_min_requests)
        self.hedged_dispatches = 0
        self.hedge_wins = 0
        self.replicas: Optional[ReplicaManager] = None
        if (replicate_hot and self.n_devices > 1
                and hasattr(self.cache, "add_replica")):
            self.replicas = ReplicaManager(
                replicas_fn=self.cache.replica_devices,
                add_fn=self.cache.add_replica,
                drop_fn=self.cache.drop_replica,
                device_load_fn=self._device_loads,
                rate_per_replica=rate_per_replica,
                max_replicas=min(max_replicas, self.n_devices),
                halflife_s=replica_halflife_s,
                interval_s=replication_interval_s)

    def close(self) -> None:
        super().close()
        self._pool.shutdown(wait=True)

    def _device_loads(self) -> List[float]:
        with self._counters_lock:
            return list(self.device_busy_s)

    def reset_stats(self) -> None:
        """Zero the fleet counters (busy clocks, dispatch/request tallies,
        round count, occupancy window) WITHOUT touching placements,
        replicas, or learned request rates: warm the engine until the hot
        set is replicated, reset, then measure only the warmed rounds."""
        with self._counters_lock:
            self.fleet_rounds = 0
            self.device_dispatches = [0] * self.n_devices
            self.device_requests = [0] * self.n_devices
            self.device_busy_s = [0.0] * self.n_devices
            self.sharded_dispatches = {"feature": 0, "block": 0}
            self.sharded_busy_s = 0.0
            self.hedged_dispatches = 0
            self.hedge_wins = 0
            self._t_first_launch = None
            self._t_last_done = None

    # ----------------------------------------------------------------- slots
    @contextlib.contextmanager
    def _on_slot(self, dev: int) -> Iterator[None]:
        """Run the body on slot ``dev``'s stream (on the card), after the
        work the default stream holds: the callers' features and plan
        copies staged from the scheduler thread."""
        stream = self._streams[dev] if self._streams is not None else None
        with torch.cuda.stream(stream):           # no-op for None
            if stream is not None:
                stream.wait_stream(
                    torch.cuda.default_stream(self.devices[dev]))
            yield

    @staticmethod
    def _hand_over(out: torch.Tensor) -> None:
        """Wait for the current stream, which made ``out``, and mark
        ``out`` as used on the default stream, where callers read it."""
        if out.device.type != "cuda":
            return
        stream = torch.cuda.current_stream(out.device)
        stream.synchronize()
        default = torch.cuda.default_stream(out.device)
        if stream != default:
            out.record_stream(default)

    def _slot_regime(self, fd: FleetDecision) -> str:
        return (fd.per_device.backend if self.backend == "auto"
                else _SLOT_REGIME[self.backend])

    # ------------------------------------------------------------------ flush
    def _flush_reads(self, items: List[WorkItem]) -> None:
        """Group by graph, route each group, launch per slot CONCURRENTLY.

        Runs on the scheduler thread; per-slot and sharded launches run on
        the pool. A raising launch does not abort its siblings — every
        launch completes or fails its own items, then the first exception
        re-raises so the scheduler fails any stragglers.

        With replication on, a single-slot group goes to the least-loaded
        replica of its plan (round-local load first, busy clock as the
        tie-break), and a multi-request group on a replicated plan SPLITS
        across its replicas — each sub-group fuses and dispatches on its
        own slot, concurrently.
        """
        order, groups = self._group_by_graph(items)
        plans = {gid: self.plan_for(gid) for gid in order}
        # version-pin each plan for the round: a concurrent publish retires
        # the superseded version but cannot reclaim it under a dispatch
        pinned = [p.key for p in plans.values()]
        for k in pinned:
            self.cache.pin_version(k)
        try:
            self._flush_routed(order, groups, plans)
        finally:
            for k in pinned:
                self.cache.unpin_version(k)

    def _flush_routed(self, order: List[str],
                      groups: Dict[str, List[WorkItem]],
                      plans: Dict[str, PartitionPlan]) -> None:
        """Route + launch one round of already-grouped read work."""
        # counted at flush start so a stats() read racing the final
        # future resolution never sees requests from an uncounted round
        with self._counters_lock:
            self.fleet_rounds += 1
            busy = list(self.device_busy_s)

        sharded: List[Tuple[FleetDecision, str]] = []
        per_dev: Dict[int, List[Tuple[str, List[WorkItem],
                                      PartitionPlan]]] = {}
        round_load: Dict[int, int] = {}
        hedges: List[Tuple[int, str, List[WorkItem], PartitionPlan]] = []

        def load_key(d: int) -> Tuple[int, float]:
            return (round_load.get(d, 0), busy[d])

        def assign(dev: int, gid: str, grp: List[WorkItem],
                   plan: PartitionPlan) -> None:
            per_dev.setdefault(dev, []).append((gid, grp, plan))
            round_load[dev] = round_load.get(dev, 0) + len(grp)

        with self._bind_lock:   # snapshot: gid -> current chained key
            keys = {gid: self._keys[gid] for gid in order}
        for gid in order:
            plan = plans[gid]
            grp = groups[gid]
            key = keys[gid]
            devs: List[int] = []
            if self.replicas is not None:
                # every request counts toward the rate estimate, whatever
                # path the group ends up on — otherwise hot graphs that
                # route to whole-fleet sharding never look hot
                self.replicas.observe(key, len(grp))
                devs = self.cache.replica_devices(key)
            if len(devs) <= 1 or len(grp) == 1:
                # unreplicated (or single-request) groups shard over the
                # whole fleet when the fused dispatch is big enough to
                # warrant it. A replicated multi-request group skips this —
                # splitting over its replicas runs the same work without
                # any cross-slot sum or concatenation.
                fused_f = sum(int(it.payload[1].shape[1]) for it in grp)
                fd = route_fleet(
                    plan.n_cols, fused_f, int(plan.slabs["C"]),
                    int(plan.slabs["R"]), plan.num_blocks, self.n_devices,
                    min_blocks_per_device=self.min_blocks_per_device)
                if fd.strategy in ("feature", "block"):
                    sharded.append((fd, gid))
                    continue
            if not devs:
                devs = [self.cache.device_index_of(key)]
            primary = devs[0]

            def replica_plan(dev: int) -> Optional[PartitionPlan]:
                return plan if dev == primary else self.cache.plan_on(
                    key, dev)

            if len(devs) == 1 or len(grp) == 1:
                dev = min(devs, key=load_key)
                p = replica_plan(dev)
                if p is None:           # replica copy LRU-evicted meanwhile
                    dev, p = primary, plan
                assign(dev, gid, grp, p)
                if self.hedge_ms is not None and len(devs) > 1:
                    alts = [d for d in devs if d != dev]
                    hp = replica_plan(min(alts, key=load_key))
                    if hp is not None:
                        hedges.append(
                            (min(alts, key=load_key), gid, grp, hp))
            else:
                # hot-group split: the fused group's requests spread over
                # its replicas, least-loaded first — but never into
                # sub-groups smaller than split_min_requests. Up to 4
                # sub-groups PER replica: several back-to-back dispatches
                # per slot keep every slot busy until the round ends
                # instead of early finishers idling behind the stragglers.
                by_load = sorted(devs, key=load_key)
                n_sub = max(1, min(len(grp) // self.split_min_requests,
                                   4 * len(by_load)))
                buckets: List[List[WorkItem]] = [[] for _ in range(n_sub)]
                for i, it in enumerate(grp):
                    buckets[i % n_sub].append(it)
                for j, sub_grp in enumerate(buckets):
                    dev = by_load[j % len(by_load)]
                    p = replica_plan(dev)
                    if p is None:
                        dev, p = primary, plan
                    assign(dev, gid, sub_grp, p)

        # ONE pool task per slot (its chunks run back to back, so the
        # per-slot busy clock never double-bills overlapping launches);
        # sharded whole-fleet dispatches get their own tasks
        launches = []
        for dev, work in sorted(per_dev.items()):
            launches.append(partial(self._launch_device, dev, work))
        for fd, gid in sharded:
            launches.append(
                partial(self._launch_sharded, fd, gid, groups, plans))
        for hedge in hedges:
            timer = threading.Timer(self.hedge_ms / 1e3, self._run_hedge,
                                    args=hedge)
            timer.daemon = True
            timer.start()

        first_exc: Optional[BaseException] = None
        n_ok = 0
        if len(launches) == 1:          # common case: skip the pool hop
            try:
                launches[0]()
                n_ok = 1
            except BaseException as e:  # noqa: BLE001 — re-raised below
                first_exc = e
        else:
            futs = [self._pool.submit(fn) for fn in launches]
            for f in futs:
                try:
                    f.result()
                    n_ok += 1
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    if first_exc is None:
                        first_exc = e
        if first_exc is not None:
            if n_ok == 0:
                # nothing dispatched: an all-failed flush must not deflate
                # fleet_graphs_per_round
                with self._counters_lock:
                    self.fleet_rounds -= 1
            raise first_exc
        if self.replicas is not None:
            # promotion/demotion without a dedicated thread: tick at flush
            # boundaries, rate-limited by interval_s
            self.replicas.maybe_step()

    # ------------------------------------------------------------------ slot
    def _launch_device(self, dev: int,
                       work: List[Tuple[str, List[WorkItem],
                                        PartitionPlan]]) -> None:
        """One slot's dispatches for this round, back to back on its stream:
        each work tuple's plan copy is already resident on
        ``devices[dev]`` (the primary staged by the fleet cache, replicas by
        the ReplicaManager). Chunking by ``max_graphs_per_batch`` matches
        the single-device engine."""
        t0 = time.perf_counter()
        with self._on_slot(dev):
            for start in range(0, len(work), self.max_graphs_per_batch):
                chunk = work[start:start + self.max_graphs_per_batch]
                # count BEFORE the dispatch resolves its futures: a caller
                # whose serve() unblocks on the last future must see these
                # requests in the per-slot stats (rolled back on failure,
                # mirroring the base counters never advancing)
                n_req = sum(len(grp) for _, grp, _ in chunk)
                with self._counters_lock:
                    self.device_dispatches[dev] += 1
                    self.device_requests[dev] += n_req
                try:
                    self._dispatch(chunk, self.devices[dev])
                except BaseException:
                    with self._counters_lock:
                        self.device_dispatches[dev] -= 1
                        self.device_requests[dev] -= n_req
                    raise
        dt = time.perf_counter() - t0
        with self._counters_lock:
            self.device_busy_s[dev] += dt
            self._note_window_locked(t0, dt)

    def _run_hedge(self, dev: int, gid: str, grp: List[WorkItem],
                   plan: PartitionPlan) -> None:
        """Tail-latency hedge: ``hedge_ms`` after the flush, re-dispatch a
        group's still-pending requests on another replica's slot. Answers
        settle idempotently (``WorkItem.complete`` is first-wins), so a
        duplicate result is harmless; a hedge failure is swallowed — the
        primary dispatch owns the items. Hedges do NOT count as served
        requests (only the hedge counters move)."""
        pending = [it for it in grp if not it.done]
        if not pending:
            return
        try:
            device = self.devices[dev]
            with self._on_slot(dev):
                feats = [torch.as_tensor(it.payload[1], dtype=torch.float32,
                                         device=device) for it in pending]
                widths = [int(f.shape[1]) for f in feats]
                x = feats[0] if len(feats) == 1 else torch.cat(feats, dim=1)
                outs = spmm_batched([plan.slabs], [x], [plan.n_rows],
                                    backend=self.backend)
                out = outs[0][plan.inv_perm]
                self._hand_over(out)
            answers, _ = self._slice_answers(pending, widths, out,
                                             time.perf_counter())
            wins = 0
            for item, result in answers:
                if not item.done:
                    item.complete(result)
                    wins += 1
            with self._counters_lock:
                self.hedged_dispatches += 1
                self.hedge_wins += wins
        except Exception:   # noqa: BLE001 — best-effort duplicate work
            pass

    # --------------------------------------------------------------- sharded
    def _launch_sharded(self, fd: FleetDecision, gid: str,
                        groups: Dict[str, List[WorkItem]],
                        plans: Dict[str, PartitionPlan]) -> None:
        """Whole-fleet dispatch of ONE graph group (feature- or block-shard):
        every slot runs its share on its own stream, the first slot's
        stream combines them and un-permutes the rows on its device."""
        t0 = time.perf_counter()
        grp = groups[gid]
        plan = plans[gid]
        primary = self.devices[0]
        regime = self._slot_regime(fd)
        live_counts = None
        with self._on_slot(0):
            feats = [torch.as_tensor(it.payload[1], dtype=torch.float32,
                                     device=primary) for it in grp]
            x = feats[0] if len(feats) == 1 else torch.cat(feats, dim=1)
            widths = [int(f.shape[1]) for f in feats]
            prep = self._shard_prepared(fd.strategy, plan)
            if fd.strategy == "feature":
                out = spmm_feature_sharded(
                    plan.slabs, x, plan.n_rows, self.devices,
                    prepared=prep["args"], regime=regime,
                    streams=self._streams)
            else:
                out, live_counts = spmm_block_sharded(
                    plan.slabs, x, plan.n_rows, self.devices,
                    prepared=(prep["args"], prep["live"]), regime=regime,
                    streams=self._streams)
            out = out[prep["inv_perm"]]
            self._hand_over(out)
        dt = time.perf_counter() - t0

        # slice outside the lock (same rule as the base dispatch: concurrent
        # launches must not serialize compute on the counter lock)
        answers, wait_s = self._slice_answers(grp, widths, out,
                                              time.perf_counter())
        with self._counters_lock:
            self.requests_served += len(grp)
            self.rows_served += plan.n_rows * len(grp)
            self.values_served += plan.n_rows * sum(widths)
            self.total_request_latency_s += wait_s
            self.batches_dispatched += 1
            self.graphs_dispatched += 1
            self.total_serve_s += dt
            self.live_blocks += plan.num_blocks
            self.padded_blocks += plan.num_blocks
            # the regime every slot ran (the reference counts "blocked":
            # its shards run the jnp twin)
            self.backend_dispatches[regime] += 1
            self.sharded_regimes[regime] += 1
            self.sharded_dispatches[fd.strategy] += 1
            self.sharded_busy_s += dt
            self.last_fleet_decision = fd
            if live_counts is not None:
                self.last_block_counts = [int(c) for c in live_counts]
            self._note_window_locked(t0, dt)
        for item, result in answers:
            item.complete(result)

    def _shard_prepared(self, strategy: str, plan: PartitionPlan) -> Dict:
        """Memoized per-(plan, strategy) sharded-dispatch preparation: each
        slot's slab shard on its device and ``inv_perm`` on the first
        slot's, complete before any slot's stream reads them."""
        key = (plan.key, strategy)
        with self._prep_lock:
            ent = self._shard_prep.get(key)
            if ent is not None:
                self._shard_prep.move_to_end(key)
                return ent
        if strategy == "feature":
            ent = {"args": prepare_feature_shards(plan.slabs, self.devices),
                   "live": None}
        else:
            args, live = prepare_block_shards(plan.slabs, plan.n_rows,
                                              self.devices)
            ent = {"args": args, "live": live}
        ent["inv_perm"] = plan.inv_perm.to(self.devices[0])
        for d in set(self.devices):
            _settle(d)
        with self._prep_lock:
            self._shard_prep[key] = ent
            while len(self._shard_prep) > self._shard_prep_cap:
                self._shard_prep.popitem(last=False)
        return ent

    def _note_window_locked(self, t0: float, dt: float) -> None:
        if self._t_first_launch is None:
            self._t_first_launch = t0
        self._t_last_done = max(self._t_last_done or 0.0, t0 + dt)

    # ------------------------------------------------------------------ stats
    def _stats_locked(self, s: Dict[str, float]) -> Dict[str, float]:
        """Extends the base under-lock snapshot, so base and fleet counters
        come from the SAME instant (one atomic snapshot, one lock hold)."""
        s = super()._stats_locked(s)
        wall = ((self._t_last_done - self._t_first_launch)
                if self._t_first_launch is not None
                and self._t_last_done is not None else 0.0)
        counts = self.last_block_counts
        # one launch per single dispatch, one per slot per sharded one
        s.update({f"slot_routed_{k}": (self.backend_dispatches[k]
                                       + (self.n_devices - 1)
                                       * self.sharded_regimes[k])
                  for k in _REGIMES})
        s.update(
            fleet_devices=self.n_devices,
            fleet_rounds=self.fleet_rounds,
            # scheduler-level coalescing per synchronized launch wave — the
            # fleet analogue of the single engine's graphs_per_dispatch
            fleet_graphs_per_round=(self.graphs_dispatched
                                    / self.fleet_rounds
                                    if self.fleet_rounds else 0.0),
            fleet_device_dispatches=list(self.device_dispatches),
            fleet_device_requests=list(self.device_requests),
            fleet_device_busy_s=list(self.device_busy_s),
            fleet_sharded_busy_s=self.sharded_busy_s,
            fleet_wall_s=wall,
            # mean busy fraction across slots over the serving window, from
            # the per-slot clocks only (whole-fleet sharded launches are
            # reported separately as fleet_sharded_busy_s)
            fleet_occupancy=(sum(self.device_busy_s)
                             / (wall * self.n_devices)
                             if wall > 0 else 0.0),
            fleet_feature_sharded=self.sharded_dispatches["feature"],
            fleet_block_sharded=self.sharded_dispatches["block"],
            fleet_block_counts=list(counts) if counts else [],
            # balance of the last block-sharded dispatch: max/mean live
            # blocks per slot (1.0 == perfectly balanced)
            fleet_block_balance=(max(counts) * len(counts) / sum(counts)
                                 if counts and sum(counts) else 0.0),
            # tail-latency hedging (0 unless hedge_ms is set)
            fleet_hedged=self.hedged_dispatches,
            fleet_hedge_wins=self.hedge_wins,
        )
        # hot-plan replication activity (replica_* residency counts arrive
        # via the cache_* prefix: cache_replicated_keys, cache_replica_copies)
        if self.replicas is not None:
            s.update({f"fleet_{k}": v
                      for k, v in self.replicas.stats().items()})
        else:
            s.update(fleet_promotions=0, fleet_demotions=0,
                     fleet_replication_steps=0)
        return s
