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

:class:`MultihostGraphEngine` lifts the same structure one level: a flush
first splits work by owning HOST (the distributed
:class:`~repro_torch.distributed.directory.PlacementDirectory`), forwards
remote-owned groups to their owner over the peer data plane, and runs the
locally-owned share through the per-slot path above; ``serve_global``
block-shards one graph over every host's slots. Validated with real
processes on ``torch.distributed`` (gloo): two CPU processes in
``tests/test_torch_multihost.py``, two processes of two slots each on one
card in ``chip_smoke.py``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.graph import CSRGraph, gcn_normalize
from ..core.plan_cache import (
    DeviceLike, PartitionConfig, PartitionPlan, build_partition_plan,
    graph_content_hash,
)
from ..core.plan_repair import EdgeDelta, delta_chain_hash, repair_plan
from ..distributed.directory import HostInfo, PlacementDirectory
from ..distributed.multihost import (
    MultihostContext, PeerClient, PeerServer, peer_ports,
)
from ..distributed.placement import FleetPlanCache, _settle
from ..distributed.replication import ReplicaManager
from ..distributed.shard_spmm import (
    _mesh_spans_processes, commit_block_shards_global, prepare_block_shards,
    prepare_feature_shards, spmm_block_sharded, spmm_feature_sharded,
)
from ..kernels.router import FleetDecision, route_fleet
from ..kernels.spmm_batched import spmm_batched
from ..launch.mesh import graph_mesh, multihost_graph_mesh, resolve_slots
from .graph_engine import GraphServeEngine
from .scheduler import WorkItem

__all__ = ["FleetGraphEngine", "MultihostGraphEngine"]

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
                add_fn=self._add_replica,
                drop_fn=self._drop_replica,
                device_load_fn=self._device_loads,
                rate_per_replica=rate_per_replica,
                max_replicas=min(max_replicas, self.n_devices),
                halflife_s=replica_halflife_s,
                interval_s=replication_interval_s)

    def close(self) -> None:
        super().close()
        self._pool.shutdown(wait=True)

    # -------------------------------------------------------------- replicas
    def _add_replica(self, key, dev: int) -> bool:
        """ReplicaManager promotion hook: stage a copy locally and, when a
        placement directory is attached (the multihost engine), record the
        new ``(host, slot)`` replica fleet-wide."""
        if not self.cache.add_replica(key, dev):
            return False
        directory = getattr(self, "directory", None)
        if directory is not None:
            try:
                directory.add_replica(
                    key, getattr(self, "process_index", 0), dev)
            except (KeyError, ValueError):
                pass    # directory host table lags (mid-rejoin): local
                #         replica still serves, directory catches up later
        return True

    def _drop_replica(self, key, dev: int) -> bool:
        """ReplicaManager demotion hook (mirror of :meth:`_add_replica`)."""
        if not self.cache.drop_replica(key, dev):
            return False
        directory = getattr(self, "directory", None)
        if directory is not None:
            directory.remove_replica(
                key, getattr(self, "process_index", 0), dev)
        return True

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
                out = plan.to_original_order(outs[0])
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

    def _shard_prepared(self, strategy: str, plan: PartitionPlan,
                        slots: Optional[Sequence] = None) -> Dict:
        """Memoized per-(plan, strategy, slot count) sharded-dispatch
        preparation: each slot's slab shard on its device and ``inv_perm``
        on the first slot's, complete before any slot's stream reads them.
        ``slots`` defaults to this engine's; the multihost engine passes
        the GLOBAL slots, whose count differs from the local one, and gets
        this process's shares of them."""
        slots = self.devices if slots is None else slots
        key = (plan.key, strategy, len(slots))
        with self._prep_lock:
            ent = self._shard_prep.get(key)
            if ent is not None:
                self._shard_prep.move_to_end(key)
                return ent
        if strategy == "feature":
            ent = {"args": prepare_feature_shards(plan.slabs, slots),
                   "live": None}
        elif _mesh_spans_processes(slots):
            args, live = commit_block_shards_global(
                plan.slabs, plan.n_rows, slots,
                getattr(self, "process_index", 0), self.devices)
            ent = {"args": args, "live": live}
        else:
            args, live = prepare_block_shards(plan.slabs, plan.n_rows, slots)
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

    # the multihost subclass keeps per-graph flush groups intact; factoring
    # the split point here keeps ONE grouping implementation
    def _flush_items_locally(self, items: List[WorkItem]) -> None:
        """Serve a subset of a flush (always READ items — mutations are
        never forwarded or failed over) entirely on this host's slots."""
        FleetGraphEngine._flush_reads(self, items)

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


def _host_array(x) -> np.ndarray:
    """A request's features as a float32 numpy array for the wire (a CUDA
    tensor is copied to the host; frames never carry a tensor)."""
    return torch.as_tensor(x).detach().to("cpu", torch.float32).numpy()


class MultihostGraphEngine(FleetGraphEngine):
    """Cross-host fleet serving: one engine per process, one shared
    placement directory, a TCP forwarding data plane between hosts.

    The flush pipeline grows exactly one stage over the single-host fleet::

        flush -> group by graph
              -> split groups by OWNING HOST (placement directory)
                   local groups  -> the inherited per-slot concurrent path
                   remote groups -> fused request forwarded to the owner
                                    host over its peer channel (numpy on
                                    the wire); the owner dispatches it
                                    INLINE on the connection thread (never
                                    through its scheduler queue — two
                                    hosts forwarding to each other through
                                    single flush workers would deadlock),
                                    on its slot's stream, and the answer
                                    travels back, is moved to this
                                    engine's device and resolves the
                                    ingress futures

    Ownership: :class:`~repro_torch.distributed.directory.PlacementDirectory`
    maps each plan key to a ``(host, slot)`` pair; the owning host pins the
    slot into its local :class:`FleetPlanCache` (:meth:`FleetPlanCache.pin`),
    so what the fleet believes and where the slabs actually sit agree.
    Registration is symmetric (every host registers every graph — the bytes
    come from shared storage) but only the OWNER builds and stages the
    plan: fleet plan capacity is the sum over hosts.

    Failure handling: a dead peer channel fails over — the affected items
    are served locally from a freshly-built plan, and after
    ``evict_after_failures`` CONSECUTIVE transport failures the owner is
    evicted from the directory (its keys re-place onto survivors; a
    recovered host rejoins via :meth:`connect_peers`). Remote EXECUTION
    errors do not fail over; they propagate to the submitting caller like
    any local dispatch error.

    ``serve_global`` is the explicitly-COLLECTIVE path for graphs too big
    for any single host: every process must call it with identical
    arguments; the plan's blocks round-robin over the global slots
    (:func:`repro_torch.launch.mesh.multihost_graph_mesh`), each process
    runs its own slots' shares through its regime's kernel, and the
    partials are gathered over gloo and folded in global slot order (the
    reference's cross-host ``psum``). The continuous-batching submit path
    never triggers it implicitly.

    Operational rule (the reference's): sequence phase changes over the
    data plane (a peer-server op setting an Event, as the two-process
    tests do), and only enter collective phases once forwarding traffic
    has drained. A process waiting in the gather still answers peers on its
    server threads, but the rule keeps both packages' tests meaning the
    same thing.
    """

    def __init__(
        self,
        *,
        context: Optional[MultihostContext] = None,
        directory: Optional[PlacementDirectory] = None,
        peer_addresses: Optional[Mapping[int, Tuple[str, int]]] = None,
        serve_port: Optional[int] = None,
        peer_timeout_s: float = 120.0,
        evict_after_failures: int = 3,
        **engine_kw,
    ):
        if context is None:
            local = graph_mesh()        # every visible card; raises without
            context = MultihostContext(  # CUDA
                process_index=0, process_count=1, coordinator=None,
                local_devices=local,
                global_devices=[(0, i) for i in range(len(local))])
        self.context = context
        self.process_index = context.process_index
        self.process_count = context.process_count
        if directory is None:
            # homogeneous-fleet default: every rank assumed to carry this
            # rank's slot count (peer handshakes correct the table)
            directory = PlacementDirectory([
                HostInfo(p, context.n_local_devices, 0)
                for p in range(context.process_count)])
        self.directory = directory

        super().__init__(devices=context.local_devices, **engine_kw)
        # the inherited pool is sized for per-slot launches; forwards to
        # remote owners block on the network, so give them their own slots
        self._pool.shutdown(wait=True)
        self._pool = ThreadPoolExecutor(
            max_workers=self.n_devices + max(1, self.process_count - 1),
            thread_name_prefix="fleet-dev")

        ports = peer_ports()
        if serve_port is None:
            serve_port = ports.get(self.process_index, 0)
        self.server = PeerServer(serve_port,
                                 process_index=self.process_index,
                                 epoch=context.epoch,
                                 n_devices=context.n_local_devices)
        self.server.register("serve", self._handle_peer_serve)
        self.server.register("mutate", self._handle_peer_mutate)
        if peer_addresses is None:
            peer_addresses = {r: ("127.0.0.1", p) for r, p in ports.items()
                              if r != self.process_index}
        self.peers: Dict[int, PeerClient] = {
            int(r): PeerClient(tuple(addr), process_index=self.process_index,
                               epoch=context.epoch, timeout_s=peer_timeout_s)
            for r, addr in peer_addresses.items()
            if int(r) != self.process_index}

        # multihost counters (under the inherited _counters_lock)
        self.forwarded_requests = 0
        self.host_forwarded = [0] * self.process_count
        self.remote_served = 0        # peer groups answered on their behalf
        self.forward_busy_s = 0.0
        self.host_failovers = 0
        self.global_dispatches = 0
        # global dispatches by the regime this process's shares ran
        self.global_regimes = dict.fromkeys(_REGIMES, 0)
        self.last_global_timing: Dict[str, float] = {}
        self.mutation_broadcasts = 0          # peer deliveries of a mutation
        self.mutation_broadcast_failures = 0  # peers a broadcast missed
        self.remote_mutations = 0             # mutations applied for a peer
        # consecutive transport failures per peer: a single slow request
        # (socket timeout on a busy owner) serves locally but keeps the
        # placements — only a PERSISTENT failure evicts the host
        self.evict_after_failures = evict_after_failures
        self._peer_failures: Dict[int, int] = {}
        # graph ids registered via register_subgraph: frontier subgraphs
        # are sampled near the data, so they serve from THIS host and
        # never enter the placement directory (guarded by _bind_lock)
        self._local_only: set = set()

    # ----------------------------------------------------------------- peers
    def connect_peers(self) -> Dict[int, int]:
        """Handshake every peer channel; the learned ``(rank, epoch,
        n_devices)`` feed the directory (a bumped epoch invalidates the
        restarted host's stale placements). Returns ``{rank: epoch}``.

        Also the REJOIN path: calling it again after a peer was evicted
        re-announces the recovered host to the directory — its ring arcs
        come back and its failure counter resets. The rejoin is
        forward-looking: keys re-placed onto survivors during the outage
        stay there (their plans are already resident).
        """
        epochs: Dict[int, int] = {}
        for _rank, client in sorted(self.peers.items()):
            peer_rank, peer_epoch = client.handshake()
            epochs[peer_rank] = peer_epoch
            self.directory.update_host(HostInfo(
                peer_rank, client.peer_devices or self.n_devices,
                peer_epoch))
            with self._counters_lock:
                self._peer_failures[peer_rank] = 0
        return epochs

    def _handle_peer_serve(self, payload: Dict) -> np.ndarray:
        """Data-plane handler: a peer forwarded a fused request group we
        own. It executes INLINE on this connection thread (an adopted,
        never-enqueued work item) — queueing it behind our single flush
        worker would deadlock two hosts forwarding to each other. The slot
        dispatch runs on the slot's stream and synchronizes it before it
        answers, so the ``.cpu()`` below reads a finished answer. The
        pinned-local marker keeps the item off the forwarding split even if
        it ever re-enters a flush path."""
        gid = payload["graph_id"]
        x = torch.from_numpy(np.asarray(payload["x"], dtype=np.float32))
        self._validate(gid, x)
        item = self.scheduler.adopt((gid, x, "pinned-local"))
        try:
            self._flush_items_locally([item])
        finally:
            if not item.done:   # dispatch raised (or forgot the item):
                item.fail(RuntimeError(   # never leave the peer hanging
                    f"peer dispatch left {gid!r} unanswered"))
        out = item.future.result(timeout=0).cpu().numpy()
        with self._counters_lock:
            self.remote_served += 1
        return out

    def close(self) -> None:
        super().close()               # drain the scheduler (may still forward)
        for client in self.peers.values():
            client.close()
        self.server.close()

    # ------------------------------------------------------------------ admin
    def register_graph(self, graph_id: str, g: CSRGraph,
                       normalize: bool = False) -> Optional[PartitionPlan]:
        """Register a graph fleet-wide (call on EVERY host with the same
        content — registration is symmetric, plan residency is not).

        Only the directory-designated owner builds and stages the plan (on
        the directory's slot, pinned into the local cache); other hosts
        record the binding and forward at serve time. Returns the plan on
        the owner, None elsewhere.
        """
        if normalize:
            g = gcn_normalize(g)
        key = (graph_content_hash(g), self.config)
        with self._bind_lock:
            prev_key = self._keys.get(graph_id)
            prev_ver = self._versions.get(graph_id)
            if prev_key == key and prev_ver is not None:
                version = prev_ver      # idempotent re-register
            elif prev_ver is not None:
                version = prev_ver + 1  # content replacement: chain advances
            else:
                version = 0
            self._graphs[graph_id] = g
            self._keys[graph_id] = key
            self._versions[graph_id] = version
        # seed the version chain fleet-wide: deterministic on every host,
        # so the first mutate's record_version(v+1) invalidates this key
        # everywhere without coordination
        self.directory.record_version(graph_id, key, version)
        placement = self.directory.place(key)
        if placement.host != self.process_index:
            return None
        dev = self.cache.pin(key, placement.device)
        return self.cache.get_by_key(
            key, lambda: build_partition_plan(g, self.config,
                                              graph_hash=key[0],
                                              device=self.devices[dev]))

    def register_subgraph(self, g: CSRGraph, prefix: str = "sub",
                          normalize: bool = False) -> str:
        """Register a frontier subgraph LOCALLY — sampling happens near
        the data, so the induced subgraph must serve from this host, not
        wherever the directory's consistent hash would place its key.
        Uses the single-host fleet path (local slot placement via
        ``FleetPlanCache``) and marks the id so ``_flush_reads`` never
        consults the directory or forwards it to a peer.
        """
        if normalize:
            g = gcn_normalize(g)
        graph_id = f"{prefix}:{graph_content_hash(g)[:16]}"
        with self._bind_lock:
            self._local_only.add(graph_id)
        FleetGraphEngine.register_graph(self, graph_id, g)
        return graph_id

    def unregister_graph(self, graph_id: str) -> bool:
        with self._bind_lock:
            self._local_only.discard(graph_id)
        return super().unregister_graph(graph_id)

    # ------------------------------------------------------------------ flush
    def _flush_reads(self, items: List[WorkItem]) -> None:
        """Split the read share of a flush by owning host FIRST; the local
        share then runs the inherited per-slot concurrent path while
        remote shares forward concurrently from the pool (one task per
        owner host). Mutations never reach here — the base ``_flush``
        wrapper splits them out and routes them via ``_apply_mutation``."""
        if self.process_count <= 1 or not self.peers:
            return super()._flush_reads(items)
        order, groups = self._group_by_graph(items)
        local: List[WorkItem] = []
        by_host: Dict[int, List[Tuple[str, List[WorkItem]]]] = {}
        with self._bind_lock:   # snapshot: gid -> current chained key
            keys = dict(self._keys)
            local_only = set(self._local_only)
        for gid in order:
            grp = groups[gid]
            if any(len(it.payload) > 2 for it in grp):
                local.extend(grp)     # pinned by a peer forward: never bounce
                continue
            if gid in local_only:
                local.extend(grp)     # frontier subgraph: sampled near the
                continue              # data, never directory-placed
            # consult the full replica set: a plan replicated ONTO this
            # host serves locally even when another host owns the primary
            reps = self.directory.replicas(keys[gid])
            owner = reps[0]
            if (any(r.host == self.process_index for r in reps)
                    or owner.host not in self.peers):
                local.extend(grp)
            else:
                by_host.setdefault(owner.host, []).append((gid, grp))

        futs = [self._pool.submit(self._forward_host, host, host_groups)
                for host, host_groups in sorted(by_host.items())]
        first_exc: Optional[BaseException] = None
        if local:
            try:
                super()._flush_reads(local)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                first_exc = e
        for f in futs:
            try:
                f.result()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                if first_exc is None:
                    first_exc = e
        if first_exc is not None:
            raise first_exc

    def _forward_host(self, host: int,
                      host_groups: List[Tuple[str, List[WorkItem]]]) -> None:
        """Forward one owner host's graph groups over its peer channel.

        Same fusion as a local dispatch: one request per graph group, the
        feature axis concatenated (as numpy), the answer sliced back per
        item on this engine's device. A TRANSPORT failure serves the
        unanswered items locally (failover) and, only after
        ``evict_after_failures`` CONSECUTIVE failures, evicts the host from
        the directory (survivors inherit its keys — ``connect_peers``
        re-admits a recovered host). A remote execution error propagates
        as-is.
        """
        t0 = time.perf_counter()
        client = self.peers[host]
        try:
            for gid, grp in host_groups:
                feats = [_host_array(it.payload[1]) for it in grp]
                widths = [int(f.shape[1]) for f in feats]
                fused = (feats[0] if len(feats) == 1
                         else np.concatenate(feats, axis=1))
                answer = client.request("serve", {"graph_id": gid,
                                                  "x": fused})
                out = torch.from_numpy(np.asarray(answer)).to(self.device)
                with self._counters_lock:
                    self._peer_failures[host] = 0
                answers, wait_s = self._slice_answers(
                    grp, widths, out, time.perf_counter())
                n_rows = int(out.shape[0])
                with self._counters_lock:
                    self.forwarded_requests += len(grp)
                    self.host_forwarded[host] += len(grp)
                    self.requests_served += len(grp)
                    self.rows_served += n_rows * len(grp)
                    self.values_served += n_rows * sum(widths)
                    self.total_request_latency_s += wait_s
                for item, result in answers:
                    item.complete(result)
        except ConnectionError:
            # serve the stragglers here either way; only a PERSISTENT
            # failure drops the host from the ring (one slow answer must
            # not permanently split the fleet — the placements stay, so
            # the next flush retries the forward)
            with self._counters_lock:
                self.host_failovers += 1
                n_fail = self._peer_failures.get(host, 0) + 1
                self._peer_failures[host] = n_fail
            if n_fail >= self.evict_after_failures:
                try:
                    self.directory.evict_host(host)
                except ValueError:
                    pass               # already the last host standing
            stragglers = [it for _, grp in host_groups for it in grp
                          if not it.done]
            if stragglers:
                self._flush_items_locally(stragglers)
        finally:
            dt = time.perf_counter() - t0
            with self._counters_lock:
                self.forward_busy_s += dt

    # --------------------------------------------------------------- mutation
    def _apply_mutation(self, gid: str, grp: List[WorkItem]) -> None:
        """Fleet-wide mutation: apply + publish locally, then broadcast the
        SAME delta sequence to every peer over the data plane.

        Every host runs the identical deterministic transition
        (:meth:`_apply_deltas_local`), so the fleet converges without a
        coordinator: same deltas -> same new graph -> same chained key ->
        same directory record. Writer discipline is SINGLE WRITER PER GRAPH
        (any host may be that writer): two hosts mutating one graph
        concurrently race their broadcasts and the version-fork guard on
        the receiving side fails the later one rather than silently
        diverging. A peer the broadcast cannot reach keeps serving its old
        binding until it rejoins.
        """
        with self._bind_lock:
            local_only = gid in self._local_only
        if local_only:
            # frontier subgraph: repair through the single-host path — no
            # broadcast, no directory transition (the id was never placed)
            return GraphServeEngine._apply_mutation(self, gid, grp)
        deltas: List[EdgeDelta] = [it.payload[1] for it in grp]
        info = self._apply_deltas_local(gid, deltas)
        if self.process_count > 1 and self.peers:
            payload = {"graph_id": gid, "deltas": deltas,
                       "base_version": info["version"] - 1}
            for rank, client in sorted(self.peers.items()):
                try:
                    client.request("mutate", payload)
                    with self._counters_lock:
                        self.mutation_broadcasts += 1
                        self._peer_failures[rank] = 0
                except ConnectionError:
                    with self._counters_lock:
                        self.mutation_broadcast_failures += 1
        for it in grp:
            it.complete(dict(info))

    def _handle_peer_mutate(self, payload: Dict) -> Dict:
        """Data-plane handler: replay a peer's mutation on this host.

        Runs inline on the connection thread (like ``serve``); a repaired
        plan is published from here, and the fleet cache synchronizes this
        thread's stream before a slot can read it. The version fork guard
        raises back to the writer if this host's chain is not at the
        broadcast's base version.
        """
        gid = payload["graph_id"]
        with self._bind_lock:
            if gid not in self._graphs:
                raise KeyError(
                    f"graph {gid!r} not registered on host "
                    f"{self.process_index}")
        info = self._apply_deltas_local(
            gid, payload["deltas"],
            expect_base=payload.get("base_version"))
        with self._counters_lock:
            self.remote_mutations += 1
        return {"graph_id": gid, "version": info["version"]}

    def _apply_deltas_local(self, gid: str, deltas: Sequence[EdgeDelta],
                            expect_base: Optional[int] = None) -> Dict:
        """One host's share of a fleet mutation (deterministic transition).

        Applies the deltas SEQUENTIALLY, advances the version chain in the
        directory (sticky owner slot via :meth:`PlacementDirectory.place_at`),
        and — only on the owner host — repairs and publishes the plan; the
        other hosts re-bind and retire their stale copies. With
        ``expect_base`` set (a replayed broadcast), a chain not at that
        version raises instead of forking.
        """
        with self._mutate_lock:
            with self._bind_lock:
                g_old = self._graphs[gid]
                old_key = self._keys[gid]
                cur_ver = self._versions[gid]
            if expect_base is not None and cur_ver != expect_base:
                raise RuntimeError(
                    f"mutation version fork on {gid!r}: host "
                    f"{self.process_index} is at v{cur_ver}, writer "
                    f"published against v{expect_base} — one writer per "
                    f"graph at a time")
            g_new = g_old
            touched: List[np.ndarray] = []
            n_edges = 0
            gh = old_key[0]
            for d in deltas:
                g_new = d.apply(g_new)
                touched.append(d.touched_rows())
                n_edges += d.size
                gh = delta_chain_hash(gh, d)
            # O(delta) chained key: every host chains the same deltas onto
            # the same parent hash, so the fleet converges on one key
            # without re-hashing the whole graph
            new_key = (gh, self.config)
            version = cur_ver + 1
            # deterministic directory transition: resolve the CURRENT
            # owner, advance the chain (drops the old key fleet-wide),
            # re-pin the new key to the same slot
            owner = self.directory.place(old_key)
            self.directory.record_version(gid, new_key, version)
            self.directory.place_at(new_key, owner.host, owner.device)
            repaired, reason, dirty = False, "non-owner rebind", 0
            if owner.host == self.process_index:
                plan_old = self.cache.lookup(old_key)
                if plan_old is not None:
                    pv = repair_plan(
                        plan_old, g_old, g_new,
                        (np.unique(np.concatenate(touched)) if touched
                         else np.empty(0, np.int64)),
                        churn_threshold=self.repair_churn_threshold,
                        graph_hash=gh)
                    plan_new = pv.plan
                    repaired, reason, dirty = (pv.repaired, pv.reason,
                                               pv.dirty_rows)
                else:       # owner copy LRU-evicted: nothing to repair from
                    plan_new = build_partition_plan(
                        g_new, self.config, graph_hash=new_key[0],
                        device=self.devices[owner.device])
                    reason = "owner plan not resident; full build"
                plan_new.version = version
                self.cache.pin(new_key, owner.device)
                self.cache.publish(plan_new, retire_key=old_key)
            else:
                self.cache.retire(old_key)
            with self._bind_lock:
                self._graphs[gid] = g_new
                self._keys[gid] = new_key
                self._versions[gid] = version
            with self._counters_lock:
                self.mutations_applied += len(deltas)
                self.mutation_edges += n_edges
                if owner.host == self.process_index:
                    if repaired:
                        self.plan_repairs += 1
                    else:
                        self.plan_rebuilds += 1
        return {"graph_id": gid, "version": version, "repaired": repaired,
                "reason": reason, "dirty_rows": dirty}

    # ----------------------------------------------------------------- global
    def serve_global(self, graph_id: str, x) -> torch.Tensor:
        """COLLECTIVE whole-fleet dispatch of one graph (SPMD contract:
        every process calls with identical arguments, in the same order
        relative to its other serve_global calls).

        Routes over the GLOBAL slot count: when the dispatch block-shards
        (giant narrow graph), the blocks round-robin over every host's
        slots, each process runs its own shares through its regime's
        kernel (``_slot_regime``), and the partials are gathered over gloo
        and folded in global slot order — fleet capacity for one graph
        becomes the sum of every host's memory. A dispatch that routes
        ``single`` falls back to the local serving path on every host
        (identical answers, no collective). The answer lies on this
        engine's first slot; ``last_global_timing`` holds the dispatch's
        shares, gather and fold ms beside its wall ms.
        """
        plan = self.plan_for(graph_id)
        gslots = multihost_graph_mesh(self.context)
        n_global = len(gslots)
        fd = route_fleet(
            plan.n_cols, int(x.shape[1]), int(plan.slabs["C"]),
            int(plan.slabs["R"]), plan.num_blocks, n_global,
            min_blocks_per_device=self.min_blocks_per_device,
            n_hosts=self.process_count)
        if fd.strategy != "block" or self.process_count <= 1:
            return self.serve_one(graph_id, x)
        regime = self._slot_regime(fd)
        timings: Dict[str, float] = {}
        t0 = time.perf_counter()
        with self._on_slot(0):
            xd = torch.as_tensor(x, dtype=torch.float32,
                                 device=self.devices[0])
            # this process's shares are staged once per plan and reused
            prep = self._shard_prepared("block", plan, gslots)
            out, live = spmm_block_sharded(
                plan.slabs, xd, plan.n_rows, gslots,
                prepared=(prep["args"], prep["live"]), regime=regime,
                streams=self._streams, local_devices=self.devices,
                timings=timings)
            out = out[prep["inv_perm"]]
            self._hand_over(out)
        dt = time.perf_counter() - t0
        with self._counters_lock:
            self.global_dispatches += 1
            self.global_regimes[regime] += 1
            self.sharded_dispatches["block"] += 1
            self.sharded_busy_s += dt
            self.last_fleet_decision = fd
            self.last_block_counts = [int(c) for c in live]
            self.last_global_timing = dict(timings, wall_ms=dt * 1e3)
            self._note_window_locked(t0, dt)
        return out

    # ------------------------------------------------------------------ stats
    def _stats_locked(self, s: Dict[str, float]) -> Dict[str, float]:
        s = super()._stats_locked(s)
        # a global dispatch launches one kernel per local slot here
        for k, n in self.global_regimes.items():
            s[f"slot_routed_{k}"] += self.n_devices * n
        s.update(
            fleet_process_index=self.process_index,
            fleet_hosts=self.process_count,
            fleet_forwarded=self.forwarded_requests,
            fleet_host_forwarded=list(self.host_forwarded),
            fleet_remote_served=self.remote_served,
            fleet_forward_busy_s=self.forward_busy_s,
            fleet_host_failovers=self.host_failovers,
            fleet_global_dispatches=self.global_dispatches,
            fleet_mutation_broadcasts=self.mutation_broadcasts,
            fleet_mutation_broadcast_failures=self.mutation_broadcast_failures,
            fleet_remote_mutations=self.remote_mutations,
        )
        for k, v in self.directory.stats().items():
            s[f"fleet_dir_{k}"] = v
        return s
