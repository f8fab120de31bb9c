"""Slot-partitioned plan cache: each partition plan resident on ONE slot.

One :class:`~repro_torch.core.plan_cache.PlanCache` caps the serving
working set at what one card holds. :class:`FleetPlanCache` wraps one
``PlanCache`` per slot (see :mod:`repro_torch.launch.mesh`) behind a
placement policy, so the fleet's plan capacity grows with its slots:

* **consistent-hash placement** — a graph's content hash lands on a hash
  ring (:class:`ConsistentHashRing`, virtual nodes per slot, the
  reference's labels and blake2b points), so the same graph lands on the
  same slot across processes and restarts, and resizing the fleet remaps
  only ~1/d of the keys;
* **load-aware override** — when the ring's choice is already far fuller
  than the emptiest shard (more than ``load_spread`` plans apart), the plan
  goes to the least-loaded shard instead. Placements are sticky: once a key
  is placed, later lookups go to the recorded shard, so the override never
  strands a cached plan.

Staging: each shard stages its plans on its slot's device, so a slot's
dispatch reads slabs from its own card. Hot plans can be **replicated**:
:meth:`FleetPlanCache.add_replica` puts an independent ``PartitionPlan``
for the primary's plan on another slot's shard, and
:meth:`FleetPlanCache.drop_replica` demotes it again. The primary
placement is never dropped by demotion.

Streams: every tensor this cache stages or publishes is complete before
the call returns (the caller's current stream on that card is
synchronized), because slots read plans on CUDA streams of their own.
"""
from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch

from ..core.graph import CSRGraph
from ..core.plan_cache import (
    DeviceLike, PartitionConfig, PartitionPlan, PlanCache,
    build_partition_plan, graph_content_hash,
)
from ..launch.mesh import graph_mesh, resolve_slots

__all__ = ["ConsistentHashRing", "FleetPlanCache"]


def _settle(device: torch.device) -> None:
    """Wait for the caller's current stream on ``device``: what it staged
    is then readable from any other stream."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class ConsistentHashRing:
    """Classic consistent-hash ring over integer member ids.

    ``vnodes`` virtual points per member smooth the arc lengths; lookup is
    a bisect over the sorted point list. Members are the fleet's slot
    indices — adding/removing a slot moves only the keys on its arcs.

    ``labels`` optionally names each member's ring points (same length as
    ``members``). Point positions depend only on the label, so a caller
    whose member ids index a mutable slot table keeps surviving keys
    stationary when the table shrinks.
    """

    def __init__(self, members: Sequence[int], vnodes: int = 64,
                 labels: Optional[Sequence[str]] = None):
        members = list(members)
        if not members:
            raise ValueError("hash ring needs >= 1 member")
        if labels is not None and len(labels) != len(members):
            raise ValueError(
                f"{len(labels)} labels for {len(members)} members")
        self.vnodes = vnodes
        self._points: List[Tuple[int, int]] = []
        for j, m in enumerate(members):
            label = labels[j] if labels is not None else f"dev{m}"
            for v in range(vnodes):
                h = hashlib.blake2b(f"{label}#v{v}".encode(),
                                    digest_size=8).digest()
                self._points.append((int.from_bytes(h, "big"), int(m)))
        self._points.sort()
        self._keys = [p[0] for p in self._points]

    def lookup(self, key: str) -> int:
        """Member owning ``key`` (first ring point clockwise of its hash)."""
        h = int.from_bytes(
            hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")
        i = bisect.bisect_right(self._keys, h) % len(self._points)
        return self._points[i][1]


class FleetPlanCache:
    """Per-slot :class:`PlanCache` shards behind one placement policy.

    Stands in for the single ``PlanCache`` where the serving engine is
    concerned (``get_or_build`` / ``get_by_key`` / ``stats`` / ``builds``…),
    plus :meth:`device_index_of` so the fleet engine can group dispatches
    by owning slot. ``devices`` is the slot list (default
    :func:`~repro_torch.launch.mesh.graph_mesh`: every visible card, raising
    without CUDA); shard ``m`` stages on ``devices[m]``.
    ``capacity_per_device`` bounds each shard, so total fleet capacity is
    ``capacity_per_device * len(devices)``.
    """

    def __init__(self, devices: Optional[Sequence[DeviceLike]] = None, *,
                 capacity_per_device: int = 32,
                 load_spread: int = 4,
                 vnodes: int = 64,
                 save_dir: Optional[str] = None):
        self.devices = (resolve_slots(devices) if devices is not None
                        else graph_mesh())
        self.capacity_per_device = capacity_per_device
        self.load_spread = load_spread
        # shards share one spill dir: spill names are content-hashed, so a
        # plan evicted from shard 3 can be reloaded by any shard later
        self.shards: List[PlanCache] = [
            PlanCache(capacity_per_device, save_dir=save_dir, device=d)
            for d in self.devices]
        self.ring = ConsistentHashRing(range(len(self.devices)), vnodes)
        self._lock = threading.Lock()
        self._placements: Dict[Tuple[str, PartitionConfig], int] = {}
        # keys whose build is in flight (placed, not yet inserted into the
        # owning shard): exempt from placement pruning, refcounted because
        # several threads can be waiting on one single-flight build
        self._building: Dict[Tuple[str, PartitionConfig], int] = {}
        # extra replica slots per key (primary NOT included); replicated
        # and pinned keys are exempt from placement pruning
        self._replicas: Dict[Tuple[str, PartitionConfig], List[int]] = {}
        self._pinned: Set[Tuple[str, PartitionConfig]] = set()
        # version pins route to the shard that was serving the key when its
        # first reader pinned it — the placement may be gone by unpin time
        # (publish retires superseded keys), so the shard is remembered here
        self._vpins: Dict[Tuple[str, PartitionConfig], int] = {}
        self.placement_overrides = 0   # load-aware departures from the ring
        self.replicas_added = 0
        self.replicas_removed = 0

    # ------------------------------------------------------------- placement
    def device_index_of(self, key: Tuple[str, PartitionConfig]) -> int:
        """Owning slot index of ``key`` (placing it if never seen)."""
        with self._lock:
            return self._place_locked(key)

    def pin(self, key: Tuple[str, PartitionConfig], device_index: int) -> int:
        """Pre-record an externally decided placement for ``key`` (a
        placement directory's choice). Sticky like any other placement: an
        existing placement wins (the plan is already resident there) and is
        returned."""
        if not 0 <= device_index < len(self.devices):
            raise ValueError(
                f"pin({device_index}) outside the {len(self.devices)}-device "
                f"fleet")
        with self._lock:
            self._pinned.add(key)
            return self._placements.setdefault(key, int(device_index))

    def _place_locked(self, key: Tuple[str, PartitionConfig]) -> int:
        dev = self._placements.get(key)
        if dev is not None:
            return dev
        dev = self.ring.lookup(key[0])
        sizes = [len(s) for s in self.shards]
        least = min(range(len(sizes)), key=sizes.__getitem__)
        if sizes[dev] - sizes[least] > self.load_spread:
            dev = least
            self.placement_overrides += 1
        self._placements[key] = dev
        # stickiness only matters while the plan is resident: once the
        # placement map outgrows the fleet's live capacity, drop entries
        # whose plan every holding shard has since evicted, so one-off
        # graph churn cannot grow the map without bound. Exempt: the key
        # just placed, in-flight builds (not inserted yet: re-placing them
        # could leave two resident copies), pinned keys, and keys resident
        # on a replica shard only.
        cap = 2 * self.capacity_per_device * len(self.shards)
        if len(self._placements) > cap:
            self._placements = {
                k: d for k, d in self._placements.items()
                if k == key or k in self._building or k in self._pinned
                or k in self.shards[d]
                or any(k in self.shards[r]
                       for r in self._replicas.get(k, ()))}
        return dev

    # -------------------------------------------------------------- replicas
    def replica_devices(self, key: Tuple[str, PartitionConfig]) -> List[int]:
        """Slot indices holding ``key``'s plan, primary first.

        Extras whose shard has since LRU-evicted the copy are lazily
        dropped. Does NOT place unseen keys — an unplaced key returns [].
        """
        with self._lock:
            primary = self._placements.get(key)
            if primary is None:
                return []
            extras = self._replicas.get(key)
            if extras:
                live = [d for d in extras if key in self.shards[d]]
                if len(live) != len(extras):
                    self.replicas_removed += len(extras) - len(live)
                    if live:
                        self._replicas[key] = live
                    else:
                        del self._replicas[key]
                extras = live
            return [primary] + list(extras or [])

    def add_replica(self, key: Tuple[str, PartitionConfig],
                    device_index: int) -> bool:
        """Put an independent ``PartitionPlan`` for ``key`` on another slot.

        The copy is the primary's ``PartitionPlan.to`` the target slot's
        device: on another card a copy there; on a slot that shares the
        primary's card, the primary's own tensors (``.to`` returns them),
        so the replica aliases them and costs no device memory. Plans are
        never written in place, so the alias is safe; the separate object
        keeps the shards' bookkeeping apart. Idempotent; returns False when
        the primary has no resident plan to copy.
        """
        if not 0 <= device_index < len(self.devices):
            raise ValueError(
                f"add_replica({device_index}) outside the "
                f"{len(self.devices)}-device fleet")
        with self._lock:
            primary = self._placements.get(key)
            if primary is None or device_index == primary:
                return primary is not None and device_index == primary
            if device_index in self._replicas.get(key, ()):
                return True
        plan = self.shards[primary].lookup(key)
        if plan is None:
            return False
        device = self.devices[device_index]
        copy = plan.to(device)
        _settle(device)
        self.shards[device_index].put(copy)
        with self._lock:
            lst = self._replicas.setdefault(key, [])
            if device_index not in lst:
                lst.append(device_index)
                self.replicas_added += 1
        return True

    def drop_replica(self, key: Tuple[str, PartitionConfig],
                     device_index: int) -> bool:
        """Demote one replica copy. The PRIMARY placement is never dropped
        here — demotion only trims extras, so a cold streak can never
        un-place a plan (use ``clear`` or shard eviction for that)."""
        with self._lock:
            lst = self._replicas.get(key)
            if not lst or device_index not in lst:
                return False
            lst.remove(device_index)
            if not lst:
                del self._replicas[key]
            self.replicas_removed += 1
        self.shards[device_index].remove(key)
        return True

    def plan_on(self, key: Tuple[str, PartitionConfig],
                device_index: int) -> Optional[PartitionPlan]:
        """The resident plan copy on one specific shard (None if absent)."""
        return self.shards[device_index].lookup(key)

    # -------------------------------------------------------- version chain
    def pin_version(self, key: Tuple[str, PartitionConfig]) -> int:
        """Pin a reader's plan version on its serving shard (see
        :meth:`~repro_torch.core.plan_cache.PlanCache.pin`). Returns the new
        refcount, or 0 when the key has no placement to pin against."""
        with self._lock:
            dev = self._vpins.get(key)
            if dev is None:
                dev = self._placements.get(key)
                if dev is None:
                    return 0
                self._vpins[key] = dev
        return self.shards[dev].pin(key)

    def unpin_version(self, key: Tuple[str, PartitionConfig]) -> int:
        """Release one reader pin (reclaims a retired version when the last
        pin drains). Routed by the shard remembered at pin time — the
        placement itself may already belong to a successor version."""
        with self._lock:
            dev = self._vpins.get(key)
        if dev is None:
            return 0
        c = self.shards[dev].unpin(key)
        if c == 0:
            with self._lock:
                self._vpins.pop(key, None)
        return c

    def retire(self, key: Tuple[str, PartitionConfig]) -> bool:
        """Retire a superseded key on EVERY shard (see
        :meth:`~repro_torch.core.plan_cache.PlanCache.retire`) and drop its
        placement / replica / pin bookkeeping. Returns True if any shard
        actually held the key."""
        any_retired = False
        for s in self.shards:
            any_retired = s.retire(key) or any_retired
        with self._lock:
            self._placements.pop(key, None)
            self._replicas.pop(key, None)
            self._pinned.discard(key)
        return any_retired

    def publish(self, plan: PartitionPlan, retire_key=None) -> PartitionPlan:
        """Publish the next version of a graph's plan fleet-wide (the shape
        of :meth:`PlanCache.publish`, so the engine's publish hook does not
        care which cache it holds):

        1. the new key inherits the retired key's PRIMARY slot (sticky
           placement across versions), staged there and inserted
           atomically on that shard;
        2. every replica slot of the retired key gets a copy of the NEW
           version (hot graphs stay hot through a mutation);
        3. the retired key drops from every shard (parking per-shard where
           readers still pin it), its placement, replica list and pin
           marker with it.

        The new plan's tensors may still be in flight on the caller's
        stream (a repair's ``torch.cat``); they are complete before any
        shard holds them.
        """
        with self._lock:
            primary = None
            extras: List[int] = []
            if retire_key is not None:
                primary = self._placements.get(retire_key)
                extras = list(self._replicas.get(retire_key, ()))
            if primary is None:
                primary = self._place_locked(plan.key)
            else:
                self._placements[plan.key] = primary
            if retire_key in self._pinned:
                self._pinned.add(plan.key)
        _settle(plan.device)
        staged = self._ensure_staged(plan, self.devices[primary])
        self.shards[primary].publish(staged)
        for dev in extras:
            self.add_replica(plan.key, dev)
        if retire_key is not None and retire_key != plan.key:
            for s in self.shards:
                s.retire(retire_key)
            with self._lock:
                self._placements.pop(retire_key, None)
                self._replicas.pop(retire_key, None)
                self._pinned.discard(retire_key)
        return staged

    # --------------------------------------------------------------- lookups
    def get_or_build(self, g: CSRGraph, cfg: PartitionConfig) -> PartitionPlan:
        """The plan for (g, cfg), built on its owning slot's device at first
        sight."""
        key = (graph_content_hash(g), cfg)
        return self.get_by_key(key, lambda: build_partition_plan(
            g, cfg, graph_hash=key[0],
            device=self.devices[self.device_index_of(key)]))

    def get_by_key(self, key: Tuple[str, PartitionConfig],
                   build_fn: Callable[[], PartitionPlan]) -> PartitionPlan:
        # place AND register the in-flight build in ONE lock hold: a prune
        # racing between the two could otherwise drop the fresh placement
        # and let a later lookup re-place the key while the first copy
        # builds — two resident copies of one plan
        with self._lock:
            dev_idx = self._place_locked(key)
            self._building[key] = self._building.get(key, 0) + 1
        try:
            plan = self.shards[dev_idx].get_by_key(key, build_fn)
        finally:
            with self._lock:
                n = self._building.get(key, 1) - 1
                if n <= 0:
                    self._building.pop(key, None)
                else:
                    self._building[key] = n
        return self._ensure_staged(plan, self.devices[dev_idx])

    def lookup(self, key: Tuple[str, PartitionConfig]
               ) -> Optional[PartitionPlan]:
        with self._lock:
            dev_idx = self._placements.get(key)
        if dev_idx is None:
            return None
        return self.shards[dev_idx].lookup(key)

    @staticmethod
    def _ensure_staged(plan: PartitionPlan,
                       device: torch.device) -> PartitionPlan:
        """Move the plan's tensors to the owning slot's device (a no-op
        where they already lie there, as for every plan this cache builds).

        Mutates the shared plan object in place: the staged tensors replace
        the old ones for every holder. Races between threads write
        equivalent values, so no lock is needed.
        """
        if plan.device == device:
            return plan
        staged = plan.to(device)
        for name in PartitionPlan.TENSOR_FIELDS:
            setattr(plan, name, getattr(staged, name))
        _settle(device)
        return plan

    # ----------------------------------------------------------------- admin
    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    def __contains__(self, key) -> bool:
        return any(key in s for s in self.shards)

    def clear(self) -> None:
        for s in self.shards:
            s.clear()
        with self._lock:
            self._placements.clear()
            self._replicas.clear()
            self._pinned.clear()

    def keys(self):
        out = []
        for s in self.shards:
            out.extend(s.keys())
        return out

    # aggregate counters, mirroring the PlanCache attribute API the tests
    # and engine use (reads are sums over shard snapshots)
    @property
    def builds(self) -> int:
        return sum(s.stats()["builds"] for s in self.shards)

    @property
    def hits(self) -> int:
        return sum(s.stats()["hits"] for s in self.shards)

    @property
    def misses(self) -> int:
        return sum(s.stats()["misses"] for s in self.shards)

    def stats(self) -> Dict[str, float]:
        """Aggregate counters + per-shard occupancy (for balance stats).
        ``device_bytes`` sums each shard's plans, so a replica that aliases
        its primary on a shared card counts twice."""
        per = [s.stats() for s in self.shards]
        agg: Dict[str, float] = {}
        for k in ("size", "lookups", "hits", "misses", "builds", "evictions",
                  "spills", "disk_hits", "device_bytes", "publishes", "pins",
                  "retired_versions", "retired_reclaimed", "retired_live"):
            agg[k] = sum(p[k] for p in per)
        total = agg["hits"] + agg["misses"]
        agg["capacity"] = self.capacity_per_device * len(self.shards)
        agg["hit_rate"] = agg["hits"] / total if total else 0.0
        agg["devices"] = len(self.devices)
        agg["shard_sizes"] = [p["size"] for p in per]
        agg["shard_bytes"] = [p["device_bytes"] for p in per]
        with self._lock:
            agg["placements"] = len(self._placements)
            agg["placement_overrides"] = self.placement_overrides
            agg["replicated_keys"] = sum(
                1 for lst in self._replicas.values() if lst)
            agg["replica_copies"] = sum(
                len(lst) for lst in self._replicas.values())
            agg["replicas_added"] = self.replicas_added
            agg["replicas_removed"] = self.replicas_removed
            agg["pinned"] = len(self._pinned)
        return agg
