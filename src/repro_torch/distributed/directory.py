"""Cross-host placement directory: ``plan_key -> (host, device)`` fleet-wide.

:class:`~repro_torch.distributed.placement.FleetPlanCache` caps the serving
working set at one *host's* slots. The :class:`PlacementDirectory` is the
level above it: every process of a multi-host fleet holds one, and a plan
key resolves to the ``(process_index, local_slot)`` pair that owns the plan
— so fleet capacity becomes the sum of every host's device memory, and a
request admitted on any host is forwarded to (and served from) the one host
whose slot actually holds the staged plan.

Pure Python over the port's
:class:`~repro_torch.distributed.placement.ConsistentHashRing`: for the same
host table and the same sequence of operations it places, replicates,
evicts and versions exactly as the reference's directory does.

Placement policy (mirroring ``FleetPlanCache``, one level up):

* **consistent hash over (host, device) slots** — every local device of
  every host is a ring slot (labelled ``host{p}:dev{i}``, virtual nodes per
  slot). Pure-hash placements are *deterministic across processes*: two
  directories built from the same host table place every key identically
  without any coordination, which is what makes the directory
  "distributed" — there is no directory server to ask.
* **load-aware override** — when the ring's slot already holds
  ``load_spread`` more placements than the emptiest slot, the key goes to
  the least-loaded slot instead. Overrides are an ingress-local
  optimization (they depend on the order this process saw keys); the
  executing host remains authoritative for which of ITS devices serves,
  so divergent overrides cost at most a duplicate local staging, never a
  wrong answer.
* **epoch-stamped entries** — each host carries an ``epoch`` that bumps on
  restart. An entry records its owner's epoch at placement time; when a
  host re-announces with a newer epoch (it restarted and lost its plan
  cache), every entry stamped with the old epoch is invalidated and
  re-placed on next lookup. :meth:`evict_host` removes a host from the
  ring entirely (crash, drain): its keys re-place onto the survivors,
  everyone else's arcs stay put (the consistent-hashing property).
* **replica sets** — a hot plan may be staged on several slots at once:
  :meth:`add_replica` / :meth:`remove_replica` maintain an ordered replica
  list per key (the primary owner first), each replica epoch-stamped like
  a primary entry. Losing the primary (epoch bump, host eviction) PROMOTES
  the first surviving replica instead of dropping the key — evicting one
  replica never discards the plan's other replicas — and :meth:`replicas`
  returns only live replicas, lazily scrubbing stale ones.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from .placement import ConsistentHashRing

__all__ = ["HostInfo", "Placement", "PlacementDirectory"]


@dataclasses.dataclass(frozen=True)
class HostInfo:
    """One fleet process: its rank, local device count, and restart epoch."""

    process_index: int
    n_devices: int
    epoch: int = 0

    def __post_init__(self):
        if self.process_index < 0:
            raise ValueError(f"bad process_index {self.process_index}")
        if self.n_devices < 1:
            raise ValueError(
                f"host {self.process_index} needs >= 1 device, "
                f"got {self.n_devices}")


@dataclasses.dataclass(frozen=True)
class Placement:
    """A key's recorded owner: host rank, local device index, owner epoch."""

    host: int
    device: int
    epoch: int


def _slot_label(host: int, device: int) -> str:
    return f"host{host}:dev{device}"


class PlacementDirectory:
    """Per-process view of the fleet-wide ``plan_key -> (host, device)`` map.

    Thread-safe; every mutation runs under one lock. Keys are whatever the
    plan cache uses (``(graph_hash, PartitionConfig)`` tuples) — the
    directory only hashes their first element, mirroring the per-host ring.
    """

    def __init__(self, hosts: Sequence[HostInfo], *,
                 load_spread: int = 4, vnodes: int = 32):
        hosts = list(hosts)
        if not hosts:
            raise ValueError("placement directory needs >= 1 host")
        ranks = [h.process_index for h in hosts]
        if len(set(ranks)) != len(ranks):
            raise ValueError(f"duplicate host ranks: {sorted(ranks)}")
        self.load_spread = load_spread
        self.vnodes = vnodes
        self._lock = threading.Lock()
        self._hosts: Dict[int, HostInfo] = {
            h.process_index: h for h in hosts}
        self._entries: Dict[object, Placement] = {}
        # extra replicas beyond the primary owner, insertion-ordered; the
        # full replica set of a key is [primary] + _replica_entries[key]
        self._replica_entries: Dict[object, List[Placement]] = {}
        self._slots: List[Tuple[int, int]] = []
        self._ring: Optional[ConsistentHashRing] = None
        with self._lock:
            self._rebuild_ring_locked()
        # versioned plan chains: graph_id -> (current plan key, version).
        # Publishing a newer version drops the OLD key's primary and every
        # replica, so no host can resolve a stale epoch through this
        # directory — and because record_version is deterministic (pure
        # function of its arguments), every host's directory converges on
        # the same current key without coordination.
        self._versions: Dict[str, Tuple[object, int]] = {}
        # monotone counters (the fleet_* stats vocabulary feeds off these)
        self.placement_overrides = 0
        self.epoch_invalidations = 0   # entries dropped by a host restart
        self.evicted_placements = 0    # entries dropped by evict_host
        self.replicas_added = 0
        self.replicas_removed = 0
        self.replica_promotions = 0    # replica became primary on owner loss
        self.replica_invalidations = 0  # stale replicas scrubbed
        self.version_invalidations = 0  # keys dropped by a newer plan version

    # ------------------------------------------------------------------ ring
    def _rebuild_ring_locked(self) -> None:
        self._slots = [(h.process_index, d)
                       for h in sorted(self._hosts.values(),
                                       key=lambda h: h.process_index)
                       for d in range(h.n_devices)]
        labels = [_slot_label(p, d) for p, d in self._slots]
        self._ring = ConsistentHashRing(range(len(self._slots)),
                                        vnodes=self.vnodes, labels=labels)

    def slots(self) -> List[Tuple[int, int]]:
        """Every live ``(host, device)`` slot, host-major."""
        with self._lock:
            return list(self._slots)

    def hosts(self) -> List[HostInfo]:
        with self._lock:
            return sorted(self._hosts.values(),
                          key=lambda h: h.process_index)

    # ------------------------------------------------------------- placement
    def place(self, key) -> Placement:
        """Resolve (placing if unseen or stale) the owner of ``key``.

        Stale entries — owner evicted, or owner restarted with a newer
        epoch — are invalidated here and the key re-placed with current
        ring/load data.
        """
        with self._lock:
            return self._resolve_primary_locked(key)

    def _live_locked(self, ent: Placement) -> bool:
        host = self._hosts.get(ent.host)
        return (host is not None and host.epoch == ent.epoch
                and ent.device < host.n_devices)

    def _resolve_primary_locked(self, key) -> Placement:
        ent = self._entries.get(key)
        if ent is not None:
            if self._live_locked(ent):
                return ent
            # stale: the owner restarted (lost its plans) or left
            del self._entries[key]
            self.epoch_invalidations += 1
        promoted = self._promote_locked(key)
        if promoted is not None:
            return promoted
        return self._place_locked(key)

    def _promote_locked(self, key) -> Optional[Placement]:
        """Make the first surviving replica of ``key`` the primary owner.

        Returns the promoted placement, or None when no live replica
        exists (the key's replica list, if any, is dropped).
        """
        live = self._scrub_replicas_locked(key)
        if not live:
            return None
        ent = live.pop(0)
        if live:
            self._replica_entries[key] = live
        else:
            self._replica_entries.pop(key, None)
        self._entries[key] = ent
        self.replica_promotions += 1
        return ent

    def _scrub_replicas_locked(self, key) -> List[Placement]:
        """Drop stale extras of ``key``; return the surviving list."""
        lst = self._replica_entries.get(key)
        if not lst:
            return []
        primary = self._entries.get(key)
        live = [e for e in lst
                if self._live_locked(e)
                and (primary is None
                     or (e.host, e.device) != (primary.host, primary.device))]
        self.replica_invalidations += len(lst) - len(live)
        if live:
            self._replica_entries[key] = live
        else:
            self._replica_entries.pop(key, None)
        return list(live)

    def lookup(self, key) -> Optional[Placement]:
        """Peek without placing; returns None for unseen AND stale keys."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return None
            host = self._hosts.get(ent.host)
            if host is None or host.epoch != ent.epoch:
                return None
            return ent

    def _place_locked(self, key) -> Placement:
        hash_key = key[0] if isinstance(key, tuple) else str(key)
        slot_idx = self._ring.lookup(str(hash_key))
        counts = self._slot_counts_locked()
        least = min(range(len(self._slots)), key=counts.__getitem__)
        if counts[slot_idx] - counts[least] > self.load_spread:
            slot_idx = least
            self.placement_overrides += 1
        host, device = self._slots[slot_idx]
        ent = Placement(host, device, self._hosts[host].epoch)
        self._entries[key] = ent
        return ent

    def _slot_counts_locked(self) -> List[int]:
        index = {slot: i for i, slot in enumerate(self._slots)}
        counts = [0] * len(self._slots)
        for ent in self._entries.values():
            i = index.get((ent.host, ent.device))
            if i is not None:
                counts[i] += 1
        for lst in self._replica_entries.values():
            for ent in lst:
                i = index.get((ent.host, ent.device))
                if i is not None:
                    counts[i] += 1
        return counts

    def place_at(self, key, host: int, device: int) -> Placement:
        """Record the primary owner of ``key`` at an EXPLICIT slot.

        The version-publish path uses this to keep a mutated graph's new
        plan key on the slot that already holds the superseded version —
        sticky ownership across versions, so warmed device state, replica
        history, and pin markers stay meaningful. Deterministic given the
        same host table, like :meth:`record_version`, so every host's
        directory converges on the same owner without coordination.
        Stamped with the host's CURRENT epoch; overwrites any prior
        primary for the key. Raises on unknown hosts / bad devices.
        """
        with self._lock:
            hinfo = self._hosts.get(host)
            if hinfo is None:
                raise KeyError(f"unknown host rank {host}")
            if not 0 <= device < hinfo.n_devices:
                raise ValueError(
                    f"host {host} has {hinfo.n_devices} devices, "
                    f"no device {device}")
            ent = Placement(host, device, hinfo.epoch)
            self._entries[key] = ent
            return ent

    def release(self, key) -> None:
        """Forget a key entirely — primary AND every replica. For dropping
        a single slot of a replicated key, use :meth:`remove_replica`."""
        with self._lock:
            self._entries.pop(key, None)
            self._replica_entries.pop(key, None)

    # -------------------------------------------------------------- versions
    def record_version(self, graph_id: str, key, version: int) -> bool:
        """Record that ``graph_id`` is now served by plan ``key`` at
        ``version``. A NEWER version invalidates the superseded key — its
        primary placement and every replica drop, so a forwarded request
        can never resolve to a host still holding the retired epoch (it
        re-places the new key instead). A stale or duplicate publish
        (``version <=`` the recorded one) is ignored, which makes
        concurrent/out-of-order announcements from several hosts converge:
        the call is a pure function of ``(graph_id, key, version)`` against
        the monotone version chain. Returns True when the record advanced.
        """
        with self._lock:
            cur = self._versions.get(graph_id)
            if cur is not None:
                cur_key, cur_ver = cur
                if version <= cur_ver:
                    return False
                if cur_key != key:
                    dropped = int(self._entries.pop(cur_key, None)
                                  is not None)
                    dropped += len(self._replica_entries.pop(cur_key, ()))
                    self.version_invalidations += dropped
            self._versions[graph_id] = (key, int(version))
            return True

    def current_version(self, graph_id: str) -> Optional[Tuple[object, int]]:
        """The recorded ``(plan key, version)`` of ``graph_id`` (None if
        the graph was never versioned through this directory)."""
        with self._lock:
            return self._versions.get(graph_id)

    # -------------------------------------------------------------- replicas
    def replicas(self, key) -> List[Placement]:
        """The live replica set of ``key``, primary first.

        Resolves (placing if unseen, promoting if the primary went stale)
        like :meth:`place`, and lazily scrubs stale extras — the returned
        list always has >= 1 element and element 0 is the primary.
        """
        with self._lock:
            primary = self._resolve_primary_locked(key)
            return [primary] + self._scrub_replicas_locked(key)

    def add_replica(self, key, host: int, device: int) -> Placement:
        """Record that ``key``'s plan is (being) staged on ``(host, device)``
        too. Epoch-stamped with the host's CURRENT epoch, like a primary
        placement. Idempotent: re-adding a live replica (or the primary's
        own slot) returns the existing placement. Raises on unknown hosts
        or out-of-range devices.
        """
        with self._lock:
            hinfo = self._hosts.get(host)
            if hinfo is None:
                raise KeyError(f"unknown host rank {host}")
            if not 0 <= device < hinfo.n_devices:
                raise ValueError(
                    f"host {host} has {hinfo.n_devices} devices, "
                    f"no device {device}")
            primary = self._resolve_primary_locked(key)
            if (primary.host, primary.device) == (host, device):
                return primary
            live = self._scrub_replicas_locked(key)
            for e in live:
                if (e.host, e.device) == (host, device):
                    return e
            ent = Placement(host, device, hinfo.epoch)
            self._replica_entries.setdefault(key, []).append(ent)
            self.replicas_added += 1
            return ent

    def remove_replica(self, key, host: int, device: int) -> bool:
        """Drop ONE replica of ``key``. Removing an extra replica leaves the
        primary and the other replicas untouched; removing the primary's
        slot promotes the first surviving replica (the key is only
        forgotten when its last replica goes). Returns True if a replica
        was actually removed.
        """
        with self._lock:
            primary = self._entries.get(key)
            if primary is not None and (primary.host,
                                        primary.device) == (host, device):
                del self._entries[key]
                self.replicas_removed += 1
                self._promote_locked(key)
                return True
            lst = self._replica_entries.get(key)
            if not lst:
                return False
            keep = [e for e in lst if (e.host, e.device) != (host, device)]
            if len(keep) == len(lst):
                return False
            if keep:
                self._replica_entries[key] = keep
            else:
                del self._replica_entries[key]
            self.replicas_removed += 1
            return True

    # --------------------------------------------------------------- liveness
    def update_host(self, host: HostInfo) -> int:
        """(Re-)announce a host. A newer epoch invalidates every entry the
        host owned under older epochs — a restarted process lost its plan
        cache, so stale placements must not keep forwarding traffic to
        plans that no longer exist. Returns the number invalidated.
        A brand-new rank joins the ring (its arcs move ~1/slots of keys).

        A changed DEVICE COUNT at the same epoch (the default directory
        guessed a homogeneous fleet; the handshake learned the truth)
        also invalidates the host's entries that point past the corrected
        slot table — a placement on a device that does not exist must
        re-place, and dangling entries would silently fall out of the
        load accounting otherwise.
        """
        with self._lock:
            prev = self._hosts.get(host.process_index)
            self._hosts[host.process_index] = host
            if prev is None or prev.n_devices != host.n_devices:
                self._rebuild_ring_locked()
            if prev is not None and prev.epoch != host.epoch:
                stale = [k for k, e in self._entries.items()
                         if e.host == host.process_index
                         and e.epoch != host.epoch]
            elif prev is not None and prev.n_devices != host.n_devices:
                stale = [k for k, e in self._entries.items()
                         if e.host == host.process_index
                         and e.device >= host.n_devices]
            else:
                stale = []
            for k in stale:
                del self._entries[k]
                # a surviving replica (on another host, or stamped with the
                # new epoch) takes over instead of the key being forgotten
                self._promote_locked(k)
            self.epoch_invalidations += len(stale)
            for k in list(self._replica_entries):
                self._scrub_replicas_locked(k)
            return len(stale)

    def evict_host(self, process_index: int) -> int:
        """Remove a host from the ring (crashed / drained): its entries drop
        and its keys re-place onto the survivors on next lookup. Returns
        the number of entries dropped. Evicting the last host raises.
        """
        with self._lock:
            if process_index not in self._hosts:
                return 0
            if len(self._hosts) == 1:
                raise ValueError("cannot evict the last live host")
            del self._hosts[process_index]
            self._rebuild_ring_locked()
            dead = [k for k, e in self._entries.items()
                    if e.host == process_index]
            dropped = 0
            for k in dead:
                del self._entries[k]
                # evicting one replica (the primary's host) must not drop
                # the plan's other replicas: promote a survivor if any
                if self._promote_locked(k) is None:
                    dropped += 1
            self.evicted_placements += dropped
            for k in list(self._replica_entries):
                self._scrub_replicas_locked(k)
            return dropped

    # ------------------------------------------------------------------ stats
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def host_placement_counts(self) -> Dict[int, int]:
        """Live placements per host rank (0 for hosts with none)."""
        with self._lock:
            counts = {p: 0 for p in self._hosts}
            for ent in self._entries.values():
                if ent.host in counts:
                    counts[ent.host] += 1
            return counts

    def stats(self) -> Dict[str, object]:
        with self._lock:
            per_host = {p: 0 for p in self._hosts}
            for ent in self._entries.values():
                per_host[ent.host] = per_host.get(ent.host, 0) + 1
            return {
                "hosts": len(self._hosts),
                "slots": len(self._slots),
                "placements": len(self._entries),
                "host_placements": [per_host[p] for p in sorted(per_host)],
                "placement_overrides": self.placement_overrides,
                "epoch_invalidations": self.epoch_invalidations,
                "evicted_placements": self.evicted_placements,
                "replicated_keys": sum(
                    1 for lst in self._replica_entries.values() if lst),
                "replica_entries": sum(
                    len(lst) for lst in self._replica_entries.values()),
                "replicas_added": self.replicas_added,
                "replicas_removed": self.replicas_removed,
                "replica_promotions": self.replica_promotions,
                "replica_invalidations": self.replica_invalidations,
                "versioned_graphs": len(self._versions),
                "version_invalidations": self.version_invalidations,
            }
