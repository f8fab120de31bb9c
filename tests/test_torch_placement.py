"""The port's plan placement (``distributed/placement.py``) and the fleet-only
``PlanCache`` methods, host side, bit for bit against the reference.

* ``ConsistentHashRing.lookup`` over 1,000 keys, with and without labels;
* ``FleetPlanCache`` placements, load-aware overrides, pruning under churn,
  replica lists and the ``stats()`` counts, the reference's cache and the
  port's driven through the same calls. The reference cache runs in this
  process over ``[jax.devices()[0]] * 8``: it only lists its devices, so
  eight entries of one CPU device place like eight devices. The port's
  runs over ``["cpu"] * 8`` slots.
* ``device_bytes`` and ``shard_bytes`` are left out of the stats
  comparison: a port plan also holds its COO tensors as int64, and a
  replica on a slot of the primary's own device aliases the primary's
  tensors, so the byte counts differ by design; every count is compared.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.graph import gcn_normalize
from repro.core.plan_cache import PartitionConfig as RefConfig
from repro.core.plan_cache import PlanCache as RefPlanCache
from repro.core.plan_cache import build_partition_plan as ref_build
from repro.data.graphs import make_power_law_graph
from repro.distributed.placement import ConsistentHashRing as RefRing
from repro.distributed.placement import FleetPlanCache as RefFleetCache
from repro_torch.core.graph import CSRGraph
from repro_torch.core.plan_cache import PartitionConfig, PlanCache
from repro_torch.core.plan_cache import build_partition_plan
from repro_torch.distributed import ConsistentHashRing, FleetPlanCache

from conftest import make_powerlaw_csr

_BYTES = ("device_bytes", "shard_bytes")


def _port(g):
    return CSRGraph(g.rowptr, g.colidx, g.values, g.n_cols)


def _pair(n_slots, **kw):
    ref = RefFleetCache([jax.devices()[0]] * n_slots, **kw)
    port = FleetPlanCache(["cpu"] * n_slots, **kw)
    return ref, port


def _counts(stats):
    return {k: v for k, v in stats.items() if k not in _BYTES}


def _same_state(ref, port):
    assert port._placements == ref._placements
    assert port._replicas == ref._replicas
    assert _counts(port.stats()) == _counts(ref.stats())
    assert [sorted(s.keys(), key=repr) for s in port.shards] == \
        [sorted(s.keys(), key=repr) for s in ref.shards]


# ------------------------------------------------------------------ ring
@pytest.mark.parametrize("members,labels", [
    (range(8), None),
    (range(3), None),
    ([0, 2, 5], ["hostA:0", "hostA:2", "hostB:0"]),
    (range(4), ["a", "b", "c", "d"]),
])
def test_hash_ring_lookup_matches_reference(members, labels):
    ref = RefRing(members, vnodes=64, labels=labels)
    port = ConsistentHashRing(members, vnodes=64, labels=labels)
    keys = [f"graph-{i}" for i in range(1000)]
    assert [port.lookup(k) for k in keys] == [ref.lookup(k) for k in keys]
    assert port._points == ref._points


def test_hash_ring_rejects_what_the_reference_rejects():
    for args in (([],), ([0, 1], 64, ["only-one"])):
        with pytest.raises(ValueError):
            RefRing(*args)
        with pytest.raises(ValueError):
            ConsistentHashRing(*args)


# ------------------------------------------------------------- placement
def test_placements_and_stats_match_reference():
    ref, port = _pair(8, capacity_per_device=8)
    rcfg, pcfg = RefConfig(), PartitionConfig()
    for i in range(12):
        g = gcn_normalize(make_powerlaw_csr(n=80 + 17 * i, seed=i))
        rp = ref.get_or_build(g, rcfg)
        pp = port.get_or_build(_port(g), pcfg)
        assert pp.key[0] == rp.key[0]
        assert port.device_index_of(pp.key) == ref.device_index_of(rp.key)
        # resident on exactly its owning shard, staged on its slot's device
        owner = port.device_index_of(pp.key)
        assert [pp.key in s for s in port.shards] == \
            [m == owner for m in range(8)]
        assert pp.device == port.devices[owner]
    # second pass: every lookup is a hit on both
    for i in range(12):
        g = gcn_normalize(make_powerlaw_csr(n=80 + 17 * i, seed=i))
        ref.get_or_build(g, rcfg)
        port.get_or_build(_port(g), pcfg)
    st = port.stats()
    assert st["builds"] == 12 and st["hits"] == 12 and st["devices"] == 8
    assert sorted(_counts(st)) == sorted(_counts(ref.stats()))
    assert {k: port._placements[(k[0], pcfg)]
            for k in ref._placements} == \
        {k: v for k, v in ref._placements.items()}
    assert st["shard_sizes"] == ref.stats()["shard_sizes"]


def _stuffed(cache, cfg, build, conv, target):
    for i in range(cache.load_spread + 2):
        g = gcn_normalize(make_powerlaw_csr(n=60 + 13 * i, seed=100 + i))
        plan = build(conv(g), cfg)
        plan.key = (f"forced-{i}", cfg)
        cache._placements[plan.key] = target
        cache.shards[target].put(plan)


def test_load_aware_override_matches_reference():
    ref, port = _pair(2, capacity_per_device=64, load_spread=2)
    _stuffed(ref, RefConfig(), ref_build, lambda g: g, 0)
    _stuffed(port, PartitionConfig(),
             lambda g, c: build_partition_plan(g, c, device="cpu"), _port, 0)
    got = [port.device_index_of((f"probe-{i}", PartitionConfig()))
           for i in range(40)]
    want = [ref.device_index_of((f"probe-{i}", RefConfig()))
            for i in range(40)]
    assert got == want
    assert port.placement_overrides == ref.placement_overrides > 0


def test_placements_bounded_under_churn_as_the_reference():
    ref, port = _pair(2, capacity_per_device=2)
    cap = 2 * port.capacity_per_device * len(port.shards)
    for i in range(6 * cap):
        g = gcn_normalize(make_powerlaw_csr(n=40 + i, seed=300 + i))
        ref.get_or_build(g, RefConfig())
        port.get_or_build(_port(g), PartitionConfig())
        assert len(port._placements) <= cap + 1
        assert sorted(v for v in port._placements.values()) == \
            sorted(v for v in ref._placements.values())
    assert {k[0]: v for k, v in port._placements.items()} == \
        {k[0]: v for k, v in ref._placements.items()}
    assert _counts(port.stats()) == _counts(ref.stats())
    for key in port.keys():
        assert key in port._placements


# --------------------------------------------------------------- replicas
def _one_plan(ref, port, seed):
    g = gcn_normalize(make_powerlaw_csr(n=90, seed=seed))
    rp = ref.get_or_build(g, RefConfig())
    pp = port.get_or_build(_port(g), PartitionConfig())
    return rp, pp


def test_add_drop_replica_matches_reference():
    ref, port = _pair(4, capacity_per_device=8)
    rp, pp = _one_plan(ref, port, 5)
    primary = port.device_index_of(pp.key)
    assert primary == ref.device_index_of(rp.key)
    others = [m for m in range(4) if m != primary]
    for m in others[:2] + others[:1]:          # idempotent re-add
        assert port.add_replica(pp.key, m) is ref.add_replica(rp.key, m) \
            is True
    assert port.replica_devices(pp.key) == ref.replica_devices(rp.key) \
        == [primary] + others[:2]
    copy = port.plan_on(pp.key, others[0])
    assert copy is not None and copy is not pp
    # a slot of the primary's own device: the copy aliases the tensors
    assert copy.slabs["colidx"].data_ptr() == pp.slabs["colidx"].data_ptr()
    # the primary can never be dropped through the replica API
    assert port.drop_replica(pp.key, primary) is \
        ref.drop_replica(rp.key, primary) is False
    assert port.drop_replica(pp.key, others[0]) is \
        ref.drop_replica(rp.key, others[0]) is True
    assert port.replica_devices(pp.key) == ref.replica_devices(rp.key)
    assert port.plan_on(pp.key, others[0]) is None
    # a replica copy evicted by its shard drops out lazily on both
    assert port.shards[others[1]].remove(pp.key)
    assert ref.shards[others[1]].remove(rp.key)
    assert port.replica_devices(pp.key) == ref.replica_devices(rp.key) \
        == [primary]
    ghost_r, ghost_p = ("ghost", RefConfig()), ("ghost", PartitionConfig())
    assert port.add_replica(ghost_p, others[0]) is \
        ref.add_replica(ghost_r, others[0]) is False
    with pytest.raises(ValueError):
        port.add_replica(pp.key, 4)
    _same_state_keys(ref, port)


def _same_state_keys(ref, port):
    assert _counts(port.stats()) == _counts(ref.stats())
    assert {k[0]: v for k, v in port._replicas.items()} == \
        {k[0]: v for k, v in ref._replicas.items()}


def test_prune_is_replica_aware_as_the_reference():
    ref, port = _pair(2, capacity_per_device=2)
    rp, pp = _one_plan(ref, port, 6)
    primary = port.device_index_of(pp.key)
    other = 1 - primary
    assert port.add_replica(pp.key, other) and ref.add_replica(rp.key, other)
    assert port.shards[primary].remove(pp.key)
    assert ref.shards[primary].remove(rp.key)
    for i in range(8 * 2 * port.capacity_per_device * len(port.shards)):
        port.device_index_of((f"churn-{i}", PartitionConfig()))
        ref.device_index_of((f"churn-{i}", RefConfig()))
    assert pp.key in port._placements
    assert port.replica_devices(pp.key) == ref.replica_devices(rp.key)
    assert port.plan_on(pp.key, other) is not None
    _same_state_keys(ref, port)
    assert len(port._placements) == len(ref._placements)


def test_pin_retire_publish_bookkeeping_matches_reference():
    ref, port = _pair(4, capacity_per_device=8)
    rp, pp = _one_plan(ref, port, 7)
    primary = port.device_index_of(pp.key)
    extra = (primary + 1) % 4
    assert port.add_replica(pp.key, extra) and ref.add_replica(rp.key, extra)
    # a directory-dictated placement is sticky and exempt from pruning
    assert port.pin(("pinned", PartitionConfig()), 3) == \
        ref.pin(("pinned", RefConfig()), 3) == 3
    assert port.pin(pp.key, 3) == ref.pin(rp.key, 3) == primary
    with pytest.raises(ValueError):
        port.pin(pp.key, 4)
    # version pins route to the serving shard; publish moves the key
    assert port.pin_version(pp.key) == ref.pin_version(rp.key) == 1
    g2 = gcn_normalize(make_powerlaw_csr(n=91, seed=7))
    rp2 = ref_build(g2, RefConfig())
    pp2 = build_partition_plan(_port(g2), PartitionConfig(), device="cpu")
    ref.publish(rp2, retire_key=rp.key)
    port.publish(pp2, retire_key=pp.key)
    assert port.device_index_of(pp2.key) == primary
    assert port.replica_devices(pp2.key) == ref.replica_devices(rp2.key) \
        == [primary, extra]
    assert port.plan_on(pp2.key, extra) is not None
    assert port.lookup(pp.key) is None and ref.lookup(rp.key) is None
    # the old version is parked on the shard its reader pinned it on
    assert port.stats()["retired_live"] == ref.stats()["retired_live"] == 1
    assert port.unpin_version(pp.key) == ref.unpin_version(rp.key) == 0
    assert port.unpin_version(pp.key) == 0
    assert port.retire(pp2.key) is ref.retire(rp2.key) is True
    _same_state_keys(ref, port)
    port.clear()
    ref.clear()
    assert len(port) == len(ref) == 0
    assert _counts(port.stats()) == _counts(ref.stats())


def test_lookup_does_not_place_and_unknown_keys_are_empty():
    ref, port = _pair(3)
    for cache, cfg in ((ref, RefConfig()), (port, PartitionConfig())):
        assert cache.lookup(("nope", cfg)) is None
        assert cache.replica_devices(("nope", cfg)) == []
        assert cache.pin_version(("nope", cfg)) == 0
        assert cache.stats()["placements"] == 0


# ---------------------------------------------- PlanCache fleet-only methods
def test_plan_cache_fleet_methods_match_reference():
    ref, port = RefPlanCache(2), PlanCache(2, device="cpu")
    plans = []
    for i in range(3):
        g = gcn_normalize(make_power_law_graph(100 + 10 * i, 500, seed=i))
        plans.append((ref_build(g, RefConfig()),
                      build_partition_plan(_port(g), PartitionConfig(),
                                           device="cpu")))
    for rp, pp in plans:
        ref.put(rp)
        port.put(pp)
    assert [k[0] for k in port.keys()] == [k[0] for k in ref.keys()]
    (r0, p0), (r1, p1), (r2, p2) = plans
    assert port.lookup(p0.key) is None and ref.lookup(r0.key) is None
    assert port.lookup(p1.key) is p1 and ref.lookup(r1.key) is r1
    # lookup refreshed LRU order on both: the next put evicts key 2
    ref.put(r0)
    port.put(p0)
    assert [k[0] for k in port.keys()] == [k[0] for k in ref.keys()] \
        == [r1.key[0], r0.key[0]]
    assert port.remove(p1.key) is ref.remove(r1.key) is True
    assert port.remove(p1.key) is ref.remove(r1.key) is False
    assert port.pin_version(p0.key) == ref.pin_version(r0.key) == 1
    assert port.unpin_version(p0.key) == ref.unpin_version(r0.key) == 0
    port.clear()
    ref.clear()
    pst, rst = port.stats(), ref.stats()
    for k in ("size", "lookups", "hits", "misses", "builds", "evictions",
              "pins"):
        assert pst[k] == rst[k], k
    assert pst["evictions"] == 2 and pst["size"] == 0


def test_fleet_cache_defaults_to_every_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetPlanCache()
