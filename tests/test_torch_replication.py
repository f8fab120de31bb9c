"""The port's hot-plan replication (``distributed/replication.py``) against
the reference, decision for decision, under one fake clock.

* ``EwmaRate.keys``/``prune`` read the same keys and forget the same ones;
* ``ReplicaManager`` takes the same promotions and demotions, in the same
  order, through the same callbacks (a scripted placement table), and its
  ``stats()`` agree;
* wired to each package's ``FleetPlanCache`` (the reference's over one CPU
  device listed 8 times, the port's over 8 CPU slots), the same traffic
  leaves the same replica lists.
"""
import jax
import numpy as np
import pytest

from repro.core.graph import gcn_normalize
from repro.core.plan_cache import PartitionConfig as RefConfig
from repro.distributed.placement import FleetPlanCache as RefFleetCache
from repro.distributed.replication import EwmaRate as RefRate
from repro.distributed.replication import ReplicaManager as RefManager
from repro_torch.core.graph import CSRGraph
from repro_torch.core.plan_cache import PartitionConfig
from repro_torch.distributed import EwmaRate, FleetPlanCache, ReplicaManager

from conftest import make_powerlaw_csr


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class Table:
    """A placement table the manager drives through its callbacks; every
    call is logged, so two managers can be compared call for call."""

    def __init__(self, n_dev, placed):
        self.n_dev = n_dev
        self.held = {k: [d] for k, d in placed.items()}
        self.log = []

    def replicas(self, key):
        self.log.append(("list", key))
        return list(self.held.get(key, []))

    def add(self, key, dev):
        ok = dev not in self.held[key] and dev != 5   # slot 5 refuses
        self.log.append(("add", key, dev, ok))
        if ok:
            self.held[key].append(dev)
        return ok

    def drop(self, key, dev):
        self.log.append(("drop", key, dev))
        self.held[key].remove(dev)
        return True

    def loads(self):
        load = [0.0] * self.n_dev
        for devs in self.held.values():
            for d in devs:
                load[d] += 1.0 + 0.01 * d
        return load


def _managers(clock, **kw):
    placed = {"hot": 0, "warm": 3, "cold": 1}
    tables = (Table(8, placed), Table(8, placed))
    out = []
    for cls, t in zip((RefManager, ReplicaManager), tables):
        out.append(cls(replicas_fn=t.replicas, add_fn=t.add,
                       drop_fn=t.drop, device_load_fn=t.loads,
                       now_fn=clock, **kw))
    return out, tables


def test_ewma_keys_and_prune_match_reference():
    clock = FakeClock()
    ref, port = RefRate(2.0, now_fn=clock), EwmaRate(2.0, now_fn=clock)
    for i, (key, n) in enumerate([("a", 3), ("b", 1), ("a", 2), ("c", 7),
                                  ("b", 4)]):
        clock.t += 0.3 * i
        ref.observe(key, n)
        port.observe(key, n)
    assert port.keys() == ref.keys() == ["a", "b", "c"]
    clock.t += 19.0
    port.observe("c")
    ref.observe("c")
    assert port.prune(0.05) == ref.prune(0.05)
    assert port.keys() == ref.keys()
    assert [port.rate(k) for k in "abc"] == [ref.rate(k) for k in "abc"]


def test_replica_manager_decisions_match_reference():
    clock = FakeClock()
    (ref, port), (t_ref, t_port) = _managers(
        clock, rate_per_replica=2.0, max_replicas=4, halflife_s=1.0,
        interval_s=0.25)
    script = ([("hot", 6), ("warm", 2)] * 4 + [("cold", 1)]
              + [("hot", 1)] * 3 + [("warm", 5)] * 2)
    steps = []
    for i, (key, n) in enumerate(script):
        clock.t += 0.1
        ref.observe(key, n)
        port.observe(key, n)
        steps.append((ref.maybe_step(), port.maybe_step()))
    # the rates fade: replicas demote, newest extras first, never a primary
    for _ in range(12):
        clock.t += 0.7
        steps.append((ref.step(), port.step()))
    assert all(a == b for a, b in steps)
    assert t_port.log == t_ref.log
    assert t_port.held == t_ref.held
    assert port.stats() == ref.stats()
    st = port.stats()
    assert st["promotions"] >= 3 and st["demotions"] >= 3
    assert all(len(devs) >= 1 for devs in t_port.held.values())
    assert t_port.held["hot"][0] == 0          # the primary stayed


def test_replica_manager_target_and_validation_match_reference():
    clock = FakeClock()
    (ref, port), _ = _managers(clock, rate_per_replica=3.0, max_replicas=3)
    for n in (1, 5, 20, 200):
        clock.t += 0.05
        ref.observe("hot", n)
        port.observe("hot", n)
        assert port.target_replicas("hot") == ref.target_replicas("hot")
    assert port.target_replicas("never") == ref.target_replicas("never") == 1
    for bad in ({"rate_per_replica": 0}, {"max_replicas": 0}):
        for cls in (RefManager, ReplicaManager):
            with pytest.raises(ValueError):
                cls(replicas_fn=list, add_fn=max, drop_fn=max,
                    device_load_fn=list, **bad)


def test_replica_manager_on_the_fleet_caches_matches_reference():
    """Both packages' FleetPlanCache under one clock: the same hot key
    promotes onto the same slots and demotes the same way."""
    clock = FakeClock()
    caches = (RefFleetCache([jax.devices()[0]] * 8, capacity_per_device=8),
              FleetPlanCache(["cpu"] * 8, capacity_per_device=8))
    cfgs = (RefConfig(), PartitionConfig())
    keys = ([], [])
    for i in range(5):
        g = gcn_normalize(make_powerlaw_csr(n=70 + 11 * i, seed=40 + i))
        for j, (cache, cfg) in enumerate(zip(caches, cfgs)):
            gg = g if j == 0 else CSRGraph(g.rowptr, g.colidx, g.values,
                                           g.n_cols)
            keys[j].append(cache.get_or_build(gg, cfg).key)
    loads = [0.0] * 8
    mgrs = [cls(replicas_fn=c.replica_devices, add_fn=c.add_replica,
                drop_fn=c.drop_replica, device_load_fn=lambda: loads,
                rate_per_replica=1.0, max_replicas=4, halflife_s=2.0,
                interval_s=0.0, now_fn=clock)
            for cls, c in zip((RefManager, ReplicaManager), caches)]
    rng = np.random.default_rng(0)
    for _ in range(40):
        clock.t += 0.05
        i = int(rng.zipf(1.6)) % 5
        for m, ks in zip(mgrs, keys):
            m.observe(ks[i])
            m.maybe_step()
    lists = [[c.replica_devices(k) for k in ks]
             for c, ks in zip(caches, keys)]
    assert lists[1] == lists[0]
    assert mgrs[1].stats() == mgrs[0].stats()
    assert mgrs[1].stats()["promotions"] >= 1
    clock.t += 60.0
    for m in mgrs:
        m.step()
    lists = [[c.replica_devices(k) for k in ks]
             for c, ks in zip(caches, keys)]
    assert lists[1] == lists[0]
    assert mgrs[1].stats() == mgrs[0].stats()
    assert all(len(caches[1].replica_devices(k)) == 1 for k in keys[1])
