"""The port's ``PlacementDirectory`` (``distributed/directory.py``) against
the reference's.

Every case of the reference's ``tests/test_directory.py`` runs on both
packages' directories (parametrized by package), and one seeded random
sequence of ``place``, ``place_at``, replica, epoch, device-count,
eviction, version and release operations runs on both side by side over
3 hosts x 4 devices: after every step ``lookup``, ``replicas``,
``current_version``, ``host_placement_counts`` and ``stats()`` must agree
field for field, and every operation must return the same value or raise
the same exception type. Placement is what "deterministic across
processes" rests on, so it must be identical, not merely similar.
"""
import importlib

import numpy as np
import pytest

PACKAGES = ("repro", "repro_torch")


@pytest.fixture(params=PACKAGES)
def pkg(request):
    mod = importlib.import_module(f"{request.param}.distributed.directory")
    cfg = importlib.import_module(
        f"{request.param}.core.plan_cache").PartitionConfig
    return mod, cfg


def _hosts(mod, n=2, devs=4, epochs=None):
    epochs = epochs or [0] * n
    return [mod.HostInfo(p, devs, epochs[p]) for p in range(n)]


def _keys(cfg_cls, n):
    cfg = cfg_cls()
    return [(f"graph-{i:04d}", cfg) for i in range(n)]


def test_placement_deterministic_across_processes(pkg):
    mod, cfg = pkg
    a = mod.PlacementDirectory(_hosts(mod), load_spread=10_000)
    b = mod.PlacementDirectory(_hosts(mod), load_spread=10_000)
    keys = _keys(cfg, 300)
    pa = [a.place(k) for k in keys]
    pb = {k: b.place(k) for k in reversed(keys)}
    for k, p in zip(keys, pa):
        assert pb[k] == p
    assert [a.place(k) for k in keys] == pa


def test_placements_spread_over_hosts_and_devices(pkg):
    mod, cfg = pkg
    d = mod.PlacementDirectory(_hosts(mod, n=2, devs=4))
    pls = [d.place(k) for k in _keys(cfg, 200)]
    assert {p.host for p in pls} == {0, 1}
    assert {(p.host, p.device) for p in pls} == set(d.slots())
    st = d.stats()
    assert st["hosts"] == 2 and st["slots"] == 8
    assert all(c >= 1 for c in st["host_placements"])
    counts = d.host_placement_counts()
    assert counts[0] + counts[1] == 200


def test_epoch_invalidation_on_host_restart(pkg):
    mod, cfg = pkg
    d = mod.PlacementDirectory(_hosts(mod, n=2, devs=2), load_spread=10_000)
    keys = _keys(cfg, 80)
    before = {k: d.place(k) for k in keys}
    owned_by_1 = [k for k, p in before.items() if p.host == 1]
    assert owned_by_1, "need at least one key on host 1"
    n_inv = d.update_host(mod.HostInfo(1, 2, epoch=7))
    assert n_inv == len(owned_by_1)
    assert d.epoch_invalidations == len(owned_by_1)
    for k in owned_by_1:
        assert d.lookup(k) is None
        again = d.place(k)
        assert again.host == before[k].host
        assert again.device == before[k].device
        assert again.epoch == 7
    for k, p in before.items():
        if p.host == 0:
            assert d.lookup(k) == p
    assert d.update_host(mod.HostInfo(1, 2, epoch=7)) == 0


def test_device_count_correction_invalidates_dangling_slots(pkg):
    mod, cfg = pkg
    d = mod.PlacementDirectory(_hosts(mod, n=2, devs=4), load_spread=10_000)
    keys = _keys(cfg, 120)
    before = {k: d.place(k) for k in keys}
    dangling = [k for k, p in before.items() if p.host == 1 and p.device >= 2]
    surviving = {k: p for k, p in before.items()
                 if not (p.host == 1 and p.device >= 2)}
    assert dangling, "need placements on host 1 devices 2..3"
    n_inv = d.update_host(mod.HostInfo(1, 2, epoch=0))
    assert n_inv == len(dangling)
    for k in dangling:
        assert d.lookup(k) is None
        p = d.place(k)
        assert (p.host, p.device) in d.slots()
    for k, p in surviving.items():
        assert d.lookup(k) == p
    counts = d._slot_counts_locked()
    assert sum(counts) == len(d._entries)


def test_stale_host_eviction_moves_only_its_keys(pkg):
    mod, cfg = pkg
    d = mod.PlacementDirectory(_hosts(mod, n=3, devs=2), load_spread=10_000)
    keys = _keys(cfg, 120)
    before = {k: d.place(k) for k in keys}
    dead = [k for k, p in before.items() if p.host == 2]
    survivors = {k: p for k, p in before.items() if p.host != 2}
    assert dead and survivors
    dropped = d.evict_host(2)
    assert dropped == len(dead)
    assert d.evicted_placements == len(dead)
    for k in dead:
        p = d.place(k)
        assert p.host in (0, 1)
    for k, p in survivors.items():
        assert d.place(k) == p
    assert d.evict_host(9) == 0
    d.evict_host(1)
    with pytest.raises(ValueError):
        d.evict_host(0)


def test_load_aware_override_mirrors_fleet_cache(pkg):
    mod, cfg = pkg
    d = mod.PlacementDirectory(_hosts(mod, n=2, devs=1), load_spread=2)
    c = cfg()
    for i in range(10):
        d._entries[(f"forced-{i}", c)] = mod.Placement(0, 0, 0)
    for i in range(60):
        key = (f"probe-{i:03d}", c)
        p = d.place(key)
        assert d.place(key) == p
    assert d.placement_overrides > 0
    counts = d._slot_counts_locked()
    assert max(counts) - min(counts) <= d.load_spread + 1


def test_new_host_joins_ring_and_takes_share(pkg):
    mod, cfg = pkg
    d = mod.PlacementDirectory(_hosts(mod, n=2, devs=2), load_spread=10_000)
    keys = _keys(cfg, 200)
    before = {k: d.place(k) for k in keys}
    d.update_host(mod.HostInfo(2, 2, epoch=0))
    for k in keys:
        assert d.place(k) == before[k]
    d3 = mod.PlacementDirectory(_hosts(mod, n=3, devs=2), load_spread=10_000)
    moved = 0
    for k in keys:
        p = d3.place(k)
        if (p.host, p.device) != (before[k].host, before[k].device):
            moved += 1
            assert p.host == 2
    assert 0 < moved < len(keys) // 2
    fresh = [(f"fresh-{i:03d}", cfg()) for i in range(100)]
    assert any(d.place(k).host == 2 for k in fresh)


def test_directory_validation(pkg):
    mod, _ = pkg
    with pytest.raises(ValueError):
        mod.PlacementDirectory([])
    with pytest.raises(ValueError):
        mod.PlacementDirectory([mod.HostInfo(0, 2), mod.HostInfo(0, 2)])
    with pytest.raises(ValueError):
        mod.HostInfo(0, 0)
    with pytest.raises(ValueError):
        mod.HostInfo(-1, 2)


def test_replica_add_remove_listing(pkg):
    mod, cfg = pkg
    d = mod.PlacementDirectory(_hosts(mod, n=2, devs=2))
    key = _keys(cfg, 1)[0]
    prim = d.place(key)
    other = (1 - prim.host, 0)
    ent = d.add_replica(key, *other)
    assert [(p.host, p.device) for p in d.replicas(key)] == \
        [(prim.host, prim.device), other]
    assert d.add_replica(key, *other) is ent
    assert d.add_replica(key, prim.host, prim.device) == prim
    assert d.stats()["replicas_added"] == 1
    assert d.remove_replica(key, *other) is True
    assert d.remove_replica(key, *other) is False
    assert d.replicas(key) == [prim]
    with pytest.raises(KeyError):
        d.add_replica(key, 9, 0)
    with pytest.raises(ValueError):
        d.add_replica(key, 0, 5)


def test_removing_primary_slot_promotes_replica(pkg):
    mod, cfg = pkg
    d = mod.PlacementDirectory(_hosts(mod, n=2, devs=2))
    key = _keys(cfg, 1)[0]
    prim = d.place(key)
    other = (1 - prim.host, 1)
    d.add_replica(key, *other)
    assert d.remove_replica(key, prim.host, prim.device) is True
    new = d.lookup(key)
    assert (new.host, new.device) == other
    assert d.stats()["replica_promotions"] == 1
    assert d.replicas(key) == [new]


def test_epoch_bump_promotes_replica_on_other_host(pkg):
    mod, cfg = pkg
    d = mod.PlacementDirectory(_hosts(mod, n=2, devs=2))
    key = _keys(cfg, 1)[0]
    prim = d.place(key)
    other_host = 1 - prim.host
    d.add_replica(key, other_host, 0)
    assert d.update_host(mod.HostInfo(prim.host, 2, epoch=7)) == 1
    new = d.lookup(key)
    assert (new.host, new.device) == (other_host, 0)
    st = d.stats()
    assert st["replica_promotions"] == 1
    assert st["epoch_invalidations"] == 1


def test_evict_host_promotes_surviving_replicas(pkg):
    mod, cfg = pkg
    d = mod.PlacementDirectory(_hosts(mod, n=2, devs=2))
    keys = _keys(cfg, 40)
    replicated = []
    for k in keys:
        p = d.place(k)
        if p.host == 0:
            d.add_replica(k, 1, 0)
            replicated.append(k)
    assert replicated
    dropped = d.evict_host(0)
    assert dropped == 0
    for k in replicated:
        ent = d.lookup(k)
        assert ent is not None and ent.host == 1
    st = d.stats()
    assert st["replica_promotions"] == len(replicated)
    assert st["replica_entries"] == 0


# ----------------------------------------------------- side-by-side sequence
def _pl(p):
    """A placement (or list of them) as plain tuples, across packages."""
    if p is None:
        return None
    if isinstance(p, list):
        return [_pl(x) for x in p]
    return (p.host, p.device, p.epoch)


def _call(fn, *args):
    try:
        out = fn(*args)
    except (KeyError, ValueError) as e:
        return ("raised", type(e).__name__)
    if hasattr(out, "host"):
        return _pl(out)
    if isinstance(out, list):
        return _pl(out)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_sequence_matches_reference_field_for_field(seed):
    """3 hosts x 4 devices, 400 seeded operations applied to both
    packages' directories; every return value and, after every step, the
    observable state of every key must agree."""
    from repro.distributed import directory as ref
    from repro_torch.distributed import directory as port
    rng = np.random.default_rng(seed)
    n_hosts, n_devs = 3, 4
    dirs = {m: m.PlacementDirectory(
        [m.HostInfo(p, n_devs, 0) for p in range(n_hosts)], load_spread=3,
        vnodes=16) for m in (ref, port)}
    keys = [(f"g{i:03d}", "cfg") for i in range(24)]
    gids = [f"graph-{i}" for i in range(4)]
    epochs = {p: 0 for p in range(n_hosts)}
    devs = {p: n_devs for p in range(n_hosts)}
    ops = ["place", "place", "place", "place_at", "add_replica",
           "add_replica", "remove_replica", "replicas", "epoch", "devices",
           "evict", "rejoin", "version", "release", "lookup"]
    for step in range(400):
        op = ops[int(rng.integers(len(ops)))]
        key = keys[int(rng.integers(len(keys)))]
        # one draw in ten names an unknown rank / a device out of range
        host = (n_hosts if rng.random() < 0.1
                else int(rng.integers(n_hosts)))
        dev = n_devs if rng.random() < 0.1 else int(rng.integers(n_devs))
        gid = gids[int(rng.integers(len(gids)))]
        ver = int(rng.integers(4))
        if op in ("epoch", "devices", "rejoin") and host == n_hosts:
            op = "lookup"                         # HostInfo of a real rank
        n_dev = max(1, dev)
        outs = {}
        for m, d in dirs.items():
            calls = {
                "place": (d.place, key),
                "place_at": (d.place_at, key, host, dev),
                "add_replica": (d.add_replica, key, host, dev),
                "remove_replica": (d.remove_replica, key, host, dev),
                "replicas": (d.replicas, key),
                "lookup": (d.lookup, key),
                "release": (d.release, key),
                "version": (d.record_version, gid, key, ver),
                "evict": (d.evict_host, host),
            }
            if op == "epoch":
                calls[op] = (d.update_host, m.HostInfo(
                    host, devs[host], epochs[host] + 1))
            elif op == "devices":
                calls[op] = (d.update_host, m.HostInfo(
                    host, n_dev, epochs[host]))
            elif op == "rejoin":
                calls[op] = (d.update_host, m.HostInfo(
                    host, devs[host], epochs[host]))
            outs[m] = _call(*calls[op])
        if op == "epoch":
            epochs[host] += 1
        elif op == "devices":
            devs[host] = n_dev
        assert outs[ref] == outs[port], (step, op, key, host, dev)
        a, b = dirs[ref], dirs[port]
        assert a.slots() == b.slots(), step
        assert a.host_placement_counts() == b.host_placement_counts(), step
        assert a.stats() == b.stats(), step
        for k in keys:
            assert _pl(a.lookup(k)) == _pl(b.lookup(k)), (step, k)
        for g in gids:
            assert a.current_version(g) == b.current_version(g), (step, g)
        assert len(a) == len(b)
    # finally every key's live replica set (resolving, as replicas() does)
    for k in keys:
        assert _pl(dirs[ref].replicas(k)) == _pl(dirs[port].replicas(k))
