"""The port's fleet engine (``serve/fleet.py::FleetGraphEngine``) on 8 CPU
slots, against the reference.

The cases of the reference's ``tests/test_fleet.py`` (mixed traffic,
concurrent submitters, the block-sharded giant graph, validation, the
8-device and zipf scripts) run in this process over
``devices=["cpu"] * 8``:

* answers against the reference's single-device
  ``GraphServeEngine(backend="blocked")``: exact on integer-valued graphs
  and features, within ``1e-4`` (the reference tests' tolerance) on
  GCN-normalized ones;
* ``last_fleet_decision`` field for field the reference's ``route_fleet``
  on the same inputs;
* the ``fleet_*`` stats keys identical to the reference fleet's, and on
  traffic every plan serves from its owning slot the per-slot request
  counts too (the reference fleet runs over ``[jax.devices()[0]] * 8``,
  which places like 8 devices). One value differs by design: the
  reference counts a sharded dispatch as ``routed_blocked`` (its shards run
  the jnp twin), the port under the regime its slots ran
  (``routed_resident`` under ``accel``);
* a ``mutate()`` racing reads on a replicated graph: every read equals
  one published version's answer, and the new version is staged on the
  primary and every replica.
"""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import csr_from_edges, gcn_normalize
from repro.data.graphs import make_power_law_graph
from repro.distributed.shard_spmm import round_robin_block_order
from repro.kernels.router import route_fleet as ref_route_fleet
from repro.serve.fleet import FleetGraphEngine as RefFleet
from repro.serve.graph_engine import GraphRequest as RefRequest
from repro.serve.graph_engine import GraphServeEngine as RefEngine
from repro_torch.core.graph import CSRGraph
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.plan_repair import EdgeDelta
from repro_torch.examples import serve_fleet
from repro_torch.serve import FleetGraphEngine, GraphRequest

from conftest import make_powerlaw_csr

SLOTS = ["cpu"] * 8


def _port(g):
    return CSRGraph(g.rowptr, g.colidx, g.values, g.n_cols)


def _int_graph(n, e, seed):
    g = make_power_law_graph(n, e, seed=seed)
    vals = np.random.default_rng(seed).integers(1, 4, g.nnz)
    return csr_from_edges(np.repeat(np.arange(g.n_rows), np.diff(g.rowptr)),
                          g.colidx, g.n_cols, values=vals)


def _feats(n, F, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        return rng.integers(-4, 5, (n, F)).astype(np.float32)
    return rng.normal(size=(n, F)).astype(np.float32)


def _ref_answers(graphs, feats):
    single = RefEngine(backend="blocked", max_graphs_per_batch=4)
    try:
        for gid, g in graphs.items():
            single.register_graph(gid, g)
        out = single.serve([RefRequest(gid, jnp.asarray(x))
                            for gid, x in feats.items()])
        return {r.graph_id: np.asarray(r.out) for r in out}
    finally:
        single.close()


def _hold(got, want, integer):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def _fields(fd):
    return dataclasses.asdict(fd)


def _mixed(n_graphs=5, feat=16, integer=False):
    graphs, feats = {}, {}
    for i in range(n_graphs):
        g = (_int_graph(180 + 40 * i, 1200 + 90 * i, i) if integer else
             gcn_normalize(make_power_law_graph(180 + 40 * i, 1200 + 90 * i,
                                                seed=i)))
        graphs[f"g{i}"] = g
        feats[f"g{i}"] = _feats(g.n_cols, feat + 4 * i, i, integer)
    return graphs, feats


# ------------------------------------------------------------- answers
@pytest.mark.parametrize("integer", [True, False])
def test_fleet_matches_the_reference_single_engine(integer):
    graphs, feats = _mixed(integer=integer)
    want = _ref_answers(graphs, feats)
    fleet = FleetGraphEngine(devices=SLOTS, backend="accel",
                             max_graphs_per_batch=4)
    try:
        for gid, g in graphs.items():
            fleet.register_graph(gid, _port(g))
        out = fleet.serve([GraphRequest(gid, torch.from_numpy(x))
                           for gid, x in feats.items()])
        for r in out:
            _hold(r.out, want[r.graph_id], integer)
        st = fleet.stats()
        assert st["requests_served"] == len(feats)
        assert st["fleet_rounds"] >= 1
        assert sum(st["fleet_device_requests"]) == len(feats)
        assert st["slot_routed_resident"] == st["routed_resident"] \
            == st["batches_dispatched"]
    finally:
        fleet.close()


def test_fleet_stats_keys_and_placement_counts_match_the_reference_fleet():
    """Same traffic through the reference fleet (8 entries of one CPU
    device) and the port's (8 CPU slots), both ``blocked``: the fleet_*
    keys are the same set, and every request lands on the same slot."""
    graphs, feats = _mixed(n_graphs=6)
    ref = RefFleet(devices=[jax.devices()[0]] * 8, backend="blocked",
                   max_graphs_per_batch=4)
    port = FleetGraphEngine(devices=SLOTS, backend="blocked",
                            max_graphs_per_batch=4)
    try:
        for gid, g in graphs.items():
            ref.register_graph(gid, g)
            port.register_graph(gid, _port(g))
        for _ in range(2):
            for gid, x in feats.items():
                ref.serve_one(gid, jnp.asarray(x))
                port.serve_one(gid, torch.from_numpy(x))
        rs, ps = ref.stats(), port.stats()
        fleet_keys = {k for k in rs if k.startswith("fleet_")}
        assert {k for k in ps if k.startswith("fleet_")} == fleet_keys
        for k in ("fleet_devices", "fleet_rounds", "fleet_device_dispatches",
                  "fleet_device_requests", "fleet_feature_sharded",
                  "fleet_block_sharded", "fleet_block_counts",
                  "fleet_hedged", "fleet_promotions", "fleet_demotions",
                  "fleet_graphs_per_round", "routed_blocked",
                  "batches_dispatched", "cache_shard_sizes",
                  "cache_placements", "cache_builds", "cache_hits"):
            assert ps[k] == rs[k], k
        assert set(rs) - set(ps) == set()
        assert {f"slot_routed_{r}" for r in ("resident", "windowed", "hbm",
                                             "blocked")} <= set(ps) - set(rs)
    finally:
        ref.close()
        port.close()


def test_fleet_concurrent_submitters_coalesce():
    graphs, feats = _mixed(n_graphs=4, integer=True)
    want = _ref_answers(graphs, feats)
    fleet = FleetGraphEngine(devices=SLOTS, max_graphs_per_batch=4)
    outs = {}
    try:
        for gid, g in graphs.items():
            fleet.register_graph(gid, _port(g))

        def submitter(gid):
            outs[gid] = fleet.submit(gid, torch.from_numpy(feats[gid]))
        threads = [threading.Thread(target=submitter, args=(gid,))
                   for gid in feats]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for gid, fut in outs.items():
            _hold(fut.result(timeout=60), want[gid], integer=True)
            _hold(fleet.serve_one(gid, torch.from_numpy(feats[gid])),
                  want[gid], integer=True)
        st = fleet.stats()
        assert st["sched_completed"] == 2 * len(feats)
        assert st["fleet_graphs_per_round"] >= 1.0
    finally:
        fleet.close()


# --------------------------------------------------------------- sharded
@pytest.mark.parametrize("integer", [True, False])
def test_giant_graph_block_shards_over_every_slot(integer):
    big = (_int_graph(6000, 40000, 5) if integer else
           gcn_normalize(make_power_law_graph(6000, 40000, seed=5)))
    x = _feats(big.n_cols, 16, 2, integer)
    want = _ref_answers({"big": big}, {"big": x})["big"]
    fleet = FleetGraphEngine(devices=SLOTS, backend="accel")
    try:
        plan = fleet.register_graph("big", _port(big))
        assert plan.num_blocks >= fleet.n_devices
        _hold(fleet.serve_one("big", torch.from_numpy(x)), want, integer)
        st = fleet.stats()
        fd = ref_route_fleet(big.n_cols, 16, int(plan.slabs["C"]),
                             int(plan.slabs["R"]), plan.num_blocks, 8)
        assert fd.strategy == "block"
        assert _fields(fleet.last_fleet_decision) == _fields(fd)
        assert st["fleet_block_sharded"] == 1
        counts = st["fleet_block_counts"]
        _, live = round_robin_block_order(plan.num_blocks, 8)
        assert counts == [int(c) for c in live]
        assert sum(counts) == plan.num_blocks
        assert max(counts) - min(counts) <= 1
        assert st["fleet_block_balance"] <= 1.10
        # the one documented difference: the slots ran K1 (its plain
        # version here), counted as resident; the reference says blocked
        assert st["routed_resident"] == 1 and st["routed_blocked"] == 0
        assert st["slot_routed_resident"] == 8
        assert (st["routed_resident"] + st["routed_windowed"]
                + st["routed_hbm"] + st["routed_blocked"]
                == st["batches_dispatched"])
    finally:
        fleet.close()


@pytest.mark.parametrize("backend,regime", [("accel", "resident"),
                                            ("auto", "resident"),
                                            ("blocked", "blocked"),
                                            ("hbm", "hbm")])
def test_wide_dispatch_feature_shards(backend, regime):
    g = _int_graph(500, 3000, 9)
    x = _feats(g.n_cols, 8 * 128, 3, integer=True)
    want = _ref_answers({"w": g}, {"w": x})["w"]
    fleet = FleetGraphEngine(devices=SLOTS, backend=backend)
    try:
        plan = fleet.register_graph("w", _port(g))
        _hold(fleet.serve_one("w", torch.from_numpy(x)), want, True)
        fd = ref_route_fleet(g.n_cols, 8 * 128, int(plan.slabs["C"]),
                             int(plan.slabs["R"]), plan.num_blocks, 8)
        assert fd.strategy == "feature" and fd.per_device.f_pad == 128
        assert _fields(fleet.last_fleet_decision) == _fields(fd)
        st = fleet.stats()
        assert st["fleet_feature_sharded"] == 1
        assert st[f"routed_{regime}"] == 1
        assert st[f"slot_routed_{regime}"] == 8
    finally:
        fleet.close()


def test_eight_slot_script_in_process():
    """The reference's 8-device subprocess script, in this process."""
    rng = np.random.default_rng(0)
    graphs, feats = {}, {}
    for i in range(4):
        g = gcn_normalize(make_power_law_graph(150 + 30 * i, 900 + 80 * i,
                                               seed=i))
        graphs[f"g{i}"] = g
        feats[f"g{i}"] = rng.normal(size=(g.n_cols, 12)).astype(np.float32)
    big = gcn_normalize(make_power_law_graph(6000, 30000, seed=9))
    xb = rng.normal(size=(big.n_cols, 16)).astype(np.float32)
    want = _ref_answers(dict(graphs, big=big), dict(feats, big=xb))
    fleet = FleetGraphEngine(devices=SLOTS, backend="blocked",
                             max_graphs_per_batch=4)
    try:
        for gid, g in graphs.items():
            fleet.register_graph(gid, _port(g))
        for r in fleet.serve([GraphRequest(gid, torch.from_numpy(x))
                              for gid, x in feats.items()]):
            _hold(r.out, want[r.graph_id], False)
        plan = fleet.register_graph("big", _port(big))
        _hold(fleet.serve_one("big", torch.from_numpy(xb)), want["big"],
              False)
        st = fleet.stats()
        assert st["fleet_devices"] == 8 and st["fleet_block_sharded"] == 1
        assert sum(st["fleet_block_counts"]) == plan.num_blocks
        assert st["fleet_block_balance"] <= 1.10
        assert max(st["fleet_block_counts"]) - \
            min(st["fleet_block_counts"]) <= 1
    finally:
        fleet.close()


# ------------------------------------------------------------ replication
def _zipf_run(graphs, feats, schedule, **kw):
    e = FleetGraphEngine(devices=SLOTS, max_batch_requests=32,
                         max_wait_ms=3.0, max_graphs_per_batch=1,
                         backend="accel", **kw)
    for k, g in graphs.items():
        e.register_graph(k, _port(g))

    def pass_once():
        futs = [[] for _ in range(4)]

        def sub(t):
            futs[t] = [e.submit(gid, torch.from_numpy(feats[gid]))
                       for gid in schedule[t::4]]
        ths = [threading.Thread(target=sub, args=(t,)) for t in range(4)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        return [(gid, f.result(timeout=60).numpy())
                for t, fs in enumerate(futs)
                for gid, f in zip(schedule[t::4], fs)]

    try:
        pass_once()              # warm: learn rates, stage replicas
        e.reset_stats()
        outs = pass_once()       # measured: replicated steady state
        return outs, e.stats()
    finally:
        e.close()


def test_zipf_replication_spreads_hot_graphs_in_process():
    """The reference's zipf script on 8 CPU slots: the hot plan promotes,
    its traffic spreads over more slots than with replication off, and
    every answer equals the replication-off fleet's (integer graphs).
    Occupancy is a time measure and is left to the card."""
    rng = np.random.default_rng(3)
    graphs = {f"z{i}": _int_graph(220 + 40 * i, 1500 + 150 * i, 50 + i)
              for i in range(5)}
    feats = {k: _feats(g.n_cols, 16, 7, integer=True)
             for k, g in graphs.items()}
    names = list(graphs)
    p = np.arange(1, len(names) + 1, dtype=np.float64) ** -1.6
    p /= p.sum()
    schedule = [names[i] for i in rng.choice(len(names), size=96, p=p)]
    outs_rep, st_rep = _zipf_run(
        graphs, feats, schedule, rate_per_replica=1.0, max_replicas=8,
        replica_halflife_s=4.0, replication_interval_s=0.005,
        split_min_requests=1)
    outs_dis, st_dis = _zipf_run(graphs, feats, schedule,
                                 replicate_hot=False)
    want = _ref_answers(graphs, feats)
    for (ga, a), (gb, b) in zip(outs_rep, outs_dis):
        assert ga == gb
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, want[ga])
    assert st_rep["fleet_promotions"] >= 1
    assert st_rep["cache_replicated_keys"] >= 1
    assert st_rep["cache_replica_copies"] >= 1
    assert (len([r for r in st_rep["fleet_device_requests"] if r > 0])
            > len([r for r in st_dis["fleet_device_requests"] if r > 0]))
    assert sum(st_rep["fleet_device_requests"]) == len(schedule)


def test_hedged_groups_answer_right():
    """Groups on replicated plans hedge onto another replica; a hedge
    answers still-pending items with the same product, first result wins.
    The engine keeps every replica (``rate_per_replica`` 1e-6)."""
    from repro_torch.serve.scheduler import WorkItem
    graphs, feats = _mixed(n_graphs=3, integer=True)
    want = _ref_answers(graphs, feats)
    fleet = FleetGraphEngine(devices=SLOTS, hedge_ms=0.0,
                             rate_per_replica=1e-6, max_replicas=3)
    try:
        for gid, g in graphs.items():
            plan = fleet.register_graph(gid, _port(g))
            primary = fleet.cache.device_index_of(plan.key)
            for m in range(1, 3):
                assert fleet.cache.add_replica(plan.key, (primary + m) % 8)
        for _ in range(3):
            for gid, x in feats.items():
                _hold(fleet.serve_one(gid, torch.from_numpy(x)), want[gid],
                      True)
        time.sleep(0.2)                  # let the hedge timers run out
        st = fleet.stats()
        assert 0 <= st["fleet_hedge_wins"] <= st["fleet_hedged"]
        assert st["requests_served"] == 9
        assert all(len(fleet.cache.replica_devices(fleet.plan_for(g).key))
                   == 3 for g in graphs)
        # a hedge on a still-pending item answers it, once
        gid = "g1"
        key = fleet.plan_for(gid).key
        dev = fleet.cache.replica_devices(key)[2]
        x = torch.from_numpy(feats[gid])
        item = WorkItem((gid, x), fleet.scheduler)
        before = fleet.stats()
        fleet._run_hedge(dev, gid, [item], fleet.cache.plan_on(key, dev))
        _hold(item.future.result(timeout=5), want[gid], True)
        fleet._run_hedge(dev, gid, [item], fleet.cache.plan_on(key, dev))
        after = fleet.stats()
        assert after["fleet_hedged"] == before["fleet_hedged"] + 1
        assert after["fleet_hedge_wins"] == before["fleet_hedge_wins"] + 1
        assert after["requests_served"] == before["requests_served"]
    finally:
        fleet.close()


# --------------------------------------------------------------- mutation
def test_mutate_races_reads_on_a_replicated_graph():
    g0 = _int_graph(400, 2400, 11)
    x = _feats(g0.n_cols, 8, 4, integer=True)
    # the engine keeps every replica it holds (rate_per_replica 1e-6)
    fleet = FleetGraphEngine(devices=SLOTS, rate_per_replica=1e-6,
                             max_replicas=3)
    try:
        plan = fleet.register_graph("hot", _port(g0))
        primary = fleet.cache.device_index_of(plan.key)
        extras = [(primary + 3) % 8, (primary + 5) % 8]
        for m in extras:
            assert fleet.cache.add_replica(plan.key, m)
        versions = [_port(g0)]
        rng = np.random.default_rng(0)
        deltas = []
        g = g0
        for k in range(3):
            eids = rng.choice(g.nnz, 4, replace=False)
            d = dict(insert_src=rng.integers(0, g.n_rows, 4),
                     insert_dst=rng.integers(0, g.n_cols, 4),
                     insert_val=rng.integers(1, 4, 4).astype(np.float32),
                     delete_src=np.searchsorted(g.rowptr, eids,
                                                side="right") - 1,
                     delete_dst=g.colidx[eids], on_duplicate="replace",
                     on_missing="ignore")
            deltas.append(EdgeDelta(**d))
            g = deltas[-1].apply(versions[-1])
            versions.append(g)
        answers = [_ref_answers({"v": RefGraph(v)}, {"v": x})["v"]
                   for v in versions]
        stop = threading.Event()
        reads, errors = [], []

        def reader():
            # two requests in flight: groups of several split over the
            # replicas
            while not stop.is_set():
                try:
                    futs = [fleet.submit("hot", torch.from_numpy(x))
                            for _ in range(2)]
                    reads.extend(f.result(timeout=60).numpy() for f in futs)
                except BaseException as e:  # noqa: BLE001 — asserted below
                    errors.append(e)
                    return
        threads = [threading.Thread(target=reader) for _ in range(2)]
        for t in threads:
            t.start()
        for d in deltas:
            res = fleet.mutate("hot", d).result(timeout=60)
            assert res["version"] >= 1
        stop.set()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert not errors and reads
        for r in reads:
            assert any(np.array_equal(r, a) for a in answers)
        np.testing.assert_array_equal(
            fleet.serve_one("hot", torch.from_numpy(x)).numpy(), answers[-1])
        key = fleet.plan_for("hot").key
        assert fleet.cache.replica_devices(key) == [primary] + extras
        for m in [primary] + extras:
            staged = fleet.cache.plan_on(key, m)
            assert staged is not None and staged.version == len(deltas)
        assert fleet.cache.stats()["placements"] == 1
    finally:
        fleet.close()


def RefGraph(g):
    """A port CSRGraph as the reference's (same arrays)."""
    from repro.core.graph import CSRGraph as RefCSR
    return RefCSR(g.rowptr, g.colidx, g.values, g.n_cols)


# ----------------------------------------------------- construction, API
def test_validation_and_construction():
    fleet = FleetGraphEngine(devices=SLOTS)
    try:
        with pytest.raises(KeyError):
            fleet.submit("nope", torch.zeros((4, 4)))
        g = gcn_normalize(make_powerlaw_csr(n=60, seed=0))
        fleet.register_graph("g", _port(g))
        with pytest.raises(ValueError):
            fleet.submit("g", torch.zeros((g.n_cols + 1, 4)))
        fleet.reset_stats()
        assert fleet.stats()["fleet_rounds"] == 0
    finally:
        fleet.close()
    with pytest.raises(TypeError):
        FleetGraphEngine(devices=SLOTS, cache=PlanCache(4, device="cpu"))
    with pytest.raises(ValueError):
        FleetGraphEngine(devices=SLOTS, n_devices=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FleetGraphEngine()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_fleet.main([])


def test_serve_fleet_example_on_eight_cpu_slots():
    out = serve_fleet.main(["--device", "cpu", "--slots", "8", "--graphs",
                            "8", "--rounds", "2"])
    assert out["slots"] == 8 and out["block_sharded"] == 1
    assert out["block_balance"] <= 1.10 and out["err"] < 1e-4
    assert out["busy_slots"] >= 2
