"""The port's ``SamplingService`` on the CPU: the single-process tests of
the reference's ``tests/test_sampling_service.py`` against the port's
service and engine, plus parity with the reference's service.

* a GCN over full-fanout sampled frontiers equals full-graph serving
  gathered at the seeds, bit for bit, on each of the port's CPU backends
  (``accel``, ``auto`` — the kernels' plain versions — and ``blocked``):
  a frontier block keeps each row's edges in parent-CSR order, and the
  plain versions sum a row in slab-slot order;
* recurring frontiers amortize through the frontier LRU and the engine's
  plan cache; store deltas repair cached frontiers through
  ``engine.mutate()`` or drop them, never serving stale ones;
* ``infer`` and ``aggregate`` agree with the reference's service on its
  ``blocked`` backend (its Pallas path is not layout-invariant): exactly on
  integer-valued graphs, features and weights, and otherwise within
  ``4 * 2**-24`` times the magnitude of the same computation on absolute
  values (``|A|``, ``|x|``, ``|W|``, ``|b|``).

The reference's two-process frontier exchange test waits for the port's
multi-host slice.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import csr_from_edges as ref_csr_from_edges
from repro.core.plan_repair import EdgeDelta as RefDelta
from repro.sampling import GraphStore as RefStore
from repro.sampling import SamplingService as RefService
from repro.serve import GraphServeEngine as RefEngine
from repro_torch.core.graph import CSRGraph, csr_from_edges
from repro_torch.core.plan_repair import EdgeDelta
from repro_torch.models.gcn import init_gcn
from repro_torch.sampling import GraphStore, SamplingService
from repro_torch.serve import GraphServeEngine

BACKENDS = ["accel", "auto", "blocked"]
CPU = "cpu"
U = 2.0 ** -24


def _edges(n, seed, m):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    eid = np.unique(src * n + dst)
    return eid // n, eid % n


def _simple_graph(n=80, seed=0, m=500):
    """Deduplicated random digraph (no parallel edges, so delta policies
    and dense comparisons are unambiguous)."""
    return csr_from_edges(*_edges(n, seed, m), n)


def _reference_gcn(engine, gid, x, params):
    """Full-graph forward pass with the exact layer arithmetic the
    service mirrors (h = aggr(h @ W) + b, relu between layers)."""
    h = torch.from_numpy(x)
    for i, p in enumerate(params):
        agg = engine.submit(gid, torch.matmul(h, p["w"])).result()
        h = agg + p["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


@pytest.mark.parametrize("backend", BACKENDS)
def test_two_layer_gcn_full_fanout_bit_exact(backend):
    n = 90
    store = GraphStore.build(_simple_graph(n, seed=0), normalize=True)
    engine = GraphServeEngine(device=CPU, backend=backend)
    try:
        engine.register_graph("full", store.in_adj)
        svc = SamplingService(engine, store, fanouts=[None, None],
                              store=store)
        x = np.random.default_rng(1).normal(size=(n, 12)).astype(np.float32)
        params = init_gcn(torch.Generator().manual_seed(0), [12, 16, 5],
                          device=CPU)
        ref = _reference_gcn(engine, "full", x, params)
        seeds = np.array([7, 3, 55, 20])   # deliberately unsorted
        out = svc.infer(seeds, x, params)
        assert out.shape == (4, 5)
        assert torch.equal(out, ref[seeds])   # bit-for-bit
    finally:
        engine.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_k_hop_aggregate_full_fanout_bit_exact(backend):
    n = 70
    store = GraphStore.build(_simple_graph(n, seed=2), normalize=True)
    engine = GraphServeEngine(device=CPU, backend=backend)
    try:
        engine.register_graph("full", store.in_adj)
        svc = SamplingService(engine, store, fanouts=[None, None],
                              store=store)
        x = np.random.default_rng(3).normal(size=(n, 8)).astype(np.float32)
        a1 = engine.submit("full", torch.from_numpy(x)).result()
        a2 = engine.submit("full", a1).result()
        seeds = np.array([1, 66, 30])
        assert torch.equal(svc.aggregate(seeds, x), a2[seeds])
        # features already in a tensor take the same path
        assert torch.equal(svc.aggregate(seeds, torch.from_numpy(x)),
                           a2[seeds])
    finally:
        engine.close()


def test_recurring_frontier_amortizes_plans():
    n = 60
    store = GraphStore.build(_simple_graph(n, seed=4), normalize=True)
    engine = GraphServeEngine(device=CPU)
    try:
        svc = SamplingService(engine, store, fanouts=[2, 2], store=store)
        x = np.random.default_rng(0).normal(size=(n, 4)).astype(np.float32)
        seeds = np.array([5, 9, 33])
        svc.aggregate(seeds, x)
        size_after_first = engine.stats()["cache_size"]
        # same seed SET in a different order: frontier LRU hit, no
        # sampling, no registration, no new plans
        svc.aggregate(np.array([33, 5, 9]), x)
        st = svc.stats()
        assert st["frontier_hits"] == 1 and st["frontier_misses"] == 1
        assert engine.stats()["cache_size"] == size_after_first
        # a SECOND service (fresh LRU, same engine): content-derived ids
        # make its registrations plan-cache hits, not rebuilds
        builds_before = engine.stats()["cache_misses"]
        svc2 = SamplingService(engine, store, fanouts=[2, 2], store=store)
        svc2.aggregate(seeds, x)
        assert engine.stats()["cache_misses"] == builds_before
    finally:
        engine.close()


def test_submit_gather_epilogue():
    n = 40
    g = GraphStore.build(_simple_graph(n, seed=5), normalize=True).in_adj
    engine = GraphServeEngine(device=CPU)
    try:
        gid = engine.register_subgraph(g, prefix="sub")
        assert gid.startswith("sub:")
        # idempotent: same content, same id, no duplicate binding
        assert engine.register_subgraph(g, prefix="sub") == gid
        x = torch.from_numpy(np.random.default_rng(1).normal(
            size=(n, 6)).astype(np.float32))
        rows = np.array([3, 0, 17])
        full = engine.submit(gid, x).result()
        gathered = engine.submit_gather(gid, x, rows).result()
        assert torch.equal(gathered, full[rows])
    finally:
        engine.close()


def test_unregister_graph_drops_binding():
    n = 30
    g = GraphStore.build(_simple_graph(n, seed=6), normalize=True).in_adj
    engine = GraphServeEngine(device=CPU)
    try:
        gid = engine.register_subgraph(g)
        x = torch.zeros((n, 2))
        engine.submit(gid, x).result()
        assert engine.unregister_graph(gid)
        assert gid not in engine.graph_ids()
        assert not engine.unregister_graph(gid)   # second call: no-op
        with pytest.raises(KeyError):
            engine.submit(gid, x)
        # re-registration re-binds (plan may still be cached)
        assert engine.register_subgraph(g) == gid
        engine.submit(gid, x).result()
    finally:
        engine.close()


def test_frontier_lru_eviction_unregisters():
    n = 60
    store = GraphStore.build(_simple_graph(n, seed=7), normalize=True)
    engine = GraphServeEngine(device=CPU)
    try:
        svc = SamplingService(engine, store, fanouts=[None],
                              max_cached_frontiers=1, store=store)
        x = np.zeros((n, 2), np.float32)
        svc.aggregate(np.array([1, 2]), x)
        gids_first = list(svc._cache.values())[0]["gids"]
        svc.aggregate(np.array([40, 41]), x)
        st = svc.stats()
        assert st["frontiers_evicted"] == 1 and st["frontiers_cached"] == 1
        for gid in gids_first:
            assert gid not in engine.graph_ids()
    finally:
        engine.close()


# ------------------------------------------------------------ invalidation
def _frontier_edge(store, svc, seeds):
    """(frontier, one in-edge (u -> v) with v a seed) for delta tests."""
    f = svc.frontier_for(seeds)
    v = int(f.layers[0][0])
    a = store.in_adj
    lo, hi = int(a.rowptr[v]), int(a.rowptr[v + 1])
    assert hi > lo, "test graph left the first seed with no in-edges"
    return f, int(a.colidx[lo]), v


def _two_hops(engine, gid, x):
    a1 = engine.submit(gid, torch.from_numpy(x)).result()
    return engine.submit(gid, a1).result()


def test_delta_rides_mutate_path_and_stays_exact():
    """Full-fanout frontier + expressible delta: the cached plans repair
    through engine.mutate() (no resample) and keep serving exactly."""
    n = 80
    store = GraphStore.build(_simple_graph(n, seed=8))   # unnormalized
    engine = GraphServeEngine(device=CPU)
    try:
        svc = SamplingService(engine, store, fanouts=[None, None],
                              store=store)
        x = np.random.default_rng(2).normal(size=(n, 5)).astype(np.float32)
        seeds = np.array([4, 11, 62])
        svc.aggregate(seeds, x)
        f, u, v = _frontier_edge(store, svc, seeds)
        # delete an existing in-edge of a seed; insert a fresh edge whose
        # endpoints both already sit in the frontier's layers
        w = int(f.layers[1][-1])
        dense = store.out_adj.to_dense()
        ins = [(w, v)] if dense[w, v] == 0 else []
        mut_before = engine.stats()["mutations_applied"]
        store.apply_delta(EdgeDelta(
            insert_src=[e[0] for e in ins], insert_dst=[e[1] for e in ins],
            insert_val=[1.0] * len(ins),
            delete_src=[u], delete_dst=[v]))
        st = svc.stats()
        assert st["frontier_mutations"] >= 1
        assert st["frontiers_invalidated"] == 0
        assert engine.stats()["mutations_applied"] > mut_before
        # cached entry survives AND serves the post-delta graph exactly
        engine.register_graph("ref", store.in_adj)
        a2 = _two_hops(engine, "ref", x)
        out = svc.aggregate(seeds, x)
        assert svc.stats()["frontier_hits"] >= 1
        assert torch.equal(out, a2[seeds])
    finally:
        engine.close()


def test_unexpressible_insert_invalidates_and_resamples():
    n = 80
    store = GraphStore.build(_simple_graph(n, seed=9))
    engine = GraphServeEngine(device=CPU)
    try:
        svc = SamplingService(engine, store, fanouts=[None, None],
                              store=store)
        x = np.random.default_rng(3).normal(size=(n, 4)).astype(np.float32)
        seeds = np.array([2, 3])
        svc.aggregate(seeds, x)
        f = svc.frontier_for(seeds)
        v = int(f.layers[0][0])
        outside = np.setdiff1d(np.arange(n), f.layers[1])
        assert len(outside), "frontier swallowed the whole graph; shrink it"
        w = int(outside[0])   # insert from OUTSIDE the frontier: no local
        #                       coordinates for w -> must resample
        store.apply_delta(EdgeDelta(insert_src=[w], insert_dst=[v],
                                    insert_val=[1.0],
                                    on_duplicate="replace"))
        st = svc.stats()
        assert st["frontiers_invalidated"] == 1
        assert st["frontier_mutations"] == 0
        # next query resamples against the post-delta store and is exact
        engine.register_graph("ref", store.in_adj)
        a2 = _two_hops(engine, "ref", x)
        assert torch.equal(svc.aggregate(seeds, x), a2[seeds])
        assert svc.stats()["frontier_misses"] == 2
    finally:
        engine.close()


def test_capped_fanout_delta_invalidates():
    n = 60
    store = GraphStore.build(_simple_graph(n, seed=10))
    engine = GraphServeEngine(device=CPU)
    try:
        svc = SamplingService(engine, store, fanouts=[2, 2], store=store)
        x = np.zeros((n, 2), np.float32)
        seeds = np.array([1, 5])
        svc.aggregate(seeds, x)
        _, u, v = _frontier_edge(store, svc, seeds)
        store.apply_delta(EdgeDelta(delete_src=[u], delete_dst=[v]))
        st = svc.stats()
        assert st["frontiers_invalidated"] == 1
        assert st["frontier_mutations"] == 0
    finally:
        engine.close()


def test_unrelated_delta_leaves_frontiers_cached():
    n = 80
    store = GraphStore.build(_simple_graph(n, seed=11))
    engine = GraphServeEngine(device=CPU)
    try:
        svc = SamplingService(engine, store, fanouts=[None], store=store)
        x = np.zeros((n, 2), np.float32)
        seeds = np.array([0, 1])
        svc.aggregate(seeds, x)
        f = svc.frontier_for(seeds)
        outside = np.setdiff1d(np.arange(n), f.layers[0])
        v = int(outside[-1])   # delta touches rows OUTSIDE the receptive
        u = int(outside[0])    # field: nothing to do
        store.apply_delta(EdgeDelta(insert_src=[u], insert_dst=[v],
                                    insert_val=[1.0],
                                    on_duplicate="replace"))
        st = svc.stats()
        assert st["frontiers_invalidated"] == 0
        assert st["frontier_mutations"] == 0
        assert st["frontiers_cached"] == 1
    finally:
        engine.close()


# ---------------------------------------------------------- parity: packages
def _both(n, seed, m, integer, normalize):
    """The same store in both packages: integer-valued edges (1-3) or the
    graph's own values, optionally GCN-normalized."""
    src, dst = _edges(n, seed, m)
    vals = (np.random.default_rng(seed + 100).integers(1, 4, len(src))
            .astype(np.float32) if integer else None)
    rg = ref_csr_from_edges(src, dst, n, vals)
    pg = CSRGraph(rg.rowptr, rg.colidx, rg.values, rg.n_cols)
    return (RefStore.build(rg, normalize=normalize),
            GraphStore.build(pg, normalize=normalize))


def _numpy_params(dims, seed, integer):
    rng = np.random.default_rng(seed)
    out = []
    for a, b in zip(dims[:-1], dims[1:]):
        if integer:
            w = rng.integers(-2, 3, (a, b)).astype(np.float32)
            bias = rng.integers(-2, 3, b).astype(np.float32)
        else:
            w = (rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
            bias = (rng.normal(size=b) * 0.1).astype(np.float32)
        out.append({"w": w, "b": bias})
    return out


def _assert_matches(got, want, mag, integer):
    got = got.numpy()
    if integer:
        assert np.array_equal(got, want)
    else:
        err = np.abs(got.astype(np.float64) - want)
        assert (err <= 4 * U * mag).all(), float((err / (U * mag)).max())


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("backend", ["accel", "blocked"])
@pytest.mark.parametrize("fanouts", [[None, None], [3, 4], [None, 2, None]])
def test_infer_matches_reference_service(integer, backend, fanouts):
    n = 90
    ref_store, store = _both(n, 21, 520, integer, normalize=not integer)
    dims = [6, 8, 5, 4][:len(fanouts) + 1]
    rng = np.random.default_rng(5)
    if integer:
        x = rng.integers(-4, 5, (n, dims[0])).astype(np.float32)
    else:
        x = rng.normal(size=(n, dims[0])).astype(np.float32)
    params = _numpy_params(dims, 6, integer)
    engine = GraphServeEngine(device=CPU, backend=backend)
    ref_engine = RefEngine(backend="blocked")
    try:
        svc = SamplingService(engine, store, fanouts, store=store,
                              sample_seed=9)
        ref_svc = RefService(ref_engine, ref_store, fanouts,
                             store=ref_store, sample_seed=9)
        seeds = np.array([40, 2, 77, 13, 2])
        got = svc.infer(seeds, x, [{k: torch.from_numpy(v)
                                    for k, v in p.items()} for p in params])
        want = ref_svc.infer(seeds, x, [{k: jnp.asarray(v)
                                         for k, v in p.items()}
                                        for p in params])
        assert svc.frontier_for(seeds).content_key() == \
            ref_svc.frontier_for(seeds).content_key()
        # the sampled frontier's own operator gives the magnitude
        mag = _frontier_magnitude(svc.frontier_for(seeds), x, params, seeds)
        _assert_matches(got, np.asarray(want, np.float64), mag, integer)
    finally:
        engine.close()
        ref_engine.close()


def _frontier_magnitude(frontier, x, params, seeds):
    """|A_k| ... |A_0| chain of the sampled blocks on absolute values."""
    h = np.abs(x[frontier.input_nodes].astype(np.float64))
    L = frontier.num_hops
    for i in range(L):
        a = np.abs(frontier.blocks[L - 1 - i].graph.to_dense()
                   .astype(np.float64))
        if params is None:
            h = a @ h
        else:
            h = a @ (h @ np.abs(params[i]["w"].astype(np.float64))) \
                + np.abs(params[i]["b"])
    return h[np.searchsorted(frontier.layers[0], seeds)]


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("backend", ["accel", "auto", "blocked"])
@pytest.mark.parametrize("fanouts", [[None, None], [2, 3]])
def test_aggregate_matches_reference_service(integer, backend, fanouts):
    n = 80
    ref_store, store = _both(n, 22, 480, integer, normalize=not integer)
    rng = np.random.default_rng(7)
    x = (rng.integers(-4, 5, (n, 8)) if integer
         else rng.normal(size=(n, 8))).astype(np.float32)
    engine = GraphServeEngine(device=CPU, backend=backend)
    ref_engine = RefEngine(backend="blocked")
    try:
        svc = SamplingService(engine, store, fanouts, store=store)
        ref_svc = RefService(ref_engine, ref_store, fanouts, store=ref_store)
        seeds = np.array([5, 79, 31])
        got = svc.aggregate(seeds, x)
        want = np.asarray(ref_svc.aggregate(seeds, x), np.float64)
        mag = _frontier_magnitude(svc.frontier_for(seeds), x, None, seeds)
        _assert_matches(got, want, mag, integer)
    finally:
        engine.close()
        ref_engine.close()


def test_delta_repair_matches_reference_service():
    """The same expressible delta into both stores: both services repair
    through mutate() and serve the same exact answer afterwards."""
    n = 80
    ref_store, store = _both(n, 23, 500, True, normalize=False)
    x = np.random.default_rng(8).integers(-4, 5, (n, 4)).astype(np.float32)
    engine = GraphServeEngine(device=CPU)
    ref_engine = RefEngine(backend="blocked")
    try:
        svc = SamplingService(engine, store, [None, None], store=store)
        ref_svc = RefService(ref_engine, ref_store, [None, None],
                             store=ref_store)
        seeds = np.array([4, 11, 62])
        svc.aggregate(seeds, x)
        ref_svc.aggregate(seeds, x)
        _, u, v = _frontier_edge(store, svc, seeds)
        ref_svc.frontier_for(seeds)         # the same lookup on both sides
        kw = dict(delete_src=[u], delete_dst=[v])
        store.apply_delta(EdgeDelta(**kw))
        ref_store.apply_delta(RefDelta(**kw))
        assert svc.stats() == ref_svc.stats()
        assert svc.stats()["frontier_mutations"] >= 1
        got = svc.aggregate(seeds, x)
        want = np.asarray(ref_svc.aggregate(seeds, x))
        assert np.array_equal(got.numpy(), want)
    finally:
        engine.close()
        ref_engine.close()


def test_service_answers_on_the_engine_device_and_checks_depth():
    n = 40
    store = GraphStore.build(_simple_graph(n, seed=12), normalize=True)
    engine = GraphServeEngine(device=CPU)
    try:
        svc = SamplingService(engine, store, [None, None], store=store)
        params = init_gcn(torch.Generator().manual_seed(1), [3, 4, 2],
                          device=CPU)
        x = np.ones((n, 3), np.float32)
        out = svc.infer(np.array([0, 1]), x, params)
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
        with pytest.raises(ValueError, match="layers for 2 sampled hops"):
            svc.infer(np.array([0]), x, params[:1])
        with pytest.raises(ValueError, match="at least one hop"):
            SamplingService(engine, store, [])
    finally:
        engine.close()

