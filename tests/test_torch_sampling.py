"""The port's sampler layer on the CPU: every test of the reference's
``tests/test_sampling.py`` against ``repro_torch.sampling``, plus parity
with the reference package.

Sampling stays on the host in numpy, with one generator per sampled node
seeded ``[seed, hop, node]``, so it must be IDENTICAL to the reference's:
``_sample_rows``, every layer of ``sample_frontier``, every block's
``rowptr``, ``colidx``, ``values``, ``dst_nodes`` and ``src_nodes``, and
``content_key()`` — for full fanout, capped fanouts and ``replace=True``,
on a store built from the same graph and after the same
``GraphStore.apply_delta``.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core.plan_repair import EdgeDelta as RefDelta
from repro.sampling import GraphStore as RefStore
from repro.sampling import sample_frontier as ref_sample_frontier
from repro.sampling.store import _sample_rows as ref_sample_rows
from repro_torch.core.graph import CSRGraph
from repro_torch.core.plan_repair import EdgeDelta
from repro_torch.data.graphs import seed_batches, seed_splits
from repro_torch.sampling import (
    Frontier, GraphStore, PartitionedStoreClient, sample_frontier,
)
from repro_torch.sampling.store import _sample_rows

from conftest import make_powerlaw_csr


def _port(g):
    return CSRGraph(g.rowptr, g.colidx, g.values, g.n_cols)


def _store(n=80, seed=0, normalize=False):
    return GraphStore.build(_port(make_powerlaw_csr(n=n, seed=seed)),
                            normalize=normalize)


# ------------------------------------------------------------------- store
def test_store_views_are_mirrors():
    store = _store(normalize=True)
    assert np.array_equal(store.in_adj.to_dense(),
                          store.out_adj.to_dense().T)


def test_store_in_adj_is_transpose_of_input():
    g = _port(make_powerlaw_csr(n=50, seed=2))
    store = GraphStore.build(g)
    assert np.array_equal(store.in_adj.to_dense(), g.to_dense().T)


def test_store_apply_delta_updates_both_views():
    store = _store(n=40, seed=1)
    # an edge u -> v not present yet
    dense = store.out_adj.to_dense()
    u, v = np.argwhere(dense == 0)[0]
    ver = store.apply_delta(EdgeDelta(insert_src=[u], insert_dst=[v],
                                      insert_val=[2.5]))
    assert ver == 1 and store.version == 1
    assert store.out_adj.to_dense()[u, v] == 2.5
    assert store.in_adj.to_dense()[v, u] == 2.5
    assert np.array_equal(store.in_adj.to_dense(),
                          store.out_adj.to_dense().T)


def test_store_listener_gets_touched_aggregation_rows():
    store = _store(n=30, seed=3)
    seen = []
    store.add_listener(lambda rows, delta: seen.append(rows))
    dense = store.out_adj.to_dense()
    u, v = np.argwhere(dense == 0)[0]
    store.apply_delta(EdgeDelta(insert_src=[u], insert_dst=[v]))
    assert len(seen) == 1
    assert np.array_equal(seen[0], np.array([v]))  # agg row = destination


def test_store_rejects_unowned_nodes():
    store = _store(n=40)
    shard = store.partition(2)[0]
    hi = shard.node_range[1]
    with pytest.raises(ValueError, match="outside owned range"):
        shard.sample_in_neighbors(np.array([hi]), None)


def test_partition_shards_preserve_owned_rows():
    store = _store(n=61, seed=5)   # odd n: uneven ranges
    shards = store.partition(3)
    full = store.in_adj.to_dense()
    covered = 0
    for sh in shards:
        lo, hi = sh.node_range
        d = sh.in_adj.to_dense()
        assert np.array_equal(d[lo:hi], full[lo:hi])
        assert d[:lo].sum() == 0 and d[hi:].sum() == 0
        assert np.array_equal(sh.in_adj.to_dense(),
                              sh.out_adj.to_dense().T)
        covered += hi - lo
    assert covered == store.n_nodes


# ------------------------------------------------------------- seed helpers
def test_seed_splits_disjoint_and_deterministic():
    a1, b1, c1 = seed_splits(100, [0.5, 0.3, 0.2], seed=4)
    a2, b2, _ = seed_splits(100, [0.5, 0.3, 0.2], seed=4)
    assert np.array_equal(a1, a2) and np.array_equal(b1, b2)
    assert (a1 & b1).sum() == 0 and (a1 & c1).sum() == 0
    assert a1.sum() == 50 and b1.sum() == 30 and c1.sum() == 20
    other, = seed_splits(100, [0.5], seed=5)
    assert not np.array_equal(a1, other)


def test_seed_splits_rejects_over_unity():
    with pytest.raises(ValueError):
        seed_splits(10, [0.8, 0.4])


def test_seed_batches_deterministic_and_complete():
    mask, = seed_splits(64, [0.5], seed=0)
    run1 = list(seed_batches(mask, 10, seed=3, epochs=2))
    run2 = list(seed_batches(mask, 10, seed=3, epochs=2))
    assert len(run1) == len(run2) == 2 * 4  # ceil(32/10) per epoch
    for b1, b2 in zip(run1, run2):
        assert np.array_equal(b1, b2)
    # each epoch covers every seed exactly once
    epoch1 = np.sort(np.concatenate(run1[:4]))
    assert np.array_equal(epoch1, np.flatnonzero(mask))
    # different seed -> different order
    run3 = list(seed_batches(mask, 10, seed=4))
    assert any(not np.array_equal(a, b) for a, b in zip(run1, run3))


def test_seed_batches_no_shuffle_is_sequential():
    ids = np.array([5, 1, 9])
    out = list(seed_batches(ids, 2, shuffle=False))
    assert np.array_equal(out[0], [5, 1]) and np.array_equal(out[1], [9])


# ------------------------------------------------------- sampler properties
@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 500),
       sample_seed=st.integers(0, 500),
       fanout=st.sampled_from([1, 2, 4, None]),
       seeds=st.lists(st.integers(0, 59), min_size=1, max_size=8))
def test_sampled_edges_exist_in_parent_and_caps_hold(seed, sample_seed,
                                                     fanout, seeds):
    store = _store(n=60, seed=seed)
    dense = store.in_adj.to_dense()
    f = sample_frontier(store.sample_in_neighbors, np.array(seeds),
                        [fanout, fanout], seed=sample_seed)
    for block in f.blocks:
        g = block.graph
        assert g.n_rows == len(block.dst_nodes)
        assert g.n_cols == len(block.src_nodes)
        for i in range(g.n_rows):
            lo, hi = g.rowptr[i], g.rowptr[i + 1]
            if fanout is not None:
                assert hi - lo <= fanout          # per-hop cap
            v = block.dst_nodes[i]
            for j in g.colidx[lo:hi]:
                u = block.src_nodes[j]
                # edge exists in parent (dense sums parallel edges, so
                # existence is the right check on a multigraph)
                assert dense[v, u] != 0


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 500),
       seeds=st.lists(st.integers(0, 49), min_size=1, max_size=6),
       fanout=st.sampled_from([1, 3, None]))
def test_sampling_bit_deterministic(seed, seeds, fanout):
    store = _store(n=50, seed=1)
    f1 = sample_frontier(store.sample_in_neighbors, np.array(seeds),
                         [fanout, fanout], seed=seed)
    f2 = sample_frontier(store.sample_in_neighbors, np.array(seeds),
                         [fanout, fanout], seed=seed)
    assert f1.content_key() == f2.content_key()
    for l1, l2 in zip(f1.layers, f2.layers):
        assert np.array_equal(l1, l2)


def test_sampling_independent_of_batch_composition():
    # node v's sampled neighborhood must not depend on which OTHER seeds
    # share its batch (rng keys on (seed, hop, node) only)
    store = _store(n=60, seed=7)
    alone = sample_frontier(store.sample_in_neighbors, np.array([11]),
                            [2], seed=9)
    grouped = sample_frontier(store.sample_in_neighbors,
                              np.array([11, 40, 3]), [2], seed=9)
    b_a, b_g = alone.blocks[0], grouped.blocks[0]
    i = int(np.searchsorted(b_g.dst_nodes, 11))
    lo, hi = b_g.graph.rowptr[i], b_g.graph.rowptr[i + 1]
    got = np.sort(b_g.src_nodes[b_g.graph.colidx[lo:hi]])
    lo_a, hi_a = b_a.graph.rowptr[0], b_a.graph.rowptr[1]
    exp = np.sort(b_a.src_nodes[b_a.graph.colidx[lo_a:hi_a]])
    assert np.array_equal(got, exp)


@settings(max_examples=10, deadline=None)
@given(seeds=st.lists(st.integers(0, 79), min_size=1, max_size=8),
       sample_seed=st.integers(0, 100))
def test_capped_fanout_matches_numpy_reference(seeds, sample_seed):
    """The service sampler must equal an independent numpy reference:
    rng([seed, hop, node]) over the in-adjacency row, sorted slots."""
    store = _store(n=80, seed=4)
    fanout = 2
    f = sample_frontier(store.sample_in_neighbors, np.array(seeds),
                        [fanout], seed=sample_seed)
    b = f.blocks[0]
    a = store.in_adj
    for i, v in enumerate(b.dst_nodes):
        lo, hi = int(a.rowptr[v]), int(a.rowptr[v + 1])
        d = hi - lo
        if d <= fanout:
            idx = np.arange(lo, hi)
        else:
            rng = np.random.default_rng([sample_seed, 0, int(v)])
            idx = lo + np.sort(rng.choice(d, size=fanout, replace=False))
        exp = a.colidx[idx]
        got = b.src_nodes[
            b.graph.colidx[b.graph.rowptr[i]:b.graph.rowptr[i + 1]]]
        assert np.array_equal(np.asarray(exp), np.asarray(got))


def test_sampling_with_replacement_caps_and_exists():
    store = _store(n=40, seed=6)
    f = sample_frontier(store.sample_in_neighbors, np.arange(10), [3],
                        seed=1, replace=True)
    dense = store.in_adj.to_dense()
    b = f.blocks[0]
    for i in range(b.graph.n_rows):
        lo, hi = b.graph.rowptr[i], b.graph.rowptr[i + 1]
        v = b.dst_nodes[i]
        if int(store.in_degrees(np.array([v]))[0]) > 0:
            assert hi - lo == 3    # with replacement: always exactly fanout
        for j in b.graph.colidx[lo:hi]:
            assert dense[v, b.src_nodes[j]] != 0


# ------------------------------------------------------------- compaction
@settings(max_examples=10, deadline=None)
@given(seeds=st.lists(st.integers(0, 59), min_size=1, max_size=6),
       fanout=st.sampled_from([2, None]))
def test_compaction_relabel_roundtrip(seeds, fanout):
    store = _store(n=60, seed=8)
    f = sample_frontier(store.sample_in_neighbors, np.array(seeds),
                        [fanout, fanout], seed=0)
    assert isinstance(f, Frontier)
    for k, block in enumerate(f.blocks):
        # id maps are sorted-unique and equal the layer sets
        assert np.array_equal(block.dst_nodes, f.layers[k])
        assert np.array_equal(block.src_nodes, f.layers[k + 1])
        # local -> global -> local round-trips
        local = np.arange(len(block.src_nodes))
        assert np.array_equal(block.to_local_src(block.src_nodes[local]),
                              local)
        local_d = np.arange(len(block.dst_nodes))
        assert np.array_equal(block.to_local_dst(block.dst_nodes[local_d]),
                              local_d)
    # layers nest
    for a, b in zip(f.layers[:-1], f.layers[1:]):
        assert np.all(np.isin(a, b))
    # seed rows recover the caller's order
    rows = f.seed_rows()
    assert np.array_equal(f.layers[0][rows], f.seeds)


def test_full_fanout_block_rows_keep_parent_order():
    # within a compacted row, edges keep the parent CSR's relative order —
    # the property that makes full-fanout aggregation bit-exact
    store = _store(n=50, seed=2, normalize=True)
    f = sample_frontier(store.sample_in_neighbors, np.arange(50), [None])
    b = f.blocks[0]
    a = store.in_adj
    assert np.array_equal(b.dst_nodes, np.arange(50))
    for v in range(50):
        lo, hi = a.rowptr[v], a.rowptr[v + 1]
        got = b.src_nodes[
            b.graph.colidx[b.graph.rowptr[v]:b.graph.rowptr[v + 1]]]
        assert np.array_equal(got, a.colidx[lo:hi])
        assert np.array_equal(
            b.graph.values[b.graph.rowptr[v]:b.graph.rowptr[v + 1]],
            a.values[lo:hi])


# ------------------------------------------------------- partitioned client
def _partitioned(store, n_parts):
    shards = store.partition(n_parts)
    bounds = [sh.node_range[0] for sh in shards] + [store.n_nodes]
    remote = {r: shards[r].sample_in_neighbors for r in range(1, n_parts)}
    return PartitionedStoreClient(shards[0], bounds, remote, 0)


@settings(max_examples=8, deadline=None)
@given(seeds=st.lists(st.integers(0, 69), min_size=1, max_size=6),
       fanout=st.sampled_from([2, None]),
       n_parts=st.sampled_from([2, 3]))
def test_partitioned_client_bit_identical_to_monolith(seeds, fanout,
                                                      n_parts):
    store = _store(n=70, seed=9)
    client = _partitioned(store, n_parts)
    fm = sample_frontier(store.sample_in_neighbors, np.array(seeds),
                         [fanout, fanout], seed=5)
    fp = sample_frontier(client.sample_in_neighbors, np.array(seeds),
                         [fanout, fanout], seed=5)
    assert fm.content_key() == fp.content_key()


def test_partitioned_client_routes_by_ownership():
    store = _store(n=60, seed=3)
    client = _partitioned(store, 2)
    # seeds straddle the partition boundary, so both shards must serve
    f = sample_frontier(client.sample_in_neighbors,
                        np.array([1, 58]), [None])
    assert f.blocks[0].n_edges > 0
    assert client.remote_edges > 0 and client.local_edges > 0
    with pytest.raises(KeyError, match="no channel"):
        PartitionedStoreClient(
            store.partition(2)[0], [0, 30, 60], {}, 0
        ).sample_in_neighbors(np.array([45]), None)


def test_partitioned_client_validates_bounds():
    store = _store(n=60)
    shards = store.partition(2)
    with pytest.raises(ValueError, match="bounds slot"):
        PartitionedStoreClient(shards[1], [0, 30, 60], {}, 0)


# ---------------------------------------------------------- parity: packages
def _both_stores(n, seed, normalize):
    g = make_powerlaw_csr(n=n, seed=seed)
    return (RefStore.build(g, normalize=normalize),
            GraphStore.build(_port(g), normalize=normalize))


def _assert_graph_equal(a, b):
    assert a.n_cols == b.n_cols
    for k in ("rowptr", "colidx", "values"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        assert np.array_equal(x, y), k


def _assert_frontiers_identical(fr, fp):
    assert np.array_equal(fr.seeds, fp.seeds)
    assert len(fr.layers) == len(fp.layers)
    for a, b in zip(fr.layers, fp.layers):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for br, bp in zip(fr.blocks, fp.blocks):
        _assert_graph_equal(br.graph, bp.graph)
        assert np.array_equal(br.dst_nodes, bp.dst_nodes)
        assert np.array_equal(br.src_nodes, bp.src_nodes)
    assert fr.content_key() == fp.content_key()


@pytest.mark.parametrize("normalize", [False, True])
def test_store_views_identical_to_reference(normalize):
    ref, port = _both_stores(90, 12, normalize)
    _assert_graph_equal(ref.in_adj, port.in_adj)
    _assert_graph_equal(ref.out_adj, port.out_adj)
    for sr, sp in zip(ref.partition(3), port.partition(3)):
        assert sr.node_range == sp.node_range
        _assert_graph_equal(sr.in_adj, sp.in_adj)


@pytest.mark.parametrize("fanout,replace", [(None, False), (1, False),
                                            (3, False), (1, True), (3, True)])
@pytest.mark.parametrize("hop", [0, 2])
def test_sample_rows_identical_to_reference(fanout, replace, hop):
    ref, port = _both_stores(120, 13, True)
    nodes = np.unique(np.random.default_rng(hop).integers(0, 120, 40))
    a = port.in_adj
    got = _sample_rows(a.rowptr, a.colidx, a.values, nodes, fanout, 17, hop,
                       replace)
    want = ref_sample_rows(a.rowptr, a.colidx, a.values, nodes, fanout, 17,
                           hop, replace)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("fanouts,replace", [
    ([None, None], False), ([None, None, None], False), ([3, 2], False),
    ([10, 10, 5], False), ([2, 2], True), ([4, None], True)])
@pytest.mark.parametrize("seeds", [[0, 5, 77], [41], list(range(0, 150, 9))])
def test_frontiers_identical_to_reference(fanouts, replace, seeds):
    ref, port = _both_stores(150, 14, True)
    fr = ref_sample_frontier(ref.sample_in_neighbors, np.array(seeds),
                             fanouts, seed=3, replace=replace)
    fp = sample_frontier(port.sample_in_neighbors, np.array(seeds),
                         fanouts, seed=3, replace=replace)
    _assert_frontiers_identical(fr, fp)


@pytest.mark.parametrize("fanouts", [[None, None], [3, 3]])
def test_frontiers_identical_to_reference_after_a_delta(fanouts):
    ref, port = _both_stores(100, 15, False)
    rng = np.random.default_rng(8)
    g = port.out_adj
    eids = rng.choice(g.nnz, 6, replace=False)
    kw = dict(insert_src=rng.integers(0, 100, 6),
              insert_dst=rng.integers(0, 100, 6),
              insert_val=rng.integers(1, 4, 6).astype(np.float32),
              delete_src=np.searchsorted(g.rowptr, eids, side="right") - 1,
              delete_dst=g.colidx[eids],
              on_duplicate="replace", on_missing="ignore")
    seen_r, seen_p = [], []
    ref.add_listener(lambda rows, d: seen_r.append(rows))
    port.add_listener(lambda rows, d: seen_p.append(rows))
    assert ref.apply_delta(RefDelta(**kw)) == port.apply_delta(EdgeDelta(**kw))
    assert len(seen_p) == 1 and np.array_equal(seen_r[0], seen_p[0])
    _assert_graph_equal(ref.in_adj, port.in_adj)
    _assert_graph_equal(ref.out_adj, port.out_adj)
    seeds = np.unique(kw["insert_dst"])
    fr = ref_sample_frontier(ref.sample_in_neighbors, seeds, fanouts, seed=1)
    fp = sample_frontier(port.sample_in_neighbors, seeds, fanouts, seed=1)
    _assert_frontiers_identical(fr, fp)
