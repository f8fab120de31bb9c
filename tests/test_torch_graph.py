"""Parity of the port's host-side graph code with the reference package:
``core/graph.py`` and ``data/graphs.py`` must give identical arrays (exact,
no tolerance) for the same inputs and seeds."""
import numpy as np
import pytest

from repro.core import graph as ref_graph
from repro.data import graphs as ref_data
from repro_torch.core import graph as port_graph
from repro_torch.data import graphs as port_data

from conftest import make_powerlaw_csr


def _same_csr(a, b):
    np.testing.assert_array_equal(a.rowptr, b.rowptr)
    np.testing.assert_array_equal(a.colidx, b.colidx)
    np.testing.assert_array_equal(a.values, b.values)
    assert a.values.dtype == b.values.dtype
    assert a.n_cols == b.n_cols
    if a.perm is None:
        assert b.perm is None
    else:
        np.testing.assert_array_equal(a.perm, b.perm)


def _port(g):
    return port_graph.CSRGraph(g.rowptr.copy(), g.colidx.copy(),
                               g.values.copy(), g.n_cols,
                               None if g.perm is None else g.perm.copy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_degree_sort_and_normalize_identical(seed):
    g = make_powerlaw_csr(n=150, seed=seed)
    _same_csr(port_graph.degree_sort_csr(_port(g)),
              ref_graph.degree_sort_csr(g))
    _same_csr(port_graph.gcn_normalize(_port(g)), ref_graph.gcn_normalize(g))
    _same_csr(port_graph.gcn_normalize(_port(g), add_self_loops=False),
              ref_graph.gcn_normalize(g, add_self_loops=False))


def test_counting_sort_large_branch_identical():
    """Above 200k rows the reference's rank-within-class helper takes its
    vectorised branch, below it a loop; the port's one stable-argsort path
    must agree with it at both sizes (the small size:
    ``test_degree_sort_and_normalize_identical``)."""
    deg = np.random.default_rng(3).integers(0, 50, 200_500)
    np.testing.assert_array_equal(port_graph.counting_sort_by_degree(deg),
                                  ref_graph.counting_sort_by_degree(deg))


def test_transpose_and_from_edges_identical():
    rng = np.random.default_rng(5)
    src = rng.integers(0, 120, 900)
    dst = rng.integers(0, 80, 900)
    vals = rng.random(900).astype(np.float32)
    ref = ref_graph.csr_from_edges(src, dst, 120, vals)
    port = port_graph.csr_from_edges(src, dst, 120, vals)
    _same_csr(port, ref)
    _same_csr(port_graph.csr_transpose(port), ref_graph.csr_transpose(ref))


def test_edge_delta_identical_and_errors_match():
    g = make_powerlaw_csr(n=90, seed=4)
    rng = np.random.default_rng(0)
    eids = rng.choice(g.nnz, 6, replace=False)
    d_src = np.searchsorted(g.rowptr, eids, side="right") - 1
    d_dst = g.colidx[eids]
    kw = dict(insert_src=rng.integers(0, 90, 5),
              insert_dst=rng.integers(0, 90, 5),
              insert_val=rng.random(5).astype(np.float32),
              delete_src=d_src, delete_dst=d_dst,
              on_duplicate="replace", on_missing="ignore")
    _same_csr(port_graph.csr_apply_edge_delta(_port(g), **kw),
              ref_graph.csr_apply_edge_delta(g, **kw))
    bad = dict(delete_src=[0], delete_dst=[89])   # likely missing
    for mod, gg in ((ref_graph, g), (port_graph, _port(g))):
        if 89 in g.colidx[g.rowptr[0]:g.rowptr[1]]:
            continue
        with pytest.raises(ValueError, match="missing edge"):
            mod.csr_apply_edge_delta(gg, **bad)


@pytest.mark.parametrize("n,m,seed", [(300, 2000, 0), (500, 9000, 7)])
def test_power_law_generator_same_seed_same_graph(n, m, seed):
    _same_csr(port_data.make_power_law_graph(n, m, seed=seed),
              ref_data.make_power_law_graph(n, m, seed=seed))


def test_benchmark_table_and_seeded_data_identical():
    assert port_data.BENCHMARK_GRAPHS == ref_data.BENCHMARK_GRAPHS
    np.testing.assert_array_equal(port_data.node_features(50, 7, seed=3),
                                  ref_data.node_features(50, 7, seed=3))
    np.testing.assert_array_equal(port_data.node_labels(50, 5, seed=3),
                                  ref_data.node_labels(50, 5, seed=3))
    for a, b in zip(port_data.seed_splits(100, [0.5, 0.2], seed=1),
                    ref_data.seed_splits(100, [0.5, 0.2], seed=1)):
        np.testing.assert_array_equal(a, b)
    seeds = np.arange(37)
    got = list(port_data.seed_batches(seeds, 8, seed=2, epochs=2))
    want = list(ref_data.seed_batches(seeds, 8, seed=2, epochs=2))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
