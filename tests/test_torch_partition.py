"""Parity of the port's partitioner (Algorithms 1 and 2, slab packing, the
warp-level baseline) with the reference: every output is identical."""
import numpy as np
import pytest

from repro.core import graph as ref_graph
from repro.core import partition as ref_part
from repro_torch.core import graph as port_graph
from repro_torch.core import partition as port_part

from conftest import make_powerlaw_csr


def _edge_graph(C, seed):
    """Degree-sorted CSR with zero-degree rows, rows of degree exactly C
    (== deg_bound) and split rows (degree > C)."""
    rng = np.random.default_rng(seed)
    deg = np.concatenate([[0] * 3, rng.integers(1, 30, 60), [C] * 2,
                          [C + 1], [2 * C + 5]])
    src = np.repeat(np.arange(len(deg)), deg)
    dst = rng.integers(0, len(deg), len(src))
    g = ref_graph.csr_from_edges(src, dst, len(deg))
    return ref_graph.degree_sort_csr(g)


def _port(g):
    return port_graph.CSRGraph(g.rowptr, g.colidx, g.values, g.n_cols, g.perm)


def _same_patterns(a, b):
    for k in ("block_rows", "warp_nzs", "factor"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert (a.mode, a.deg_bound) == (b.mode, b.deg_bound)


MODES = [("tpu", 8, 4), ("paper", 12, 8), ("tpu", 64, 4), ("paper", 12, 32)]


@pytest.mark.parametrize("mode,mbw,mwn", MODES)
def test_patterns_identical(mode, mbw, mwn):
    _same_patterns(port_part.get_partition_patterns(mbw, mwn, mode=mode),
                   ref_part.get_partition_patterns(mbw, mwn, mode=mode))


@pytest.mark.parametrize("mode", ["tpu", "paper"])
def test_patterns_with_override_identical(mode):
    mbw, mwn = 8, 4
    d = np.arange(1, mbw * mwn + 1)
    override = np.maximum(-(-d // mbw), np.minimum(mwn, 2))
    _same_patterns(
        port_part.get_partition_patterns(mbw, mwn, mode=mode,
                                         warp_nzs_override=override),
        ref_part.get_partition_patterns(mbw, mwn, mode=mode,
                                        warp_nzs_override=override))


def test_override_validation_errors_match():
    bad = np.ones(32, dtype=np.int64)      # 8 * 1 < d for d > 8
    for mod in (ref_part, port_part):
        with pytest.raises(ValueError, match="inadmissible"):
            mod.validate_warp_nzs_override(8, 4, bad)
        with pytest.raises(ValueError, match="1-D vector"):
            mod.validate_warp_nzs_override(8, 4, np.ones(5))


@pytest.mark.parametrize("mode,mbw,mwn", MODES)
def test_block_partition_and_slabs_identical(mode, mbw, mwn):
    C = mbw * mwn
    gs = _edge_graph(C, seed=mbw)
    rp = ref_part.block_level_partition(
        gs, ref_part.get_partition_patterns(mbw, mwn, mode=mode))
    pp = port_part.block_level_partition(
        _port(gs), port_part.get_partition_patterns(mbw, mwn, mode=mode))
    for k in ("meta", "n_rows_blk", "nnz_blk", "is_split"):
        np.testing.assert_array_equal(getattr(pp, k), getattr(rp, k))
    assert pp.is_split.any(), "graph must exercise split rows"
    assert (np.diff(gs.rowptr) == C).any(), "graph must hit deg == deg_bound"
    for R in (None, int(rp.n_rows_blk.max()) + 3):
        rs = ref_part.pack_slabs(gs, rp, R=R)
        ps = port_part.pack_slabs(_port(gs), pp, R=R)
        assert rs.keys() == ps.keys()
        for k, v in rs.items():
            np.testing.assert_array_equal(ps[k], v)
    assert port_part.balance_stats(pp) == ref_part.balance_stats(rp)
    assert port_part.metadata_bytes(pp) == ref_part.metadata_bytes(rp)


@pytest.mark.parametrize("ng", [8, 32])
def test_warp_partition_identical(ng):
    g = make_powerlaw_csr(n=120, seed=6)
    rw = ref_part.warp_level_partition(g, ng_size=ng)
    pw = port_part.warp_level_partition(_port(g), ng_size=ng)
    np.testing.assert_array_equal(pw.meta, rw.meta)
    assert port_part.balance_stats(pw) == ref_part.balance_stats(rw)
    assert port_part.metadata_bytes(pw) == ref_part.metadata_bytes(rw)
