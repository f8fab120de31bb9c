"""The slab layout that K2 and K3 rely on, and K2's window order, on the CPU.

K2 and K3 add each local row's run of slots straight into the output, so in
every block of ``pack_slabs`` (the reference's and the port's) and of
``batch_graph_slabs`` (both packages) the live slots' ``rowloc`` must never
decrease: each local row is one contiguous run. The graphs cover both
partition modes, zero-degree rows, rows of degree C and split rows (degree
> C), a forced wider R, and merged slabs padded in C, R and blocks.

K2 adds a row's window partials in window order, whatever order its
columns come in. The order-pinning block sums +1 (window 1), +2**24
(window 0) and -2**24 (window 1): in window order that is exactly 1, in
slot order 0 (fp32 rounds 1 + 2**24 to 2**24). The reference's Pallas
kernel (interpret mode) and the port's plain version must both give 1.
"""
import numpy as np
import pytest
import torch

from repro.core import graph as ref_graph
from repro.core import partition as ref_part
from repro.kernels import spmm_batched as ref_b
from repro.kernels.spmm_accel import spmm_block_slabs_windowed as ref_k2
from repro_torch.core import graph as port_graph
from repro_torch.core import partition as port_part
from repro_torch.kernels import spmm_accel as port_k
from repro_torch.kernels import spmm_batched as port_b

MODES = [("tpu", 8, 4), ("paper", 12, 8), ("tpu", 64, 4), ("paper", 12, 32)]


def _edge_graph(C, seed):
    """Degree-sorted CSR with zero-degree rows, rows of degree exactly C,
    and split rows (degree > C)."""
    rng = np.random.default_rng(seed)
    deg = np.concatenate([[0] * 4, rng.integers(1, 30, 60), [C] * 2,
                          [C + 1], [2 * C + 5], [0] * 2])
    rng.shuffle(deg)
    src = np.repeat(np.arange(len(deg)), deg)
    dst = rng.integers(0, len(deg), len(src))
    return ref_graph.degree_sort_csr(
        ref_graph.csr_from_edges(src, dst, len(deg)))


def _port(g):
    return port_graph.CSRGraph(g.rowptr, g.colidx, g.values, g.n_cols, g.perm)


def _assert_row_runs(slabs):
    """Every block's live slots have non-decreasing rowloc; returns the
    number of blocks with no live slot."""
    values = np.asarray(slabs["values"])
    rowloc = np.asarray(slabs["rowloc"])
    empty = 0
    for b in range(values.shape[0]):
        rows = rowloc[b][values[b] != 0]
        empty += rows.size == 0
        assert np.all(np.diff(rows) >= 0), (b, rows)
    return empty


def _partitions(mode, mbw, mwn, seed):
    C = mbw * mwn
    gs = _edge_graph(C, seed)
    assert (np.diff(gs.rowptr) == 0).any()
    rp = ref_part.block_level_partition(
        gs, ref_part.get_partition_patterns(mbw, mwn, mode=mode))
    pp = port_part.block_level_partition(
        _port(gs), port_part.get_partition_patterns(mbw, mwn, mode=mode))
    assert rp.is_split.any() and pp.is_split.any()
    return gs, rp, pp


@pytest.mark.parametrize("wider_r", [0, 3])
@pytest.mark.parametrize("mode,mbw,mwn", MODES)
def test_pack_slabs_keeps_each_row_one_run(mode, mbw, mwn, wider_r):
    gs, rp, pp = _partitions(mode, mbw, mwn, seed=mbw + mwn)
    R = int(rp.n_rows_blk.max()) + wider_r if wider_r else None
    _assert_row_runs(ref_part.pack_slabs(gs, rp, R=R))
    _assert_row_runs(port_part.pack_slabs(_port(gs), pp, R=R))


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_batch_graph_slabs_keeps_each_row_one_run(pkg):
    """Both modes merged (C and R padded to the batch max) plus a tail of
    all-zero padding blocks."""
    slabs, n_rows, n_cols = [], [], []
    for i, (mode, mbw, mwn) in enumerate(MODES):
        gs, rp, pp = _partitions(mode, mbw, mwn, seed=i)
        if pkg == "reference":
            slabs.append(ref_part.pack_slabs(gs, rp))
        else:
            s = port_part.pack_slabs(_port(gs), pp)
            slabs.append({k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                          else v for k, v in s.items()})
        n_rows.append(gs.n_rows)
        n_cols.append(gs.n_cols)
    b_live = sum(s["colidx"].shape[0] for s in slabs)
    batch = ref_b if pkg == "reference" else port_b
    merged = batch.batch_graph_slabs(slabs, n_rows, n_cols,
                                     pad_blocks_to=2 * b_live)[0]
    assert merged["colidx"].shape[0] == 2 * b_live
    assert _assert_row_runs(merged) >= b_live


def _order_pinning_block():
    colidx = np.array([[5, 1, 6, 0]], dtype=np.int32)
    values = np.array([[1.0, 2.0 ** 24, -2.0 ** 24, 0.0]], dtype=np.float32)
    rowloc = np.zeros((1, 4), dtype=np.int32)
    out_row = np.zeros((1, 1), dtype=np.int32)
    return colidx, values, rowloc, out_row


@pytest.mark.parametrize("F", [1, 100])
def test_window_order_pinned(F):
    slabs = _order_pinning_block()
    x = np.ones((8, F), dtype=np.float32)
    ref = np.asarray(ref_k2(*slabs, x, 1, window_rows=4, f_tile=128))
    args = [torch.from_numpy(a) for a in (*slabs, x)]
    port = port_k.spmm_block_slabs_windowed(*args, 1, window_rows=4)
    slot_order = port_k.spmm_block_slabs_plain(*args, 1)
    np.testing.assert_array_equal(ref, np.ones((1, F), np.float32))
    assert torch.equal(port, torch.ones((1, F)))
    assert torch.equal(slot_order, torch.zeros((1, F)))


@pytest.mark.parametrize("F,offset,f_tile,instance", [
    (2048, 0, 128, "bulk"), (100, 0, 128, "bulk"), (4, 0, 128, "bulk"),
    (1, 0, 128, "cp_async"), (77, 0, 128, "cp_async"),
    (2048, 1, 128, "cp_async"), (2048, 4, 128, "bulk"),
    (2048, 0, 992, "bulk"), (2048, 0, 1024, "cp_async")])
def test_gather_instance_choice(F, offset, f_tile, instance):
    """bulk needs every row segment on 16 bytes: F % 4 == 0 and a 16-byte
    aligned base (an offset of 4 floats keeps it), and f_tile consumer
    threads plus the producer warp within 1024."""
    base = torch.empty(16 * F + 16)
    shift = (-base.data_ptr() // 4) % 4 + offset      # floats to the boundary
    x = base[shift:shift + 8 * F].view(8, F)
    assert x.is_contiguous()
    assert port_k.gather_instance(x, f_tile) == instance
