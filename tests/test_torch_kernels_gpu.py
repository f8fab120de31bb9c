"""K1, K2, K3 and K4 on the card against their plain versions (needs a
CUDA device).

Run on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

This file imports neither JAX nor the reference package, so it also runs
where only PyTorch is installed. Integer-valued graphs make every sum exact
in fp32: each kernel must equal its plain version bit for bit. On
normalized graphs two fp32 results may differ by twice the summation bound
``k * 2**-24 * (|A| @ |x|)``, ``k = min(deg, C) + ceil(deg / C) + 1`` per
row, plus ``num_windows`` for K2. K2's window order is pinned by blocks
whose rows come out exactly 1 only if each row adds its window partials in
window order (slot order gives 0), held bit for bit against the plain
version on the CPU (``index_add_`` on the card has no fixed order). K1
runs at every f_tile its wrapper can pick (each multiple of 32 up to
``K1_F_TILE``), and at the tile ``k1_f_tile`` picks equals itself at
``K1_F_TILE`` bit for bit; each K1 case and each K1/K2/K3
gather-instance case asserts which instance ran. K4's sums of K products are each within
``(K + 1) * 2**-24 * (|x| @ |w|)`` of the exact product (fmaf in order in
the simt instance, the tensor cores' order in the wgmma instance, any
order in the plain version), so the two differ by at most twice that;
integer inputs with |x|, |w| <= 2 keep every partial sum below 2**24, so
every sum is exact in any order. Each K4 case asserts which instance ran.

Training and mutation run K1 (and K3) on plans the serving path does not
make: ``GraphOp``'s backward launches K1 on the A'^T plan (exact against
the plain version and the transpose's CSR product on integer graphs, and
a two-layer GCN's loss and gradients within a stated bound of the twin's),
and repaired and chain-repaired plans (masked lanes, appended blocks)
through K1 and K3 must equal a fresh build's output bit for bit on
integer graphs.

Slice E runs K1, K2 and K3 on every slab shape the partition tuner can
promote (the candidates of the tpu default and of paper (12, 32)), exact
on integer graphs with split rows; an engine with a forced-win tuner
promotes on the card with its shadows on a stream of their own; and a
2-hop full-fanout sampled aggregation through ``auto`` is exact.

Slice F runs the sharded SpMM on slots of one card, each share on its own
CUDA stream through K1, K2 or K3 (exact against the plain version on
integer graphs, one launch per slot), and a ``FleetGraphEngine`` over
four slots of one card (single, feature- and block-sharded dispatches and
a ``mutate()``, exact, with K1's launches equal to the per-slot routed
count).

Slice G runs ``serve_global`` in two processes of two slots each on the one
card (``run_fleet``, gloo): the global shares through K1 under ``accel``
and K3 under ``auto``, the answer equal bit for bit to the single-process
``spmm_block_sharded`` over four slots of the card and to the plain
version, each worker's launches equal to its per-slot routed counts.
"""
import json
import os
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.core.graph import CSRGraph, csr_transpose, gcn_normalize
from repro_torch.core.plan_cache import PartitionConfig, build_partition_plan
from repro_torch.core.plan_repair import EdgeDelta, apply_and_repair
from repro_torch.data.graphs import make_power_law_graph
from repro_torch.kernels.spmm_accel import (K1_F_TILE, gather_instance,
                                            k1_f_tile, spmm_block_slabs,
                                            spmm_block_slabs_plain,
                                            spmm_block_slabs_windowed,
                                            spmm_block_slabs_windowed_plain)
from repro_torch.kernels.spmm_batched import batch_graph_slabs, bucket_blocks
from repro_torch.kernels.grouped_matmul import (_instance, grouped_matmul,
                                                grouped_matmul_plain)
from repro_torch.kernels.spmm_hbm import (spmm_block_slabs_hbm,
                                          spmm_block_slabs_hbm_plain)
from repro_torch.kernels.ops import spmm_accel, spmm_pallas_hbm
from repro_torch.models.gcn import (GraphOp, gcn_loss, init_gcn,
                                    transform_first)
from repro_torch.models.moe import _route, block_dispatch, init_moe, moe_block
from repro_torch.serve import GraphServeEngine
from repro_torch.tuning import PlanTuner, default_candidates

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _edge_graph(C, seed):
    rng = np.random.default_rng(seed)
    deg = np.concatenate([[0] * 4, [C] * 2, [C + 1], [3 * C + 7],
                          rng.integers(1, 40, 200)])
    rng.shuffle(deg)
    rowptr = np.zeros(len(deg) + 1, dtype=np.int64)
    np.cumsum(deg, out=rowptr[1:])
    nnz = int(rowptr[-1])
    return CSRGraph(rowptr, rng.integers(0, len(deg), nnz),
                    rng.integers(1, 4, nnz).astype(np.float32), len(deg))


def _args(slabs):
    return (slabs["colidx"], slabs["values"], slabs["rowloc"],
            slabs["out_row"])


# every f_tile K1's wrapper can pick
K1_TILES = list(range(32, K1_F_TILE + 1, 32))


def _view(n, F, offset, cuda):
    """An [n, F] view ``offset`` floats past a 256-byte aligned base."""
    base = torch.empty(n * F + offset, device=cuda)
    return base[offset:].view(n, F)


def _k1_on(args, x, n_rows, f_tile):
    """K1's output, asserting that it launched once, in the instance
    ``gather_instance`` picks for x and the tile, at the caller's f_tile
    or, for None, at ``k1_f_tile(F)``."""
    tile = k1_f_tile(x.shape[1]) if f_tile is None else f_tile
    instance = gather_instance(x, tile)
    before = spmm_block_slabs.launches
    by_instance = dict(spmm_block_slabs.launches_by_instance)
    by_tile = dict(spmm_block_slabs.launches_by_f_tile)
    got = spmm_block_slabs(*args, x, n_rows, f_tile=f_tile)
    torch.cuda.synchronize()
    by_instance[instance] += 1
    by_tile[tile] = by_tile.get(tile, 0) + 1
    assert spmm_block_slabs.launches == before + 1
    assert spmm_block_slabs.launches_by_instance == by_instance
    assert spmm_block_slabs.launches_by_f_tile == by_tile
    return got


@pytest.mark.parametrize("mode,mbw,mwn", [("tpu", 64, 4), ("paper", 12, 32)])
@pytest.mark.parametrize("F", [1, 100, 2048])
@pytest.mark.parametrize("f_tile", K1_TILES)
@pytest.mark.parametrize("offset", [0, 1])
def test_k1_equals_plain_on_integer_graphs(cuda, mode, mbw, mwn, F, f_tile,
                                           offset):
    """Split rows, at every f_tile; offset 1 puts x 4 bytes off a 16-byte
    boundary, which takes the cp_async instance (as F = 1 does)."""
    cfg = PartitionConfig(mode, mbw, mwn)
    g = _edge_graph(cfg.deg_bound, seed=F)
    plan = build_partition_plan(g, cfg, device=cuda)
    assert plan.partition.is_split.any()
    gen = torch.Generator(device=cuda).manual_seed(F)
    x = _view(g.n_cols, F, offset, cuda)
    x.copy_(torch.randint(-4, 5, (g.n_cols, F), generator=gen, device=cuda))
    assert gather_instance(x, f_tile) == (
        "bulk" if F % 4 == 0 and offset == 0 else "cp_async")
    got = _k1_on(_args(plan.slabs), x, g.n_rows, f_tile)
    assert torch.equal(got, spmm_block_slabs_plain(*_args(plan.slabs), x,
                                                   g.n_rows))


@pytest.mark.parametrize("mode,mbw,mwn", [("tpu", 64, 4), ("paper", 12, 32)])
@pytest.mark.parametrize("F", [1, 33, 40, 41, 47, 65, 100, 129, 256])
@pytest.mark.parametrize("offset", [0, 1])
def test_k1_rule_tile_equals_widest_tile_bit_for_bit(cuda, mode, mbw, mwn, F,
                                                     offset):
    """K1 at the tile ``k1_f_tile(F)`` picks equals K1 at f_tile 256 bit
    for bit on integer graphs with split rows, in both gather instances
    (offset 1, or F % 4 != 0: cp_async), and its launch is counted at the
    picked tile."""
    cfg = PartitionConfig(mode, mbw, mwn)
    g = _edge_graph(cfg.deg_bound, seed=F + offset)
    plan = build_partition_plan(g, cfg, device=cuda)
    assert plan.partition.is_split.any()
    gen = torch.Generator(device=cuda).manual_seed(F)
    x = _view(g.n_cols, F, offset, cuda)
    x.copy_(torch.randint(-4, 5, (g.n_cols, F), generator=gen, device=cuda))
    got = _k1_on(_args(plan.slabs), x, g.n_rows, None)
    want = _k1_on(_args(plan.slabs), x, g.n_rows, K1_F_TILE)
    assert torch.equal(got, want)


@pytest.mark.parametrize("f_tile", K1_TILES)
@pytest.mark.parametrize("F", [77, 2048])
def test_k1_equals_plain_on_merged_slabs_with_padding_blocks(cuda, f_tile, F):
    plans, n_cols = [], []
    for cfg in (PartitionConfig("tpu", 64, 4), PartitionConfig("paper", 12, 32)):
        g = _edge_graph(cfg.deg_bound, seed=cfg.deg_bound)
        plans.append(build_partition_plan(g, cfg, device=cuda))
        n_cols.append(g.n_cols)
    b_total = sum(p.num_blocks for p in plans)
    merged, _, _, n_out = batch_graph_slabs(
        [p.slabs for p in plans], [p.n_rows for p in plans], n_cols,
        pad_blocks_to=2 * bucket_blocks(b_total))
    x = torch.randint(-4, 5, (sum(n_cols), F), device=cuda).float()
    got = _k1_on(_args(merged), x, n_out, f_tile)
    assert torch.equal(got, spmm_block_slabs_plain(*_args(merged), x, n_out))


@pytest.mark.parametrize("f_tile", K1_TILES)
def test_k1_normalized_graph_within_summation_bound(cuda, f_tile):
    """fp32 sums in different orders: |K1 - plain| <= 2 k u (|A| @ |x|) with
    k = min(deg, C) + ceil(deg / C) + 1 per row."""
    cfg = PartitionConfig()
    g = gcn_normalize(make_power_law_graph(3000, 60000, seed=3))
    plan = build_partition_plan(g, cfg, device=cuda)
    x = torch.randn(g.n_cols, 256, device=cuda)
    args = _args(plan.slabs)
    got = _k1_on(args, x, g.n_rows, f_tile)
    want = spmm_block_slabs_plain(*args, x, g.n_rows)
    mag = spmm_block_slabs_plain(args[0], args[1].abs(), args[2], args[3],
                                 x.abs(), g.n_rows).double()
    deg = np.sort(np.diff(g.rowptr), kind="stable")     # degree-sorted order
    k = np.minimum(deg, cfg.deg_bound) + -(-deg // cfg.deg_bound) + 1
    bound = 2 * 2.0 ** -24 * torch.as_tensor(k, device=cuda)[:, None] * mag
    assert torch.all((got.double() - want.double()).abs() <= bound)


# K2 at three window heights (window_rows) and K3 (None)
ROUTED = {"windowed_4096": 4096, "windowed_80": 80, "windowed_33": 33,
          "hbm": None}


def _routed(kernel, n_cols):
    """(kernel, plain version, keyword arguments, summation levels the
    kernel adds over K1: one per row window for K2); "resident" is K1."""
    if kernel == "resident":
        return spmm_block_slabs, spmm_block_slabs_plain, {}, 0
    window = ROUTED[kernel]
    if window is None:
        return spmm_block_slabs_hbm, spmm_block_slabs_hbm_plain, {}, 0

    def plain(*args):
        return spmm_block_slabs_windowed_plain(*args, window)
    return (spmm_block_slabs_windowed, plain, {"window_rows": window},
            -(-n_cols // window))


@pytest.mark.parametrize("kernel", sorted(ROUTED))
@pytest.mark.parametrize("mode,mbw,mwn", [("tpu", 64, 4), ("paper", 12, 32)])
@pytest.mark.parametrize("F", [1, 100, 2048])
def test_routed_kernels_equal_plain_on_integer_graphs(cuda, kernel, mode,
                                                      mbw, mwn, F):
    cfg = PartitionConfig(mode, mbw, mwn)
    g = _edge_graph(cfg.deg_bound, seed=F)
    fn, plain, kw, _ = _routed(kernel, g.n_cols)
    plan = build_partition_plan(g, cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(F)
    x = torch.randint(-4, 5, (g.n_cols, F), generator=gen, device=cuda).float()
    before = fn.launches
    got = fn(*_args(plan.slabs), x, g.n_rows, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, plain(*_args(plan.slabs), x, g.n_rows))


@pytest.mark.parametrize("kernel", sorted(ROUTED))
def test_routed_kernels_on_merged_slabs_with_padding_blocks(cuda, kernel):
    plans, n_cols = [], []
    for cfg in (PartitionConfig("tpu", 64, 4), PartitionConfig("paper", 12, 32)):
        g = _edge_graph(cfg.deg_bound, seed=cfg.deg_bound)
        plans.append(build_partition_plan(g, cfg, device=cuda))
        n_cols.append(g.n_cols)
    b_total = sum(p.num_blocks for p in plans)
    merged, _, _, n_out = batch_graph_slabs(
        [p.slabs for p in plans], [p.n_rows for p in plans], n_cols,
        pad_blocks_to=2 * bucket_blocks(b_total))
    fn, plain, kw, _ = _routed(kernel, sum(n_cols))
    x = torch.randint(-4, 5, (sum(n_cols), 77), device=cuda).float()
    before = fn.launches
    got = fn(*_args(merged), x, n_out, **kw)
    assert fn.launches == before + 1
    assert torch.equal(got, plain(*_args(merged), x, n_out))


@pytest.mark.parametrize("kernel", sorted(ROUTED))
def test_routed_kernels_normalized_graph_within_summation_bound(cuda, kernel):
    cfg = PartitionConfig()
    g = gcn_normalize(make_power_law_graph(3000, 60000, seed=3))
    fn, plain, kw, levels = _routed(kernel, g.n_cols)
    plan = build_partition_plan(g, cfg, device=cuda)
    x = torch.randn(g.n_cols, 256, device=cuda)
    args = _args(plan.slabs)
    got = fn(*args, x, g.n_rows, **kw)
    want = plain(*args, x, g.n_rows)
    mag = spmm_block_slabs_plain(args[0], args[1].abs(), args[2], args[3],
                                 x.abs(), g.n_rows).double()
    deg = np.sort(np.diff(g.rowptr), kind="stable")     # degree-sorted order
    k = np.minimum(deg, cfg.deg_bound) + -(-deg // cfg.deg_bound) + 1 + levels
    bound = 2 * 2.0 ** -24 * torch.as_tensor(k, device=cuda)[:, None] * mag
    assert torch.all((got.double() - want.double()).abs() <= bound)


def _pinning_block(n_rows, window, seed):
    """One block of ``n_rows`` local rows, each summing +1 at a column of a
    higher window, +2**24 at a column of a lower window, then -2**24 in
    the higher window, over x = 1: window order gives exactly 1 per row,
    slot order 0. Slots are in row runs, windows out of order."""
    rng = np.random.default_rng(seed)
    n_x = 64 * window
    lo = rng.integers(0, 32, n_rows) * window + rng.integers(0, window, n_rows)
    hi = rng.integers(32, 64, n_rows) * window
    cols = np.stack([hi + rng.integers(0, window, n_rows), lo,
                     hi + rng.integers(0, window, n_rows)], axis=1)
    vals = np.tile(np.float32([1.0, 2.0 ** 24, -2.0 ** 24]), (n_rows, 1))
    C = 3 * n_rows + 5                                 # 5 padding slots
    colidx = np.zeros((1, C), np.int32)
    values = np.zeros((1, C), np.float32)
    rowloc = np.full((1, C), n_rows - 1, np.int32)
    colidx[0, :3 * n_rows] = cols.reshape(-1)
    values[0, :3 * n_rows] = vals.reshape(-1)
    rowloc[0, :3 * n_rows] = np.repeat(np.arange(n_rows), 3)
    out_row = np.arange(n_rows, dtype=np.int32)[None, :]
    return [torch.from_numpy(a) for a in (colidx, values, rowloc, out_row)], n_x


@pytest.mark.parametrize("n_rows,window", [(1, 4), (50, 1), (50, 33)])
@pytest.mark.parametrize("F", [1, 100, 2048])
def test_k2_window_order_pinned(cuda, n_rows, window, F):
    slabs, n_x = _pinning_block(n_rows, window, seed=n_rows + F)
    x = torch.ones((n_x, F))
    want = spmm_block_slabs_windowed_plain(*slabs, x, n_rows, window)
    assert torch.equal(want, torch.ones((n_rows, F)))
    got = spmm_block_slabs_windowed(*[t.to(cuda) for t in slabs], x.to(cuda),
                                    n_rows, window_rows=window)
    assert torch.equal(got.cpu(), want)


# x layouts (F, offset in floats from a 256-byte aligned allocation),
# f_tile, and the gather instance K1, K2 and K3 must take for each
INSTANCE_CASES = {"F1": (1, 0, 128, "cp_async"),
                  "F77": (77, 0, 128, "cp_async"),
                  "F100": (100, 0, 128, "bulk"),
                  "F2048": (2048, 0, 128, "bulk"),
                  "F2048_unaligned": (2048, 1, 128, "cp_async"),
                  "F2048_ftile992": (2048, 0, 992, "bulk"),
                  "F2048_ftile1024": (2048, 0, 1024, "cp_async")}


@pytest.mark.parametrize("kernel", ["windowed_80", "hbm", "resident"])
@pytest.mark.parametrize("case", sorted(INSTANCE_CASES))
def test_routed_kernels_gather_instances(cuda, kernel, case):
    F, offset, f_tile, instance = INSTANCE_CASES[case]
    cfg = PartitionConfig("tpu", 64, 4)
    g = _edge_graph(cfg.deg_bound, seed=F + offset)
    fn, plain, kw, _ = _routed(kernel, g.n_cols)
    plan = build_partition_plan(g, cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(F)
    x = _view(g.n_cols, F, offset, cuda)
    x.copy_(torch.randint(-4, 5, (g.n_cols, F), generator=gen, device=cuda))
    assert gather_instance(x, f_tile) == instance
    before = dict(fn.launches_by_instance)
    got = fn(*_args(plan.slabs), x, g.n_rows, f_tile=f_tile, **kw)
    torch.cuda.synchronize()
    before[instance] += 1
    assert fn.launches_by_instance == before
    assert torch.equal(got, plain(*_args(plan.slabs), x, g.n_rows))


# K4 edge cases: rows per expert in blocks (0 = an expert with no rows),
# trailing blocks past the last expert (clipped to E-1, zero rows), m_tile.
# chip_smoke.py keeps its own copy: it imports nothing of the tests.
K4_CASES = {
    "empty_expert": ([2, 0, 1, 3], 0, 16),
    "single_expert": ([4], 0, 16),
    "trailing_blocks": ([1, 2, 0], 3, 8),
    "m_tile_128": ([2, 1, 0, 1], 1, 128),
    "m_tile_160": ([1, 0, 2], 1, 160),
}
K4_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _k4_inputs(case, K, N, xd, wd, integer, cuda, seed=0):
    blocks, trailing, m_tile = K4_CASES[case]
    return _k4_blocks(blocks, trailing, m_tile, K, N, xd, wd, integer, cuda,
                      seed)


def _k4_blocks(blocks, trailing, m_tile, K, N, xd, wd, integer, cuda, seed):
    """x, w and block_expert for ``blocks[e]`` row blocks of expert e, then
    ``trailing`` zero-row blocks clipped to expert E-1."""
    E = len(blocks)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    be = torch.cat([torch.arange(E, device=cuda).repeat_interleave(
        torch.tensor(blocks, device=cuda)),
        torch.full((trailing,), E - 1, device=cuda)]).to(torch.int32)
    M = be.numel() * m_tile
    if integer:
        x = torch.randint(-2, 3, (M, K), generator=gen, device=cuda).float()
        w = torch.randint(-2, 3, (E, K, N), generator=gen, device=cuda).float()
    else:
        x = torch.randn((M, K), generator=gen, device=cuda)
        w = torch.randn((E, K, N), generator=gen, device=cuda)
    x[M - trailing * m_tile:] = 0
    return x.to(K4_DTYPES[xd]), w.to(K4_DTYPES[wd]), be, m_tile


@pytest.mark.parametrize("case", sorted(K4_CASES))
@pytest.mark.parametrize("xd", sorted(K4_DTYPES))
@pytest.mark.parametrize("wd", sorted(K4_DTYPES))
def test_k4_equals_plain_on_integer_inputs(cuda, case, xd, wd):
    """K=99 and N=301: neither a multiple of 4 nor of the CTA tiles (the
    reference's tiles are set to the whole K and N so it takes them)."""
    K, N = 99, 301
    x, w, be, m_tile = _k4_inputs(case, K, N, xd, wd, True, cuda)
    before = grouped_matmul.launches
    got = _k4_on(x, w, be, m_tile, "simt", k_tile=K, n_tile=N)
    torch.cuda.synchronize()
    assert grouped_matmul.launches == before + 1
    assert torch.equal(got, grouped_matmul_plain(x, w, be, m_tile))


def _k4_on(x, w, be, m_tile, instance, **tiles):
    """K4's output, asserting that ``instance`` launched it once."""
    assert _instance(x, w, m_tile) == instance
    before = grouped_matmul.launches_by_instance[instance]
    got = grouped_matmul(x, w, be, m_tile=m_tile, **tiles)
    assert grouped_matmul.launches_by_instance[instance] == before + 1
    return got


def _k4_within_pair_bound(x, w, be, m_tile, instance, **tiles):
    """K4's output, asserted within twice the summation bound of the plain
    version's on the same operands."""
    K = x.shape[1]
    got = _k4_on(x, w, be, m_tile, instance, **tiles)
    want = grouped_matmul_plain(x, w, be, m_tile)
    mag = grouped_matmul_plain(x.abs(), w.abs(), be, m_tile).double()
    bound = 2 * (K + 1) * 2.0 ** -24 * mag
    assert torch.all((got.double() - want.double()).abs() <= bound)
    return got


@pytest.mark.parametrize("case", sorted(K4_CASES))
@pytest.mark.parametrize("xd", sorted(K4_DTYPES))
@pytest.mark.parametrize("wd", sorted(K4_DTYPES))
def test_k4_float_inputs_within_summation_bound(cuda, case, xd, wd):
    K, N = 512, 258
    x, w, be, m_tile = _k4_inputs(case, K, N, xd, wd, False, cuda, seed=1)
    _k4_within_pair_bound(x, w, be, m_tile, "simt", n_tile=N)


# The wgmma instance: rows per expert in blocks and trailing clipped blocks.
K4_WGMMA_CASES = {
    "empty_expert": ([2, 0, 1, 3], 0),
    "single_expert": ([3], 0),
    "trailing_blocks": ([1, 2, 0], 3),
}


@pytest.mark.parametrize("case", sorted(K4_WGMMA_CASES))
@pytest.mark.parametrize("m_tile", [64, 128, 192, 256])
@pytest.mark.parametrize("K,N", [(512, 256), (520, 264)])
@pytest.mark.parametrize("integer", [True, False])
def test_k4_wgmma_equals_plain(cuda, case, m_tile, K, N, integer):
    """bf16 x bf16 through the tensor cores: exact on integers, within the
    pair bound on floats. K = 520 ends in an 8-deep K tile and N = 264 in
    an 8-wide column tile; m_tile 64 and 192 end blocks inside a 128-row
    CTA tile."""
    blocks, trailing = K4_WGMMA_CASES[case]
    x, w, be, _ = _k4_blocks(blocks, trailing, m_tile, K, N, "bf16", "bf16",
                             integer, cuda, seed=2)
    if integer:
        got = _k4_on(x, w, be, m_tile, "wgmma", k_tile=K, n_tile=N)
        assert torch.equal(got, grouped_matmul_plain(x, w, be, m_tile))
    else:
        _k4_within_pair_bound(x, w, be, m_tile, "wgmma", k_tile=K, n_tile=N)


@pytest.mark.parametrize("m_tile", [64, 128])
@pytest.mark.parametrize("poison", [float("nan"), float("inf")])
def test_k4_wgmma_reads_only_its_experts_weights(cuda, m_tile, poison):
    """Expert 1's blocks alone are multiplied while experts 0 and 2 hold
    NaN or Inf. K = 520: the last K tile reaches 56 rows past expert 1's
    weights, which a map over E * K rows would read from expert 2 and
    0 * NaN would carry into the output. It must be finite and exact."""
    x, w, be, _ = _k4_blocks([0, 3, 0], 0, m_tile, 520, 264, "bf16", "bf16",
                             True, cuda, seed=3)
    w[2] = poison
    w[0] = poison
    got = _k4_on(x, w, be, m_tile, "wgmma", k_tile=520, n_tile=264)
    assert bool(torch.isfinite(got).all())
    want = x.float() @ w[1].float()
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", [-1, 4])
def test_k4_refuses_expert_ids_out_of_range(cuda, bad):
    x, w, be, m_tile = _k4_inputs("empty_expert", 64, 64, "f32", "f32",
                                  True, cuda)
    be[1] = bad
    before = grouped_matmul.launches
    with pytest.raises(ValueError, match="outside"):
        grouped_matmul(x, w, be, m_tile=m_tile)
    assert grouped_matmul.launches == before


@pytest.mark.parametrize("m_tile,instance", [(16, "simt"), (64, "wgmma")])
def test_moe_block_launches_k4_three_times(cuda, m_tile, instance):
    """K4 carries the three products of moe_block on the card (the twin
    launches no kernel), all three through the instance that m_tile picks
    (d_model 64 and d_ff 96 are multiples of 8); each product, rebuilt from
    the dispatch, is within the pair bound of its plain version on the same
    operands."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = init_moe(gen, 64, 96, 4, dtype=torch.bfloat16, device=cuda)
    x = torch.randn((2, 40, 64), generator=gen, device=cuda).bfloat16()
    before = grouped_matmul.launches
    on = grouped_matmul.launches_by_instance[instance]
    y, aux = moe_block(p, x, top_k=2, n_experts=4, m_tile=m_tile)
    assert grouped_matmul.launches == before + 3
    assert grouped_matmul.launches_by_instance[instance] == on + 3
    y2, aux2 = moe_block(p, x, top_k=2, n_experts=4, m_tile=m_tile,
                         use_pallas=False)
    assert grouped_matmul.launches == before + 3
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())
    assert float(aux) == float(aux2)
    xt = x.reshape(-1, 64)
    meta = block_dispatch(_route(p, xt, 2, True)[1], 4, m_tile)
    xs = torch.zeros((meta["M"], 64), dtype=x.dtype, device=cuda)
    xs[meta["dst"]] = xt[meta["order"] // 2]
    be = meta["block_expert"]
    h = _k4_within_pair_bound(xs, p["wi"], be, m_tile, instance).to(x.dtype)
    g = _k4_within_pair_bound(xs, p["wg"], be, m_tile, instance).to(x.dtype)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * h
    _k4_within_pair_bound(h, p["wo"], be, m_tile, instance)


# ------------------------------------------------- training and mutation

def _dense(g, cuda):
    a = torch.zeros((g.n_rows, g.n_cols), dtype=torch.float64, device=cuda)
    rows = torch.from_numpy(np.repeat(np.arange(g.n_rows), np.diff(g.rowptr)))
    a.index_put_((rows.to(cuda), torch.from_numpy(g.colidx).to(cuda)),
                 torch.from_numpy(g.values.astype(np.float64)).to(cuda),
                 accumulate=True)
    return a


@pytest.mark.parametrize("F", [1, 100, 2048])
def test_graph_op_backward_is_k1_on_the_transpose(cuda, F):
    """An integer-valued directed graph with split rows in both A and A^T:
    the gradient of ``sum(A @ x * g)`` is A^T @ g, launched as K1 on the
    transpose's plan, bit for bit equal to the plain version and to the
    dense fp64 product."""
    g = _edge_graph(256, seed=F)
    # a third of the edges into column 0: an in-degree hub, split in A^T
    hub = np.random.default_rng(F).random(g.nnz) < 0.3
    g = CSRGraph(g.rowptr, np.where(hub, 0, g.colidx), g.values, g.n_cols)
    op = GraphOp.build(g, device=cuda)
    assert op.fwd.plan.partition.is_split.any()
    assert op.bwd.plan.partition.is_split.any()
    gen = torch.Generator(device=cuda).manual_seed(F)
    x = torch.randint(-4, 5, (g.n_cols, F), generator=gen,
                      device=cuda).float().requires_grad_()
    up = torch.randint(-4, 5, (g.n_rows, F), generator=gen,
                       device=cuda).float()
    before = spmm_block_slabs.launches
    y = op(x)
    assert spmm_block_slabs.launches == before + 1
    y.backward(up)
    torch.cuda.synchronize()
    assert spmm_block_slabs.launches == before + 2
    s = op.bwd.plan.slabs
    plain = spmm_block_slabs_plain(*_args(s), up, g.n_cols)[op.bwd.inv_perm]
    assert torch.equal(x.grad, plain)
    assert torch.equal(x.grad.double(), _dense(g, cuda).T @ up.double())
    assert torch.equal(y, spmm_block_slabs_plain(
        *_args(op.fwd.slabs), x.detach(), g.n_rows)[op.fwd.inv_perm])
    gt = csr_transpose(g)
    assert op.bwd.plan.nnz == gt.nnz and op.bwd.n_rows == g.n_cols


@pytest.mark.parametrize("variant", ["gcn", "sage", "gin"])
def test_gcn_gradients_k1_against_the_twin(cuda, variant):
    """Loss and every gradient of a 3-layer GCN on a directed normalized
    graph, K1 (``accel``) against the twin (``blocked``) from the same
    parameters: the two differ only in the order of fp32 sums, held to
    ``1e-4 * max|grad|`` per parameter (the aggregations' pair bound,
    ``2 * (C + 2) * 2**-24`` relative, over 3 layers forward and back with
    margin)."""
    g = gcn_normalize(make_power_law_graph(3000, 30000, seed=5))
    dims = [32, 64, 64, 8]
    x = torch.randn((g.n_rows, dims[0]), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    y = torch.randint(0, dims[-1], (g.n_rows,), device=cuda)
    base = init_gcn(torch.Generator().manual_seed(0), dims, variant,
                    device=cuda)
    out = {}
    for backend in ("accel", "blocked"):
        op = GraphOp.build(g, backend=backend, device=cuda)
        params = [{k: t.clone().requires_grad_() for k, t in p.items()}
                  for p in base]
        before = spmm_block_slabs.launches
        loss = gcn_loss(params, op, x, y, variant)
        loss.backward()
        torch.cuda.synchronize()
        launched = spmm_block_slabs.launches - before
        layers = len(dims) - 1
        # a backward aggregation for every layer but one that aggregates
        # its raw features (``transform_first``; gin always does)
        want = layers + sum(
            i > 0 or (variant != "gin" and transform_first(
                variant, a, b, i > 0, True))
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])))
        assert launched == (want if backend == "accel" else 0)
        out[backend] = (float(loss.detach()),
                        [{k: t.grad for k, t in p.items()} for p in params])
    (la, ga), (lb, gb) = out["accel"], out["blocked"]
    assert abs(la - lb) <= 1e-5 * abs(lb)
    for pa, pb in zip(ga, gb):
        for k in pb:
            tol = 1e-4 * float(pb[k].abs().max()) + 1e-9
            assert float((pa[k] - pb[k]).abs().max()) <= tol, k


@pytest.mark.parametrize("mode,mbw,mwn", [("tpu", 64, 4), ("paper", 12, 32)])
@pytest.mark.parametrize("F", [100, 2048])
def test_repaired_plans_through_k1_and_k3_equal_fresh_build(cuda, mode, mbw,
                                                            mwn, F):
    """A chain of three repairs of an integer-valued graph with split rows
    (mixed inserts and deletes, inserts into the hub, a row emptied): after
    each, K1 and K3 on the repaired plan equal K1 and K3 on a fresh build
    of the post-delta graph and the dense fp64 product, bit for bit."""
    cfg = PartitionConfig(mode, mbw, mwn)
    g = _edge_graph(cfg.deg_bound, seed=F + mbw)
    plan = build_partition_plan(g, cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(F)
    x = torch.randint(-4, 5, (g.n_cols, F), generator=gen,
                      device=cuda).float()
    rng = np.random.default_rng(F)
    for step in range(3):
        deg = np.diff(g.rowptr)
        if step == 0:
            eids = rng.choice(g.nnz, 40, replace=False)
            kw = dict(insert_src=rng.integers(0, g.n_rows, 40),
                      insert_dst=rng.integers(0, g.n_cols, 40),
                      insert_val=rng.integers(1, 4, 40).astype(np.float32),
                      delete_src=np.searchsorted(g.rowptr, eids,
                                                 side="right") - 1,
                      delete_dst=g.colidx[eids],
                      on_duplicate="replace", on_missing="ignore")
        elif step == 1:
            hub = int(np.argmax(deg))
            kw = dict(insert_src=[hub] * 5, insert_dst=np.arange(5),
                      on_duplicate="replace")
        else:
            r = int(np.flatnonzero(deg > 0)[0])
            kw = dict(delete_src=[r] * int(deg[r]),
                      delete_dst=g.colidx[g.rowptr[r]:g.rowptr[r + 1]])
        g, pv = apply_and_repair(plan, g, EdgeDelta(**kw),
                                 churn_threshold=1.0)
        assert pv.repaired, pv.reason
        plan = pv.plan
        fresh = build_partition_plan(g, cfg, device=cuda)
        dense = _dense(g, cuda) @ x.double()
        k1_before = spmm_block_slabs.launches
        k3_before = spmm_block_slabs_hbm.launches
        for fn in (spmm_accel, spmm_pallas_hbm):
            got = fn(plan.slabs, x, plan.n_rows)[plan.inv_perm]
            want = fn(fresh.slabs, x, fresh.n_rows)[fresh.inv_perm]
            torch.cuda.synchronize()
            assert torch.equal(got, want), (step, fn.__name__)
            assert torch.equal(got.double(), dense), (step, fn.__name__)
        assert spmm_block_slabs.launches == k1_before + 2
        assert spmm_block_slabs_hbm.launches == k3_before + 2


# ---------------------------------------------------------------- slice E
# every slab shape the tuner can promote: the candidates of both bases
CANDIDATES = {f"{base.mode}{base.max_block_warps}x{base.max_warp_nzs}-"
              f"{c.label}": c.config
              for base in (PartitionConfig(), PartitionConfig("paper", 12, 32))
              for c in default_candidates(base)}


@pytest.mark.parametrize("name", sorted(CANDIDATES))
@pytest.mark.parametrize("kernel", ["resident", "windowed_80", "hbm"])
@pytest.mark.parametrize("F", [100, 2048])
def test_candidate_slab_shapes_equal_plain_on_integer_graphs(cuda, name,
                                                             kernel, F):
    """K1, K2 and K3 on every candidate's (C, R, warp_nzs table): split
    rows, partly filled warps (dead slots between live ones), exact."""
    cfg = CANDIDATES[name]
    g = _edge_graph(cfg.deg_bound, seed=F + cfg.deg_bound)
    plan = build_partition_plan(g, cfg, device=cuda)
    assert plan.partition.is_split.any()
    assert plan.slabs["C"] == cfg.deg_bound
    fn, plain, kw, _ = _routed(kernel, g.n_cols)
    gen = torch.Generator(device=cuda).manual_seed(F)
    x = torch.randint(-4, 5, (g.n_cols, F), generator=gen, device=cuda).float()
    before = fn.launches
    got = fn(*_args(plan.slabs), x, g.n_rows, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, plain(*_args(plan.slabs), x, g.n_rows))


def test_forced_promotion_on_the_card_shadows_on_their_own_stream(
        cuda, monkeypatch):
    """An ``accel`` engine whose tuner wins every comparison promotes its
    one candidate; every shadow dispatch ran on a stream other than the
    live one, K1 launched 5 times per shadow, and the answers before and
    after the promotion equal the fp64 product exactly (integer graph)."""
    import threading

    from repro_torch.serve import graph_engine as ge

    streams = {"live": set(), "shadow": set()}
    real = ge.spmm_batched

    def spy(*a, **kw):
        side = ("shadow" if threading.current_thread().name
                .startswith("plan-shadow") else "live")
        streams[side].add(torch.cuda.current_stream().cuda_stream)
        return real(*a, **kw)

    monkeypatch.setattr(ge, "spmm_batched", spy)
    g = _edge_graph(256, seed=5)
    x = torch.randint(-4, 5, (g.n_cols, 64), device=cuda).float()
    dense = _dense(g, cuda) @ x.double()
    cand = default_candidates(PartitionConfig())[0]
    engine = GraphServeEngine(device=cuda, backend="accel", tuner=PlanTuner(
        hot_rate=0.0, shadow_fraction=1.0, win_streak=2,
        min_improvement=-100.0, max_trials=4, candidates=[cand]))
    try:
        engine.register_graph("g", g)
        before = spmm_block_slabs.launches
        answers = []
        for _ in range(200):
            answers.append(engine.serve_one("g", x))
            if engine.stats()["tuned_promotions"]:
                break
            time.sleep(0.005)
        answers.append(engine.serve_one("g", x))
        engine.close()
        s = engine.stats()
        assert s["tuned_promotions"] == 1 and s["shadow_failures"] == 0
        plan = engine.plan_for("g")
        assert plan.tuned["label"] == cand.label and plan.version == 1
        assert plan.config == cand.config
        assert spmm_block_slabs.launches - before == \
            s["batches_dispatched"] + 5 * s["shadow_dispatches"]
        for y in answers:
            assert torch.equal(y.double(), dense)
        assert streams["shadow"] and not streams["shadow"] & streams["live"]
    finally:
        engine.close()


def test_sampled_two_hop_aggregate_through_auto_is_exact(cuda):
    """Full fanout, integer store: ``aggregate`` through ``auto`` equals
    the fp64 product (A^2 x) at the seeds, bit for bit."""
    from repro_torch.sampling import GraphStore, SamplingService

    g = _edge_graph(256, seed=9)
    store = GraphStore.build(g)
    engine = GraphServeEngine(device=cuda, backend="auto")
    try:
        svc = SamplingService(engine, store, [None, None], store=store)
        x = torch.randint(-4, 5, (g.n_rows, 128), device=cuda).float()
        seeds = np.array([3, 200, 17, 3, 150])
        got = svc.aggregate(seeds, x)
        a = _dense(store.in_adj, cuda)
        want = (a @ (a @ x.double()))[torch.as_tensor(seeds, device=cuda)]
        assert torch.equal(got.double(), want)
        assert engine.stats()["routed_resident"] == 2
    finally:
        engine.close()


# ---------------------------------------------------------------- slice F
def _int_csr(n, e, seed):
    g = make_power_law_graph(n, e, seed=seed)
    vals = np.random.default_rng(seed).integers(1, 4, g.nnz)
    return CSRGraph(g.rowptr, g.colidx, vals.astype(np.float32), g.n_cols)


_REGIME_KERNEL = {"resident": spmm_block_slabs,
                  "windowed": spmm_block_slabs_windowed,
                  "hbm": spmm_block_slabs_hbm}


@pytest.mark.parametrize("n_slots", [1, 4])
@pytest.mark.parametrize("regime", ["resident", "windowed", "hbm"])
@pytest.mark.parametrize("strategy", ["feature", "block"])
def test_sharded_spmm_on_slot_streams_is_exact(cuda, strategy, regime,
                                               n_slots):
    from repro_torch.distributed import (spmm_block_sharded,
                                         spmm_feature_sharded)
    g = _int_csr(6000, 40000, 3)          # > 4096 rows: K2 takes 2 windows
    plan = build_partition_plan(g, PartitionConfig(), device=cuda)
    x = torch.from_numpy(np.random.default_rng(1).integers(
        -4, 5, (g.n_cols, 258)).astype(np.float32))
    want = spmm_block_slabs_plain(
        *(plan.slabs[k].cpu() for k in ("colidx", "values", "rowloc",
                                        "out_row")), x, plan.n_rows)
    slots = [torch.device("cuda", 0)] * n_slots
    streams = [torch.cuda.Stream(d) for d in slots]
    kernel = _REGIME_KERNEL[regime]
    kernel.launches = 0
    if strategy == "feature":
        got = spmm_feature_sharded(plan.slabs, x.to(cuda), plan.n_rows, slots,
                                   regime=regime, streams=streams)
    else:
        got, live = spmm_block_sharded(plan.slabs, x.to(cuda), plan.n_rows,
                                       slots, regime=regime, streams=streams)
        assert int(live.sum()) == plan.num_blocks
    torch.cuda.synchronize()
    assert kernel.launches == n_slots
    assert torch.equal(got.cpu(), want)


def test_fleet_engine_on_four_slots_of_one_card(cuda):
    from repro_torch.serve import FleetGraphEngine
    slots = ["cuda:0"] * 4
    fleet = FleetGraphEngine(devices=slots, backend="accel",
                             replicate_hot=False)
    rng = np.random.default_rng(2)
    graphs = {f"g{i}": _int_csr(300 + 50 * i, 2000 + 100 * i, i)
              for i in range(5)}
    graphs["big"] = _int_csr(6000, 40000, 9)           # block-sharded
    widths = {gid: 16 for gid in graphs}
    widths["g0"] = 4 * 128                              # feature-sharded
    try:
        assert len({id(s) for s in fleet._streams}) == 4
        for gid, g in graphs.items():
            fleet.register_graph(gid, g)
        spmm_block_slabs.launches = 0
        for rnd in range(2):
            feats = {gid: torch.from_numpy(rng.integers(
                -4, 5, (g.n_cols, widths[gid])).astype(np.float32)).to(cuda)
                for gid, g in graphs.items()}
            outs = {gid: fleet.submit(gid, x) for gid, x in feats.items()}
            for gid, fut in outs.items():
                g = graphs[gid]
                plan = build_partition_plan(g, PartitionConfig(),
                                            device="cpu")
                want = spmm_block_slabs_plain(
                    *(plan.slabs[k] for k in ("colidx", "values", "rowloc",
                                              "out_row")),
                    feats[gid].cpu(), plan.n_rows)[plan.inv_perm]
                assert torch.equal(fut.result(timeout=120).cpu(), want), gid
        st = fleet.stats()
        assert st["fleet_feature_sharded"] >= 1
        assert st["fleet_block_sharded"] >= 1
        assert spmm_block_slabs.launches == st["slot_routed_resident"]
        # a mutation publishes on the primary's card; the next read sees it
        plan = fleet.plan_for("g1")
        g1 = graphs["g1"]
        delta = EdgeDelta(insert_src=np.array([0, 1]),
                          insert_dst=np.array([2, 3]),
                          insert_val=np.array([2.0, 3.0], np.float32),
                          delete_src=np.array([], np.int64),
                          delete_dst=np.array([], np.int64),
                          on_duplicate="replace")
        fleet.mutate("g1", delta).result(timeout=120)
        g_new = delta.apply(g1)
        x = torch.ones((g1.n_cols, 16), device=cuda)
        fresh = build_partition_plan(g_new, PartitionConfig(), device="cpu")
        want = spmm_block_slabs_plain(
            *(fresh.slabs[k] for k in ("colidx", "values", "rowloc",
                                       "out_row")),
            x.cpu(), fresh.n_rows)[fresh.inv_perm]
        assert torch.equal(fleet.serve_one("g1", x).cpu(), want)
        assert fleet.plan_for("g1").version == plan.version + 1
    finally:
        fleet.close()


# ---------------------------------------------------------------- slice G
_MH_WORKER = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, "src")
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.multihost import initialize_multihost
    ctx = initialize_multihost(timeout_s=60)
    from repro_torch.core.graph import CSRGraph
    from repro_torch.data.graphs import make_power_law_graph
    from repro_torch.distributed.shard_spmm import spmm_block_sharded
    from repro_torch.kernels.spmm_accel import (
        spmm_block_slabs, spmm_block_slabs_plain, spmm_block_slabs_windowed)
    from repro_torch.kernels.spmm_hbm import spmm_block_slabs_hbm
    from repro_torch.serve import MultihostGraphEngine

    n, backend = int(os.environ["MH_NODES"]), os.environ["MH_BACKEND"]
    g0 = make_power_law_graph(n, 8 * n, seed=5)
    vals = np.random.default_rng(5).integers(1, 4, g0.nnz)
    g = CSRGraph(g0.rowptr, g0.colidx, vals.astype(np.float32), g0.n_cols)
    engine = MultihostGraphEngine(context=ctx, backend=backend)
    engine.register_graph("g", g)
    x = torch.from_numpy(np.random.default_rng(6).integers(
        -4, 5, (g.n_cols, 64)).astype(np.float32)).cuda()
    kernels = {"resident": spmm_block_slabs,
               "windowed": spmm_block_slabs_windowed,
               "hbm": spmm_block_slabs_hbm}
    for k in kernels.values():
        k.launches = 0
    y = engine.serve_global("g", x)
    st = engine.stats()
    launched = {r: k.launches for r, k in kernels.items()}
    fd = engine.last_fleet_decision
    regime = "resident" if backend == "accel" else fd.per_device.backend
    plan = engine.plan_for("g")
    want, _ = spmm_block_sharded(plan.slabs, x, plan.n_rows,
                                 [torch.device("cuda", 0)] * 4,
                                 regime=regime)
    plain = spmm_block_slabs_plain(
        *(plan.slabs[k].cpu() for k in ("colidx", "values", "rowloc",
                                        "out_row")), x.cpu(), plan.n_rows)
    print(json.dumps({
        "rank": ctx.process_index, "strategy": fd.strategy,
        "regime": regime, "launched": launched,
        "routed": {r: st["slot_routed_" + r] for r in kernels},
        "blocks": st["fleet_block_counts"],
        "equal": bool(torch.equal(y, want[plan.inv_perm])),
        "plain": bool(torch.equal(y.cpu(), plain[plan.inv_perm.cpu()])),
    }))
    engine.close()
    dist.destroy_process_group()
""")


@pytest.mark.parametrize("backend,n_nodes,regime",
                         [("accel", 6000, "resident"),
                          ("auto", 20000, "hbm")])
def test_serve_global_two_processes_on_one_card(cuda, backend, n_nodes,
                                                regime):
    from repro_torch.distributed.multihost import run_fleet
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    records = run_fleet(_MH_WORKER, num_processes=2, n_local_slots=2,
                        device="cuda", timeout_s=240, cwd=root,
                        extra_env={"MH_NODES": str(n_nodes),
                                   "MH_BACKEND": backend})
    for r in records:
        assert r["strategy"] == "block" and r["regime"] == regime, r
        assert len(r["blocks"]) == 4
        assert max(r["blocks"]) - min(r["blocks"]) <= 1
        assert r["equal"] and r["plain"], r
        assert r["launched"] == r["routed"], r
        assert r["launched"][regime] == 2, r        # one per local slot
    assert json.dumps(records[0]["blocks"]) == \
        json.dumps(records[1]["blocks"])
