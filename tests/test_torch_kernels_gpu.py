"""K1 on the card against its plain version (needs a CUDA device).

Run on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

This file imports neither JAX nor the reference package, so it also runs
where only PyTorch is installed. Integer-valued graphs make every sum exact
in fp32: K1 must equal the plain version bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.graph import CSRGraph, gcn_normalize
from repro_torch.core.plan_cache import PartitionConfig, build_partition_plan
from repro_torch.data.graphs import make_power_law_graph
from repro_torch.kernels.spmm_accel import (spmm_block_slabs,
                                            spmm_block_slabs_plain)
from repro_torch.kernels.spmm_batched import batch_graph_slabs, bucket_blocks

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
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


@pytest.mark.parametrize("mode,mbw,mwn", [("tpu", 64, 4), ("paper", 12, 32)])
@pytest.mark.parametrize("F", [1, 100, 2048])
def test_k1_equals_plain_on_integer_graphs(cuda, mode, mbw, mwn, F):
    cfg = PartitionConfig(mode, mbw, mwn)
    g = _edge_graph(cfg.deg_bound, seed=F)
    plan = build_partition_plan(g, cfg, device=cuda)
    assert plan.partition.is_split.any()
    gen = torch.Generator(device=cuda).manual_seed(F)
    x = torch.randint(-4, 5, (g.n_cols, F), generator=gen, device=cuda).float()
    before = spmm_block_slabs.launches
    got = spmm_block_slabs(*_args(plan.slabs), x, g.n_rows)
    torch.cuda.synchronize()
    assert spmm_block_slabs.launches == before + 1
    assert torch.equal(got, spmm_block_slabs_plain(*_args(plan.slabs), x,
                                                   g.n_rows))


def test_k1_equals_plain_on_merged_slabs_with_padding_blocks(cuda):
    plans, n_cols = [], []
    for cfg in (PartitionConfig("tpu", 64, 4), PartitionConfig("paper", 12, 32)):
        g = _edge_graph(cfg.deg_bound, seed=cfg.deg_bound)
        plans.append(build_partition_plan(g, cfg, device=cuda))
        n_cols.append(g.n_cols)
    b_total = sum(p.num_blocks for p in plans)
    merged, _, _, n_out = batch_graph_slabs(
        [p.slabs for p in plans], [p.n_rows for p in plans], n_cols,
        pad_blocks_to=2 * bucket_blocks(b_total))
    x = torch.randint(-4, 5, (sum(n_cols), 77), device=cuda).float()
    got = spmm_block_slabs(*_args(merged), x, n_out)
    assert torch.equal(got, spmm_block_slabs_plain(*_args(merged), x, n_out))


def test_k1_normalized_graph_within_summation_bound(cuda):
    """fp32 sums in different orders: |K1 - plain| <= 2 k u (|A| @ |x|) with
    k = min(deg, C) + ceil(deg / C) + 1 per row."""
    cfg = PartitionConfig()
    g = gcn_normalize(make_power_law_graph(3000, 60000, seed=3))
    plan = build_partition_plan(g, cfg, device=cuda)
    x = torch.randn(g.n_cols, 256, device=cuda)
    args = _args(plan.slabs)
    got = spmm_block_slabs(*args, x, g.n_rows)
    want = spmm_block_slabs_plain(*args, x, g.n_rows)
    mag = spmm_block_slabs_plain(args[0], args[1].abs(), args[2], args[3],
                                 x.abs(), g.n_rows).double()
    deg = np.sort(np.diff(g.rowptr), kind="stable")     # degree-sorted order
    k = np.minimum(deg, cfg.deg_bound) + -(-deg // cfg.deg_bound) + 1
    bound = 2 * 2.0 ** -24 * torch.as_tensor(k, device=cuda)[:, None] * mag
    assert torch.all((got.double() - want.double()).abs() <= bound)
