"""The port's multi-graph merge and fused SpMM against the reference:
merged slabs are bit-identical to the reference's host-side merge, and the
fused outputs match the reference's fused Pallas dispatch exactly on
integer-valued graphs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan_cache as ref_pc
from repro.core.graph import CSRGraph as RefCSR
from repro.kernels import spmm_batched as ref_b
from repro_torch.core import graph as port_graph
from repro_torch.core import plan_cache as port_pc
from repro_torch.kernels import spmm_batched as port_b

from conftest import make_powerlaw_csr

CFGS = [("tpu", 64, 4), ("paper", 12, 8), ("tpu", 16, 8)]


def _int_graph(n, seed):
    g = make_powerlaw_csr(n=n, seed=seed)
    vals = np.random.default_rng(seed).integers(1, 4, g.nnz).astype(np.float32)
    return RefCSR(g.rowptr, g.colidx, vals, g.n_cols)


def _plans(graphs, cfgs):
    ref, port = [], []
    for g, (mode, mbw, mwn) in zip(graphs, cfgs):
        ref.append(ref_pc.build_partition_plan(
            g, ref_pc.PartitionConfig(mode, mbw, mwn)))
        pg = port_graph.CSRGraph(g.rowptr, g.colidx, g.values, g.n_cols)
        port.append(port_pc.build_partition_plan(
            pg, port_pc.PartitionConfig(mode, mbw, mwn), device="cpu"))
    return ref, port


@pytest.mark.parametrize("b_total,min_bucket", [(0, 8), (3, 8), (8, 8),
                                                (9, 8), (1000, 1), (5, 64)])
def test_bucket_blocks_identical(b_total, min_bucket):
    assert port_b.bucket_blocks(b_total, min_bucket) == \
        ref_b.bucket_blocks(b_total, min_bucket)


@pytest.mark.parametrize("pad", [None, "bucket", "double"])
def test_merged_slabs_bit_identical(pad):
    graphs = [_int_graph(70 + 30 * i, seed=i) for i in range(3)]
    ref, port = _plans(graphs, CFGS)
    b_total = sum(p.num_blocks for p in ref)
    pad_to = {None: None, "bucket": ref_b.bucket_blocks(b_total),
              "double": 2 * ref_b.bucket_blocks(b_total)}[pad]
    n_rows = [p.n_rows for p in ref]
    n_cols = [p.n_cols for p in ref]
    rm, ro, rc, rn = ref_b.batch_graph_slabs([p.slabs for p in ref], n_rows,
                                             n_cols, pad_blocks_to=pad_to)
    pm, po, pc, pn = port_b.batch_graph_slabs([p.slabs for p in port], n_rows,
                                              n_cols, pad_blocks_to=pad_to)
    assert (pm["R"], pm["C"], pn) == (rm["R"], rm["C"], rn)
    np.testing.assert_array_equal(po, ro)
    np.testing.assert_array_equal(pc, rc)
    for k in ("colidx", "values", "rowloc", "out_row"):
        assert pm[k].dtype == torch.from_numpy(rm[k]).dtype
        np.testing.assert_array_equal(pm[k].numpy(), rm[k])


@pytest.mark.parametrize("backend", ["accel", "blocked"])
def test_fused_outputs_equal_reference_pallas(backend):
    graphs = [_int_graph(60 + 40 * i, seed=10 + i) for i in range(3)]
    ref, port = _plans(graphs, CFGS)
    rng = np.random.default_rng(0)
    xs = [rng.integers(-3, 4, (g.n_cols, 5 + 4 * i)).astype(np.float32)
          for i, g in enumerate(graphs)]
    pad_to = ref_b.bucket_blocks(sum(p.num_blocks for p in ref))
    want = ref_b.spmm_batched([p.slabs for p in ref],
                              [jnp.asarray(x) for x in xs],
                              [p.n_rows for p in ref], backend="pallas",
                              interpret=True, pad_blocks_to=pad_to)
    got = port_b.spmm_batched([p.slabs for p in port],
                              [torch.from_numpy(x) for x in xs],
                              [p.n_rows for p in port], backend=backend,
                              pad_blocks_to=pad_to)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fused_batch_validation():
    graphs = [_int_graph(50, seed=1)]
    _, port = _plans(graphs, CFGS[:1])
    x = torch.ones(graphs[0].n_cols, 3)
    with pytest.raises(ValueError, match="backend must be auto|pallas"):
        port_b.spmm_batched([port[0].slabs], [x], [port[0].n_rows],
                            backend="segment")
    with pytest.raises(ValueError, match="one feature matrix"):
        port_b.spmm_batched([port[0].slabs], [x, x], [port[0].n_rows])
    with pytest.raises(ValueError, match="one n_rows"):
        port_b.batch_graph_slabs([port[0].slabs], [1, 2], [1])


@pytest.mark.parametrize("backend", ["accel", "auto", "blocked"])
def test_ops_spmm_batched_equals_reference_ops(backend):
    """``kernels.ops.spmm_batched``, the public name, against the
    reference's ``repro.kernels.ops.spmm_batched`` (its Pallas kernel in
    interpret mode) on the same slabs: exact on an integer-valued graph.
    The signatures match but for the reference's ``interpret=``."""
    import inspect

    from repro.kernels import ops as ref_ops
    from repro_torch.kernels import ops as port_ops
    ref_params = [p for p in inspect.signature(
        ref_ops.spmm_batched).parameters if p != "interpret"]
    assert list(inspect.signature(port_ops.spmm_batched).parameters) == \
        ref_params
    assert "spmm_batched" in port_ops.__all__
    graphs = [_int_graph(50 + 30 * i, seed=20 + i) for i in range(2)]
    ref, port = _plans(graphs, CFGS[:2])
    rng = np.random.default_rng(1)
    xs = [rng.integers(-3, 4, (g.n_cols, 6)).astype(np.float32)
          for g in graphs]
    want, ref_dec = ref_ops.spmm_batched(
        [p.slabs for p in ref], [jnp.asarray(x) for x in xs],
        [p.n_rows for p in ref], return_decision=True)
    got, dec = port_ops.spmm_batched(
        [p.slabs for p in port], [torch.from_numpy(x) for x in xs],
        [p.n_rows for p in port], backend=backend, return_decision=True)
    assert (dec is None) == (backend != "auto")
    if dec is not None:
        assert dec.backend == ref_dec.backend == "resident"
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
