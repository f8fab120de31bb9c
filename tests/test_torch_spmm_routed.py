"""The routed slab SpMM of the port against the reference: the plain
versions of K2 (windowed) and K3 (HBM gather) against the reference's
Pallas kernels in interpret mode, ``AccelSpMM`` and ``spmm_batched`` with
the backends ``auto|pallas|windowed|hbm``, and the routed serving engine.

Tolerances. Integer-valued graphs and features make every sum exact in
fp32: results must be identical. On normalized graphs the fp32 sums run in
different orders. K3 sums a row as K1 does, in two levels (at most
min(deg, C) products inside a block, then ceil(deg / C) block partials);
K2 adds one level, the window partials of each block row (at most
``num_windows`` of them). Two such results may differ by twice the
recursive-summation bound ``k * 2**-24 * (|A| @ |x|)`` with
``k = min(deg, C) + ceil(deg / C) + 1`` for K3 and ``k + num_windows`` for
K2.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan_cache as ref_pc
from repro.core.graph import CSRGraph as RefCSR
from repro.core.graph import degree_sort_csr, gcn_normalize
from repro.core.partition import (block_level_partition,
                                  get_partition_patterns, pack_slabs)
from repro.core.spmm import make_accel_spmm as ref_make
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels import spmm_batched as ref_b
from repro.kernels.router import VmemBudgetError as RefVmemBudgetError
from repro.kernels.spmm_accel import spmm_block_slabs_windowed as ref_k2
from repro.kernels.spmm_hbm import spmm_block_slabs_hbm as ref_k3
from repro.serve.graph_engine import GraphRequest as RefRequest
from repro.serve.graph_engine import GraphServeEngine as RefEngine
from repro_torch.core import graph as port_graph
from repro_torch.core import plan_cache as port_pc
from repro_torch.core import spmm as port_spmm
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import spmm_accel as port_k
from repro_torch.kernels import spmm_batched as port_b
from repro_torch.kernels import spmm_hbm as port_hbm
from repro_torch.kernels.router import VmemBudgetError
from repro_torch.serve import GraphRequest, GraphServeEngine

from conftest import make_powerlaw_csr

U = 2.0 ** -24
MODES = [("tpu", 32, 8), ("paper", 12, 8), ("tpu", 16, 8)]


def _int_values(g, seed):
    vals = np.random.default_rng(seed).integers(1, 4, g.nnz).astype(np.float32)
    return RefCSR(g.rowptr, g.colidx, vals, g.n_cols)


def _wide_int_graph(n_rows, n_cols, nnz, seed):
    """Few rows over a wide feature-row space: the shape whose X operand
    leaves the resident regime while its slabs stay CI-cheap."""
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, n_rows, nnz))
    rowptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=rowptr[1:])
    return RefCSR(rowptr, rng.integers(0, n_cols, nnz).astype(np.int64),
                  rng.integers(1, 4, nnz).astype(np.float32), n_cols)


def _port(g):
    return port_graph.CSRGraph(g.rowptr, g.colidx, g.values, g.n_cols)


def _slabs(g, mode, mbw, mwn):
    gs = degree_sort_csr(g)
    bp = block_level_partition(gs, get_partition_patterns(mbw, mwn, mode=mode))
    return gs, pack_slabs(gs, bp)


def _t(s):
    return [torch.from_numpy(np.ascontiguousarray(s[k]))
            for k in ("colidx", "values", "rowloc", "out_row")]


def _j(s):
    return [jnp.asarray(s[k]) for k in ("colidx", "values", "rowloc", "out_row")]


def _int_x(seed, n, f):
    return np.random.default_rng(seed).integers(-3, 4, (n, f)).astype(
        np.float32)


def _bound(gs, C, x, extra_levels=0):
    """Twice the summation bound of one row of the degree-sorted graph."""
    deg = np.diff(gs.rowptr)
    k = np.minimum(deg, C) + -(-deg // C) + 1 + extra_levels
    mag = ref_ref.csr_spmm_ref(gs.rowptr, gs.colidx, np.abs(gs.values),
                               jnp.abs(jnp.asarray(x)))
    return 2 * U * k[:, None] * np.asarray(mag, dtype=np.float64)


# ------------------------------------------------------ K2 plain version
@pytest.mark.parametrize("mode,mbw,mwn", MODES)
@pytest.mark.parametrize("window_rows,F", [(None, 9), (96, 17), (64, 130),
                                           (40, 5)])
def test_windowed_plain_matches_reference_exactly_on_integer_graphs(
        mode, mbw, mwn, window_rows, F):
    g = _int_values(make_powerlaw_csr(n=180, seed=F), seed=F)
    gs, s = _slabs(g, mode, mbw, mwn)
    x = _int_x(F, g.n_cols, F)
    want = np.asarray(ref_k2(*_j(s), jnp.asarray(x), gs.n_rows,
                             window_rows=window_rows, interpret=True))
    got = port_k.spmm_block_slabs_windowed(*_t(s), torch.from_numpy(x),
                                           gs.n_rows, window_rows=window_rows)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode,mbw,mwn", MODES[:2])
@pytest.mark.parametrize("window_rows", [48, 100])
def test_windowed_plain_within_bound_on_normalized_graphs(mode, mbw, mwn,
                                                          window_rows):
    g = gcn_normalize(make_powerlaw_csr(n=200, seed=11))
    gs, s = _slabs(g, mode, mbw, mwn)
    x = np.random.default_rng(1).normal(size=(g.n_cols, 40)).astype(np.float32)
    want = np.asarray(ref_k2(*_j(s), jnp.asarray(x), gs.n_rows,
                             window_rows=window_rows, interpret=True),
                      dtype=np.float64)
    got = port_k.spmm_block_slabs_windowed(
        *_t(s), torch.from_numpy(x), gs.n_rows,
        window_rows=window_rows).numpy().astype(np.float64)
    n_windows = -(-g.n_cols // window_rows)
    assert n_windows >= 2
    assert np.all(np.abs(got - want) <= _bound(gs, mbw * mwn, x, n_windows))


def test_windowed_wrapper_defaults_and_validation():
    g = _int_values(make_powerlaw_csr(n=60, seed=4), seed=4)
    gs, s = _slabs(g, "tpu", 16, 8)
    ci, va, rl, orow = _t(s)
    x = torch.from_numpy(_int_x(4, g.n_cols, 6))
    before = port_k.spmm_block_slabs_windowed.launches
    out = port_k.spmm_block_slabs_windowed(ci, va, rl, orow, x, gs.n_rows)
    assert port_k.spmm_block_slabs_windowed.launches == before, \
        "CPU tensors take the plain version, which is not a kernel launch"
    assert torch.equal(out, port_k.spmm_block_slabs(ci, va, rl, orow, x,
                                                    gs.n_rows))
    with pytest.raises(TypeError, match="x must be torch.float32"):
        port_k.spmm_block_slabs_windowed(ci, va, rl, orow, x.double(),
                                         gs.n_rows)
    with pytest.raises(ValueError, match="window_rows must be >= 1"):
        port_k.spmm_block_slabs_windowed(ci, va, rl, orow, x, gs.n_rows,
                                         window_rows=-8)


# ------------------------------------------------------ K3 plain version
@pytest.mark.parametrize("mode,mbw,mwn", MODES)
@pytest.mark.parametrize("F", [1, 17, 130])
def test_hbm_plain_matches_reference_exactly_on_integer_graphs(mode, mbw,
                                                               mwn, F):
    g = _int_values(make_powerlaw_csr(n=150, seed=F + 1), seed=F)
    gs, s = _slabs(g, mode, mbw, mwn)
    x = _int_x(F, g.n_cols, F)
    want = np.asarray(ref_k3(*_j(s), jnp.asarray(x), gs.n_rows,
                             interpret=True))
    got = port_hbm.spmm_block_slabs_hbm(*_t(s), torch.from_numpy(x),
                                        gs.n_rows)
    np.testing.assert_array_equal(got.numpy(), want)


def test_hbm_plain_within_bound_on_normalized_graphs():
    g = gcn_normalize(make_powerlaw_csr(n=200, seed=12))
    gs, s = _slabs(g, "tpu", 64, 4)
    x = np.random.default_rng(2).normal(size=(g.n_cols, 33)).astype(np.float32)
    want = np.asarray(ref_k3(*_j(s), jnp.asarray(x), gs.n_rows,
                             interpret=True), dtype=np.float64)
    got = port_hbm.spmm_block_slabs_hbm(
        *_t(s), torch.from_numpy(x), gs.n_rows).numpy().astype(np.float64)
    assert np.all(np.abs(got - want) <= _bound(gs, 256, x))


@pytest.mark.parametrize("kernel", ["windowed", "hbm"])
def test_plain_versions_on_merged_slabs_with_padding_blocks(kernel):
    graphs = [_int_values(make_powerlaw_csr(n=70 + 40 * i, seed=i), seed=i)
              for i in range(2)]
    cfgs = [("tpu", 32, 8), ("paper", 12, 8)]
    ref_plans, port_plans = [], []
    for g, (mode, mbw, mwn) in zip(graphs, cfgs):
        ref_plans.append(_ref_plan(g, mode, mbw, mwn))
        port_plans.append(port_pc.build_partition_plan(
            _port(g), port_pc.PartitionConfig(mode, mbw, mwn), device="cpu"))
    b_total = sum(p.num_blocks for p in ref_plans)
    pad_to = 2 * ref_b.bucket_blocks(b_total)
    n_rows = [p.n_rows for p in ref_plans]
    n_cols = [p.n_cols for p in ref_plans]
    rm, _, _, n_out = ref_b.batch_graph_slabs(
        [p.slabs for p in ref_plans], n_rows, n_cols, pad_blocks_to=pad_to)
    pm, _, _, _ = port_b.batch_graph_slabs(
        [p.slabs for p in port_plans], n_rows, n_cols, pad_blocks_to=pad_to)
    x = _int_x(5, sum(n_cols), 21)
    if kernel == "windowed":
        want = ref_k2(*_j(rm), jnp.asarray(x), n_out, window_rows=64,
                      interpret=True)
        got = port_k.spmm_block_slabs_windowed(
            *_port_args(pm), torch.from_numpy(x), n_out, window_rows=64)
    else:
        want = ref_k3(*_j(rm), jnp.asarray(x), n_out, interpret=True)
        got = port_hbm.spmm_block_slabs_hbm(*_port_args(pm),
                                            torch.from_numpy(x), n_out)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ref_plan(g, mode, mbw, mwn):
    return ref_pc.build_partition_plan(g, ref_pc.PartitionConfig(mode, mbw,
                                                                 mwn))


def _port_args(slabs):
    return (slabs["colidx"], slabs["values"], slabs["rowloc"],
            slabs["out_row"])


# ------------------------------------------- operators and batching
@pytest.mark.parametrize("backend", ["auto", "pallas", "windowed", "hbm"])
def test_accel_spmm_routed_backends_equal_reference(backend):
    g = _int_values(make_powerlaw_csr(n=130, seed=6), seed=6)
    x = _int_x(6, g.n_cols, 24)
    want = ref_make(g, backend=backend)(jnp.asarray(x))
    got = port_spmm.make_accel_spmm(_port(g), backend=backend,
                                    device="cpu")(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_cols,dtype", [(3000, "float32"),
                                          (6000, "float32"),
                                          (6000, "bfloat16"),
                                          (17000, "float32")])
def test_spmm_auto_decision_equals_reference(n_cols, dtype):
    """The caller's dtype sets the routing itemsize, as in the reference:
    6000 rows are windowed at fp32 and resident at bf16."""
    g = _wide_int_graph(24, n_cols, 400, seed=n_cols)
    ref_plan = _ref_plan(g, "tpu", 64, 4)
    port_plan = port_pc.build_partition_plan(_port(g), port_pc.PartitionConfig(),
                                             device="cpu")
    x = _int_x(7, n_cols, 10)
    xj = jnp.asarray(x, dtype=getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want, want_d = ref_ops.spmm_auto(ref_plan.slabs, xj, ref_plan.n_rows,
                                     return_decision=True)
    got, got_d = port_ops.spmm_auto(port_plan.slabs, xt, port_plan.n_rows,
                                    return_decision=True)
    assert dataclasses.asdict(got_d) == dataclasses.asdict(want_d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if want_d.backend != "resident":
        with pytest.raises(VmemBudgetError) as port_err:
            port_ops.spmm_pallas(port_plan.slabs, xt, port_plan.n_rows)
        with pytest.raises(RefVmemBudgetError) as ref_err:
            ref_ops.spmm_pallas(ref_plan.slabs, xj, ref_plan.n_rows)
        assert str(port_err.value) == str(ref_err.value)


BATCHES = {
    # each graph alone is resident; merged they overflow into windowed
    "merged_windowed": [(24, 1500, 300), (30, 1500, 300), (20, 1600, 250)],
    # merged past MAX_WINDOWS windows: hbm
    "merged_hbm": [(20, 9000, 300), (16, 8000, 300)],
    "resident": [(20, 900, 200), (12, 700, 150)],
}


@pytest.mark.parametrize("batch", sorted(BATCHES))
@pytest.mark.parametrize("backend", ["auto", "pallas", "windowed", "hbm"])
def test_spmm_batched_routed_backends_equal_reference(batch, backend):
    graphs = [_wide_int_graph(*shape, seed=i)
              for i, shape in enumerate(BATCHES[batch])]
    ref_plans = [_ref_plan(g, "tpu", 64, 4) for g in graphs]
    port_plans = [port_pc.build_partition_plan(
        _port(g), port_pc.PartitionConfig(), device="cpu") for g in graphs]
    xs = [_int_x(i, g.n_cols, 6 + 5 * i) for i, g in enumerate(graphs)]
    n_rows = [p.n_rows for p in ref_plans]
    pad_to = ref_b.bucket_blocks(sum(p.num_blocks for p in ref_plans))
    kw = dict(backend=backend, pad_blocks_to=pad_to, return_decision=True)
    try:
        want, want_d = ref_b.spmm_batched(
            [p.slabs for p in ref_plans], [jnp.asarray(x) for x in xs],
            n_rows, **kw)
    except RefVmemBudgetError as e:
        assert backend == "pallas" and batch != "resident"
        with pytest.raises(VmemBudgetError) as port_err:
            port_b.spmm_batched([p.slabs for p in port_plans],
                                [torch.from_numpy(x) for x in xs], n_rows,
                                **kw)
        assert str(port_err.value) == str(e)
        return
    got, got_d = port_b.spmm_batched(
        [p.slabs for p in port_plans], [torch.from_numpy(x) for x in xs],
        n_rows, **kw)
    assert dataclasses.asdict(got_d) == dataclasses.asdict(want_d)
    if backend == "auto":
        expected = {"merged_windowed": "windowed", "merged_hbm": "hbm",
                    "resident": "resident"}[batch]
        assert got_d.backend == expected
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_spmm_batched_accel_and_blocked_take_no_decision():
    g = _wide_int_graph(10, 500, 80, seed=3)
    plan = port_pc.build_partition_plan(_port(g), port_pc.PartitionConfig(),
                                        device="cpu")
    x = torch.from_numpy(_int_x(3, g.n_cols, 4))
    outs = {}
    for backend in ("accel", "blocked", "pallas"):
        outs[backend], decision = port_b.spmm_batched(
            [plan.slabs], [x], [plan.n_rows], backend=backend,
            return_decision=True, grid_order="ft_major")
        assert (decision is None) == (backend != "pallas")
    assert torch.equal(outs["accel"][0], outs["blocked"][0])
    assert torch.equal(outs["accel"][0], outs["pallas"][0])


# ------------------------------------------------------------- engine
def test_routed_engine_matches_reference_answers_and_stats():
    """backend="auto": one graph per regime, each dispatched alone, then a
    fused flush of small graphs that overflows into windowed together."""
    graphs = {
        "small": _int_values(make_powerlaw_csr(n=120, seed=1), seed=1),
        "mid": _wide_int_graph(24, 6000, 300, seed=2),
        "big": _wide_int_graph(20, 17000, 300, seed=3),
    }
    fused = {f"f{i}": _wide_int_graph(16, 1500, 200, seed=10 + i)
             for i in range(3)}
    results = {}
    for name, engine_cls, wrap, to_x, req in (
            ("ref", lambda **kw: RefEngine(backend="auto", **kw),
             lambda g: g, jnp.asarray, RefRequest),
            ("port", lambda **kw: GraphServeEngine(backend="auto",
                                                   device="cpu", **kw),
             _port, torch.from_numpy, GraphRequest)):
        alone = engine_cls(max_graphs_per_batch=1)
        together = engine_cls(max_graphs_per_batch=8)
        for gid, g in graphs.items():
            alone.register_graph(gid, wrap(g))
        for gid, g in fused.items():
            together.register_graph(gid, wrap(g))
        outs = [r.out for r in alone.serve(
            [req(gid, to_x(_int_x(i, g.n_cols, 5 + i)))
             for i, (gid, g) in enumerate(graphs.items())])]
        outs += [r.out for r in together.serve(
            [req(gid, to_x(_int_x(i, g.n_cols, 7)))
             for i, (gid, g) in enumerate(fused.items())])]
        results[name] = (outs, alone.stats(), together.stats(),
                         together.last_decision)
        alone.close()
        together.close()
    ref_outs, ref_alone, ref_together, ref_last = results["ref"]
    outs, st_alone, st_together, last = results["port"]
    for a, b in zip(outs, ref_outs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for key in ("routed_resident", "routed_windowed", "routed_hbm",
                "routed_blocked", "batches_dispatched", "live_blocks",
                "padded_blocks"):
        assert st_alone[key] == ref_alone[key], key
        assert st_together[key] == ref_together[key], key
    assert (st_alone["routed_resident"], st_alone["routed_windowed"],
            st_alone["routed_hbm"]) == (1, 1, 1)
    assert st_together["batches_dispatched"] == 1
    assert st_together["routed_windowed"] == 1
    assert dataclasses.asdict(last) == dataclasses.asdict(ref_last)


def test_routed_engine_pallas_raises_past_resident_threshold():
    g = _wide_int_graph(20, 6000, 200, seed=4)
    port = GraphServeEngine(backend="pallas", device="cpu")
    port.register_graph("mid", _port(g))
    with pytest.raises(VmemBudgetError, match="windowed"):
        port.serve_one("mid", torch.ones(g.n_cols, 3))
    assert port.stats()["batches_dispatched"] == 0
    port.close()
