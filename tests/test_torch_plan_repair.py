"""The port's incremental plan repair against the reference's, on the CPU.

The same plan, graph and delta go through both packages' ``EdgeDelta``,
``delta_chain_hash``, ``repair_plan`` and ``apply_and_repair``: errors carry
the same messages, chained keys are equal, and repaired slabs
(``colidx``, ``values``, ``rowloc``, ``out_row``), ``inv_perm``, the COO
arrays and the block metadata are identical byte for byte, for single and
chained repairs and for both rebuild fallbacks. The repaired plan's SpMM
equals a fresh build's exactly on integer-valued graphs and features
(every fp32 sum is exact), through K1's plain version, the twin and the
batched dispatch. The cache side: ``PartitionPlan.version`` spills and
reloads (as 0 from a spill without it) and ``PlanCache.apply_delta``
publishes the next version.
"""
import numpy as np
import pytest
import torch

from repro.core import graph as ref_graph
from repro.core import plan_cache as ref_pc
from repro.core import plan_repair as ref_pr
from repro_torch.core import graph as port_graph
from repro_torch.core import plan_cache as port_pc
from repro_torch.core import plan_repair as port_pr
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels.spmm_batched import spmm_batched

from conftest import make_powerlaw_csr

MODES = [("tpu", 4, 2), ("paper", 4, 2), ("tpu", 64, 4)]


def _port(g):
    return port_graph.CSRGraph(g.rowptr, g.colidx, g.values, g.n_cols)


def _graph(n, seed, integer=False):
    g = make_powerlaw_csr(n=n, seed=seed)
    if integer:
        vals = np.random.default_rng(seed).integers(1, 4, g.nnz)
        return ref_graph.CSRGraph(g.rowptr, g.colidx,
                                  vals.astype(np.float32), g.n_cols)
    return ref_graph.gcn_normalize(g)


def _cfgs(mode, mbw, mwn):
    return (ref_pc.PartitionConfig(mode, mbw, mwn),
            port_pc.PartitionConfig(mode, mbw, mwn))


def _mixed_delta_kw(g, seed, k_ins=6, k_del=4):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, g.n_rows, k_ins)
    eids = rng.choice(g.nnz, k_del, replace=False)
    return dict(
        insert_src=rows, insert_dst=rng.integers(0, g.n_cols, k_ins),
        insert_val=rng.integers(1, 4, k_ins).astype(np.float32),
        delete_src=np.searchsorted(g.rowptr, eids, side="right") - 1,
        delete_dst=g.colidx[eids],
        on_duplicate="replace", on_missing="ignore")


def _assert_plans_identical(rp, pp):
    assert pp.key[0] == rp.key[0]
    assert (pp.n_rows, pp.n_cols, pp.nnz, pp.version) == \
        (rp.n_rows, rp.n_cols, rp.nnz, rp.version)
    assert (pp.slabs["R"], pp.slabs["C"]) == (rp.slabs["R"], rp.slabs["C"])
    for k in ("colidx", "values", "rowloc", "out_row"):
        want = np.asarray(rp.slabs[k])
        got = pp.slabs[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert got.tobytes() == want.tobytes(), k
    np.testing.assert_array_equal(pp.inv_perm.numpy(),
                                  np.asarray(rp.inv_perm))
    for k in ("coo_row", "coo_col", "coo_val"):
        np.testing.assert_array_equal(getattr(pp, k).numpy(),
                                      np.asarray(getattr(rp, k)))
    for k in ("meta", "n_rows_blk", "nnz_blk", "is_split"):
        np.testing.assert_array_equal(getattr(pp.partition, k),
                                      getattr(rp.partition, k))


# --------------------------------------------------------- delta semantics

DELTA_ERRORS = {
    "insert_lengths": dict(insert_src=[0, 1], insert_dst=[2]),
    "insert_values": dict(insert_src=[0, 1], insert_dst=[2, 3],
                          insert_val=[1.0]),
    "delete_lengths": dict(delete_src=[0], delete_dst=[1, 2]),
}


@pytest.mark.parametrize("case", sorted(DELTA_ERRORS))
def test_edge_delta_validation_errors_match(case):
    kw = DELTA_ERRORS[case]
    with pytest.raises(ValueError) as ref_err:
        ref_pr.EdgeDelta(**kw)
    with pytest.raises(ValueError) as port_err:
        port_pr.EdgeDelta(**kw)
    assert str(port_err.value) == str(ref_err.value)


APPLY_ERRORS = {
    "duplicate_insert": dict(insert_src=[0], insert_dst=[1]),
    "missing_delete": dict(delete_src=[2], delete_dst=[3]),
    "row_out_of_range": dict(insert_src=[4], insert_dst=[0]),
    "col_out_of_range": dict(insert_src=[0], insert_dst=[4]),
    "negative_delete": dict(delete_src=[-1], delete_dst=[0]),
}


@pytest.mark.parametrize("case", sorted(APPLY_ERRORS))
def test_edge_delta_apply_errors_match(case):
    src, dst = np.array([0, 1]), np.array([1, 2])
    g = ref_graph.csr_from_edges(src, dst, 4)
    pg = port_graph.csr_from_edges(src, dst, 4)
    with pytest.raises(ValueError) as ref_err:
        ref_pr.EdgeDelta(**APPLY_ERRORS[case]).apply(g)
    with pytest.raises(ValueError) as port_err:
        port_pr.EdgeDelta(**APPLY_ERRORS[case]).apply(pg)
    assert str(port_err.value) == str(ref_err.value)


def test_edge_delta_fields_and_touched_rows_match():
    kw = dict(insert_src=[5, 1, 5], insert_dst=[0, 2, 3],
              insert_val=[1, 2, 3], delete_src=[7], delete_dst=[1])
    r, p = ref_pr.EdgeDelta(**kw), port_pr.EdgeDelta(**kw)
    for k in ("insert_src", "insert_dst", "insert_val", "delete_src",
              "delete_dst"):
        a, b = getattr(r, k), getattr(p, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert (p.n_inserts, p.n_deletes, p.size) == (3, 1, 4)
    np.testing.assert_array_equal(p.touched_rows(), r.touched_rows())


CHAIN_DELTAS = [
    dict(insert_src=[0], insert_dst=[1]),
    dict(insert_src=[0], insert_dst=[2]),
    dict(insert_src=[0], insert_dst=[1], on_duplicate="replace"),
    dict(insert_src=[3, 4], insert_dst=[1, 0], insert_val=[0.5, -2.0],
         delete_src=[1], delete_dst=[1], on_missing="ignore"),
    dict(),
]


@pytest.mark.parametrize("i", range(len(CHAIN_DELTAS)))
def test_delta_chain_hash_identical(i):
    kw = CHAIN_DELTAS[i]
    for parent in ("parent", "0" * 32):
        h = port_pr.delta_chain_hash(parent, port_pr.EdgeDelta(**kw))
        assert h == ref_pr.delta_chain_hash(parent, ref_pr.EdgeDelta(**kw))
    hashes = {port_pr.delta_chain_hash("parent", port_pr.EdgeDelta(**d))
              for d in CHAIN_DELTAS}
    assert len(hashes) == len(CHAIN_DELTAS)


# ----------------------------------------------------- repaired plans

@pytest.mark.parametrize("mode,mbw,mwn", MODES)
@pytest.mark.parametrize("seed", [0, 4, 11])
def test_repaired_plan_identical_to_reference(mode, mbw, mwn, seed):
    g = _graph(90, seed)
    cr, cp = _cfgs(mode, mbw, mwn)
    rp = ref_pc.build_partition_plan(g, cr)
    pp = port_pc.build_partition_plan(_port(g), cp, device="cpu")
    kw = _mixed_delta_kw(g, seed + 1)
    rg, rpv = ref_pr.apply_and_repair(rp, g, ref_pr.EdgeDelta(**kw))
    pg, ppv = port_pr.apply_and_repair(pp, _port(g), port_pr.EdgeDelta(**kw))
    assert rpv.repaired and ppv.repaired
    assert (ppv.version, ppv.reason, ppv.dirty_rows, ppv.reused_blocks,
            ppv.rebuilt_blocks) == (rpv.version, rpv.reason, rpv.dirty_rows,
                                    rpv.reused_blocks, rpv.rebuilt_blocks)
    _assert_plans_identical(rpv.plan, ppv.plan)
    np.testing.assert_array_equal(pg.rowptr, rg.rowptr)
    np.testing.assert_array_equal(pg.colidx, rg.colidx)
    assert ppv.plan.inv_perm is pp.inv_perm   # positions stay: by reference


@pytest.mark.parametrize("mode,mbw,mwn", MODES[:2])
def test_chained_repairs_identical_to_reference(mode, mbw, mwn):
    g = _graph(70, 5)
    cr, cp = _cfgs(mode, mbw, mwn)
    rp = ref_pc.build_partition_plan(g, cr)
    pp = port_pc.build_partition_plan(_port(g), cp, device="cpu")
    rg, pg = g, _port(g)
    for step in range(5):
        kw = _mixed_delta_kw(rg, 30 + step, k_ins=3, k_del=2)
        rg, rpv = ref_pr.apply_and_repair(rp, rg, ref_pr.EdgeDelta(**kw),
                                          churn_threshold=1.0)
        pg, ppv = port_pr.apply_and_repair(pp, pg, port_pr.EdgeDelta(**kw),
                                           churn_threshold=1.0)
        assert ppv.repaired == rpv.repaired and ppv.reason == rpv.reason
        _assert_plans_identical(rpv.plan, ppv.plan)
        assert ppv.version == step + 1
        rp, pp = rpv.plan, ppv.plan


def test_empty_delta_advances_version_only():
    g = _graph(40, 2)
    pp = port_pc.build_partition_plan(_port(g), port_pc.PartitionConfig(),
                                      device="cpu")
    pv = port_pr.repair_plan(pp, _port(g), _port(g), np.empty(0, np.int64),
                             graph_hash="k2")
    assert pv.repaired and pv.version == 1 and pv.reason == "empty delta"
    assert pv.plan.slabs["colidx"] is pp.slabs["colidx"]   # by reference
    assert pv.plan.graph_hash == "k2"


def test_churn_fallback_taken_where_the_reference_takes_it():
    g = _graph(40, 0)
    cr, cp = _cfgs("tpu", 4, 2)
    rp = ref_pc.build_partition_plan(g, cr)
    pp = port_pc.build_partition_plan(_port(g), cp, device="cpu")
    rows = np.arange(g.n_rows)
    kw = dict(insert_src=rows, insert_dst=(rows + 1) % g.n_cols,
              on_duplicate="replace")
    _, rpv = ref_pr.apply_and_repair(rp, g, ref_pr.EdgeDelta(**kw))
    _, ppv = port_pr.apply_and_repair(pp, _port(g), port_pr.EdgeDelta(**kw))
    assert not rpv.repaired and not ppv.repaired
    assert "churn" in ppv.reason and ppv.reason == rpv.reason
    assert ppv.dirty_rows == rpv.dirty_rows == g.n_rows
    _assert_plans_identical(rpv.plan, ppv.plan)


def test_fragmentation_fallback_taken_where_the_reference_takes_it():
    g = _graph(50, 2)
    cr, cp = _cfgs("tpu", 4, 2)
    rp = ref_pc.build_partition_plan(g, cr)
    pp = port_pc.build_partition_plan(_port(g), cp, device="cpu")
    rg, pg = g, _port(g)
    fired = None
    for step in range(80):
        r = int(np.random.default_rng(step).integers(0, g.n_rows))
        kw = dict(insert_src=[r], insert_dst=[(r + step) % g.n_cols],
                  on_duplicate="replace")
        rg, rpv = ref_pr.apply_and_repair(rp, rg, ref_pr.EdgeDelta(**kw),
                                          churn_threshold=1.0)
        pg, ppv = port_pr.apply_and_repair(pp, pg, port_pr.EdgeDelta(**kw),
                                           churn_threshold=1.0)
        assert ppv.repaired == rpv.repaired and ppv.reason == rpv.reason
        _assert_plans_identical(rpv.plan, ppv.plan)
        rp, pp = rpv.plan, ppv.plan
        if not ppv.repaired:
            fired = step
            break
    assert fired is not None and "fragmentation" in ppv.reason


REPAIR_INPUT_ERRORS = ["touched_out_of_range", "rows_changed", "nnz_changed"]


@pytest.mark.parametrize("case", REPAIR_INPUT_ERRORS)
def test_repair_validates_inputs_as_the_reference(case):
    g = _graph(30, 1)
    rp = ref_pc.build_partition_plan(g, ref_pc.PartitionConfig())
    pp = port_pc.build_partition_plan(_port(g), port_pc.PartitionConfig(),
                                      device="cpu")
    src, dst = np.array([0]), np.array([1])
    if case == "touched_out_of_range":
        args = (g, g, [g.n_rows])
    elif case == "rows_changed":
        args = (g, ref_graph.csr_from_edges(src, dst, g.n_rows + 1), [0])
    else:
        other = ref_graph.csr_from_edges(src, dst, g.n_rows)
        args = (other, other, [0])
    with pytest.raises(ValueError) as ref_err:
        ref_pr.repair_plan(rp, *args, graph_hash="x")
    with pytest.raises(ValueError) as port_err:
        port_pr.repair_plan(pp, _port(args[0]), _port(args[1]), args[2],
                            graph_hash="x")
    assert str(port_err.value) == str(ref_err.value)


# ----------------------------------------- repaired SpMM == fresh build

def _kernel_outputs(plan, x):
    """The plan's SpMM in original row order through K1's wrapper (its
    plain version on the CPU), the twin and the batched dispatch."""
    s = plan.slabs
    inv = plan.inv_perm
    return {
        "accel": port_ops.spmm_accel(s, x, plan.n_rows)[inv],
        "blocked": port_ops.spmm_blocked(
            s["colidx"], s["values"], s["rowloc"], s["out_row"], x,
            plan.n_rows)[inv],
        "batched_hbm": spmm_batched([s], [x], [plan.n_rows],
                                    backend="hbm")[0][inv],
    }


@pytest.mark.parametrize("mode,mbw,mwn", MODES)
def test_repaired_spmm_equals_fresh_build_exactly_on_integer_graphs(
        mode, mbw, mwn):
    g = _port(_graph(80, 7, integer=True))
    cfg = port_pc.PartitionConfig(mode, mbw, mwn)
    plan = port_pc.build_partition_plan(g, cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).integers(
        -4, 5, (g.n_cols, 9)).astype(np.float32))
    for step in range(3):
        kw = _mixed_delta_kw(g, 50 + step)
        g, pv = port_pr.apply_and_repair(plan, g, port_pr.EdgeDelta(**kw))
        assert pv.repaired
        plan = pv.plan
        fresh = port_pc.build_partition_plan(g, cfg, device="cpu")
        got = _kernel_outputs(plan, x)
        want = _kernel_outputs(fresh, x)
        dense = torch.from_numpy(g.to_dense()) @ x
        for k in got:
            assert torch.equal(got[k], want[k]), (step, k)
            assert torch.equal(got[k], dense), (step, k)


# ------------------------------------------------------ cache side

def test_plan_version_spills_and_reloads(tmp_path):
    g1, g2 = _port(_graph(40, 1)), _port(_graph(45, 2))
    cache = port_pc.PlanCache(1, save_dir=str(tmp_path), device="cpu")
    cfg = port_pc.PartitionConfig()
    p1 = cache.get_or_build(g1, cfg)
    _, pv = port_pr.apply_and_repair(p1, g1, port_pr.EdgeDelta(
        insert_src=[0], insert_dst=[3], on_duplicate="replace"))
    cache.publish(pv.plan, retire_key=p1.key)   # capacity 1: spills v0
    cache.get_or_build(g2, cfg)                 # evicts and spills v1
    assert cache.stats()["spills"] == 2
    back = cache.get_by_key(pv.plan.key, lambda: None)
    assert back.version == 1 and cache.stats()["disk_hits"] == 1
    for k in ("colidx", "values", "rowloc", "out_row"):
        assert torch.equal(back.slabs[k], pv.plan.slabs[k])
    # a spill written before plans had versions reloads as version 0
    path = cache._spill_path(back.key)
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files if k != "version"}
    np.savez(path, **payload)
    fresh = port_pc.PlanCache(1, save_dir=str(tmp_path), device="cpu")
    assert fresh.get_by_key(back.key, lambda: None).version == 0


def test_cache_apply_delta_publishes_next_version():
    g = _graph(60, 3)
    cr, cp = _cfgs("tpu", 4, 2)
    rcache, pcache = ref_pc.PlanCache(), port_pc.PlanCache(device="cpu")
    rp = rcache.get_or_build(g, cr)
    pp = pcache.get_or_build(_port(g), cp)
    kw = _mixed_delta_kw(g, 9)
    pcache.pin(pp.key)                      # a reader holds version 0
    rg, rpv = rcache.apply_delta(rp.key, g, ref_pr.EdgeDelta(**kw))
    pg, ppv = pcache.apply_delta(pp.key, _port(g), port_pr.EdgeDelta(**kw))
    _assert_plans_identical(rpv.plan, ppv.plan)
    assert pcache.keys() == [ppv.plan.key]
    s = pcache.stats()
    assert s["publishes"] == 1 and s["retired_live"] == 1
    pcache.unpin(pp.key)
    s = pcache.stats()
    assert s["retired_live"] == 0 and s["retired_reclaimed"] == 1
    np.testing.assert_array_equal(pg.colidx, rg.colidx)
