"""Parity and behaviour of the port's plan cache: content hashes and staged
slabs identical to the reference, and the cache's single-flight, LRU,
version-pin and spill/reload behaviour on the port's tensors."""
import threading

import numpy as np
import pytest
import torch

from repro.core import plan_cache as ref_pc
from repro.core.graph import gcn_normalize as ref_normalize
from repro_torch.core import graph as port_graph
from repro_torch.core import plan_cache as port_pc

from conftest import make_powerlaw_csr

CPU = torch.device("cpu")


def _graphs(seed, n=110):
    g = ref_normalize(make_powerlaw_csr(n=n, seed=seed))
    pg = port_graph.CSRGraph(g.rowptr, g.colidx, g.values, g.n_cols)
    return g, pg


@pytest.mark.parametrize("seed", [0, 3])
def test_content_hash_and_config_tag_identical(seed):
    g, pg = _graphs(seed)
    assert port_pc.graph_content_hash(pg) == ref_pc.graph_content_hash(g)
    cfg_r = ref_pc.PartitionConfig(mode="paper", max_block_warps=12,
                                   max_warp_nzs=8)
    cfg_p = port_pc.PartitionConfig(mode="paper", max_block_warps=12,
                                    max_warp_nzs=8)
    assert port_pc._config_tag(cfg_p) == ref_pc._config_tag(cfg_r)
    assert port_pc.PartitionConfig() == port_pc.PartitionConfig(
        mode="tpu", max_block_warps=64, max_warp_nzs=4)


@pytest.mark.parametrize("mode,mbw,mwn", [("tpu", 64, 4), ("paper", 12, 8)])
def test_plan_slabs_identical(mode, mbw, mwn):
    g, pg = _graphs(1, n=160)
    rp = ref_pc.build_partition_plan(
        g, ref_pc.PartitionConfig(mode, mbw, mwn))
    pp = port_pc.build_partition_plan(
        pg, port_pc.PartitionConfig(mode, mbw, mwn), device="cpu")
    assert pp.key[0] == rp.key[0]
    assert (pp.n_rows, pp.n_cols, pp.nnz, pp.num_blocks) == \
        (rp.n_rows, rp.n_cols, rp.nnz, rp.num_blocks)
    for k in ("colidx", "values", "rowloc", "out_row"):
        got = pp.slabs[k]
        assert isinstance(got, torch.Tensor) and got.device == CPU
        np.testing.assert_array_equal(got.numpy(), np.asarray(rp.slabs[k]))
    assert (pp.slabs["R"], pp.slabs["C"]) == (rp.slabs["R"], rp.slabs["C"])
    for k in ("inv_perm", "coo_row", "coo_col", "coo_val"):
        np.testing.assert_array_equal(getattr(pp, k).numpy(),
                                      np.asarray(getattr(rp, k)))
    assert pp.device_bytes() > 0


def test_entry_points_default_to_cuda():
    """Without device=, building a plan or a cache targets CUDA: it raises
    where there is none and lands on the card where there is one."""
    _, pg = _graphs(2)
    cfg = port_pc.PartitionConfig()
    assert port_pc.resolve_device("cpu") == CPU
    if torch.cuda.is_available():
        assert port_pc.build_partition_plan(pg, cfg).device.type == "cuda"
        assert port_pc.PlanCache().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_pc.build_partition_plan(pg, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_pc.PlanCache()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_pc.resolve_device("cuda:0")


def test_single_flight_build_under_concurrency():
    _, pg = _graphs(4)
    cache = port_pc.PlanCache(capacity=4, device="cpu")
    cfg = port_pc.PartitionConfig()
    start = threading.Barrier(8)
    plans = []

    def worker():
        start.wait(timeout=10)
        plans.append(cache.get_or_build(pg, cfg))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(plans) == 8 and all(p is plans[0] for p in plans)
    st = cache.stats()
    assert st["builds"] == 1 and st["misses"] == 1 and st["hits"] == 7
    assert st["lookups"] == st["hits"] + st["misses"]


def test_lru_eviction_spill_and_reload(tmp_path):
    cache = port_pc.PlanCache(capacity=2, save_dir=str(tmp_path),
                              device="cpu")
    cfg = port_pc.PartitionConfig()
    gs = [_graphs(s)[1] for s in (5, 6, 7)]
    first = cache.get_or_build(gs[0], cfg)
    first.tuned = {"backend": "accel", "label": "t"}
    cache.get_or_build(gs[1], cfg)
    cache.get_or_build(gs[2], cfg)          # evicts gs[0] -> spilled
    assert cache.evictions == 1 and cache.spills == 1
    assert first.key not in cache
    again = cache.get_or_build(gs[0], cfg)  # reloaded, not rebuilt
    assert cache.disk_hits == 1 and cache.builds == 3
    for k in ("colidx", "values", "rowloc", "out_row"):
        assert torch.equal(again.slabs[k], first.slabs[k])
    for k in ("inv_perm", "coo_row", "coo_col", "coo_val"):
        assert torch.equal(getattr(again, k), getattr(first, k))
    np.testing.assert_array_equal(again.partition.meta, first.partition.meta)
    # every tensor of the plan's one list round-trips, dtype and all
    old, new = first.tensors(), again.tensors()
    assert list(old) == list(new) == list(port_pc.PartitionPlan.TENSORS)
    for k in old:
        assert new[k].dtype == old[k].dtype and torch.equal(new[k], old[k]), k
    assert (again.slabs["R"], again.slabs["C"]) == \
        (first.slabs["R"], first.slabs["C"])
    assert (again.key, again.n_rows, again.n_cols, again.nnz, again.version,
            again.tuned) == (first.key, first.n_rows, first.n_cols,
                             first.nnz, first.version, first.tuned)
    assert again.device_bytes() == first.device_bytes()


def test_plan_lists_every_tensor_and_moves_to_meta():
    plan = port_pc.build_partition_plan(_graphs(12)[1],
                                        port_pc.PartitionConfig(),
                                        device="cpu")
    listed = plan.tensors()
    held = {id(v) for v in [*vars(plan).values(), *plan.slabs.values()]
            if isinstance(v, torch.Tensor)}
    assert held == {id(t) for t in listed.values()}
    assert set(port_pc.PartitionPlan.TENSOR_FIELDS) <= set(vars(plan))
    moved = plan.to("meta")
    assert moved is not plan and moved.device == torch.device("meta")
    for k, t in moved.tensors().items():
        assert t.device.type == "meta", k
        assert (t.shape, t.dtype) == (listed[k].shape, listed[k].dtype), k
    assert (moved.slabs["R"], moved.slabs["C"]) == \
        (plan.slabs["R"], plan.slabs["C"])
    assert moved.key == plan.key and moved.partition is plan.partition
    assert plan.device == CPU          # the source plan is left as it was
    # a move to where the tensors lie shares them
    same = plan.to(CPU)
    assert all(same.tensors()[k] is t for k, t in listed.items())
    out = torch.arange(plan.n_rows * 2.0).reshape(plan.n_rows, 2)
    assert torch.equal(plan.to_original_order(out), out[plan.inv_perm])


def test_corrupt_spill_rebuilds(tmp_path):
    cache = port_pc.PlanCache(capacity=1, save_dir=str(tmp_path),
                              device="cpu")
    cfg = port_pc.PartitionConfig()
    g0, g1 = _graphs(8)[1], _graphs(9)[1]
    p0 = cache.get_or_build(g0, cfg)
    cache.get_or_build(g1, cfg)                 # spills g0
    with open(cache._spill_path(p0.key), "wb") as f:
        f.write(b"not an npz")
    cache.get_or_build(g0, cfg)
    assert cache.disk_hits == 0 and cache.builds == 3


def test_pin_retire_publish_lifecycle():
    cache = port_pc.PlanCache(capacity=4, device="cpu")
    cfg = port_pc.PartitionConfig()
    old = cache.get_or_build(_graphs(10)[1], cfg)
    new = port_pc.build_partition_plan(_graphs(11)[1], cfg, device="cpu")
    assert cache.pin(old.key) == 1
    cache.publish(new, retire_key=old.key)
    st = cache.stats()
    assert st["publishes"] == 1 and st["retired_live"] == 1
    assert old.key not in cache and new.key in cache
    assert cache.unpin(old.key) == 0
    st = cache.stats()
    assert st["retired_live"] == 0 and st["retired_reclaimed"] == 1
    assert st["pins"] == 0
    # an unpinned retire drops at once
    assert cache.retire(new.key) is True and new.key not in cache
    assert cache.retire(new.key) is False


def test_capacity_validation():
    with pytest.raises(ValueError, match="capacity"):
        port_pc.PlanCache(capacity=0, device="cpu")
