"""The port's AccelSpMM operator against the reference's, backend by
backend, in the ORIGINAL row order. Integer-valued graphs: exact. The
dense backend multiplies in another order: exact on integers too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import CSRGraph as RefCSR
from repro.core.spmm import make_accel_spmm as ref_make
from repro_torch.core import graph as port_graph
from repro_torch.core import spmm as port_spmm
from repro_torch.core.plan_cache import PartitionConfig, PlanCache

from conftest import make_powerlaw_csr


def _graph(seed, n=130):
    g = make_powerlaw_csr(n=n, seed=seed)
    vals = np.random.default_rng(seed).integers(1, 4, g.nnz).astype(np.float32)
    return (RefCSR(g.rowptr, g.colidx, vals, g.n_cols),
            port_graph.CSRGraph(g.rowptr, g.colidx, vals, g.n_cols))


# reference backend each port backend is held against
PAIRS = [("accel", "pallas"), ("blocked", "blocked"), ("segment", "segment"),
         ("warp", "warp"), ("dense", "dense")]


@pytest.mark.parametrize("port_be,ref_be", PAIRS)
@pytest.mark.parametrize("mode,mbw,mwn", [("tpu", 64, 4), ("paper", 12, 8)])
def test_backends_equal_reference(port_be, ref_be, mode, mbw, mwn):
    g, pg = _graph(seed=mbw)
    x = np.random.default_rng(1).integers(-3, 4, (g.n_cols, 9)).astype(
        np.float32)
    want = ref_make(g, mode=mode, max_block_warps=mbw, max_warp_nzs=mwn,
                    backend=ref_be, with_baselines=True)(jnp.asarray(x))
    op = port_spmm.make_accel_spmm(pg, mode=mode, max_block_warps=mbw,
                                   max_warp_nzs=mwn, backend=port_be,
                                   with_baselines=True, device="cpu")
    got = op(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_from_plan_cache_and_backend_override():
    _, pg = _graph(seed=3)
    cache = PlanCache(capacity=2, device="cpu")
    op = port_spmm.make_accel_spmm(pg, plan_cache=cache)
    assert op.backend == "accel" and cache.builds == 1
    port_spmm.make_accel_spmm(pg, plan_cache=cache)
    assert cache.builds == 1 and cache.hits == 1
    x = torch.randint(-3, 4, (pg.n_cols, 4)).float()
    assert torch.equal(op(x), op(x, backend="blocked"))
    same = port_spmm.accel_spmm_from_plan(op.plan, backend="segment")
    assert torch.equal(same(x), op(x))
    assert op.plan.config == PartitionConfig()


def test_unknown_and_unported_backends_raise():
    _, pg = _graph(seed=4)
    op = port_spmm.make_accel_spmm(pg, device="cpu")
    x = torch.ones(pg.n_cols, 2)
    for be in ("pallas", "auto", "nope"):
        with pytest.raises(ValueError, match="unknown backend"):
            op(x, backend=be)


def test_make_accel_spmm_defaults_to_cuda():
    _, pg = _graph(seed=5)
    if torch.cuda.is_available():
        assert port_spmm.make_accel_spmm(pg).plan.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_spmm.make_accel_spmm(pg)
    with pytest.raises(ValueError, match="differs from the plan cache"):
        port_spmm.make_accel_spmm(pg, device="cpu",
                                  plan_cache=PlanCache(device="meta"))
