"""The port's GCN forward against the reference: the same parameters (the
reference's ``init_gcn`` through ``params_from_jax``), the same graph and
features, all three variants. Aggregation sums run in other orders, and the
dense products through other BLAS kernels, so logits must agree within
``2e-5 * max|logit| + 1e-6`` (a few hundred fp32 ulp of the largest logit
after two layers of fp32 products and sums)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import gcn_normalize
from repro.models import gcn as ref_gcn
from repro_torch.core.graph import CSRGraph
from repro_torch.models import gcn as port_gcn
from repro_torch.models.layers import dense_init

from conftest import make_powerlaw_csr


@pytest.mark.parametrize("variant", ["gcn", "sage", "gin"])
def test_two_layer_forward_matches_reference(variant):
    g = gcn_normalize(make_powerlaw_csr(n=140, seed=8))
    dims = [10, 24, 6]
    params = ref_gcn.init_gcn(jax.random.PRNGKey(3), dims, variant)
    # non-zero biases and eps so every parameter takes part
    params = [{k: (v + 0.1 if k in ("b", "eps") else v) for k, v in p.items()}
              for p in params]
    x = np.random.default_rng(0).normal(size=(g.n_rows, dims[0])).astype(
        np.float32)
    ref_aggr = ref_gcn.GraphOp.build(g, backend="pallas")
    want = np.asarray(ref_gcn.gcn_forward(params, ref_aggr, jnp.asarray(x),
                                          variant))
    port_aggr = port_gcn.GraphOp.build(
        CSRGraph(g.rowptr, g.colidx, g.values, g.n_cols), device="cpu")
    got = port_gcn.gcn_forward(port_gcn.params_from_jax(params, "cpu"),
                               port_aggr, torch.from_numpy(x), variant)
    assert got.shape == want.shape
    tol = 2e-5 * np.abs(want).max() + 1e-6
    assert np.abs(got.numpy() - want).max() <= tol


def test_init_and_dense_init_are_seeded_and_scaled():
    gen = torch.Generator().manual_seed(0)
    w = dense_init(gen, 256, 64)
    assert w.dtype == torch.bfloat16 and w.shape == (256, 64)
    assert abs(w.float().std().item() - 1 / 16) < 0.01
    a = port_gcn.init_gcn(torch.Generator().manual_seed(5), [8, 16, 4],
                          "gin", device="cpu")
    b = port_gcn.init_gcn(torch.Generator().manual_seed(5), [8, 16, 4],
                          "gin", device="cpu")
    assert [sorted(p) for p in a] == [["b", "eps", "w", "w2"]] * 2
    for pa, pb in zip(a, b):
        for k in pa:
            assert torch.equal(pa[k], pb[k])
    assert a[0]["w"].shape == (8, 16) and a[1]["w2"].shape == (4, 4)
    with pytest.raises(ValueError):
        port_gcn.gcn_forward(a, lambda h: h, torch.ones(3, 8), "gat")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_gcn.init_gcn(torch.Generator(), [4, 4])
