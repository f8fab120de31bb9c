"""The port's GCN forward against the reference: the same parameters (the
reference's ``init_gcn`` through ``params_from_jax``), the same graph and
features, all three variants. Aggregation sums run in other orders, and the
dense products through other BLAS kernels, so logits must agree within
``2e-5 * max|logit| + 1e-6`` (a few hundred fp32 ulp of the largest logit
after two layers of fp32 products and sums). The placement rule
(``transform_first``) over the benchmark cells' layer shapes, and the widths
``gcn_forward`` then aggregates at."""
import weakref

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


@pytest.mark.parametrize("variant,d_in,d_out,h_grad,w_grad,want", [
    # Reddit's SAGE: 602 wide once forward (raw features need no gradient)
    # against 256 forward and back; then 41 against 256, both ways
    ("sage", 602, 256, False, True, True),
    ("sage", 256, 41, True, True, True),
    # Arxiv's GCN: aggregating 128 wide first would keep A'h for the
    # gradient of W, which transforming first does not; then a tie; 40 wide
    ("gcn", 128, 256, False, True, True),
    ("gcn", 256, 256, True, True, True),
    ("sage", 256, 256, True, True, False),
    ("gcn", 256, 40, True, True, True),
    # inference: the narrower side wins
    ("gcn", 128, 256, False, False, False),
    ("sage", 602, 256, False, False, True),
    ("gcn", 256, 256, False, False, True),
    ("sage", 256, 256, False, False, False),
    # the first layer's missing backward makes aggregating first cheaper
    ("sage", 300, 256, False, True, False),
    ("sage", 300, 256, True, True, True),
    # a frozen W: nothing kept for it, and h's gradient goes through A'^T
    # in both orders
    ("gcn", 100, 150, True, False, False),
    ("gcn", 150, 100, True, False, True),
])
def test_placement_rule(variant, d_in, d_out, h_grad, w_grad, want):
    assert port_gcn.transform_first(variant, d_in, d_out, h_grad,
                                    w_grad) is want


def _widths(params, x, variant, grad):
    """The widths ``gcn_forward`` aggregates at, forward, in order."""
    seen = []

    def aggr(h):
        seen.append(h.shape[1])
        return h

    with torch.set_grad_enabled(grad):
        port_gcn.gcn_forward(params, aggr, x, variant)
    return seen


@pytest.mark.parametrize("variant,dims,none,trained,no_grad,x_grad", [
    ("gcn", [128, 256, 200], [128, 200], [256, 200], [128, 200],
     [256, 200]),
    ("sage", [300, 256, 200], [256, 200], [300, 200], [256, 200],
     [256, 200]),
])
def test_forward_places_each_layer_by_the_rule(variant, dims, none, trained,
                                               no_grad, x_grad):
    params = port_gcn.init_gcn(torch.Generator().manual_seed(0), dims,
                               variant, dtype=torch.float32, device="cpu")
    x = torch.ones(5, dims[0])
    # nothing needs a gradient: each layer gathers its narrower side
    assert _widths(params, x, variant, True) == none
    for p in params:
        p["w"].requires_grad_()
    assert _widths(params, x, variant, True) == trained
    assert _widths(params, x, variant, False) == no_grad
    x.requires_grad_()
    assert _widths(params, x, variant, True) == x_grad


@pytest.mark.parametrize("variant", ["gcn", "sage"])
def test_forward_frees_each_layers_partial_sums(variant):
    """No aggregation's output outlives its layer: only the layer's output
    stays live into the next one (nothing is saved without grad)."""
    outs = []

    def aggr(h):
        assert all(r() is None for r in outs)
        out = h * 1.0
        outs.append(weakref.ref(out))
        return out

    params = port_gcn.init_gcn(torch.Generator().manual_seed(0),
                               [8, 16, 16, 4], variant, dtype=torch.float32,
                               device="cpu")
    with torch.no_grad():
        port_gcn.gcn_forward(params, aggr, torch.ones(5, 8), variant)
    assert len(outs) == 3


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
