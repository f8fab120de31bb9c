"""GCN training in the port against the reference, on the CPU.

The same parameters (the reference's ``init_gcn`` through
``params_from_jax``), graph, features and labels go through the reference's
``jax.value_and_grad`` of ``gcn_loss`` (``GraphOp`` with
``backend="pallas"``, its Pallas kernel in interpret mode, backward on A'^T
through the same kernel) and the port's ``gcn_loss`` with ``backward()``
(K1's plain version on CPU tensors, backward through ``GraphOp.bwd``). The
graphs are directed power-law graphs, so A' != A'^T.

Tolerances. Sums and dense products run in other orders in the two
packages, so the loss must agree within ``2e-6 * |loss|`` and every
gradient within ``2e-5 * max|grad| + 1e-7`` of the reference's (a few
hundred fp32 ulp of the largest entry after two layers forward and back;
measured gaps are below 3e-7 relative). A backward through A' instead of
A'^T misses by more than 20% of ``max|grad|``. The ``tiny`` preset's first
10 SGD losses agree within ``1e-5 * |loss|``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import csr_transpose as ref_transpose
from repro.core.graph import gcn_normalize
from repro.data.graphs import make_power_law_graph as ref_power_law
from repro.data.graphs import node_features, node_labels
from repro.models import gcn as ref_gcn
from repro_torch.core.graph import CSRGraph
from repro_torch.core.plan_cache import PlanCache
from repro_torch.examples import train_gcn as port_train
from repro_torch.models import gcn as port_gcn

from conftest import make_powerlaw_csr

DIMS = [10, 24, 6]


def _problem(variant, seed=8, n=140):
    g = gcn_normalize(make_powerlaw_csr(n=n, seed=seed))
    params = ref_gcn.init_gcn(jax.random.PRNGKey(3), DIMS, variant)
    # non-zero biases and eps so every parameter takes part
    params = [{k: (v + 0.1 if k in ("b", "eps") else v) for k, v in p.items()}
              for p in params]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(g.n_rows, DIMS[0])).astype(np.float32)
    y = rng.integers(0, DIMS[-1], g.n_rows).astype(np.int32)
    return g, params, x, y


def _port_graph(g):
    return CSRGraph(g.rowptr, g.colidx, g.values, g.n_cols)


def _port_loss_and_grads(params, aggr, x, y, variant, mask=None):
    pp = port_gcn.params_from_jax(params, "cpu")
    for p in pp:
        for t in p.values():
            t.requires_grad_()
    loss = port_gcn.gcn_loss(pp, aggr, torch.from_numpy(x),
                             torch.from_numpy(y), variant,
                             mask=None if mask is None
                             else torch.from_numpy(mask))
    loss.backward()
    return float(loss.detach()), [{k: t.grad for k, t in p.items()} for p in pp]


def _grad_gap(ref_grads, port_grads):
    """Per parameter: max |port - ref| over the bound for it."""
    gaps = {}
    for i, (pr, pt) in enumerate(zip(ref_grads, port_grads)):
        assert sorted(pr) == sorted(pt)
        for k in pr:
            want = np.asarray(pr[k])
            got = pt[k].numpy()
            assert got.shape == want.shape, (i, k)
            gaps[(i, k)] = float(np.abs(got - want).max()) / (
                2e-5 * np.abs(want).max() + 1e-7)
    return gaps


def test_graph_is_directed():
    g, *_ = _problem("gcn")
    assert not np.array_equal(g.to_dense(), ref_transpose(g).to_dense())


@pytest.mark.parametrize("masked", [False, True])
def test_gcn_loss_matches_reference(masked):
    g, params, x, y = _problem("gcn")
    mask = None
    if masked:
        mask = (np.random.default_rng(5).random(g.n_rows) < 0.3).astype(
            np.float32)
    ref_aggr = ref_gcn.GraphOp.build(g, backend="blocked")
    want = float(ref_gcn.gcn_loss(params, ref_aggr, jnp.asarray(x),
                                  jnp.asarray(y), "gcn",
                                  None if mask is None
                                  else jnp.asarray(mask)))
    aggr = port_gcn.GraphOp.build(_port_graph(g), device="cpu")
    with torch.no_grad():
        got = float(port_gcn.gcn_loss(
            port_gcn.params_from_jax(params, "cpu"), aggr,
            torch.from_numpy(x), torch.from_numpy(y), "gcn",
            None if mask is None else torch.from_numpy(mask)))
    assert abs(got - want) <= 2e-6 * abs(want)
    if masked:      # an all-zero mask divides by 1, not by 0
        with torch.no_grad():
            zero = port_gcn.gcn_loss(
                port_gcn.params_from_jax(params, "cpu"), aggr,
                torch.from_numpy(x), torch.from_numpy(y), "gcn",
                torch.zeros(g.n_rows))
        assert float(zero) == 0.0


@pytest.mark.parametrize("variant", ["gcn", "sage", "gin"])
def test_loss_and_gradients_match_value_and_grad(variant):
    g, params, x, y = _problem(variant)
    ref_aggr = ref_gcn.GraphOp.build(g, backend="pallas")
    want_loss, want_grads = jax.value_and_grad(
        lambda p: ref_gcn.gcn_loss(p, ref_aggr, jnp.asarray(x),
                                   jnp.asarray(y), variant))(params)
    aggr = port_gcn.GraphOp.build(_port_graph(g), device="cpu")
    loss, grads = _port_loss_and_grads(params, aggr, x, y, variant)
    assert abs(loss - float(want_loss)) <= 2e-6 * abs(float(want_loss))
    gaps = _grad_gap(want_grads, grads)
    assert max(gaps.values()) <= 1.0, gaps


class _Counting:
    """An operator wrapper that counts its calls and keeps their widths."""

    def __init__(self, op):
        self.op, self.calls, self.widths = op, 0, []

    def __call__(self, x):
        self.calls += 1
        self.widths.append(x.shape[1])
        return self.op(x)


@pytest.mark.parametrize("variant", ["gcn", "sage", "gin"])
def test_backward_goes_through_bwd_on_the_transpose(variant):
    g, params, x, y = _problem(variant)
    aggr = port_gcn.GraphOp.build(_port_graph(g), device="cpu")
    fwd, bwd = _Counting(aggr.fwd), _Counting(aggr.bwd)
    counted = port_gcn.GraphOp(fwd=fwd, bwd=bwd)
    _port_loss_and_grads(params, counted, x, y, variant)
    # ``transform_first``: gcn aggregates after each product; sage
    # aggregates the input features (10 -> 24) first, which need no grad,
    # and aggregates after its product in 24 -> 6; gin aggregates each
    # layer's input
    layers = len(DIMS) - 1
    assert fwd.calls == layers
    want = {"gcn": ([24, 6], [6, 24]), "sage": ([10, 6], [6]),
            "gin": ([10, 24], [24])}[variant]
    assert (fwd.widths, bwd.widths) == want
    assert bwd.op.n_rows == g.n_cols and bwd.op.plan.nnz == g.nnz
    if variant != "gin":
        # the plain forward records no graph: with a zero backward operator
        # no gradient reaches the weights of a layer that aggregates after
        # its product
        zero = port_gcn.GraphOp(fwd=aggr.fwd, bwd=lambda h: torch.zeros(
            (g.n_cols, h.shape[1])))
        _, grads = _port_loss_and_grads(params, zero, x, y, variant)
        for i in ([0, 1] if variant == "gcn" else [1]):
            assert float(grads[i]["w"].abs().max()) == 0.0, i
        assert float(grads[1]["b"].abs().max()) > 0.0
    # a symmetric-A' impostor (backward through A' itself) is caught
    ref_aggr = ref_gcn.GraphOp.build(g, backend="blocked")
    _, want_grads = jax.value_and_grad(
        lambda p: ref_gcn.gcn_loss(p, ref_aggr, jnp.asarray(x),
                                   jnp.asarray(y), variant))(params)
    impostor = port_gcn.GraphOp(fwd=aggr.fwd, bwd=aggr.fwd)
    _, bad = _port_loss_and_grads(params, impostor, x, y, variant)
    assert _grad_gap(want_grads, bad)[(0, "w")] > 1e3


@pytest.mark.parametrize("transform", [True, False])
@pytest.mark.parametrize("variant", ["gcn", "sage"])
def test_either_placement_matches_the_reference(monkeypatch, variant,
                                                transform):
    """Every layer forced to one order, ``A'(h W)`` or ``(A' h) W``, against
    the reference's own order: logits, loss and every gradient."""
    g, params, x, y = _problem(variant)
    monkeypatch.setattr(port_gcn, "transform_first", lambda *a: transform)
    ref_aggr = ref_gcn.GraphOp.build(g, backend="pallas")
    want_logits = np.asarray(ref_gcn.gcn_forward(params, ref_aggr,
                                                 jnp.asarray(x), variant))
    want_loss, want_grads = jax.value_and_grad(
        lambda p: ref_gcn.gcn_loss(p, ref_aggr, jnp.asarray(x),
                                   jnp.asarray(y), variant))(params)
    aggr = port_gcn.GraphOp.build(_port_graph(g), device="cpu")
    fwd, bwd = _Counting(aggr.fwd), _Counting(aggr.bwd)
    counted = port_gcn.GraphOp(fwd=fwd, bwd=bwd)
    with torch.no_grad():
        logits = port_gcn.gcn_forward(port_gcn.params_from_jax(params, "cpu"),
                                      counted, torch.from_numpy(x), variant)
    assert np.abs(logits.numpy() - want_logits).max() <= (
        2e-5 * np.abs(want_logits).max() + 1e-6)
    fwd.widths = []
    loss, grads = _port_loss_and_grads(params, counted, x, y, variant)
    assert fwd.widths == (DIMS[1:] if transform else DIMS[:-1])
    # transforming first, the first layer's ``x W`` needs A'^T for W
    assert bwd.widths == ([6, 24] if transform else [24])
    assert abs(loss - float(want_loss)) <= 2e-6 * abs(float(want_loss))
    gaps = _grad_gap(want_grads, grads)
    assert max(gaps.values()) <= 1.0, gaps


def test_expanded_and_strided_grads_reach_bwd_contiguous():
    g = gcn_normalize(make_powerlaw_csr(n=60, seed=2))
    aggr = port_gcn.GraphOp.build(_port_graph(g), device="cpu",
                                  backend="accel")
    seen = []

    def bwd(h):
        seen.append(h.is_contiguous())
        return aggr.bwd(h)

    op = port_gcn.GraphOp(fwd=aggr.fwd, bwd=bwd)
    x = torch.randn(g.n_cols, 5, requires_grad=True)
    op(x).mean().backward()                      # stride-0 grad
    want = aggr.bwd(torch.full((g.n_rows, 5), 1.0 / (g.n_rows * 5)))
    assert torch.allclose(x.grad, want, rtol=1e-6, atol=0)
    x.grad = None
    op(x)[:, ::2].sum().backward()              # strided grad
    assert seen == [True, True]


def test_transpose_plans_are_cached():
    g = _port_graph(gcn_normalize(make_powerlaw_csr(n=90, seed=4)))
    cache = PlanCache(device="cpu")
    a = port_gcn.GraphOp.build(g, plan_cache=cache)
    assert cache.stats()["builds"] == 2        # A' and A'^T
    hits = cache.stats()["hits"]
    b = port_gcn.GraphOp.build(g, plan_cache=cache)
    s = cache.stats()
    assert s["builds"] == 2 and s["hits"] == hits + 2
    assert a.fwd.plan is b.fwd.plan and a.bwd.plan is b.bwd.plan
    assert a.fwd.plan.key != a.bwd.plan.key


@pytest.mark.parametrize("variant", ["gcn", "sage", "gin"])
def test_tiny_preset_sgd_losses_match_reference_loop(variant):
    n, e, dims, classes, _ = port_train.PRESETS["tiny"]
    g = gcn_normalize(ref_power_law(n, e, seed=0))
    aggr = ref_gcn.GraphOp.build(g, backend="blocked")
    X = jnp.asarray(node_features(n, dims[0], 0))
    y = jnp.asarray(node_labels(n, classes, 0))
    params = ref_gcn.init_gcn(jax.random.PRNGKey(0), dims + [classes],
                              variant)
    prob = port_train.build_problem("tiny", variant, device="cpu")
    np.testing.assert_array_equal(prob.x.numpy(), np.asarray(X))
    np.testing.assert_array_equal(prob.labels.numpy(), np.asarray(y))
    port_params = port_gcn.params_from_jax(params, "cpu")
    step = jax.jit(jax.value_and_grad(
        lambda p: ref_gcn.gcn_loss(p, aggr, X, y, variant)))
    want = []
    for _ in range(10):
        loss, grads = step(params)
        want.append(float(loss))
        params = jax.tree.map(lambda p, gr: p - 1e-2 * gr, params, grads)
    got = port_train.train(port_params, prob.aggr, prob.x, prob.labels,
                           variant=variant, lr=1e-2, steps=10)
    assert len(got) == 10
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-5 * abs(b), (got, want)


def test_trainer_main_runs_and_checkpoints(tmp_path, capsys):
    losses = port_train.main(["--preset", "tiny", "--device", "cpu",
                              "--steps", "100", "--ckpt-dir",
                              str(tmp_path)])
    assert len(losses) == 100 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "final loss" in capsys.readouterr().out
    from repro_torch.checkpoint.manager import CheckpointManager
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 100
    like = port_train.build_problem("tiny", device="cpu").params
    restored = mgr.restore(100, like)
    assert [sorted(p) for p in restored] == [sorted(p) for p in like]
    with pytest.raises(SystemExit):
        port_train.main(["--backend", "nope"])
