"""The benchmark's ogbn-products model, GraphSAGE-mean 100-256-256-47, at
widths that keep its layers' orders (12-32-32-7: the first two aggregate
before their product, the raw features and the tie; the third after it),
on the CPU against the benchmark's plain fp32 reference: the loss and every
leaf's gradient from the same seeded weights, and the spans that name each
layer's order with what it holds for the gradient of ``W``."""
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from gcnbench.data import draw_params, generator  # noqa: E402
from gcnbench.reference import graphs, model as ref  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.core.graph import CSRGraph  # noqa: E402
from repro_torch.examples import train_gcn  # noqa: E402
from repro_torch.models.gcn import GraphOp  # noqa: E402

DIMS = [12, 32, 32, 7]
N, EDGES = 300, 6000
# Both sides sum in fp32 in different orders (the port's K1 slabs and its
# third layer's A'(h W) against the reference's segment sums and (A h) W):
# over five seeds the losses agreed to the last bit and the gradients to
# at most 8.3e-7 of a leaf's largest entry, so 1e-5 of each leaves tenfold
# room and still fails any wrong term, which moves them by percents.
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5


@pytest.fixture(autouse=True)
def _spans_off():
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def _problem(seed):
    rowptr, col, val = graphs.row_normalize(
        graphs.power_law_graph(N, EDGES, seed))
    gen = generator(seed, "cpu")
    params = draw_params(gen, DIMS, "sage", "cpu")
    x = torch.randn((N, DIMS[0]), generator=gen)
    y = torch.randint(0, DIMS[-1], (N,), generator=gen)
    return (rowptr, col, val), params, x, y


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 7, 4_000_000_019])
def test_loss_and_every_gradient_match_the_reference(seed):
    (rowptr, col, val), params, x, y = _problem(seed)
    aggr = GraphOp.build(CSRGraph(rowptr, col, val, N), device="cpu")
    loss, grads = train_gcn.loss_and_grads(params, aggr, x, y, "sage")
    r_losses, r_grads, _ = ref.sgd_steps(
        params, ref.build_graph(rowptr, col, val, N, "cpu"), x, y, "sage",
        0.1, 1)
    assert float(loss) == pytest.approx(r_losses[0], rel=LOSS_RTOL)
    for i, (i_ref, k) in enumerate(ref.leaves(params)):
        g, r = grads[i_ref][k], r_grads[0][i_ref][k]
        assert g.shape == r.shape, (i, k)
        scale = float(r.abs().max())
        assert scale > 0, (i_ref, k)
        assert float((g - r).abs().max()) <= GRAD_TOL * scale, (i_ref, k)


def test_spans_name_each_layers_order_and_what_it_holds():
    (rowptr, col, val), params, x, y = _problem(5)
    aggr = GraphOp.build(CSRGraph(rowptr, col, val, N), device="cpu")
    spans.enable()
    train_gcn.loss_and_grads(params, aggr, x, y, "sage")
    spans.disable()
    got = spans.drain()["spans"]
    layers = sorted((s for s in got if s["name"].startswith("layer.")),
                    key=lambda s: s["start_ns"])
    assert [s["name"] for s in layers] == [
        "layer.aggr_first", "layer.aggr_first", "layer.transform_first"]
    assert [s["attrs"] for s in layers] == [
        {"d_in": 12, "d_out": 32, "held_bytes": N * 12 * 4},
        {"d_in": 32, "d_out": 32, "held_bytes": N * 32 * 4},
        {"d_in": 32, "d_out": 7, "held_bytes": 0}]
    # each layer's forward aggregation runs inside its span, at the width
    # its order gathers
    fwd = sorted((s for s in got if s["name"] == "aggr.fwd"),
                 key=lambda s: s["start_ns"])
    assert [s["attrs"]["f"] for s in fwd] == [12, 32, 7]
    for s, layer in zip(fwd, layers):
        assert s["parent"] == layer["id"]
