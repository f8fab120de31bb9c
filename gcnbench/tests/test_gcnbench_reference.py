"""The plain reference against a dense product, on graphs with empty rows
and rows long enough to be summed in several segments."""
import numpy as np
import pytest
import torch

from gcnbench.reference import graphs
from gcnbench.reference import model as ref


def dense_of(rowptr, col, val, n_cols):
    d = np.zeros((len(rowptr) - 1, n_cols))
    for r in range(len(rowptr) - 1):
        np.add.at(d[r], col[rowptr[r]:rowptr[r + 1]],
                  val[rowptr[r]:rowptr[r + 1]])
    return d


@pytest.mark.parametrize("degrees", [[0, 3, 1, 0, 2],
                                     [700, 1, 0, 40, 9, 1300],
                                     [5] * 30])
def test_spmm_matches_dense(degrees):
    rng = np.random.default_rng(len(degrees))
    n_cols = 13
    rowptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int64)
    col = rng.integers(0, n_cols, rowptr[-1])
    val = rng.normal(size=rowptr[-1]).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(n_cols, 6)).astype(np.float32))
    a = ref.make_csr(rowptr, col, val, n_cols, "cpu")
    want = dense_of(rowptr, col, val, n_cols) @ x.double().numpy()
    got = ref.spmm(a, x).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    at = ref.transpose(a)
    x_t = torch.from_numpy(rng.normal(size=(len(degrees), 3)).astype(
        np.float32))
    np.testing.assert_allclose(ref.spmm(at, x_t).double().numpy(),
                               dense_of(rowptr, col, val, n_cols).T
                               @ x_t.double().numpy(), rtol=1e-5, atol=1e-5)


def test_segment_length_pads_at_most_twice():
    # degree-8 rows: L=16 pads to exactly twice the entries
    assert ref.segment_length(torch.tensor([0, 8, 16, 24])) == 16
    # one long row and many single entries: the single rows decide
    rp = torch.tensor([0, 10000] + list(range(10001, 10101)))
    assert ref.segment_length(rp) == 64


@pytest.mark.parametrize("variant,dims", [("gcn", [6, 5, 3]),
                                          ("sage", [6, 5, 3])])
def test_gradients_match_a_dense_autograd(variant, dims):
    g = graphs.power_law_graph(40, 200, seed=3)
    g = (graphs.gcn_normalize if variant == "gcn" else graphs.row_normalize)(g)
    graph = ref.build_graph(*g, 40, "cpu")
    dense = torch.from_numpy(dense_of(g[0], g[1], g[2], 40)).float()
    gen = torch.Generator().manual_seed(0)
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        p = {"w": torch.randn(a, b, generator=gen), "b": torch.randn(b, generator=gen)}
        if variant == "sage":
            p["w_self"] = torch.randn(a, b, generator=gen)
        params.append(p)
    x = torch.randn(40, dims[0], generator=gen)
    y = torch.randint(0, dims[-1], (40,), generator=gen)
    losses, grads, _ = ref.sgd_steps(params, graph, x, y, variant, 0.1, 1)
    live = [{k: v.clone().requires_grad_() for k, v in p.items()}
            for p in params]
    loss = ref.loss_fn(ref.forward(live, lambda h: dense @ h, x, variant), y)
    loss.backward()
    assert losses[0] == pytest.approx(float(loss.detach()), rel=1e-5)
    for p, gp in zip(live, grads[0]):
        for k in p:
            torch.testing.assert_close(gp[k], p[k].grad, rtol=1e-4, atol=1e-5)


def test_normalizations():
    g = graphs.power_law_graph(50, 300, seed=1)
    rp, col, val = graphs.row_normalize(g)
    sums = np.add.reduceat(val, rp[:-1][np.diff(rp) > 0])
    np.testing.assert_allclose(sums, 1.0, rtol=1e-6)
    rp2, col2, val2 = graphs.gcn_normalize(g)
    assert rp2[-1] == rp[-1] + 50
    d = np.diff(rp2)
    rows = np.repeat(np.arange(50), d)
    np.testing.assert_allclose(val2, 1 / np.sqrt(d[rows] * d[col2]),
                               rtol=1e-6)
    assert np.all(col2[rp2[1:] - 1] == np.arange(50))


def test_generator_is_seeded_and_exact():
    a = graphs.power_law_graph(300, 2500, seed=4)
    b = graphs.power_law_graph(300, 2500, seed=4)
    assert a[0][-1] == 2500
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def test_tf32_round_keeps_ten_mantissa_bits():
    t = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, -3.0 - 2 ** -9])
    r = ref.tf32_round(t)
    assert r.tolist() == [1.0 + 2 ** -10, 1.0, -3.0 - 2 ** -9]
