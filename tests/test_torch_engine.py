"""The port's GraphServeEngine (device="cpu") against the reference's engine
(backend="pallas", interpret mode) on the same graphs and requests.

Integer-valued graphs and features make every sum exact, so answers must be
bit-identical between the engines. The served slice (a small GCN layer by
layer through both engines, on GCN-normalized graphs) agrees within the
two-level fp32 summation bound of each answer, doubled:
``2 * (min(deg, C) + ceil(deg / C) + 1) * 2**-24 * (|A| @ |x|)``.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import CSRGraph as RefCSR
from repro.core.graph import gcn_normalize as ref_normalize
from repro.kernels.ref import csr_spmm_ref
from repro.serve.graph_engine import GraphRequest as RefRequest
from repro.serve.graph_engine import GraphServeEngine as RefEngine
from repro_torch.core.graph import CSRGraph
from repro_torch.core.plan_cache import PlanCache
from repro_torch.serve import GraphRequest, GraphServeEngine, QueueFullError

from conftest import make_powerlaw_csr


def _int_graph(n, seed):
    g = make_powerlaw_csr(n=n, seed=seed)
    vals = np.random.default_rng(seed).integers(1, 4, g.nnz).astype(np.float32)
    return RefCSR(g.rowptr, g.colidx, vals, g.n_cols)


def _port(g):
    return CSRGraph(g.rowptr, g.colidx, g.values, g.n_cols)


def _engines(graphs, **kw):
    ref = RefEngine(backend="pallas", **kw)
    port = GraphServeEngine(device="cpu", **kw)
    for gid, g in graphs.items():
        ref.register_graph(gid, g)
        port.register_graph(gid, _port(g))
    return ref, port


def _int_x(rng, n, f):
    return rng.integers(-3, 4, (n, f)).astype(np.float32)


def test_serve_matches_reference_engine_and_fuses_same_graph():
    graphs = {f"g{i}": _int_graph(80 + 30 * i, seed=i) for i in range(3)}
    ref, port = _engines(graphs)
    rng = np.random.default_rng(0)
    xs = [("g0", _int_x(rng, graphs["g0"].n_cols, 6)),
          ("g1", _int_x(rng, graphs["g1"].n_cols, 16)),
          ("g0", _int_x(rng, graphs["g0"].n_cols, 3)),
          ("g2", _int_x(rng, graphs["g2"].n_cols, 9))]
    want = ref.serve([RefRequest(g, jnp.asarray(x)) for g, x in xs])
    got = port.serve([GraphRequest(g, torch.from_numpy(x)) for g, x in xs])
    for a, b in zip(got, want):
        assert a.out.shape == b.out.shape
        np.testing.assert_array_equal(a.out.numpy(), np.asarray(b.out))
        assert a.latency_s is not None and a.latency_s > 0
    st, rst = port.stats(), ref.stats()
    assert st["batches_dispatched"] == rst["batches_dispatched"] == 1
    assert st["requests_served"] == 4 and st["graphs_per_dispatch"] == 3.0
    assert st["routed_resident"] == 1 and st["routed_blocked"] == 0
    assert st["live_blocks"] == rst["live_blocks"]
    assert st["padded_blocks"] == rst["padded_blocks"]
    for key in ("cache_builds", "cache_hits", "rows_served", "values_served",
                "requests_per_batch", "block_pad_ratio"):
        assert st[key] == rst[key], key
    ref.close()
    port.close()


@pytest.mark.parametrize("backend", ["accel", "blocked"])
def test_split_by_max_graphs_per_batch(backend):
    graphs = {f"g{i}": _int_graph(60 + 10 * i, seed=20 + i) for i in range(5)}
    port = GraphServeEngine(device="cpu", backend=backend,
                            max_graphs_per_batch=2)
    for gid, g in graphs.items():
        port.register_graph(gid, _port(g))
    rng = np.random.default_rng(1)
    xs = {gid: _int_x(rng, g.n_cols, 4) for gid, g in graphs.items()}
    reqs = port.serve([GraphRequest(gid, torch.from_numpy(x))
                       for gid, x in xs.items()])
    assert port.batches_dispatched == 3                  # ceil(5 / 2)
    key = "routed_resident" if backend == "accel" else "routed_blocked"
    assert port.stats()[key] == 3
    for r in reqs:
        g = graphs[r.graph_id]
        np.testing.assert_array_equal(
            r.out.numpy(), np.asarray(csr_spmm_ref(
                g.rowptr, g.colidx, g.values, jnp.asarray(xs[r.graph_id]))))
    port.close()


def test_validation_errors_and_backends():
    g = _int_graph(70, seed=3)
    port = GraphServeEngine(device="cpu")
    port.register_graph("a", _port(g))
    with pytest.raises(KeyError, match="not registered"):
        port.submit("nope", torch.zeros(3, 3))
    with pytest.raises(ValueError, match="expected"):
        port.serve([GraphRequest("a", torch.zeros(g.n_cols + 1, 2))])
    assert port.batches_dispatched == 0
    with pytest.raises(ValueError, match="backend must be"):
        GraphServeEngine(device="cpu", backend="segment")
    for be in ("auto", "pallas", "windowed", "hbm"):
        GraphServeEngine(device="cpu", backend=be).close()
    with pytest.raises(ValueError, match="plan cache stages on"):
        GraphServeEngine(device="cpu", cache=PlanCache(device="meta"))
    if torch.cuda.is_available():
        assert GraphServeEngine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GraphServeEngine()
    port.close()


def test_registration_lifecycle_and_gather():
    g = _int_graph(90, seed=4)
    port = GraphServeEngine(device="cpu")
    port.register_graph("a", _port(g))
    port.register_graph("a", _port(g))          # same content: a cache hit
    assert port.cache.builds == 1
    sid = port.register_subgraph(_port(g), prefix="f")
    assert sid.startswith("f:") and port.cache.builds == 1
    x = torch.randint(-3, 4, (g.n_cols, 5)).float()
    rows = np.array([4, 0, 17])
    got = port.submit_gather(sid, x, rows).result(timeout=60)
    full = port.serve_one("a", x)
    assert torch.equal(got, full[torch.from_numpy(rows)])
    assert port.unregister_graph(sid) is True
    assert port.unregister_graph(sid) is False
    assert port.plan_for("a").num_blocks > 0
    timings = port.plan_timings()
    assert timings and all(t["n"] >= 1 for t in timings.values())
    port.close()


def test_concurrent_submit_matches_serve_and_coalesces():
    graphs = {f"g{i}": _int_graph(70 + 20 * i, seed=30 + i) for i in range(3)}
    ref, port = _engines(graphs, max_wait_ms=60.0)
    rng = np.random.default_rng(2)
    xs = {gid: _int_x(rng, g.n_cols, 8) for gid, g in graphs.items()}
    n_threads, per_thread = 4, 6
    futs = [[None] * per_thread for _ in range(n_threads)]

    def caller(t):
        for k in range(per_thread):
            gid = f"g{(t + k) % len(graphs)}"
            futs[t][k] = (gid, t + 1.0, port.submit(
                gid, torch.from_numpy(xs[gid] * (t + 1.0))))

    threads = [threading.Thread(target=caller, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    for row in futs:
        for gid, scalef, fut in row:
            want = ref.serve_one(gid, jnp.asarray(xs[gid] * scalef))
            np.testing.assert_array_equal(fut.result(timeout=60).numpy(),
                                          np.asarray(want))
    st = port.stats()
    assert st["requests_served"] == n_threads * per_thread
    assert st["batches_dispatched"] < n_threads * per_thread
    assert st["requests_per_batch"] > 1.0 and st["graphs_per_dispatch"] > 1.0
    assert st["sched_completed"] == n_threads * per_thread
    ref.close()
    port.close()


def test_backpressure_nonblocking_submit_raises():
    g = _int_graph(50, seed=5)
    port = GraphServeEngine(device="cpu", max_pending=1, max_wait_ms=10_000,
                            max_batch_requests=64)
    port.register_graph("a", _port(g))
    x = torch.ones(g.n_cols, 2)
    first = port.submit("a", x)
    with pytest.raises(QueueFullError):
        port.submit("a", x, block=False)
    port.close()                        # drains the queued request
    assert first.result(timeout=60).shape == (g.n_rows, 2)


def _bound(g, x, C=256):
    deg = np.diff(g.rowptr)
    k = np.minimum(deg, C) + -(-deg // C) + 1
    mag = np.asarray(csr_spmm_ref(g.rowptr, g.colidx, np.abs(g.values),
                                  jnp.abs(jnp.asarray(x))), dtype=np.float64)
    return 2 * 2.0 ** -24 * k[:, None] * mag


def test_served_gcn_slice_matches_reference_engine():
    """Two graphs, a 3-layer GCN served layer by layer through both engines
    (fused two-graph dispatches), normalized graphs, seeded weights."""
    graphs = {"big": ref_normalize(make_powerlaw_csr(n=260, seed=40)),
              "small": ref_normalize(make_powerlaw_csr(n=150, seed=41))}
    ref, port = _engines(graphs, max_graphs_per_batch=2)
    rng = np.random.default_rng(3)
    dims = [12, 24, 16, 8]
    ws = [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    h = {gid: rng.normal(size=(g.n_rows, dims[0])).astype(np.float32)
         for gid, g in graphs.items()}
    for li, w in enumerate(ws):
        xw = {gid: h[gid] @ w for gid in graphs}
        want = ref.serve([RefRequest(gid, jnp.asarray(xw[gid]))
                          for gid in graphs])
        got = port.serve([GraphRequest(gid, torch.from_numpy(xw[gid]))
                          for gid in graphs])
        for a, b in zip(got, want):
            diff = np.abs(a.out.numpy().astype(np.float64)
                          - np.asarray(b.out, dtype=np.float64))
            assert np.all(diff <= _bound(graphs[a.graph_id], xw[a.graph_id]))
            out = np.asarray(b.out)
            h[a.graph_id] = (np.asarray(jax.nn.relu(out))
                             if li < len(ws) - 1 else out)
    assert port.stats()["graphs_per_dispatch"] == 2.0
    assert port.stats()["batches_dispatched"] == len(ws)
    ref.close()
    port.close()
