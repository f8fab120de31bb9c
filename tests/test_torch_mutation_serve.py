"""The port's serving mutation path, ``GraphServeEngine.mutate`` end to end
on the CPU: the single-host tests of the reference's
``tests/test_mutation_serve.py`` run against the port's engine, and the
port's answers after the same deltas are held against the reference
engine's.

* a mutation publishes a new plan version and later reads observe it;
* chained mutations chain versions;
* a bad delta fails only its own mutation future, not the flush's reads;
* mutations racing live reads never fail a read and never tear it: every
  answer equals the SpMM of some version in the published chain;
* version pins and retired plans drain to zero once traffic stops.

Answers on GCN-normalized graphs are held to ``1e-3`` (the reference tests'
tolerance) against an fp64 dense oracle; against the reference engine they
are held to twice the two-level fp32 summation bound
``(min(deg, C) + ceil(deg / C) + 1) * 2**-24 * (|A| @ |x|)``; on
integer-valued graphs and features both engines are exact and must be
identical.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import CSRGraph as RefCSR
from repro.core.graph import gcn_normalize
from repro.core.plan_repair import EdgeDelta as RefDelta
from repro.serve.graph_engine import GraphServeEngine as RefEngine
from repro_torch.core.graph import CSRGraph
from repro_torch.core.plan_repair import EdgeDelta
from repro_torch.serve import GraphServeEngine

from conftest import make_powerlaw_csr

U = 2.0 ** -24


def _port(g):
    return CSRGraph(g.rowptr, g.colidx, g.values, g.n_cols)


def _dense(g):
    a = np.zeros((g.n_rows, g.n_cols), np.float64)
    row = np.repeat(np.arange(g.n_rows), np.diff(g.rowptr))
    np.add.at(a, (row, g.colidx.astype(np.int64)), g.values.astype(np.float64))
    return a


def _delta_kw(g, seed, k=3, integer=False):
    """A small mixed delta valid against ``g``."""
    rng = np.random.default_rng(seed)
    eids = rng.choice(g.nnz, k, replace=False)
    rows = rng.integers(0, g.n_rows, k)
    vals = (rng.integers(1, 4, k) if integer else rng.normal(size=k))
    return dict(
        insert_src=rows, insert_dst=rng.integers(0, g.n_cols, k),
        insert_val=vals.astype(np.float32),
        delete_src=np.searchsorted(g.rowptr, eids, side="right") - 1,
        delete_dst=g.colidx[eids],
        on_duplicate="replace", on_missing="ignore")


def _delta(g, seed, k=3):
    return EdgeDelta(**_delta_kw(g, seed, k))


def _drain(engine, timeout=5.0):
    """Poll until version pins and retired plans drain (a resolved future
    only means the answer is out — the flush thread's finally-unpin can
    still be in flight for a moment)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        s = engine.stats()
        if s["cache_pins"] == 0 and s["cache_retired_live"] == 0:
            return s
        time.sleep(0.01)
    raise AssertionError(f"pins/retired never drained: {engine.stats()}")


def _x(g, f, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).normal(size=(g.n_cols, f)).astype(
            np.float32))


def test_mutate_publishes_and_serves_new_version():
    engine = GraphServeEngine(device="cpu")
    g0 = _port(gcn_normalize(make_powerlaw_csr(n=70, seed=0)))
    engine.register_graph("g", g0)
    assert engine.graph_version("g") == 0 and engine.graph_ids() == ["g"]

    delta = _delta(g0, seed=1)
    g1 = delta.apply(g0)
    info = engine.mutate("g", delta).result(timeout=30)
    assert info["version"] == 1 and info["graph_id"] == "g"
    assert info["repaired"] and info["dirty_rows"] > 0
    assert engine.graph_version("g") == 1
    s = engine.stats()
    assert s["mutations_applied"] == 1 and s["mutation_edges"] == delta.size
    assert s["plan_repairs"] + s["plan_rebuilds"] == 1

    x = _x(g1, 5, 2)
    out = engine.submit("g", x).result(timeout=30)
    np.testing.assert_allclose(out.numpy(), _dense(g1) @ x.double().numpy(),
                               atol=1e-3, rtol=1e-3)
    _drain(engine)
    engine.close()


def test_sequential_mutations_chain_versions():
    engine = GraphServeEngine(device="cpu")
    g = _port(gcn_normalize(make_powerlaw_csr(n=60, seed=3)))
    engine.register_graph("g", g)
    for i in range(4):
        delta = _delta(g, seed=10 + i)
        g = delta.apply(g)
        info = engine.mutate("g", delta).result(timeout=30)
        assert info["version"] == i + 1
    x = _x(g, 4, 0)
    out = engine.submit("g", x).result(timeout=30)
    np.testing.assert_allclose(out.numpy(), _dense(g) @ x.double().numpy(),
                               atol=1e-3, rtol=1e-3)
    _drain(engine)
    engine.close()


def test_bad_delta_fails_only_its_mutation():
    engine = GraphServeEngine(device="cpu")
    g = _port(gcn_normalize(make_powerlaw_csr(n=50, seed=5)))
    engine.register_graph("g", g)
    x = _x(g, 3, 1)
    # a delete of a non-existent edge with strict on_missing: the delta is
    # well-formed at submit time, fails during apply
    bad = EdgeDelta(delete_src=[0], delete_dst=[g.n_cols - 1])
    assert _dense(g)[0, g.n_cols - 1] == 0.0
    read = engine.submit("g", x)
    fut = engine.mutate("g", bad)
    with pytest.raises(ValueError):
        fut.result(timeout=30)
    # the read (same flush or not) is unaffected, version unchanged
    np.testing.assert_allclose(read.result(timeout=30).numpy(),
                               _dense(g) @ x.double().numpy(), atol=1e-3,
                               rtol=1e-3)
    assert engine.graph_version("g") == 0
    assert engine.stats()["mutations_applied"] == 0
    with pytest.raises(TypeError):
        engine.mutate("g", {"insert_src": [0]})
    with pytest.raises(KeyError):
        engine.mutate("nope", bad)
    _drain(engine)
    engine.close()


def test_mutations_racing_reads_are_never_torn():
    """Reader threads submit continuously while a writer publishes a chain
    of versions. Every answer must equal the SpMM of some published version
    — pre- or post-publish, never a blend — and no read may ever fail."""
    engine = GraphServeEngine(device="cpu", max_wait_ms=1.0)
    g0 = _port(gcn_normalize(make_powerlaw_csr(n=80, seed=7)))
    engine.register_graph("g", g0)

    n_versions = 5
    chain = [g0]
    for i in range(n_versions):
        chain.append(_delta(chain[-1], seed=100 + i).apply(chain[-1]))
    x = _x(g0, 4, 9)
    refs = [_dense(g) @ x.double().numpy() for g in chain]

    stop = threading.Event()
    failures = []
    matched_versions = set()

    def reader():
        while not stop.is_set():
            try:
                y = engine.submit("g", x).result(timeout=30).numpy()
            except Exception as e:  # noqa: BLE001 — a failed read IS the bug
                failures.append(repr(e))
                return
            errs = [float(np.max(np.abs(y - r))) for r in refs]
            best = int(np.argmin(errs))
            if errs[best] > 1e-3:
                failures.append(f"answer matches no version: errs={errs}")
                return
            matched_versions.add(best)

    readers = [threading.Thread(target=reader) for _ in range(3)]
    for t in readers:
        t.start()
    try:
        for i in range(n_versions):
            delta = _delta(chain[i], seed=100 + i)
            info = engine.mutate("g", delta).result(timeout=30)
            assert info["version"] == i + 1
            time.sleep(0.02)     # let readers overlap each published version
    finally:
        stop.set()
        for t in readers:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in readers)
    assert not failures, failures[:3]
    # the race was real: reads landed on several distinct versions
    assert len(matched_versions) >= 2, matched_versions
    assert engine.graph_version("g") == n_versions
    s = _drain(engine)
    assert s["cache_publishes"] >= n_versions
    engine.close()


# ------------------------------------------- against the reference engine

def _pair_bound(g, x, C):
    deg = np.diff(g.rowptr).astype(np.int64)
    k = np.minimum(deg, C) + -(-deg // C) + 1
    return 2 * U * k[:, None] * (np.abs(_dense(g)) @ np.abs(x))


@pytest.mark.parametrize("backend", ["accel", "auto", "blocked"])
@pytest.mark.parametrize("integer", [False, True])
def test_mutated_answers_match_reference_engine(backend, integer):
    base = make_powerlaw_csr(n=90, seed=12)
    if integer:
        vals = np.random.default_rng(12).integers(1, 4, base.nnz)
        g = RefCSR(base.rowptr, base.colidx, vals.astype(np.float32),
                   base.n_cols)
    else:
        g = gcn_normalize(base)
    ref = RefEngine(backend="blocked")
    port = GraphServeEngine(device="cpu", backend=backend)
    ref.register_graph("g", g)
    port.register_graph("g", _port(g))
    rng = np.random.default_rng(4)
    if integer:
        x = rng.integers(-4, 5, (g.n_cols, 6)).astype(np.float32)
    else:
        x = rng.normal(size=(g.n_cols, 6)).astype(np.float32)
    try:
        for step in range(3):
            kw = _delta_kw(g, 60 + step, k=4, integer=integer)
            g = RefDelta(**kw).apply(g)
            want_info = ref.mutate("g", RefDelta(**kw)).result(timeout=30)
            got_info = port.mutate("g", EdgeDelta(**kw)).result(timeout=30)
            assert got_info == want_info
            want = np.asarray(ref.submit("g", jnp.asarray(x)).result(
                timeout=30))
            got = port.submit("g", torch.from_numpy(x)).result(
                timeout=30).numpy()
            if integer:
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(got, _dense(g) @ x)
            else:
                bound = _pair_bound(g, x, port.config.deg_bound)
                assert np.all(np.abs(got - want) <= bound)
        assert port.graph_version("g") == ref.graph_version("g") == 3
        s, rs = port.stats(), ref.stats()
        for k in ("mutations_applied", "mutation_edges", "plan_repairs",
                  "plan_rebuilds"):
            assert s[k] == rs[k], k
        assert port.plan_for("g").key[0] == ref.plan_for("g").key[0]
    finally:
        ref.close()
        port.close()
