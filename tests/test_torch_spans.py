"""The port's span recorder (``repro_torch.spans``): nothing recorded while
off, parents and self time while on, spans begun on another thread, the
epoch clock against an exported profiler trace, and the spans placed in
the plan build and the training step, which change none of the numbers
the program computes."""
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core.graph import csr_transpose, gcn_normalize
from repro_torch.data.graphs import make_power_law_graph
from repro_torch.examples import train_gcn
from repro_torch.models.gcn import GraphOp, init_gcn

PLAN_STAGES = ("plan.hash", "plan.sort", "plan.partition", "plan.pack",
               "plan.copy")


@pytest.fixture(autouse=True)
def _off_and_empty():
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def _by_name(got):
    out = {}
    for s in got["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_records_nothing():
    assert not spans.enabled()
    with spans.span("a", rows=3) as s:
        s.set(bytes=4)
        with spans.span("b"):
            pass
    # one shared null context: nothing made while off
    assert spans.span("x") is spans.span("y", n=1)
    got = spans.drain()
    assert got["spans"] == []
    assert got["dropped"] == 0


def test_nesting_parents_and_self_time():
    spans.enable()
    with spans.span("a", cpu_clock=True, rows=3) as a:
        with spans.span("b"):
            time.sleep(0.002)
        with spans.span("c") as c:
            c.set(bytes=8)
        a.set(blocks=2)
    got = spans.drain()
    assert spans.drain()["spans"] == []
    by = _by_name(got)
    a, b, c = by["a"][0], by["b"][0], by["c"][0]
    # spans are kept in the order they ended
    assert [s["name"] for s in got["spans"]] == ["b", "c", "a"]
    assert a["parent"] is None and b["parent"] == a["id"] \
        and c["parent"] == a["id"]
    assert a["attrs"] == {"rows": 3, "blocks": 2} and c["attrs"] == {
        "bytes": 8}
    for kid in (b, c):
        assert a["start_ns"] <= kid["start_ns"] <= kid["end_ns"] \
            <= a["end_ns"]
    assert b["end_ns"] <= c["start_ns"]
    # a parent's self time: its span less the part its children cover
    dur = a["end_ns"] - a["start_ns"]
    kids = sum(s["end_ns"] - s["start_ns"] for s in (b, c))
    assert 0 <= dur - kids < dur
    # the thread's CPU time only where the span asked for it
    assert a["cpu_ns"] >= 0 and b["cpu_ns"] is None and c["cpu_ns"] is None
    assert {s["tid"] for s in got["spans"]} == {threading.get_ident()}


def test_a_span_on_another_thread_has_no_parent():
    """As the autograd engine's backward does on a card: a span begun on
    another thread while one is open here has no parent on its thread."""
    spans.enable()
    with spans.span("train.backward"):
        t = threading.Thread(target=lambda: spans.span("aggr.bwd")
                             .__enter__().__exit__(None, None, None))
        with spans.span("inner"):
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    by = _by_name(spans.drain())
    bwd, outer = by["aggr.bwd"][0], by["train.backward"][0]
    assert bwd["parent"] is None and bwd["tid"] != outer["tid"]
    assert by["inner"][0]["parent"] == outer["id"]
    assert outer["start_ns"] <= bwd["start_ns"] <= outer["end_ns"]


def test_dropped_past_the_cap(monkeypatch):
    monkeypatch.setattr(spans, "MAX_SPANS", 2)
    spans.enable()
    for _ in range(5):
        with spans.span("x"):
            pass
    got = spans.drain()
    assert len(got["spans"]) == 2 and got["dropped"] == 3


def test_epoch_offset_puts_spans_on_the_trace_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans.enable()
        for i in range(6):
            with spans.span(f"clock{i}"):
                time.sleep(0.001)
        spans.disable()
    got = spans.drain()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = float(trace["baseTimeNanoseconds"])
    events = {e["name"]: e for e in trace["traceEvents"]
              if e.get("name", "").startswith(spans.PREFIX)
              and e.get("ph") == "X"}
    skew = []
    for s in got["spans"]:
        e = events[spans.PREFIX + s["name"]]
        skew.append(abs(float(e["ts"]) * 1e3 + base
                        - (s["start_ns"] + got["epoch_offset_ns"])))
    assert len(skew) == 6
    # the first span in a profile also pays the profiler's first record
    assert float(np.median(skew)) < 1e6


def _tiny_steps(on: bool, steps: int = 3):
    prob = train_gcn.build_problem("tiny", device="cpu")
    if on:
        spans.enable()
    losses = [train_gcn.sgd_step(prob.params, prob.aggr, prob.x,
                                 prob.labels, "gcn", 1e-2)
              for _ in range(steps)]
    spans.disable()
    return losses, prob.params, spans.drain()


def test_sgd_step_with_spans_on_is_bit_identical():
    l_off, p_off, got_off = _tiny_steps(False)
    l_on, p_on, got = _tiny_steps(True)
    assert l_on == l_off
    for a, b in zip(p_on, p_off):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert got_off["spans"] == []
    by = _by_name(got)
    # a step: 5 spans of its own, one for each of its 3 layers and 3 for
    # each of its 6 aggregations
    assert len(got["spans"]) == 3 * 26
    steps = {s["id"] for s in by["train.step"]}
    for name in ("train.forward", "train.update", "train.readback"):
        assert {s["parent"] for s in by[name]} <= steps, name
    assert len(by["aggr.fwd"]) == len(by["aggr.bwd"]) == 9
    # of a step's spans, only the aggregations carry an attribute, the
    # width, and the layers theirs: every trained gcn layer transforms first
    assert [s["attrs"] for s in by["aggr.fwd"]] == [
        {"f": 128}, {"f": 16}, {"f": 16}] * 3
    assert [s["attrs"] for s in by["aggr.bwd"]] == [
        {"f": 16}, {"f": 16}, {"f": 128}] * 3
    assert "layer.aggr_first" not in by
    assert [s["attrs"] for s in by["layer.transform_first"]] == [
        {"d_in": 64, "d_out": 128, "held_bytes": 0},
        {"d_in": 128, "d_out": 16, "held_bytes": 0},
        {"d_in": 16, "d_out": 16, "held_bytes": 0}] * 3
    assert all(s["attrs"] == {} for s in got["spans"]
               if not s["name"].startswith(("aggr.", "layer.")))
    assert all(s["cpu_ns"] is None for s in got["spans"])


@pytest.mark.parametrize("variant,dims,fwd,bwd", [
    ("sage", [602, 256, 41], [256, 41], [41, 256]),
    ("gcn", [128, 256, 256, 40], [256, 256, 40], [40, 256, 256]),
])
def test_aggregation_spans_carry_the_width_each_layer_gathers(variant, dims,
                                                               fwd, bwd):
    """One SGD step of the benchmark cells' models on a small graph: the
    aggregations' spans show where each layer placed its aggregation."""
    g = gcn_normalize(make_power_law_graph(120, 600, seed=3))
    aggr = GraphOp.build(g, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = init_gcn(gen, dims, variant, device="cpu")
    x = torch.randn((g.n_rows, dims[0]), generator=gen)
    y = torch.randint(0, dims[-1], (g.n_rows,), generator=gen)
    spans.enable()
    train_gcn.sgd_step(params, aggr, x, y, variant, 1e-2)
    spans.disable()
    by = _by_name(spans.drain())
    assert [s["attrs"]["f"] for s in by["aggr.fwd"]] == fwd
    assert [s["attrs"]["f"] for s in by["aggr.bwd"]] == bwd


def test_graph_op_build_with_spans_on_same_slabs_and_six_stages():
    g = train_gcn.build_problem("tiny", device="cpu").graph
    off = GraphOp.build(g, device="cpu")
    spans.enable()
    on = GraphOp.build(g, device="cpu")
    spans.disable()
    got = spans.drain()
    for a, b in ((off.fwd, on.fwd), (off.bwd, on.bwd)):
        assert torch.equal(a.inv_perm, b.inv_perm)
        for k, v in a.slabs.items():
            assert (torch.equal(v, b.slabs[k]) if isinstance(v, torch.Tensor)
                    else v == b.slabs[k]), k
    by = _by_name(got)
    assert len(by["plan.build"]) == len(by["plan.transpose"]) == 1
    for name in PLAN_STAGES:
        assert len(by[name]) == 2, name
    build = by["plan.build"][0]
    assert all(s["cpu_ns"] >= 0 for s in got["spans"])
    assert all(s["parent"] == build["id"] for s in got["spans"]
               if s["name"] != "plan.build")
    assert by["plan.transpose"][0]["attrs"] == {"nnz": g.nnz}
    g_t = csr_transpose(g)
    nbytes = {s["attrs"]["bytes"] for s in by["plan.hash"]}
    assert nbytes == {8 * (g.n_rows + 1) + 12 * g.nnz + 24,
                      8 * (g_t.n_rows + 1) + 12 * g_t.nnz + 24}
    for s, op in zip(by["plan.pack"], (on.fwd, on.bwd)):
        assert s["attrs"] == {"slots": op.plan.num_blocks * op.slabs["C"]}
    for s, op in zip(by["plan.copy"], (on.fwd, on.bwd)):
        assert s["attrs"]["bytes"] == op.plan.device_bytes()
    for s, op in zip(by["plan.partition"], (on.fwd, on.bwd)):
        assert s["attrs"]["blocks"] == op.plan.num_blocks
        assert 0 <= s["attrs"]["split_rows"] <= op.n_rows
