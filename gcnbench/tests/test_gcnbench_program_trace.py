"""The reduction of the program's spans (``gcnbench/program_trace.py``) on a
Chrome trace made by hand, the ten ``program_span`` readers on records
made by hand, the pass on a tiny cell on the CPU and what ends it, and the
older readers' keys, which the driver's stretch alone still fills."""
import pytest
import torch

from gcnbench import program_trace as pt
from gcnbench import spec
from gcnbench.tracing import WINDOW

MAIN, AUTOGRAD = 1, 2
BASE_NS = 1.0e15


def _span(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": pt.PREFIX + name,
            "ts": ts, "dur": dur, "tid": tid}


def _launch(corr, ts, tid):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 2, "tid": tid, "args": {"correlation": corr}}


def _kernel(corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts, "dur": dur,
            "tid": 7, "args": {"correlation": corr}}


def _readback(ts, dur):
    return {"ph": "X", "cat": "cpu_op", "name": pt.READBACK, "ts": ts,
            "dur": dur, "tid": MAIN}


# one step in a 1000 us window: the forward's aggregation on the stepping
# thread, the backward's on the autograd engine's, the loss read back last
SPANS = [("train.step", 10, 900, MAIN), ("train.forward", 10, 300, MAIN),
         ("aggr.fwd", 20, 100, MAIN), ("spmm.kernel", 20, 50, MAIN),
         ("spmm.unpermute", 70, 50, MAIN),
         ("train.backward", 310, 300, MAIN),
         ("aggr.bwd", 320, 100, AUTOGRAD),
         ("spmm.unpermute", 370, 50, AUTOGRAD),
         ("train.update", 610, 100, MAIN),
         ("train.readback", 710, 200, MAIN)]


def _events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0,
           "dur": 1000, "tid": MAIN}]
    ev += [_span(*s) for s in SPANS]
    ev += [_launch(1, 25, MAIN), _kernel(1, 100, 200),      # the kernel
           _launch(2, 75, MAIN), _kernel(2, 300, 20),       # un-permute
           _launch(3, 380, AUTOGRAD), _kernel(3, 400, 30),  # un-permute
           _launch(4, 320, MAIN), _kernel(4, 430, 70),      # a product
           _launch(5, 715, MAIN), _kernel(5, 800, 10, "gpu_memcpy"),
           _readback(720, 185)]
    # the same step before it with spans off: idle [2000, 2100], [2300,
    # 2400] between launches and [2500, 2800] at the readback (ends 2700)
    ev += [{"ph": "X", "cat": "user_annotation", "name": pt.OFF_WINDOW,
            "ts": 2000, "dur": 800, "tid": MAIN},
           _launch(6, 2010, MAIN), _kernel(6, 2100, 200),
           _launch(7, 2020, MAIN), _kernel(7, 2400, 100),
           _readback(2600, 100)]
    return ev


def _drained(skew_us=5.0, offset_ns=123):
    """The spans as the recorder keeps them, ``skew_us`` before their
    events on the epoch clock."""
    out = []
    for i, (name, ts, dur, tid) in enumerate(SPANS):
        start = ts * 1e3 + BASE_NS - offset_ns - skew_us * 1e3
        out.append({"name": name, "id": i, "parent": None, "tid": tid,
                    "start_ns": start, "end_ns": start + dur * 1e3,
                    "cpu_ns": 0, "attrs": {}})
    return {"spans": out, "dropped": 0, "epoch_offset_ns": offset_ns}


def test_reduce_program_by_hand():
    got = pt.reduce_program(_events(), _drained(), BASE_NS)
    assert got["steps"] == 1
    assert got["window_s"] == pytest.approx(1e-3)
    # busy [100, 320], [400, 500], [800, 810]
    assert got["busy_s"] == pytest.approx(330e-6)
    dev = got["span_device_s"]
    assert dev["spmm.kernel"] == pytest.approx(200e-6)
    # the forward's and the autograd engine's, each on its own thread
    assert dev["spmm.unpermute"] == pytest.approx(50e-6)
    assert dev["aggr.fwd"] == pytest.approx(220e-6)
    assert dev["aggr.bwd"] == pytest.approx(30e-6)
    assert dev["train.backward"] == pytest.approx(70e-6)
    assert dev["train.readback"] == pytest.approx(10e-6)
    assert dev["train.step"] == pytest.approx(300e-6)
    # the gap [810, 1000] holds the readback's end (905)
    assert got["idle_by_span_s"] == pytest.approx(
        {pt.AT_SYNC: 190e-6, "train.forward": 100e-6,
         "train.backward": 80e-6, "train.update": 300e-6})
    idle = got["window_s"] - got["busy_s"]
    assert sum(got["idle_by_span_s"].values()) == pytest.approx(idle)
    assert got["readbacks"] == [1, 1]
    assert got["span_events"]["train.step"] == 1
    assert got["span_events"]["spmm.unpermute"] == 2
    # the metrics' idle, from the stretch with spans off
    off = got["spans_off"]
    assert off["window_s"] == pytest.approx(800e-6)
    assert off["busy_s"] == pytest.approx(300e-6)
    assert off["idle_at_sync_s"] == pytest.approx(300e-6)
    assert off["idle_in_step_s"] == pytest.approx(200e-6)
    assert got["clock_skew_us"] == pytest.approx([5.0, 5.0])
    assert got["epoch_offset_ns"] == 123


def test_idle_with_no_span_open_and_no_window():
    ev = _events()
    # a readback outside train.readback is counted apart
    got = pt.reduce_program(
        [e for e in ev if e["name"] != pt.PREFIX + "train.readback"],
        _drained(), BASE_NS)
    assert got["readbacks"] == [0, 1]
    assert "train.readback" not in got["span_events"]
    ev = [e for e in ev if e["name"] not in (pt.PREFIX + "train.readback",
                                             pt.READBACK)]
    got = pt.reduce_program(ev, _drained(), BASE_NS)
    # the last gap [810, 1000] now lies in the step and no child of it
    assert pt.AT_SYNC not in got["idle_by_span_s"]
    assert got["idle_by_span_s"]["train.step"] == pytest.approx(190e-6)
    assert got["spans_off"]["idle_at_sync_s"] == 0.0
    assert got["spans_off"]["idle_in_step_s"] == pytest.approx(500e-6)
    ev[0]["dur"] = 1200               # the window outlasts the step
    got = pt.reduce_program(ev, _drained(), BASE_NS)
    assert got["idle_by_span_s"][pt.NO_SPAN] == pytest.approx(390e-6)
    assert "train.step" not in got["idle_by_span_s"]
    assert pt.reduce_program(ev[1:], _drained()) == {}
    # nor without the stretch with spans off
    assert pt.reduce_program([e for e in ev if e["name"] != pt.OFF_WINDOW],
                             _drained()) == {}


def test_autograd_spans_placed_under_the_backward_by_time():
    d = _drained()["spans"]
    for s in d:           # the stepping thread's nesting, as recorded
        if s["tid"] == MAIN and s["name"] != "train.step":
            s["parent"] = 0
    d[4]["parent"] = 2    # the forward's un-permute in its aggregation
    d[7]["parent"] = 6    # the backward's in its aggregation
    parent = pt.parent_of(d)
    assert parent[6] == 5                      # aggr.bwd -> train.backward
    self_s = pt.self_s(d)
    # train.backward's 300 us less the autograd engine's 100
    assert self_s["train.backward"] == pytest.approx(200e-6)
    assert self_s["aggr.bwd"] == pytest.approx(50e-6)


def test_plan_stages_sum_by_name():
    spans = [{"name": "plan.build", "id": 0, "parent": None, "tid": 1,
              "start_ns": 0, "end_ns": 10e9, "cpu_ns": 9e9, "attrs": {}}]
    for i, (name, a, b) in enumerate([("plan.sort", 0, 2e9),
                                      ("plan.sort", 5e9, 6e9),
                                      ("plan.hash", 2e9, 4e9)]):
        spans.append({"name": name, "id": i + 1, "parent": 0, "tid": 1,
                      "start_ns": a, "end_ns": b, "cpu_ns": b - a,
                      "attrs": {}})
    spans[1]["attrs"] = {"rows": 5, "nnz": 7}
    spans[2]["attrs"] = {"rows": 5, "nnz": 9}
    spans.append({"name": "plan.pack", "id": 4, "parent": 0, "tid": 1,
                  "start_ns": 6e9, "end_ns": 7e9, "cpu_ns": None,
                  "attrs": {"slots": 40}})
    got = pt.plan_stages({"spans": spans, "dropped": 0})
    assert got["wall_s"] == pytest.approx({"plan.build": 10.0,
                                           "plan.sort": 3.0,
                                           "plan.hash": 2.0,
                                           "plan.pack": 1.0})
    assert got["count"] == {"plan.build": 1, "plan.sort": 2, "plan.hash": 1,
                            "plan.pack": 1}
    assert got["cpu_s"]["plan.build"] == pytest.approx(9.0)
    assert got["cpu_s"]["plan.pack"] == 0.0     # no CPU clock asked for
    assert got["self_s"]["plan.build"] == pytest.approx(4.0)
    assert got["attrs"] == {"plan.sort": {"rows": 10, "nnz": 16},
                            "plan.pack": {"slots": 40}}


NEW = {"plan_transpose_s": 1.0, "plan_hash_s": 2.0, "plan_sort_s": 3.0,
       "plan_partition_s": 4.0, "plan_pack_s": 5.0, "plan_copy_s": 6.0,
       "unpermute_ms.train": 0.5, "unpermute_ms.train.small_graph": 0.5,
       "idle_at_sync_ms.train.small_graph": 0.1,
       "idle_in_step_ms.train.small_graph": 0.3}


def _record():
    wall = {f"plan.{n}": v for n, v in (
        ("transpose", 1.0), ("hash", 2.0), ("sort", 3.0),
        ("partition", 4.0), ("pack", 5.0), ("copy", 6.0))}
    return {"plan_spans": {"wall_s": wall},
            "program": {"steps": 4, "span_device_s": {
                "spmm.unpermute": 2e-3, "spmm.kernel": 1.0},
                "idle_by_span_s": {pt.AT_SYNC: 9.0},
                "spans_off": {"steps": 4, "idle_at_sync_s": 0.4e-3,
                              "idle_in_step_s": 1.2e-3}}}


def test_new_readers_by_hand():
    rec = _record()
    for name, want in NEW.items():
        assert spec.metric_reader(name)(rec) == pytest.approx(want), name


def test_new_readers_find_nothing_and_return_none():
    bare = {"config": {}, "n": 5, "nnz": 7}
    for name in NEW:
        assert spec.metric_reader(name)(dict(bare)) is None, name
    # a pass that ran no step reads nothing, never 0
    rec = {"plan_spans": {"wall_s": {}},
           "program": {"steps": 0, "spans_off": {"steps": 0}}}
    for name in NEW:
        assert spec.metric_reader(name)(dict(rec)) is None, name


def test_new_entries_in_the_benchmark():
    import json
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    ours = {m["name"]: m for m in bench["per_layer"]
            if m["source"] == "program_span"}
    assert set(ours) == set(NEW)
    for name, m in ours.items():
        assert (spec.BENCH_DIR / "metrics" / f"{name}.py").is_file()
        want = (["sage-reddit.train", "gcn-arxiv.train"]
                if name.startswith("plan_") else
                ["sage-reddit.train"] if name == "unpermute_ms.train"
                else ["gcn-arxiv.train"])
        assert m["workloads"] == want, name


def _tiny_cell(tiny, workload):
    _, root, bench = tiny
    return spec.load_cell(workload, root, bench)


def test_pass_on_a_tiny_cell_on_the_cpu(tiny, tmp_path):
    cell = _tiny_cell(tiny, "gcn-arxiv.train")
    got = pt.program_pass(cell, torch.device("cpu"), 3, 2 ** 31 + 11,
                          log=lambda s: None, data_dir=tmp_path / "data")
    assert set(got) == {"plan_spans", "program"}
    plan = got["plan_spans"]
    assert plan["count"]["plan.transpose"] == plan["count"]["plan.build"] \
        == 1
    for name in pt.PLAN_STAGES[1:]:
        assert plan["count"][name] == 2, name
    stages = sum(plan["wall_s"][n] for n in pt.PLAN_STAGES)
    assert 0 < stages <= plan["wall_s"]["plan.build"]
    assert plan["build_s"] >= plan["wall_s"]["plan.build"]
    assert plan["attrs"]["plan.pack"]["slots"] > 0
    prog = got["program"]
    # three layers: 5 spans a step of its own, 3 for each of 6 aggregations
    assert prog["steps"] == 3 and prog["dropped"] == 0
    assert prog["span_events"]["aggr.fwd"] == 9
    assert prog["readbacks"] == [3, 3]
    assert prog["window_s"] > 0 and prog["busy_s"] == 0.0
    assert prog["clock_skew_us"] is not None
    assert prog["host_self_s"]["train.step"] > 0
    off = prog["spans_off"]
    assert off["steps"] == 3 and off["host_s"] > 0 and off["busy_s"] == 0.0
    assert off["idle_at_sync_s"] + off["idle_in_step_s"] == pytest.approx(
        off["window_s"])


def test_a_pass_missing_a_span_the_readers_need_ends_the_run(
        tiny, tmp_path, monkeypatch):
    plan = {"count": {n: 2 for n in pt.PLAN_STAGES}}
    prog = {"span_events": {n: 3 for n in pt.STEP_SPANS}}
    assert pt.missing_spans(plan, prog) == []
    del plan["count"]["plan.hash"]
    prog["span_events"]["spmm.unpermute"] = 0
    assert pt.missing_spans(plan, prog) == ["plan.hash", "spmm.unpermute"]
    cell = _tiny_cell(tiny, "gcn-arxiv.train")
    real = pt.profiled_steps

    def without(name):
        def steps(*a):
            out = real(*a)
            out["span_events"].pop(name, None)
            return out
        return steps

    monkeypatch.setattr(pt, "profiled_steps", without("spmm.unpermute"))
    with pytest.raises(RuntimeError, match="spmm.unpermute"):
        pt.program_pass(cell, torch.device("cpu"), 1, 3, log=lambda s: None,
                        data_dir=tmp_path / "data")

    def stray(*a):
        out = real(*a)
        out["readbacks"][1] += 1
        return out

    monkeypatch.setattr(pt, "profiled_steps", stray)
    with pytest.raises(RuntimeError, match="outside train.readback"):
        pt.program_pass(cell, torch.device("cpu"), 1, 3, log=lambda s: None,
                        data_dir=tmp_path / "data")


def test_filled_runs_the_pass_on_the_runs_workload_and_seed(monkeypatch):
    """On a card, the pass takes ``--workload`` and ``--seed`` from the
    command line; what it raises ends the run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr("sys.argv", ["gcnbench/run.py", "--workload",
                                     "gcn-arxiv.train", "--seed",
                                     str(2 ** 31 + 9), "--trace", "1"])
    assert pt.run_args() == ("gcn-arxiv.train", 2 ** 31 + 9)
    with pytest.raises(RuntimeError, match="--seed"):
        pt.run_args(["--workload", "gcn-arxiv.train"])
    seen = []

    def fake(cell, device, n_steps, seed):
        seen.append((cell.name, n_steps, seed))
        return _record()

    monkeypatch.setattr(pt, "program_pass", fake)
    monkeypatch.setattr(pt, "_log_pass", lambda rec: None)
    rec = {"trace": {"window_s": 1.0}, "config": {}, "traced_steps": 7}
    assert pt.filled(rec)["program_pass"] == "done"
    assert seen == [("gcn-arxiv.train", 7, 2 ** 31 + 9)]
    assert pt.filled(rec) is rec and len(seen) == 1   # tried once

    def broken(*a):
        raise torch.cuda.OutOfMemoryError("the second plan")

    monkeypatch.setattr(pt, "program_pass", broken)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        pt.filled({"trace": {"window_s": 1.0}, "config": {},
                   "traced_steps": 7})


def test_older_readers_read_the_drivers_stretch_alone(tiny):
    """The driver's record holds every key the seven older readers read,
    from its own stretch with spans off; the pass adds its own keys and
    none of theirs, and without a card it does not run."""
    from gcnbench.drivers import train
    from gcnbench.drivers.common import Context
    import time
    cell = _tiny_cell(tiny, "gcn-arxiv.train")
    ctx = Context(cell, 2 ** 31 + 7, 0.3, True, torch.device("cpu"),
                  time.perf_counter(), log=lambda s: None,
                  data_dir=tiny[1] / "data")
    rec = train.run(ctx)["record"]
    older = ("plan_build_s", "mfu.train", "spmm_roofline.train",
             "device_idle.train")
    assert {"plan_build_s", "step_s", "traced_steps", "aggr_calls",
            "trace"} <= set(rec)
    assert not {"program", "plan_spans"} & set(rec)
    before = {n: spec.metric_reader(n)(rec) for n in older}
    assert before["plan_build_s"] > 0 and before["mfu.train"] > 0
    for name in NEW:
        assert spec.metric_reader(name)(rec) is None
    assert rec["program_pass"] == "not run"
    rec.update(_record())
    assert {n: spec.metric_reader(n)(rec) for n in older} == before


def test_the_pass_logs_the_cost_of_spans(capsys):
    rec = {"traced_steps": 10, "plan_build_s": 2.2,
           "trace": {"window_s": 0.100},
           "plan_spans": {"wall_s": {n: 0.3 for n in pt.PLAN_STAGES},
                          "attrs": {"plan.hash": {"bytes": 600}},
                          "build_s": 2.0},
           "program": {"steps": 10, "window_s": 0.102, "busy_s": 0.092,
                       "spans_off": {"steps": 10, "host_s": 0.101,
                                     "window_s": 0.101, "busy_s": 0.093}}}
    pt._log_pass(rec)
    err = capsys.readouterr().err
    assert "(+0.99%)" in err and "(+2.00%)" in err
    assert "plan stages 1.800 s of the pass's build 2.000 s" in err
    assert "device idle 1.0000 ms a step with spans on against 0.8000 ms" \
        in err
    assert "plan.hash bytes 600 at 2000/s" in err
