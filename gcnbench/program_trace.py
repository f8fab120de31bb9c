"""The program's own spans (``repro_torch.spans``) in a training cell,
reduced to what the ``program_span`` metrics read.

A traced run (``--trace 1``) of a training cell leaves the driver's record
as it is and, when a reader first asks, makes a pass of its own with the
program's spans on (``program_pass``), on the run's ``--workload`` and
``--seed``: it builds the cell's operator again with spans on and keeps the
plan build's spans (``record["plan_spans"]``), then, in one
``torch.profiler`` session, runs one step, a stretch of as many steps as
the driver's traced one with spans off (range ``gcnbench.spans_off``), and
the same again with spans on inside the window range
(``record["program"]``). The driver's stretch, which every older metric and
the ``breakdown`` read, ran with spans off; the spans-on stretch's step time
against the pass's spans-off one, and against the driver's, is the cost of
the spans when on, which the pass logs. A program without spans, or a run
without a card, leaves the record without these keys and the readers find
nothing; a pass that fails, or finds a span its readers need missing, ends
the run.

``record["plan_spans"]``: by span name, summed over both plans, ``wall_s``,
``cpu_s`` (the thread's CPU time), ``self_s`` (wall less the children's),
``count`` and ``attrs`` (each numeric attribute, summed); ``build_s``, the
pass's own host clock around ``GraphOp.build`` ending in a synchronise, as
``plan_build_s`` reads the driver's.

``record["program"]`` (times in seconds over a stretch): of the spans-on
stretch, ``steps`` (the ``train.step`` spans), ``window_s``, ``busy_s``;
``span_device_s``, the device time of the work launched inside each span
name, joined by correlation id on the span's own thread (the autograd
engine's spans included); ``idle_by_span_s``, its idle stretches, those
that contain the end of a loss readback (``aten::_local_scalar_dense``,
where the step waits for the device to drain) under ``at_sync`` and every
other by the innermost ``train.*`` span open at its midpoint (``none``
where none is); ``readbacks``, the readbacks inside a ``train.readback``
span and in all; ``host_self_s``, each span name's host time less its
children's, the autograd engine's spans placed under the span of the
stepping thread open when they began; and the clocks: ``epoch_offset_ns``
and ``clock_skew_us``, how far each span's recorded start lies from its
event in the trace (largest and median). ``spans_off``: of the spans-off
stretch, ``steps``, ``host_s`` (its host clock), ``window_s``, ``busy_s``,
``idle_at_sync_s`` and ``idle_in_step_s`` (every other idle stretch), which
the idle metrics read: the spans' host cost when on lands in the device's
idle gaps, so the spans only label them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .tracing import _DEVICE_CATS, _LAUNCH_CATS, WINDOW, _union

PREFIX = "repro_torch."
PLAN_STAGES = ("plan.transpose", "plan.hash", "plan.sort", "plan.partition",
               "plan.pack", "plan.copy")
# the spans of a step the readers read
STEP_SPANS = ("train.step", "train.readback", "spmm.unpermute")
OFF_WINDOW = "gcnbench.spans_off"
READBACK = "aten::_local_scalar_dense"
AT_SYNC = "at_sync"
NO_SPAN = "none"
# the program's spans are host ranges of either kind
_SPAN_CATS = ("user_annotation", "cpu_op")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parent_of(spans: List[dict]) -> Dict[int, Optional[int]]:
    """Each span's parent; one with none on its own thread goes under the
    innermost span of another thread open when it began."""
    out = {s["id"]: s["parent"] for s in spans}
    for s in spans:
        if s["parent"] is not None:
            continue
        cover = [o for o in spans if o["tid"] != s["tid"]
                 and o["start_ns"] <= s["start_ns"] <= o["end_ns"]]
        if cover:
            out[s["id"]] = min(
                cover, key=lambda o: o["end_ns"] - o["start_ns"])["id"]
    return out


def self_s(spans: List[dict]) -> Dict[str, float]:
    """Host seconds by span name less the part its children cover."""
    parent = parent_of(spans)
    kids: Dict[int, list] = defaultdict(list)
    for s in spans:
        if parent[s["id"]] is not None:
            kids[parent[s["id"]]].append((s["start_ns"], s["end_ns"]))
    out: Dict[str, float] = defaultdict(float)
    for s in spans:
        iv = np.asarray(kids.get(s["id"], []), dtype=np.float64).reshape(-1, 2)
        iv = _union(np.clip(iv, s["start_ns"], s["end_ns"]))
        covered = float((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0.0
        out[s["name"]] += (s["end_ns"] - s["start_ns"] - covered) * 1e-9
    return dict(out)


def plan_stages(drained: dict) -> dict:
    """The plan build's spans, summed by name."""
    spans = drained["spans"]
    out = {"wall_s": defaultdict(float), "cpu_s": defaultdict(float),
           "count": defaultdict(int),
           "attrs": defaultdict(lambda: defaultdict(int))}
    for s in spans:
        out["wall_s"][s["name"]] += (s["end_ns"] - s["start_ns"]) * 1e-9
        out["cpu_s"][s["name"]] += (s["cpu_ns"] or 0) * 1e-9
        out["count"][s["name"]] += 1
        for k, v in s["attrs"].items():
            out["attrs"][s["name"]][k] += int(v)
    out = {k: {n: dict(v) if isinstance(v, dict) else v
               for n, v in d.items()} for k, d in out.items()}
    out["self_s"] = self_s(spans)
    out["dropped"] = drained["dropped"]
    return out


def _intervals_by_tid(xs: List[dict], name: str) -> Dict[object, np.ndarray]:
    per: Dict[object, list] = defaultdict(list)
    for e in xs:
        if e["name"] == name:
            per[e.get("tid")].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return {t: np.asarray(sorted(v), dtype=np.float64)
            for t, v in per.items()}


def _innermost(xs: List[dict], t: float) -> Optional[dict]:
    cover = [e for e in xs
             if float(e["ts"]) <= t <= float(e["ts"]) + float(e["dur"])]
    return min(cover, key=lambda e: float(e["dur"])) if cover else None


def _window(xs: List[dict], name: str) -> Optional[Tuple[float, float]]:
    win = [e for e in xs if e.get("name") == name
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    return float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])


def _end(e: dict) -> float:
    return float(e["ts"]) + float(e["dur"])


def idle_gaps(dev: List[dict], w0: float, w1: float
              ) -> Tuple[float, np.ndarray]:
    """The device's busy microseconds in [w0, w1] and its idle stretches
    there, as a [k, 2] array."""
    iv = np.asarray([[float(e["ts"]), _end(e)] for e in dev],
                    dtype=np.float64).reshape(-1, 2)
    iv = np.clip(iv, w0, w1)
    busy = _union(iv[iv[:, 1] > iv[:, 0]])
    busy_us = float((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0.0
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    return busy_us, edges[edges[:, 1] > edges[:, 0]]


def _at_sync(gaps: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Which idle stretches contain the end of a readback."""
    if not len(ends):
        return np.zeros(len(gaps), dtype=bool)
    return np.asarray([bool(np.any((ends >= a) & (ends <= b)))
                       for a, b in gaps], dtype=bool)


def reduce_program(events: List[dict], drained: dict,
                   base_ns: float = 0.0) -> dict:
    """``record["program"]`` from a Chrome trace's events (microseconds)
    and the spans drained over the spans-on stretch (see the module); {}
    where the trace lacks either stretch's range."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    on, off = _window(xs, WINDOW), _window(xs, OFF_WINDOW)
    if on is None or off is None:
        return {}
    w0, w1 = on
    prog = [e for e in xs if e.get("cat") in _SPAN_CATS
            and e["name"].startswith(PREFIX) and w0 <= float(e["ts"]) <= w1]
    names = sorted({e["name"] for e in prog})
    dev = [e for e in xs if e.get("cat") in _DEVICE_CATS]
    reads = [e for e in xs if e.get("name") == READBACK
             and e.get("cat") == "cpu_op"]

    # device time launched inside each span name, on the span's thread
    launches = {}
    for e in xs:
        if e.get("cat") in _LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (float(e["ts"]), e.get("tid"))
    ranges = {n: _intervals_by_tid(prog, n) for n in names}
    span_dev: Dict[str, float] = defaultdict(float)
    for e in dev:
        corr = (e.get("args") or {}).get("correlation")
        if corr not in launches:
            continue
        ts, tid = launches[corr]
        for n, per_tid in ranges.items():
            r = per_tid.get(tid)
            if r is None:
                continue
            k = int(np.searchsorted(r[:, 0], ts, side="right")) - 1
            if k >= 0 and ts <= r[k, 1]:
                span_dev[n[len(PREFIX):]] += float(e["dur"]) * 1e-6

    # the spans-on stretch's idle, labelled by the step's spans
    busy_us, gaps = idle_gaps(dev, w0, w1)
    reads_on = [e for e in reads if w0 <= float(e["ts"]) <= w1]
    sync = _at_sync(gaps, np.asarray([_end(e) for e in reads_on]))
    train = [e for e in prog if e["name"].startswith(PREFIX + "train.")]
    rb = [e for e in train if e["name"] == PREFIX + "train.readback"]
    idle_by_span: Dict[str, float] = defaultdict(float)
    for (a, b), s in zip(gaps, sync):
        if s:
            label = AT_SYNC
        else:
            inner = _innermost(train, 0.5 * (a + b))
            label = inner["name"][len(PREFIX):] if inner else NO_SPAN
        idle_by_span[label] += (b - a) * 1e-6
    in_rb = sum(_innermost(rb, float(e["ts"])) is not None for e in reads_on)

    # the spans-off stretch's idle, which the idle metrics read
    o0, o1 = off
    busy_off, gaps_off = idle_gaps(dev, o0, o1)
    sync_off = _at_sync(gaps_off, np.asarray(
        [_end(e) for e in reads if o0 <= float(e["ts"]) <= o1]))
    gap_s = (gaps_off[:, 1] - gaps_off[:, 0]) * 1e-6
    spans_off = {"window_s": (o1 - o0) * 1e-6, "busy_s": busy_off * 1e-6,
                 "idle_at_sync_s": float(gap_s[sync_off].sum()),
                 "idle_in_step_s": float(gap_s[~sync_off].sum())}

    # each recorded span beside its event in the trace, in start order
    offset = drained.get("epoch_offset_ns", 0)
    by_name: Dict[str, list] = defaultdict(list)
    for e in sorted(prog, key=lambda e: float(e["ts"])):
        by_name[e["name"][len(PREFIX):]].append(float(e["ts"]) * 1e3
                                                + base_ns)
    skew = []
    rec_by_name: Dict[str, list] = defaultdict(list)
    for s in drained["spans"]:
        rec_by_name[s["name"]].append(s["start_ns"] + offset)
    for n, starts in rec_by_name.items():
        if len(starts) == len(by_name.get(n, ())):
            skew += [abs(t - s) * 1e-3
                     for t, s in zip(by_name[n], sorted(starts))]

    return {"steps": len(by_name.get("train.step", ())),
            "window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "span_events": {n: len(v) for n, v in by_name.items()},
            "span_device_s": dict(span_dev),
            "idle_by_span_s": dict(idle_by_span),
            "readbacks": [in_rb, len(reads_on)],
            "spans_off": spans_off,
            "host_self_s": self_s(drained["spans"]),
            "dropped": drained.get("dropped", 0),
            "epoch_offset_ns": offset,
            "clock_skew_us": ([max(skew), float(np.median(skew))]
                              if skew else None)}


def profiled_steps(step: Callable[[], None], n_steps: int, spans) -> dict:
    """``n_steps`` calls of ``step`` with the program's spans on, inside the
    window range of a profiler session, reduced by ``reduce_program``.
    Before the window, in the same session:
    one step with spans on, whose spans are dropped (the launches of a
    session's first milliseconds may go unrecorded, and its first range
    pays the profiler's first record), then ``n_steps`` with spans off
    inside the range ``gcnbench.spans_off``, timed on the host clock too
    (the control for the spans' cost)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def sync() -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        spans.enable()
        step()
        sync()
        spans.disable()
        spans.drain()
        t0 = time.perf_counter()
        with record_function(OFF_WINDOW):
            for _ in range(n_steps):
                step()
            sync()
        off_s = time.perf_counter() - t0
        spans.enable()
        try:
            with record_function(WINDOW):
                for _ in range(n_steps):
                    step()
                sync()
        finally:
            spans.disable()
    drained = spans.drain()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    out = reduce_program(trace["traceEvents"], drained,
                         float(trace.get("baseTimeNanoseconds", 0)))
    if out:
        out["spans_off"].update(steps=n_steps, host_s=off_s)
    return out


def missing_spans(plan: dict, prog: dict) -> List[str]:
    """The spans the readers need that a pass did not record."""
    out = [n for n in PLAN_STAGES if not plan.get("count", {}).get(n)]
    events = prog.get("span_events") or {}
    return out + [n for n in STEP_SPANS if not events.get(n)]


def program_pass(cell, device: torch.device, n_steps: int, seed: int,
                 log: Callable[[str], None] = _log, data_dir=None) -> dict:
    """The plan build and ``n_steps`` steps of the cell with the program's
    spans on: ``{"plan_spans": ..., "program": ...}``. Raises where a span
    the readers need was not recorded."""
    from repro_torch import spans

    from .drivers.train import TrainCell

    def plog(msg: str) -> None:
        log(f"program pass: {msg}")

    spans.enable()
    try:
        tc = TrainCell(cell, device, plog, data_dir)
    finally:
        spans.disable()
        drained = spans.drain()
    plan = plan_stages(drained)
    plan["build_s"] = tc.plan_build_s
    params, x, y = tc.inputs(seed)
    prog = profiled_steps(lambda: tc.step(params, x, y), n_steps, spans)
    missing = missing_spans(plan, prog)
    if missing:
        raise RuntimeError(f"the program's pass recorded no {missing}: the "
                           f"program_span metrics have nothing to read")
    if prog["readbacks"][0] != prog["readbacks"][1]:
        raise RuntimeError(
            f"{prog['readbacks'][1] - prog['readbacks'][0]} host readbacks "
            f"outside train.readback: the idle at the loss readback would "
            f"count them")
    return {"plan_spans": plan, "program": prog}


def run_args(argv: Optional[List[str]] = None) -> Tuple[str, int]:
    """The ``--workload`` and ``--seed`` of this run, from the command line
    of ``gcnbench/run.py`` (the driver's record holds neither)."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    got = ap.parse_known_args(sys.argv[1:] if argv is None else argv)[0]
    if got.workload is None or got.seed is None:
        raise RuntimeError("the program's pass runs under gcnbench/run.py, "
                           "whose --workload and --seed it takes")
    return got.workload, got.seed


def filled(rec: dict) -> dict:
    """``rec``, with ``plan_spans`` and ``program`` from ``program_pass``
    where it lacks them and came from a traced run of a training cell on a
    card of a program that has spans. The pass is tried once for a
    record."""
    if "program_pass" in rec or "program" in rec or "plan_spans" in rec:
        return rec
    rec["program_pass"] = "not run"
    if not rec.get("trace") or "config" not in rec \
            or not torch.cuda.is_available():
        return rec
    try:
        import repro_torch.spans  # noqa: F401
    except ModuleNotFoundError as e:
        if e.name != "repro_torch.spans":
            raise
        rec["program_pass"] = "the program has no spans"
        return rec
    from . import spec
    workload, seed = run_args()
    cell = spec.load_cell(workload)
    if cell.traffic.get("driver") != "train":
        return rec
    rec.update(program_pass(cell, torch.device("cuda", 0),
                            int(rec["traced_steps"]), seed))
    rec["program_pass"] = "done"
    _log_pass(rec)
    return rec


def _log_pass(rec: dict) -> None:
    """What the pass read, beside the driver's stretch: the cost of the
    spans when on, the plan stages' rates and the numbers the metrics do
    not carry."""
    prog, plan = rec["program"], rec["plan_spans"]
    off = prog["spans_off"]
    on = prog["window_s"] / prog["steps"] if prog.get("steps") else None
    for what, window, n in (
            ("the pass's stretch with spans off", off.get("host_s"),
             off.get("steps")),
            ("the driver's traced stretch",
             (rec.get("trace") or {}).get("window_s"), rec["traced_steps"])):
        if on and window and n:
            _log(f"program pass: step {on * 1e3:.4f} ms with spans on "
                 f"against {window / n * 1e3:.4f} ms in {what} "
                 f"({100 * (on / (window / n) - 1):+.2f}%)")
    if on and off.get("steps"):
        idle_on = (prog["window_s"] - prog["busy_s"]) / prog["steps"]
        idle_off = (off["window_s"] - off["busy_s"]) / off["steps"]
        _log(f"program pass: device idle {idle_on * 1e3:.4f} ms a step with "
             f"spans on against {idle_off * 1e3:.4f} ms with spans off")
    stages = sum(plan["wall_s"].get(n, 0.0) for n in PLAN_STAGES)
    _log(f"program pass: plan stages {stages:.3f} s of the pass's build "
         f"{plan['build_s']:.3f} s and the driver's "
         f"{rec.get('plan_build_s')} s")
    rates = [f"{n} {k} {v:.4g} at {v / plan['wall_s'][n]:.4g}/s"
             for n, attrs in sorted(plan["attrs"].items())
             for k, v in sorted(attrs.items()) if plan["wall_s"].get(n)]
    _log("program pass: plan rates: " + "; ".join(rates))
    _log("program pass: " + json.dumps({"plan_spans": plan,
                                        "program": prog}))


def per_step_ms(seconds: Optional[float], steps: Optional[int]
                ) -> Optional[float]:
    """``seconds`` over ``steps`` steps as milliseconds a step, or None."""
    if seconds is None or not steps:
        return None
    return 1e3 * seconds / steps


def plan_stage_s(rec: dict, name: str) -> Optional[float]:
    """Seconds of the plan spans ``name`` over both plans, or None."""
    plan = filled(rec).get("plan_spans") or {}
    return (plan.get("wall_s") or {}).get(name)
