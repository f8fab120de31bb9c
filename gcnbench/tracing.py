"""A bounded stretch of a run under ``torch.profiler``, reduced to what the
per-layer metrics and the result's ``breakdown`` read.

The stretch runs inside a host range ``gcnbench.window`` and ends with a
synchronise, so the range's length is the traced window. From the exported
Chrome trace:

* ``busy_s``: the union of the device's kernel, copy and set intervals
  inside the window;
* ``range_device_s[name]``: the device time of the work launched inside the
  harness's host ranges of that name: a kernel belongs to a range when the
  runtime or driver call that launched it (joined by its correlation id)
  lies inside such a range on the same host thread, whatever the kernel is
  called;
* ``device_ops``: device time by kernel name, the ten largest;
* ``idle_gaps``: the longest idle stretches of the device, labelled by the
  innermost host operation running at their midpoint, summed by label.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List

import numpy as np
import torch

WINDOW = "gcnbench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_GAPS_LABELLED = 200


@contextmanager
def traced(out: dict):
    """Profile the body; on exit fill ``out`` with the reduction above."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out.update(reduce_events(events))


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged, sorted intervals of an [k, 2] array."""
    if not len(iv):
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0])]
    merged = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return np.asarray(merged, dtype=np.float64)


def reduce_events(events: List[dict]) -> dict:
    """The reduction of a Chrome trace's events (times in microseconds)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in xs if e.get("cat") in _DEVICE_CATS]
    iv = np.asarray([[float(e["ts"]), float(e["ts"]) + float(e["dur"])]
                     for e in dev], dtype=np.float64).reshape(-1, 2)
    iv = np.clip(iv, w0, w1)
    busy = _union(iv[iv[:, 1] > iv[:, 0]])
    busy_us = float((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0.0

    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        if e.get("cat") == "kernel":
            by_name[e["name"][:96]] += float(e["dur"]) * 1e-6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # the harness's ranges (other than the window) by thread
    ranges: Dict[str, Dict[object, np.ndarray]] = defaultdict(dict)
    tmp: Dict[str, Dict[object, list]] = defaultdict(lambda: defaultdict(list))
    for e in xs:
        if (e.get("cat") == "user_annotation" and e["name"] != WINDOW
                and e["name"].startswith("gcnbench.")):
            tmp[e["name"]][e.get("tid")].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    for name, per_tid in tmp.items():
        for tid, lst in per_tid.items():
            ranges[name][tid] = np.asarray(sorted(lst), dtype=np.float64)
    launches = {}
    for e in xs:
        if e.get("cat") in _LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (float(e["ts"]), e.get("tid"))
    range_dev: Dict[str, float] = defaultdict(float)
    for e in dev:
        corr = (e.get("args") or {}).get("correlation")
        if corr is None or corr not in launches:
            continue
        ts, tid = launches[corr]
        for name, per_tid in ranges.items():
            r = per_tid.get(tid)
            if r is None:
                continue
            k = int(np.searchsorted(r[:, 0], ts, side="right")) - 1
            if k >= 0 and ts <= r[k, 1]:
                range_dev[name] += float(e["dur"]) * 1e-6

    # idle gaps inside the window, labelled by the host
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2) \
        if len(busy) else np.asarray([[w0, w1]])
    gaps = edges[edges[:, 1] > edges[:, 0]]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:_GAPS_LABELLED]
    host = [e for e in xs if e.get("cat") in _HOST_CATS
            and e.get("name") != WINDOW]
    hs = np.asarray([float(e["ts"]) for e in host])
    he = hs + np.asarray([float(e["dur"]) for e in host])
    labels: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        cover = np.nonzero((hs <= mid) & (he >= mid))[0] if len(hs) else []
        if len(cover):
            inner = cover[np.argmin(he[cover] - hs[cover])]
            label = host[inner]["name"][:96]
        else:
            label = "no host operation traced"
        labels[label] += float(b - a) * 1e-6
    idle = sorted(labels.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "range_device_s": dict(range_dev),
            "device_ops": [[k, v] for k, v in device_ops],
            "idle_gaps": [[k, v] for k, v in idle]}
