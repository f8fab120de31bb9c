"""Spans inside the program, off unless switched on.

    from repro_torch import spans
    spans.enable()
    ...                  # the program runs; its spans are recorded
    got = spans.drain()  # spans, dropped, epoch_offset_ns
    spans.disable()

``span(name, **attrs)`` marks a stretch of the program's work. Off (the
default) it reads one module flag and returns a shared null context: no
clock is read and nothing is kept. On, it stamps its start and end
(``time.perf_counter_ns``), its thread, its parent (the span open on the
same thread when it began, or None) and ``attrs`` (counts: rows, nnz,
bytes ...), and opens a profiler range ``"repro_torch." + name``
(PyTorch's fast ``RecordFunction``, or ``record_function`` where there is
none) so that a profiler run shows the same span on the device trace's
clock. ``span(name, cpu_clock=True)`` also stamps the thread's CPU time
over it (``time.thread_time_ns``, a system call that can take tens of
microseconds while a profiler traces the device): the host stages that
run for seconds ask for it, the spans of a step do not. A span begun on
another thread, such as the autograd engine's, has no parent: a reader
places it by time.

Clocks: ``epoch_offset_ns`` is ``time.time_ns() - time.perf_counter_ns()``
taken at ``enable()``, so a span's start on the epoch clock is ``start_ns +
epoch_offset_ns``; an exported Chrome trace puts an event at ``ts * 1e3 +
baseTimeNanoseconds`` on the same clock.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import List

import torch
from torch.profiler import record_function

# a profiler range at about a tenth of ``record_function``'s host cost
# (a ``cpu_op`` event rather than a ``user_annotation`` in the trace)
_range = getattr(torch._C._profiler, "_RecordFunctionFast", record_function)

__all__ = ["span", "enabled", "enable", "disable", "drain",
           "MAX_SPANS", "PREFIX"]

PREFIX = "repro_torch."
MAX_SPANS = 1 << 20      # spans kept between two drains; later ones dropped

_on = False
_lock = threading.Lock()
_spans: List[dict] = []
_dropped = 0
_epoch_offset_ns = 0
_ids = itertools.count()
_local = threading.local()


class _Null:
    """What ``span`` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None

    def set(self, **attrs) -> None:
        pass


_NULL = _Null()


class _Span:
    __slots__ = ("name", "attrs", "cpu_clock", "id", "parent", "start_ns",
                 "cpu0_ns", "_rf")

    def __init__(self, name: str, cpu_clock: bool, attrs: dict):
        self.name = name
        self.cpu_clock = cpu_clock
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Add counts known only once the work inside has run."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self.cpu0_ns = time.thread_time_ns() if self.cpu_clock else None
        self.start_ns = time.perf_counter_ns()
        self._rf = _range(PREFIX + self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        end_ns = time.perf_counter_ns()
        cpu_ns = (time.thread_time_ns() - self.cpu0_ns if self.cpu_clock
                  else None)
        _local.stack.pop()
        rec = {"name": self.name, "id": self.id, "parent": self.parent,
               "tid": threading.get_ident(), "start_ns": self.start_ns,
               "end_ns": end_ns, "cpu_ns": cpu_ns, "attrs": self.attrs}
        global _dropped
        with _lock:
            if len(_spans) < MAX_SPANS:
                _spans.append(rec)
            else:
                _dropped += 1
        return False


def span(name: str, *, cpu_clock: bool = False, **attrs):
    """A context manager around one stretch of work (see the module); with
    ``cpu_clock`` it also reads the thread's CPU time."""
    if not _on:
        return _NULL
    return _Span(name, cpu_clock, attrs)


def enabled() -> bool:
    """Whether spans are recorded: call sites compute costly counts only
    then."""
    return _on


def enable() -> None:
    """Record from now on; takes the epoch offset of the span clock."""
    global _on, _epoch_offset_ns
    _epoch_offset_ns = time.time_ns() - time.perf_counter_ns()
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until ``drain()``."""
    global _on
    _on = False


def drain() -> dict:
    """What was recorded since the last drain, which it clears: ``spans``
    (in the order they ended), ``dropped`` (spans past ``MAX_SPANS``) and
    ``epoch_offset_ns``."""
    global _spans, _dropped
    with _lock:
        out = {"spans": _spans, "dropped": _dropped,
               "epoch_offset_ns": _epoch_offset_ns}
        _spans, _dropped = [], 0
    return out
