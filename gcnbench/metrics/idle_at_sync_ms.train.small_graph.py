"""Device milliseconds idle a training step in the stretches that contain
the end of its loss readback (``float(loss)`` in
``examples/train_gcn.py::sgd_step``, the profiler's
``aten::_local_scalar_dense``): the device drained, waiting for the host's
next launches, in the spans-off stretch of ``gcnbench/program_trace.py``
(the spans-on stretch's span ``train.readback`` holds each readback)."""
from gcnbench.program_trace import filled, per_step_ms


def read(rec):
    off = (filled(rec).get("program") or {}).get("spans_off") or {}
    return per_step_ms(off.get("idle_at_sync_s"), off.get("steps"))
