"""Device milliseconds idle a training step outside the stretches at its
loss readback (``idle_at_sync_ms.train.small_graph``): the gaps between the
step's launches, in the spans-off stretch of
``gcnbench/program_trace.py``. The two add up to the stretch's idle time a
step."""
from gcnbench.program_trace import filled, per_step_ms


def read(rec):
    off = (filled(rec).get("program") or {}).get("spans_off") or {}
    return per_step_ms(off.get("idle_in_step_s"), off.get("steps"))
