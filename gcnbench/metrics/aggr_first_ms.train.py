"""Device milliseconds a training step spends in the work launched inside
``models/gcn.py``'s ``layer.aggr_first`` spans: the forward of each
``gcn``/``sage`` layer that aggregates before its dense product, which is
its K1 aggregation, its products with ``W`` and ``W_self`` and its
un-permute gather, joined by correlation id in the spans-on stretch of
``gcnbench/program_trace.py``. The backward of those layers runs on the
autograd engine's thread, outside the span, and is not counted. A program
without the span (no layer aggregates first, or no such span at all) reads
None."""
from gcnbench.program_trace import filled, per_step_ms


def read(rec):
    prog = filled(rec).get("program") or {}
    return per_step_ms((prog.get("span_device_s") or {}).get(
        "layer.aggr_first"), prog.get("steps"))
