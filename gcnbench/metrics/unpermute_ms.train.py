"""Device milliseconds a training step spends in the un-permute gather of
``core/spmm.py::AccelSpMM`` (``out_sorted[inv_perm]``, span
``spmm.unpermute``) over all its aggregations, forward and backward: the
work launched inside the span, joined by correlation id, in the spans-on
stretch of ``gcnbench/program_trace.py``."""
from gcnbench.program_trace import filled, per_step_ms


def read(rec):
    prog = filled(rec).get("program") or {}
    return per_step_ms((prog.get("span_device_s") or {}).get(
        "spmm.unpermute"), prog.get("steps"))
