"""Share of the traced window in which no kernel, copy or set ran on the
device (the profiler's timeline)."""


def read(rec):
    trace = rec.get("trace") or {}
    if not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
