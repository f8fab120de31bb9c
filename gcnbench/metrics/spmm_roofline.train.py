"""Share of the bytes bound achieved by the training step's aggregations:
the bytes they need (``gcnbench.flops.aggregation_bytes`` for each call
in the traced steps) at the HBM peak, over the device time of the work
launched inside the harness's ``gcnbench.aggr`` ranges around the
operator's forward and backward calls, whichever kernels that work ran."""
from gcnbench.flops import aggregation_bytes
from gcnbench.peaks import HBM_BYTES_PER_S


def read(rec):
    calls = rec.get("aggr_calls")
    trace = rec.get("trace") or {}
    device_s = (trace.get("range_device_s") or {}).get("gcnbench.aggr")
    if not calls or not device_s:
        return None
    need = sum(aggregation_bytes(*c) for c in calls)
    return 100.0 * need / HBM_BYTES_PER_S / device_s
