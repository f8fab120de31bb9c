"""Model FLOPs of one training step (``gcnbench.flops.model_flops``) over
the window's mean step time, as a share of the fp32 peak."""
from gcnbench.flops import model_flops
from gcnbench.peaks import FP32_FLOP_PER_S


def read(rec):
    step_s = rec.get("step_s")
    if not step_s:
        return None
    m = rec["config"]["model"]
    flops = model_flops(m["variant"], m["dims"], rec["n"], rec["nnz"], True)
    return 100.0 * flops / step_s / FP32_FLOP_PER_S
