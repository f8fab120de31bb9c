"""``chip_smoke.py`` phase 19 (the LM training path) end to end on the CPU,
every arch at its reduced config, in a fresh process (the CUDA clock is
the host's there; the card's run is the script's own)."""
import json
import os
import subprocess
import sys

_PHASE19 = """
import json, sys, time
sys.path[:0] = [{src!r}, {root!r}]
import torch
import chip_smoke
import repro_torch.configs as configs
configs.get_config = configs.get_reduced     # full widths only on the card
chip_smoke.TRAIN_LONG_T = 1024               # (b)'s length: the card's 4096


class HostEvent:                              # CUDA events on the host clock
    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


torch.cuda.Event = HostEvent
torch.cuda.synchronize = lambda *a: None
torch.cuda.reset_peak_memory_stats = lambda *a: None
torch.cuda.max_memory_allocated = lambda *a: 0
torch.cuda.memory_allocated = lambda *a: 0
torch.cuda.empty_cache = lambda: None
torch.backends.cudnn.allow_tf32 = False       # phase 1 does this on the card
import repro_torch.analysis.roofline as roofline
# phase 20 (b): the card's row, named here; the CPU has no allocator peak,
# so the tracker's own count on the CPU stands in for the card's
roofline.hw_for = lambda device="cuda": roofline.hw_row(
    "NVIDIA H100 80GB HBM3")
chip_smoke.card_step_peak = lambda torch, base, counts: counts.peak_live_bytes
rec = chip_smoke.phase_train_lm(torch, "CPU", device="cpu")
print(json.dumps({{"losses": rec["full"]["losses"],
                  "profile": rec["full"]["profile"]["stacks"],
                  "card_vs_cpu": [rec["card_vs_cpu"]["loss"],
                                  rec["card_vs_cpu"]["master_all"]],
                  "microbatch": rec["microbatch"]["loss_rel"],
                  "archs": {{a: r["loss"] for a, r in rec["archs"].items()}},
                  "restart": rec["restart"]["bit_equal"],
                  "launches": rec["launches"],
                  "dryrun": [rec["dryrun"][k] for k in (
                      "flops", "card_flops", "argument_bytes", "live_bytes",
                      "peak", "card_peak")]}}))
"""


def test_phase19_on_cpu_at_reduced_configs():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(root, "src")
    out = subprocess.run(
        [sys.executable, "-c", _PHASE19.format(src=src, root=root)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=src))
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(rec["losses"]) == 6 and all(0 < x < 20 for x in rec["losses"])
    assert rec["profile"] > 0                   # the stacked leaves' stacks
    assert rec["card_vs_cpu"] == [0.0, 0.0]     # the "card" is the CPU here
    assert rec["microbatch"] <= 1e-5
    assert len(rec["archs"]) == 9
    assert rec["restart"] is True               # bit for bit on the CPU
    assert rec["launches"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    # phase 20 (b) on the train step: meta against the CPU, exact
    flops, cflops, args, live, peak, cpeak = rec["dryrun"]
    assert flops == cflops > 0 and args == live > 0 and peak == cpeak > args
