"""The dry run's tables (per-device memory of both production meshes, and
the roofline) from the port's records, ``benchmarks/results/dryrun_torch.json``
(``python -m repro_torch.launch.dryrun --all``):

    PYTHONPATH=src python -m repro_torch.scripts.make_experiments_tables \\
        [PATH] [--hw "NVIDIA H100 80GB HBM3"]

The hardware note is the card's row of ``analysis.roofline.HARDWARE``
(``--hw``, or the card this process runs on, with its power limit as
``nvidia-smi`` reads it); "fits" is against that card's memory. The
port's records carry trace seconds where the reference's carry compile
seconds.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from typing import Optional, Sequence

from ..analysis.roofline import hw_row


def human(n):
    if n is None:
        return "-"
    for unit in ("", "K", "M", "G", "T", "P", "E"):
        if abs(n) < 1000:
            return f"{n:.3g}{unit}"
        n /= 1000
    return f"{n:.3g}Z"


def power_limit() -> str:
    """Card 0's power limit as ``nvidia-smi`` prints it, or why not."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"power limit not read ({type(e).__name__})"
    if r.returncode:
        return "power limit not read"
    return f"power limit {r.stdout.strip()}"


def hw_note(hw=None) -> str:
    """The card's name and rates (``hw`` a row name, or None for the card
    this process runs on, with its power limit)."""
    row = hw_row(hw)
    limit = power_limit() if hw is None else "power limit not read"
    return (f"{row['name']}: {row['peak_flops'] / 1e12:.1f} TFLOP/s bf16, "
            f"{row['hbm_bw'] / 1e12:.2f} TB/s HBM, "
            f"{row['link_bw'] / 1e9:.0f} GB/s NVLink; "
            f"{row['memory_bytes'] / 1e9:.0f} GB a card; {limit}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", nargs="?",
                    default="benchmarks/results/dryrun_torch.json")
    ap.add_argument("--hw", default=None,
                    help="a row of repro_torch.analysis.roofline.HARDWARE "
                         "(default: the card this process runs on)")
    args = ap.parse_args(argv)
    row = hw_row(args.hw)
    gb = row["memory_bytes"] / 1e9
    with open(args.path) as f:
        recs = json.load(f)
    recs.sort(key=lambda r: (r["arch"], r["shape"]))

    print("### §Dry-run table (per-device memory analysis; both meshes)\n")
    print(f"_{hw_note(args.hw)}_\n")
    print("| arch | shape | mesh | trace s | args GB/dev | temp GB/dev | "
          f"rolled coll B/dev | fits {gb:.0f}GB? |")
    print("|---|---|---|---|---|---|---|---|")
    for r in recs:
        cell = f"{r['arch']} | {r['shape']}"
        if "skipped" in r:
            print(f"| {cell} | — | — | — | — | — | SKIP: {r['skipped']} |")
            continue
        if "error" in r:
            print(f"| {cell} | — | — | — | — | — | ERROR |")
            continue
        for mesh in ("pod16x16", "multipod2x16x16"):
            m = r.get(mesh)
            if not m:
                continue
            tot = (m["argument_bytes_per_dev"] + m["temp_bytes_per_dev"]) / 1e9
            fits = "yes" if tot < gb else f"no ({tot:.0f}GB)"
            print(f"| {cell} | {mesh} | {m['trace_s']:.1f} | "
                  f"{m['argument_bytes_per_dev']/1e9:.2f} | "
                  f"{m['temp_bytes_per_dev']/1e9:.2f} | "
                  f"{human(m['rolled_cost']['coll'])} | {fits} |")

    print("\n### §Roofline table (single-pod 16x16; probe-extrapolated)\n")
    print("| arch | shape | compute s | memory s | collective s | bottleneck | "
          "MODEL_FLOPS | useful ratio |")
    print("|---|---|---|---|---|---|---|---|")
    for r in recs:
        if "skipped" in r or "error" in r or "roofline" not in r:
            continue
        rl = r["roofline"]
        print(f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.4g} | "
              f"{rl['memory_s']:.4g} | {rl['collective_s']:.4g} | "
              f"**{rl['bottleneck']}** | {human(rl['model_flops'])} | "
              f"{rl['useful_ratio']:.3f} |")


if __name__ == "__main__":
    main()
