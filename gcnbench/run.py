"""Run one cell of the benchmark once and print its result.

    python3 gcnbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is looked up in ``BENCHMARK.json``;
its traffic file names the driver (``drivers/``). Progress goes to standard
error, ending with each compared number beside its limit; the last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``. Without a CUDA card, or with fewer than the cell asks for, it
exits with 2 and prints no result. Caches of the program's builds stay
inside the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(names=None) -> list:
    """Top-level names among ``names`` (the loaded modules by default) that
    no run may load, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, root: Path = ROOT,
             bench_dir: Path = None, data_dir=None) -> dict:
    """Everything after the look for a card: the cell's driver, its metrics
    and its checks, as the result's dictionary (``checks`` last)."""
    from gcnbench import spec
    from gcnbench.drivers.common import Context
    cell = spec.load_cell(workload, root, bench_dir or spec.BENCH_DIR)
    driver = importlib.import_module(
        f"gcnbench.drivers.{spec.check_name(cell.traffic['driver'])}")
    ctx = Context(cell, seed, seconds, trace, device, t_start,
                  data_dir=data_dir)
    out = driver.run(ctx)

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = spec.metric_reader(m.name, bench_dir or spec.BENCH_DIR)(
                out["record"])
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        for m in cell.end_to_end:
            # ``<quantity>.<qualifier>`` is the driver's ``<quantity>``,
            # held to a bound of its own in the cells that it lists
            e2e = out["e2e"]
            value = e2e.get(m.name, e2e.get(m.name.split(".")[0]))
            metrics[m.name] = {"value": value, "unit": m.unit}
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in out["checks"].items()}
    correct = (out["failed"] == 0 and out["attempted"] > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics}
    if device.type == "cuda":
        import torch
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(device),
                            "count": 1,
                            "memory_peak_bytes": int(out["memory_peak_bytes"])}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    tr = out.get("trace")
    if trace and tr:
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the program inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    # the checkout's root and the program's sources, in place of this
    # script's own folder
    sys.path[:1] = [str(ROOT / "src"), str(ROOT)]

    import torch
    t_torch = time.perf_counter()
    from gcnbench import spec
    from gcnbench.peaks import CARD, FP32_FLOP_PER_S, HBM_BYTES_PER_S
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < chips[args.workload]:
        log(f"{args.workload} needs {chips[args.workload]} cards, "
            f"{torch.cuda.device_count()} visible")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    t_init = time.perf_counter()
    log(f"device: {torch.cuda.get_device_name(dev)}, "
        f"{torch.cuda.device_count()} visible; card: {power_limit()}; "
        f"peaks ({CARD}): fp32 {FP32_FLOP_PER_S:.3g} FLOP/s, "
        f"HBM {HBM_BYTES_PER_S:.3g} B/s; torch {torch.__version__}; "
        f"CUDA init {time.perf_counter() - T_START:.3f} s after start "
        f"(import torch {t_torch - T_START:.3f} s, CUDA context "
        f"{t_init - t_torch:.3f} s)")
    spec.check_name(args.workload)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), dev, T_START)
    bad = forbidden_modules()
    if bad:
        log(f"refused: the run loaded {', '.join(bad)}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
