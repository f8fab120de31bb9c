"""What ``BENCHMARK.json`` says about one cell, and the files the harness
finds by name: ``configs/`` (the configuration's ``file``),
``traffic/<traffic>.json``, ``limits/<workload>.json`` and
``metrics/<metric>.py``. A new cell, configuration, traffic mix or metric is
a new file and a new entry; no file here needs an edit for it."""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise ValueError(f"bad name {name!r}: 1-64 of A-Z a-z 0-9 _ . -, "
                         f"not starting with . or -")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.match(unit):
        raise ValueError(f"bad unit {unit!r}: 1-16 of A-Z a-z 0-9 _ / % . -")
    return unit


@dataclass
class Metric:
    name: str
    unit: str


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric] = field(default_factory=list)


def _metric(m: dict) -> Metric:
    return Metric(check_name(m["name"]), check_unit(m["unit"]))


def load_cell(workload: str, root: Path = ROOT,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``: its configuration,
    traffic mix, comparison limits, and the metrics it reports (end-to-end
    with ``--trace 0``, per-layer with ``--trace 1``)."""
    bench = json.loads((Path(root) / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(one of {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((Path(root) / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (Path(bench_dir) / "traffic" / f"{check_name(w['traffic'])}.json"
         ).read_text())
    limits = json.loads(
        (Path(bench_dir) / "limits" / f"{check_name(workload)}.json"
         ).read_text())
    e2e = [_metric(m) for m in bench["end_to_end"]
           if m.get("workloads") is None or workload in m["workloads"]]
    names = {m.name for m in e2e}
    per_layer = [_metric(m) for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(workload, cfg, traffic, limits, e2e, per_layer)


def metric_reader(name: str, bench_dir: Path = BENCH_DIR
                  ) -> Callable[[dict], Optional[float]]:
    """``read(record)`` of ``metrics/<name>.py``: the metric's value from
    what the run recorded, or None where it finds nothing to read."""
    path = Path(bench_dir) / "metrics" / f"{check_name(name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"gcnbench_metric_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
