"""A copy of the benchmark at a tiny size: the real traffic, limits and
metric files, the real configurations with their graphs and widths cut,
and a ``BENCHMARK.json`` that points at them."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"sage-reddit": ([24, 16, 5], 600, 6000),
        "gcn-arxiv": ([12, 16, 16, 4], 600, 3000)}


def make_tiny(root: Path) -> Path:
    bench = root / "bench"
    for d in ("traffic", "limits", "metrics"):
        shutil.copytree(REPO / "gcnbench" / d, bench / d)
    (root / "configs").mkdir()
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in real["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        dims, nodes, edges = TINY[c["name"]]
        cfg["model"]["dims"] = dims
        cfg["graph"].update(nodes=nodes, edges=edges)
        c["file"] = f"configs/{c['name']}.json"
        (root / c["file"]).write_text(json.dumps(cfg))
    (root / "BENCHMARK.json").write_text(json.dumps(real))
    return bench


@pytest.fixture
def tiny(tmp_path):
    """(run, root, bench): ``run(workload, seed, trace=False)`` runs the
    tiny cell on the CPU past the look for a card."""
    import torch
    from gcnbench.run import run_cell
    bench = make_tiny(tmp_path)

    def run(workload, seed=2 ** 31 + 5, trace=False, seconds=0.5):
        return run_cell(workload, seed, seconds, trace, torch.device("cpu"),
                        time.perf_counter(), root=tmp_path, bench_dir=bench,
                        data_dir=tmp_path / "data")

    return run, tmp_path, bench
