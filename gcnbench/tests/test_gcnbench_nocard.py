"""Without a card the harness fails; it never falls back to the CPU."""
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "gcnbench/run.py", "--workload", "gcn-arxiv.train",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_unknown_workload_exits_nonzero():
    p = subprocess.run(
        [sys.executable, "gcnbench/run.py", "--workload", "no-such.cell",
         "--seed", "1", "--seconds", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
