"""The comparison catches what it must, at a tiny size on the CPU: the
control (the reference with TF32-rounded dense products in the program's
place) and the planted faults each fail one of the cell's numbers, while
the program as it is passes."""
import pytest
import torch

from gcnbench import control, spec
from gcnbench.drivers.train import TrainCell

SEEDS = (2 ** 31 + 1, 7, 2 ** 32 + 9)


def log(_):
    pass


def exceeds(readings, limits):
    return [k for k, v in readings.items() if k in limits and v > limits[k]]


@pytest.fixture
def train_cell(tiny):
    _, root, bench = tiny

    def make(workload):
        cell = spec.load_cell(workload, root, bench)
        return TrainCell(cell, torch.device("cpu"), log,
                         data_dir=root / "data"), cell.limits
    return make


@pytest.mark.parametrize("workload", ["sage-reddit.train", "gcn-arxiv.train"])
@pytest.mark.parametrize("mode", ["program", "ref_tf32", "unchanged",
                                  "half_batch", "altered", "altered_late"])
def test_training_readings(train_cell, workload, mode):
    tc, limits = train_cell(workload)
    for seed in SEEDS:
        r = control.train_reading(tc, seed, mode)
        if mode == "program":
            assert not exceeds(r, limits), r
        else:
            assert exceeds(r, limits), (mode, r)
