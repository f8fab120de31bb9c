"""A whole run past the look for a card, with the timed path broken
underneath, comes out not correct: for each fault that the cell can have
(one chip, so no exchange between chips to leave out), and a fault that
sets in only after the checked steps, which the window step catches."""
import pytest

from gcnbench import control

CELL_FAULTS = [("sage-reddit.train", "unchanged"),
               ("sage-reddit.train", "half_batch"),
               ("sage-reddit.train", "altered"),
               ("gcn-arxiv.train", "unchanged"),
               ("gcn-arxiv.train", "half_batch"),
               ("gcn-arxiv.train", "altered"),
               ("sage-reddit.train", "altered_late"),
               ("gcn-arxiv.train", "altered_late")]


@pytest.mark.parametrize("workload,fault", CELL_FAULTS)
def test_a_broken_run_is_not_correct(tiny, workload, fault):
    run, _, _ = tiny
    assert run(workload)["correct"]
    with control.planted(fault):
        r = run(workload, seconds=0.8)
    assert r["correct"] is False, r["checks"]
