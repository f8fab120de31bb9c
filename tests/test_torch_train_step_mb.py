"""``tests/test_torch_train_step.py``'s comparison with ``microbatch=1``:
two microbatches of one sequence, each one's gradients cast to bf16 and
summed in bf16, then read as fp32 divided by 2 (a file of its own, so the
two halves of the reference's compiles run on two test workers)."""
import pytest

from repro.configs import ARCH_IDS

from test_torch_train_step import check_train_step


@pytest.mark.parametrize("name", ARCH_IDS)
def test_train_step_with_microbatches_against_reference(name):
    check_train_step(name, 1)
