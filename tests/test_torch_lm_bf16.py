"""The parity tests of ``tests/test_torch_lm.py`` in bf16, as initialised:
the same reference and port functions on the same inputs for all ten
reduced archs, within the reference's own serving bounds (``atol=rtol=
0.08`` with attention, ``2e-3`` for mamba2; the module docstring of
``tests/test_torch_lm.py`` gives the reasons). A file of its own so that
the two precisions run on two workers."""
import pytest

from test_torch_lm import (  # noqa: F401 (the tests, on this file's fixture)
    ARCH_IDS, results, test_decode_state_from_jax, test_decode_steps,
    test_lm_forward, test_lm_loss, test_prefill,
    test_reset_decode_slot_against_reference)


@pytest.fixture(scope="module", params=ARCH_IDS)
def run(request):
    return results(request.param, "bf16")
