"""The port's token pipeline (``repro_torch.data.tokens``) against the
reference's (``repro.data.tokens``): bit-identical batches for every
``(batch, seq, vocab, seed, step)`` of a grid, and the reference's
statelessness test (``tests/test_serve.py``), port-side."""
import itertools

import numpy as np
import pytest

from repro.data.tokens import token_batch_fn as ref_token_batch_fn
from repro_torch.data import token_batch_fn as pkg_token_batch_fn
from repro_torch.data.tokens import token_batch_fn


@pytest.mark.parametrize("batch,seq", [(1, 1), (2, 8), (4, 33), (3, 128)])
def test_bit_identical_to_reference(batch, seq):
    for vocab, seed in itertools.product((2, 64, 32064), (0, 3, 11)):
        got = token_batch_fn(batch=batch, seq=seq, vocab=vocab, seed=seed)
        want = ref_token_batch_fn(batch=batch, seq=seq, vocab=vocab,
                                  seed=seed)
        for step in (0, 1, 5, 1 << 20, 123_457):
            a, b = got(step), want(step)
            assert a.keys() == b.keys() == {"inputs", "labels"}
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                assert a[k].shape == (batch, seq)
                np.testing.assert_array_equal(a[k], b[k])


def test_data_pipeline_stateless():
    bf = token_batch_fn(batch=2, seq=8, vocab=64, seed=3)
    a, b = bf(5), bf(5)
    np.testing.assert_array_equal(a["inputs"], b["inputs"])
    c = bf(6)
    assert not np.array_equal(a["inputs"], c["inputs"])
    # markov structure: labels are reachable successors of inputs
    assert a["labels"].shape == (2, 8)
    np.testing.assert_array_equal(a["inputs"][:, 1:], a["labels"][:, :-1])


def test_package_exports_the_pipeline():
    assert pkg_token_batch_fn is token_batch_fn
