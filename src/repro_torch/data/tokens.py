"""Stateless token-batch pipeline: batch = f(seed, step).

The reference's (``repro.data.tokens``) generator, bit for bit: numpy, so
a batch depends on ``(batch, seq, vocab, seed, step)`` alone and a
restarted loop (``train/loop.py``) replays identical batches. Synthetic
data is Markov-chain text (so a real LM can learn next-token structure).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict

import numpy as np

__all__ = ["token_batch_fn"]


def _markov_row(seed: int, vocab: int, branch: int = 8):
    rng = np.random.default_rng(seed)
    # each symbol transitions to one of `branch` successors
    return rng.integers(0, vocab, size=(vocab, branch)).astype(np.int32)


@functools.lru_cache(maxsize=4)
def _table(vocab: int, seed: int):
    return _markov_row(seed, vocab)


def token_batch_fn(*, batch: int, seq: int, vocab: int, seed: int = 0
                   ) -> Callable[[int], Dict[str, np.ndarray]]:
    """Returns batch_fn(step) -> {"inputs": [B,T] i32, "labels": [B,T] i32}."""
    table = _table(vocab, seed)
    branch = table.shape[1]

    def batch_fn(step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((seed << 20) ^ step)
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab, size=batch)
        choices = rng.integers(0, branch, size=(batch, seq))
        for t in range(seq):
            toks[:, t + 1] = table[toks[:, t], choices[:, t]]
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:].copy()}

    return batch_fn
