"""Serve step for every architecture.

``make_serve_step(cfg)`` returns ``serve_step(params, state, tokens) ->
(next_tokens, logits, state)``, the reference's (``repro.train.step``)
greedy step: the reference jit-compiles it, here it is a plain call under
``torch.inference_mode()``. The training steps of that module wait for the
optimizer's port.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models import lm


def make_serve_step(cfg: ArchConfig):
    """Returns serve_step(params, state, tokens) -> (next [B, 1] int32,
    logits [B, V] fp32, state). Greedy decode of one token for the whole
    batch (the first of tied maxima, as ``jnp.argmax``)."""

    def serve_step(params, state: lm.DecodeState, tokens: torch.Tensor):
        with torch.inference_mode():
            logits, state = lm.decode_step(cfg, params, tokens, state)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return nxt, logits, state

    return serve_step
