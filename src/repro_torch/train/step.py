"""Train and serve steps for every architecture.

``make_train_step(cfg)`` returns ``train_step(state, batch) -> (state,
metrics)``, the reference's (``repro.train.step``) step: ``lm_loss`` under
remat, gradients of every leaf by autograd, optional microbatching with
bf16 gradient accumulation, the cosine schedule and AdamW. The reference
jit-compiles a pure function; here the step updates ``state`` in place
(``optim.adamw.adamw_update``) and returns it.

``make_serve_step(cfg)`` returns ``serve_step(params, state, tokens) ->
(next_tokens, logits, state)``, the reference's greedy step, a plain call
under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..configs.base import ArchConfig
from ..core.plan_cache import DeviceLike
from ..models import lm
from ..optim.adamw import (AdamWState, adamw_init, adamw_update,
                           cosine_schedule, tree_leaves, tree_map)

__all__ = ["TrainState", "init_train_state", "make_train_step",
           "make_serve_step"]


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def init_train_state(cfg: ArchConfig,
                     generator: Optional[torch.Generator] = None, *,
                     device: DeviceLike = None) -> TrainState:
    """``lm.init_lm`` (parameters drawn from ``generator`` onto ``device``,
    ``cuda`` unless named) plus ``adamw_init``."""
    params = lm.init_lm(cfg, generator, device=device)
    return TrainState(params, adamw_init(params))


def make_train_step(cfg: ArchConfig, *, peak_lr=3e-4, warmup=100,
                    total=10_000, microbatch: Optional[int] = None,
                    loss_chunk=512, q_chunk=512, kv_chunk=512,
                    ssd_chunk=128):
    """Returns train_step(state, batch) -> (state, metrics).

    batch: {"inputs": [B, T] or [B, T, D], "labels": [B, T]}, tensors or
    numpy arrays (moved to the parameters' device). metrics: 0-d tensors
    ``ce``, ``aux`` (the last microbatch's), ``loss``, ``lr`` and
    ``grad_norm``. With ``microbatch`` < B, each microbatch's gradients
    are cast to bf16 and summed in bf16 (each add rounds), then read as
    fp32 divided by the microbatch count, as the reference accumulates.
    """

    def grads_of(params, inputs, labels):
        # autograd leaves sharing the parameters' storage
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = tree_leaves(live)
        loss, metrics = lm.lm_loss(cfg, live, inputs, labels, remat=True,
                                   loss_chunk=loss_chunk, q_chunk=q_chunk,
                                   kv_chunk=kv_chunk, ssd_chunk=ssd_chunk)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        by_leaf = {id(t): g for t, g in zip(leaves, grads)}
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_map(lambda t: by_leaf[id(t)], live))

    def train_step(state: TrainState, batch):
        dev = tree_leaves(state.params)[0].device
        inputs = torch.as_tensor(batch["inputs"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        B = inputs.shape[0]
        nmb = 1
        if microbatch and microbatch < B:
            if B % microbatch:
                raise ValueError(f"batch {B} is not a multiple of the "
                                 f"microbatch {microbatch}")
            nmb = B // microbatch
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.bfloat16, device=dev), state.params)
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(nmb):
                sl = slice(i * microbatch, (i + 1) * microbatch)
                l, metrics, g = grads_of(state.params, inputs[sl],
                                         labels[sl])
                # bf16 accumulation halves the carried payload
                tree_map(lambda a, x: a.add_(x.to(torch.bfloat16)), grads, g)
                del g
                lsum = lsum + l
            loss = lsum / nmb
        else:
            loss, metrics, grads = grads_of(state.params, inputs, labels)

        # +1: the schedule is evaluated for the step being TAKEN (lr(0)=0
        # would silently no-op the first optimizer step)
        lr = cosine_schedule(state.opt.step + 1, peak_lr=peak_lr,
                             warmup=warmup, total=total)
        params, opt, om = adamw_update(grads, state.opt, state.params, lr=lr,
                                       grad_divisor=nmb)
        metrics = dict(metrics, loss=loss, lr=lr, **om)
        return TrainState(params, opt), metrics

    return train_step


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
