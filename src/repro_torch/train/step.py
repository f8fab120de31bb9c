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

Both steps are partitioned when the state is: ``init_train_state(...,
mesh=device_mesh)`` places the parameters and the optimizer state by
``param_specs`` on a ``DeviceMesh`` (FSDP on "data", TP/EP on "model"),
the step puts the batch on the batch axes, brings each gradient to its
parameter's placements (the reduce-scatters and all-reduces of data
parallelism) and returns replicated metrics and tokens.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor

from ..configs.base import ArchConfig
from ..core.plan_cache import DeviceLike, resolve_device
from ..models import lm
from ..optim.adamw import (AdamWState, adamw_init, adamw_update,
                           cosine_schedule, tree_leaves, tree_map)
from ..sharding import (batch_axes, distribute, mesh_of, on_batch_axes,
                        param_specs, partitioned, use_mesh)

__all__ = ["TrainState", "init_train_state", "materialize", "whole",
           "loss_and_grads", "make_train_step", "make_serve_step"]


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def init_train_state(cfg: ArchConfig,
                     generator: Optional[torch.Generator] = None, *,
                     device: DeviceLike = None, mesh=None) -> TrainState:
    """``lm.init_lm`` (parameters drawn from ``generator`` onto ``device``,
    ``cuda`` unless named) plus ``adamw_init``. With a ``DeviceMesh``,
    every leaf is drawn whole from the generator (the values of the
    one-device init) and placed by ``param_specs`` on the mesh; on
    ``meta`` nothing is drawn, and each rank's leaves are shards of meta
    tensors (see :func:`materialize` for a card)."""
    params = lm.init_lm(cfg, generator, device=device)
    if mesh is not None:
        params = distribute(params, param_specs(params, mesh), mesh)
    return TrainState(params, adamw_init(params))


def materialize(tree, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None):
    """A tree of DTensors whose local shards lie on ``meta`` with each
    rank's shard allocated on ``device`` (``cuda`` unless named): floating
    leaves drawn ~ N(0, 0.02^2) from ``generator`` (zeros without one),
    integer leaves zero; the placements are kept. This is how one rank's
    share of a mesh too large for a host is made on a card without
    making the whole. Leaves that are not DTensors are moved as they
    are."""
    dev = resolve_device(device)

    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        loc = t.to_local() if isinstance(t, DTensor) else t
        new = torch.zeros(loc.shape, dtype=loc.dtype, device=dev)
        if generator is not None and new.is_floating_point():
            new.copy_(torch.randn(loc.shape, generator=generator,
                                  dtype=torch.float32, device=dev) * 0.02)
        if not isinstance(t, DTensor):
            return new
        return DTensor.from_local(new, t.device_mesh, t.placements,
                                  shape=t.shape, stride=t.stride())

    return tree_map(one, tree)


def whole(t):
    """A DTensor as the whole tensor on every rank (its ``full_tensor()``);
    anything else as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def loss_and_grads(cfg: ArchConfig, params, inputs, labels, **chunks):
    """(loss, {"ce", "aux"}, gradient tree): ``lm.lm_loss`` under remat at
    ``chunks`` and its gradients by autograd, the train step's own. On a
    partitioned state (the caller holds its mesh context and puts the
    batch on the batch axes) each gradient comes back at its parameter's
    placements: the reduce-scatter (FSDP leaves) or all-reduce (leaves
    replicated over the batch axes) of data parallelism."""
    # autograd leaves sharing the parameters' storage
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    loss, metrics = lm.lm_loss(cfg, live, inputs, labels, remat=True,
                               **chunks)
    with partitioned():    # the backward reads the forward's constants
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    grads = [g.redistribute(t.device_mesh, t.placements)
             if isinstance(g, DTensor) and g.placements != t.placements
             else g for t, g in zip(leaves, grads)]
    by_leaf = {id(t): g for t, g in zip(leaves, grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda t: by_leaf[id(t)], live))


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
    Under a mesh microbatch ``i`` is still the global rows ``[i * mb, (i
    + 1) * mb)``, placed on the batch axes (a rank computes ``mb /
    prod(batch axes)`` rows of it), so the batch comes whole (a plain
    tensor every rank holds); each microbatch gathers the FSDP weights and
    reduce-scatters its gradients, which are summed at the parameters'
    placements.
    """

    def grads_of(params, inputs, labels):
        return loss_and_grads(cfg, params, inputs, labels,
                              loss_chunk=loss_chunk, q_chunk=q_chunk,
                              kv_chunk=kv_chunk, ssd_chunk=ssd_chunk)

    def train_step(state: TrainState, batch):
        mesh = mesh_of(state.params)
        with use_mesh(mesh):
            state, metrics = _step(state, batch, mesh)
        return state, {k: whole(v) for k, v in metrics.items()}

    def _step(state: TrainState, batch, mesh):
        leaf = tree_leaves(state.params)[0]
        dev = leaf.to_local().device if isinstance(leaf, DTensor) else \
            leaf.device
        inputs = torch.as_tensor(batch["inputs"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        B = inputs.shape[0]
        if not (microbatch and microbatch < B):
            if mesh is not None:
                inputs = on_batch_axes(inputs, mesh)
                labels = on_batch_axes(labels, mesh)
            loss, metrics, grads = grads_of(state.params, inputs, labels)
            nmb = 1
        else:
            if B % microbatch:
                raise ValueError(f"batch {B} is not a multiple of the "
                                 f"microbatch {microbatch}")
            if mesh is not None:
                _check_microbatch(microbatch, mesh, inputs, labels)
            nmb = B // microbatch
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.bfloat16), state.params)
            lsum = None
            for i in range(nmb):
                # global rows [i*mb, (i+1)*mb), as the reference's reshape
                # makes them; under a mesh each on the batch axes
                sl = slice(i * microbatch, (i + 1) * microbatch)
                x, y = inputs[sl], labels[sl]
                if mesh is not None:
                    x, y = on_batch_axes(x, mesh), on_batch_axes(y, mesh)
                l, metrics, g = grads_of(state.params, x, y)
                # bf16 accumulation halves the carried payload
                tree_map(lambda a, x: a.add_(x.to(torch.bfloat16)), grads, g)
                del g
                lsum = l if lsum is None else lsum + l
            loss = lsum / nmb

        # +1: the schedule is evaluated for the step being TAKEN (lr(0)=0
        # would silently no-op the first optimizer step)
        lr = cosine_schedule(state.opt.step + 1, peak_lr=peak_lr,
                             warmup=warmup, total=total)
        params, opt, om = adamw_update(grads, state.opt, state.params, lr=lr,
                                       grad_divisor=nmb)
        metrics = dict(metrics, loss=loss, lr=lr, **om)
        return TrainState(params, opt), metrics

    return train_step


def _check_microbatch(mb: int, mesh, *batch) -> None:
    """A microbatched partitioned step takes the batch whole and places
    each microbatch on the batch axes, which must divide it."""
    if any(isinstance(t, DTensor) for t in batch):
        raise ValueError("a microbatched partitioned step takes the batch "
                         "whole (a plain tensor every rank holds), not a "
                         "DTensor")
    names = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n = math.prod(names[a] for a in batch_axes(mesh))
    if mb % n:
        raise ValueError(f"microbatch {mb} does not divide over the {n} "
                         f"ranks of the batch axes {batch_axes(mesh)}")


def make_serve_step(cfg: ArchConfig):
    """Returns serve_step(params, state, tokens) -> (next [B, 1] int32,
    logits [B, V] fp32, state). Greedy decode of one token for the whole
    batch (the first of tied maxima, as ``jnp.argmax``)."""

    def serve_step(params, state: lm.DecodeState, tokens: torch.Tensor):
        mesh = mesh_of(params)
        with torch.inference_mode(), use_mesh(mesh):
            if mesh is not None:
                tokens = on_batch_axes(tokens, mesh)
            logits, state = lm.decode_step(cfg, params, tokens, state)
            logits = whole(logits)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return nxt, logits, state

    return serve_step
