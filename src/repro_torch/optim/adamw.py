"""AdamW with fp32 master weights over bf16 params, global-norm clipping,
cosine LR schedule, and a bf16 gradient-compression hook, as in the
reference (``repro.optim.adamw``).

State layout (``AdamWState``):
  step      0-d int32 tensor (the reference's ``jnp.int32`` scalar)
  m, v      fp32 moments
  master    fp32 master copy of every param (a copy also of fp32 params)

Every element sees the reference's arithmetic in the reference's order
(clip scale ``min(1, max_norm / max(norm, 1e-9))``; ``m = b1*m +
(1-b1)*g``; ``v = b2*v + (1-b2)*g*g``; bias corrections from the new
step; ``master - lr*(mh/(sqrt(vh)+eps) + wd*master)``; the cast back to
each param's dtype). The one difference is where the results go:
``adamw_update`` writes ``m``, ``v``, ``master`` and the params **in
place**, under ``torch.no_grad()``, and walks each leaf in contiguous
chunks of at most :data:`UPDATE_CHUNK` elements, so no fp32 temporary is
larger than a chunk (phi3-mini's ``mlp.wi`` is ``[32, 3072, 8192]``: a
whole-leaf fp32 temporary would be 3.2 GB; dbrx-132b's one-layer expert
slice 4.2 GB). The state and params passed in are the ones returned.

Trees are dicts, lists and tuples (named tuples included) of tensors;
leaves are visited in the reference's ``jax.tree_util`` order (dict keys
sorted), which fixes the order in which the global norm adds its leaves.

Distributed leaves (DTensors, as ``train.step`` places a partitioned
state) are updated on each rank's **local shard**, with the same chunked
views; their gradients must have the parameters' placements. The global
norm adds each rank's local squares, counting a leaf replicated over some
mesh dims on one rank of them only, and all-reduces the sum once over the
mesh, so the clip scale is the same on every rank; the step is a host-side
count, the same on every rank.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate

__all__ = ["AdamWState", "adamw_init", "clip_by_global_norm",
           "cosine_schedule", "compress_grads", "adamw_update",
           "global_norm", "UPDATE_CHUNK"]

# elements per chunk of the in-place update (fp32 temporaries <= 64 MiB)
UPDATE_CHUNK = 1 << 24


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    m: Any
    v: Any
    master: Any          # fp32 copy of params


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``), keeping the structure; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """Leaves in ``jax.tree_util.tree_leaves`` order (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if _is_node(tree):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def adamw_init(params) -> AdamWState:
    """Zero moments and an fp32 master copy of every param, each a tensor
    of its own on the param's device."""
    def zeros(p):
        if isinstance(p, DTensor):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    leaves = tree_leaves(params)
    dev = _local(leaves[0]).device if leaves else torch.device("cpu")
    return AdamWState(
        torch.zeros((), dtype=torch.int32, device=dev),
        tree_map(zeros, params), tree_map(zeros, params),
        tree_map(lambda p: p.detach().to(torch.float32, copy=True), params))


def _local(t):
    """A DTensor's local shard (a view of its storage); anything else as it
    is."""
    return t.to_local() if isinstance(t, DTensor) else t


def _counted_here(t) -> bool:
    """Whether this rank adds ``t``'s local squares to the global norm: on
    each mesh dim where ``t`` is replicated, only the rank at index 0."""
    if not isinstance(t, DTensor):
        return True
    mesh = t.device_mesh
    return all(mesh.get_local_rank(i) == 0
               for i, p in enumerate(t.placements) if isinstance(p, Replicate))


def _all_reduce_over(mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over every rank of ``mesh`` (the process group's world)
    in one all-reduce."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the global norm's mesh has {mesh.size()} ranks, "
                         f"the process group {dist.get_world_size()}")
    return funcol.wait_tensor(
        funcol.all_reduce(t, "sum", dist.group.WORLD))


def _chunks(t: torch.Tensor):
    """Contiguous flat views of ``t``, ``UPDATE_CHUNK`` elements at most
    each."""
    if not t.is_contiguous():
        raise ValueError("the in-place update needs contiguous tensors")
    return t.view(-1).split(UPDATE_CHUNK)


def _fp32(g: torch.Tensor, divisor: int) -> torch.Tensor:
    """A gradient chunk as the fp32 values the reference sees: cast, then
    divided by ``divisor`` (a microbatch count) unless it is 1."""
    g = g.float()
    return g / divisor if divisor != 1 else g


@torch.no_grad()
def global_norm(grads, divisor: int = 1) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's fp32 sum
    of squares; a leaf is read ``UPDATE_CHUNK`` elements at a time.
    Distributed leaves: each rank's local shards, a replicated leaf counted
    once, the sum all-reduced over the mesh once."""
    leaves = tree_leaves(grads)
    dev = _local(leaves[0]).device if leaves else torch.device("cpu")
    mesh = next((g.device_mesh for g in leaves if isinstance(g, DTensor)),
                None)
    g2 = torch.zeros((), dtype=torch.float32, device=dev)
    for g in leaves:
        if not _counted_here(g):
            continue
        s = torch.zeros((), dtype=torch.float32, device=dev)
        for gc in _local(g).reshape(-1).split(UPDATE_CHUNK):
            x = _fp32(gc, divisor)
            s = s + torch.sum(x * x)
        g2 = g2 + s
    if mesh is not None:
        g2 = _all_reduce_over(mesh, g2)
    return torch.sqrt(g2)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / max(norm, 1e-9))`` in fp32 (a true division:
    torch's ``scalar / tensor`` multiplies by a reciprocal)."""
    num = torch.full((), max_norm, dtype=torch.float32, device=norm.device)
    return torch.clamp(num / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(fp32 grads scaled by the clip factor, the global norm): new
    tensors, as the reference returns."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor_frac * peak_lr`` at ``total``; fp32, on ``step``'s
    device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi
                                                                * prog))
    return peak_lr * torch.where(s < warmup, warm, cos)


def compress_grads(grads):
    """bf16 gradient compression for the cross-pod reduce: halves the
    collective payload; moments/updates stay fp32."""
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1,
                 max_grad_norm: Optional[float] = 1.0,
                 grad_divisor: int = 1):
    """One AdamW step, in place: returns (params, AdamWState(step + 1, m,
    v, master), {"grad_norm"}), the same tensors the caller passed, now
    updated (``step`` is a new 0-d tensor). ``lr`` is a float or a 0-d
    fp32 tensor; ``grads`` may be in any float dtype. ``grad_divisor``
    (not in the reference) divides each fp32 gradient
    chunk as it is read: the microbatch path passes its bf16 sums and
    their count, where the reference first builds the whole fp32 quotient
    tree."""
    g_l = [_local(t) for t in tree_leaves(grads)]
    p_l = [_local(t) for t in tree_leaves(params)]
    m_l, v_l, w_l = ([_local(t) for t in tree_leaves(tree)]
                     for tree in (state.m, state.v, state.master))
    if not len(g_l) == len(p_l) == len(m_l) == len(v_l) == len(w_l):
        raise ValueError(f"grads, params and state differ in leaves: "
                         f"{len(g_l)}, {len(p_l)}, {len(m_l)}, {len(v_l)}, "
                         f"{len(w_l)}")
    if max_grad_norm is not None:
        gnorm = global_norm(grads, grad_divisor)
        scale = _clip_scale(gnorm, max_grad_norm)
    else:
        gnorm = torch.zeros((), dtype=torch.float32,
                            device=_local(state.step).device)
        scale = None
    step = state.step + 1
    sf = _local(step).to(torch.float32)
    lr = _local(lr)
    b1c = 1 - torch.pow(b1, sf)
    b2c = 1 - torch.pow(b2, sf)
    for g, p, m, v, w in zip(g_l, p_l, m_l, v_l, w_l):
        if not g.shape == p.shape == m.shape == v.shape == w.shape:
            raise ValueError(f"leaf shapes differ: grad {tuple(g.shape)}, "
                             f"param {tuple(p.shape)}")
        for gc, pc, mc, vc, wc in zip(g.reshape(-1).split(UPDATE_CHUNK),
                                      _chunks(p), _chunks(m), _chunks(v),
                                      _chunks(w)):
            gf = _fp32(gc, grad_divisor)
            if scale is not None:
                gf = gf * scale
            mc.mul_(b1).add_(gf * (1 - b1))
            vc.mul_(b2).add_((gf * (1 - b2)).mul_(gf))
            upd = (mc / b1c).div_((vc / b2c).sqrt_().add_(eps))
            upd.add_(wc * weight_decay)
            wc.sub_(upd.mul_(lr))
            pc.copy_(wc)
    return params, AdamWState(step, state.m, state.v, state.master), \
        {"grad_norm": gnorm}
