"""Mixture-of-Experts with Accel-GCN-style block-balanced dispatch.

Two dispatch paths (numerically equivalent up to capacity drops), as in the
reference (``repro.models.moe``):

* ``moe_capacity`` — sort-based capacity dispatch with static shapes and
  dense per-expert einsums; with ``DISPATCH_GROUPS > 1`` the tokens are
  split into groups with per-group capacity (the reference's ``vmap`` over
  groups is a batch dimension here). In the partitioned program (DTensors
  on a ``DeviceMesh``) it takes the reference's constraints: groups on
  "data", experts on "model" (EP), and the one resharding between them;
  the dispatch's sort, scatter and ``index_add_`` have no DTensor rule
  and run on each rank's local groups.
* ``moe_block``    — the paper's technique: tokens are degree-sorted by
  expert id, block-partitioned into fixed ``m_tile``-row blocks with one
  int32 metadata word per block, and multiplied by the grouped GEMM K4
  (``kernels/grouped_matmul.py``). Dropless.

Routers: softmax top-k with optional normalization (dbrx normalizes top-k
probs; deepseek-moe uses unnormalized gates + shared experts).
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..core.plan_cache import DeviceLike, resolve_device
from ..kernels.grouped_matmul import grouped_matmul_in_range
from ..kernels.ops import grouped_matmul_blocked
from ..sharding import local_part, shard
from .layers import (PARAM_DTYPE, apply_mlp, dense_init, gather_weight,
                     init_mlp, normal, promote, to_torch)

__all__ = ["DISPATCH_GROUPS", "init_moe", "params_from_jax", "moe_capacity",
           "moe_block", "block_dispatch", "aux_load_balance_loss"]


def init_moe(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, n_shared: int = 0,
             dtype: torch.dtype = PARAM_DTYPE,
             device: DeviceLike = None) -> Dict:
    """Router ``[d_model, E]`` fp32; ``wi``/``wg`` ``[E, d_model, d_ff]`` and
    ``wo`` ``[E, d_ff, d_model]`` in ``dtype``, ~ N(0, 1/fan_in); a gated
    shared MLP of width ``d_ff * n_shared`` when ``n_shared``. Drawn in fp32
    from ``generator`` on its device, then moved to ``device`` (on ``meta``
    nothing is drawn)."""
    dev = resolve_device(device)

    def experts(d_in, d_out):
        return normal(generator, (n_experts, d_in, d_out), d_in ** -0.5,
                      dtype, dev)

    p = {"router": dense_init(generator, d_model, n_experts, torch.float32,
                              device=dev),
         "wi": experts(d_model, d_ff),
         "wg": experts(d_model, d_ff),
         "wo": experts(d_ff, d_model)}
    if n_shared:
        p["shared"] = init_mlp(generator, d_model, d_ff * n_shared,
                               gated=True, dtype=dtype, device=dev)
    return p


def params_from_jax(p: Dict, device: DeviceLike = None) -> Dict:
    """The reference package's ``init_moe`` tree (any array type numpy can
    read) as this package's parameters on ``device``, each leaf in its own
    dtype."""
    dev = resolve_device(device)
    return {k: (params_from_jax(v, dev) if isinstance(v, dict)
                else to_torch(v).to(dev)) for k, v in p.items()}


def _route(p, x2d: torch.Tensor, top_k: int, normalize: bool):
    """x2d: [T, D] -> (weights [T, k] f32, ids [T, k] int64, probs [T, E])."""
    logits = x2d.float() @ gather_weight(p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    # ``jax.lax.top_k``'s order: equal probabilities (a saturated softmax
    # underflows the rest to 0) by ascending expert id; ``torch.topk``
    # leaves ties in no stated order
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[..., :top_k], ids[..., :top_k]
    if normalize:
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, ids, probs


def aux_load_balance_loss(probs: torch.Tensor, ids: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load balancing loss (mean_prob x mean_assignment)."""
    me = probs.mean(0)
    # the one-hot as a comparison with arange, the same ops on every device
    # (F.one_hot reads its input's range back to the host on the CPU only)
    ce = (ids[:, 0, None] == torch.arange(n_experts, device=ids.device)
          ).float().mean(0)
    return n_experts * torch.sum(me * ce)


# ---------------------------------------------------------------------------
# Path 1: capacity dispatch
# ---------------------------------------------------------------------------
# GShard-style grouped dispatch: when >1, tokens are split into this many
# groups with per-group capacity (the reference sets it to the mesh "data"
# extent). Decode-sized token counts keep the single-group path.
DISPATCH_GROUPS = 1


def _dispatch_group(xt, ids, *, top_k: int, n_experts: int, cap: int):
    """Capacity dispatch of one group ``xt [t, D]`` or of G groups at once
    ``xt [G, t, D]`` (ids ``[..., t, k]``) -> (xe ``[..., E*cap, D]``, slot
    ``[..., t*k]``, flat_t ``[..., t*k]``). Rows past an expert's capacity
    go to the dropped slot ``E*cap``."""
    single = xt.dim() == 2
    if single:
        xt, ids = xt[None], ids[None]
    G, t, D = xt.shape
    dev = xt.device
    flat_e = ids.reshape(G, t * top_k)
    flat_t = torch.arange(t, device=dev).repeat_interleave(top_k).expand(
        G, -1)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order).contiguous()
    rank_sorted = (torch.arange(t * top_k, device=dev)
                   - torch.searchsorted(se, se, side="left"))
    ranks = torch.empty_like(flat_e).scatter_(1, order, rank_sorted)
    keep = ranks < cap
    slot = torch.where(keep, flat_e * cap + ranks,
                       torch.full_like(flat_e, n_experts * cap))
    xe = torch.zeros((G, n_experts * cap + 1, D), dtype=xt.dtype, device=dev)
    g_idx = torch.arange(G, device=dev)[:, None]
    xe[g_idx, slot] = xt[g_idx, flat_t]
    xe = xe[:, :-1]
    if single:
        return xe[0], slot[0], flat_t[0]
    return xe, slot, flat_t


def _expert_ffn(xe, p, spec: str):
    """The gated expert FFN as einsums over ``xe`` (``spec`` names xe's
    axes, e.g. ``"ecd"``); silu in fp32, cast back to h's dtype."""
    out_spec = spec[:-1]
    wi, wg, wo = (gather_weight(p[k]) for k in ("wi", "wg", "wo"))
    h = torch.einsum(f"{spec},edf->{out_spec}f", *promote(xe, wi))
    g = torch.einsum(f"{spec},edf->{out_spec}f", *promote(xe, wg))
    h = F.silu(g.float()).to(h.dtype) * h
    return torch.einsum(f"{out_spec}f,efd->{out_spec}d", *promote(h, wo))


def moe_capacity(p, x: torch.Tensor, *, top_k: int, n_experts: int,
                 capacity_factor: float = 1.25, normalize: bool = True,
                 act: str = "silu"):
    """x: [B, T, D] -> ([B, T, D], aux loss). Static shapes."""
    B, T, D = x.shape
    xt = x.reshape(B * T, D)
    n_tok = B * T
    if isinstance(xt, DTensor):
        return _capacity_partitioned(p, xt, B=B, T=T, top_k=top_k,
                                     n_experts=n_experts,
                                     capacity_factor=capacity_factor,
                                     normalize=normalize, act=act)
    w, ids, probs = _route(p, xt, top_k, normalize)

    G = _groups(n_tok)
    tl = n_tok // G
    cap = int(capacity_factor * tl * top_k / n_experts)
    cap = max(8, ((cap + 7) // 8) * 8)
    dev = x.device

    if G == 1:
        xe, slot, flat_t = _dispatch_group(xt, ids, top_k=top_k,
                                           n_experts=n_experts, cap=cap)
        ye = _expert_ffn(xe.reshape(n_experts, cap, D), p, "ecd")
        ye = ye.reshape(n_experts * cap, D)
        ye = torch.cat([ye, ye.new_zeros((1, D))], dim=0)
        yt = ye[slot] * w.reshape(-1)[:, None].to(ye.dtype)
        out = torch.zeros((n_tok, D), dtype=torch.float32, device=dev)
        out.index_add_(0, flat_t, yt.float())
    else:
        xg = xt.reshape(G, tl, D)
        idg = ids.reshape(G, tl, top_k)
        xe, slot, flat_t = _dispatch_group(xg, idg, top_k=top_k,
                                           n_experts=n_experts, cap=cap)
        xe = xe.reshape(G, n_experts, cap, D).transpose(0, 1)
        ye = _expert_ffn(xe, p, "egcd").to(x.dtype)
        ye = ye.transpose(0, 1).reshape(G, n_experts * cap, D)
        ye = torch.cat([ye, ye.new_zeros((G, 1, D))], dim=1)
        g_idx = torch.arange(G, device=dev)[:, None]
        yt = ye[g_idx, slot] * w.reshape(G, -1)[..., None].to(ye.dtype)
        out = torch.zeros((G * tl, D), dtype=torch.float32, device=dev)
        out.index_add_(0, (g_idx * tl + flat_t).reshape(-1),
                       yt.float().reshape(-1, D))

    out = out.to(x.dtype)
    if "shared" in p:
        out = out + apply_mlp(p["shared"], xt, act=act)
    return out.reshape(B, T, D), aux_load_balance_loss(probs, ids, n_experts)


def _from_local(t: torch.Tensor, like: DTensor, placements) -> DTensor:
    """``t`` (this rank's even shard) as a DTensor on ``like``'s mesh."""
    return DTensor.from_local(t, like.device_mesh, placements)


def _groups(n_tok: int) -> int:
    """Dispatch groups for ``n_tok`` tokens (see ``DISPATCH_GROUPS``)."""
    return (DISPATCH_GROUPS
            if (DISPATCH_GROUPS and n_tok % DISPATCH_GROUPS == 0
                and n_tok // DISPATCH_GROUPS >= 64)
            else 1)


def _capacity_partitioned(p, xt: DTensor, *, B, T, top_k, n_experts,
                          capacity_factor, normalize, act):
    """``moe_capacity`` on DTensors, with the reference's constraints.

    The router runs on each rank's token rows (its softmax and top-k are
    row by row) and the aux loss sums each rank's rows, reduced over the
    batch axes. G > 1: the groups on "data"; each rank dispatches its own
    groups (the sort, the scatter and the combine's ``index_add_`` have no
    DTensor rule: they run on ``to_local()`` and go back by
    ``from_local``, each group's rows exactly as on one device), the
    dispatched rows are resharded to experts on "model" ("the one
    resharding"), the expert FFN runs on each rank's experts and the
    outputs go back to the groups on "data" before the combine. G == 1
    (decode-sized token counts): one dispatch over every token, so the
    tokens are gathered over the batch axes first and the dispatch is the
    same on every rank."""
    mesh = xt.device_mesh
    D = xt.shape[-1]
    n_tok = B * T
    G = _groups(n_tok)
    tl = n_tok // G
    cap = int(capacity_factor * tl * top_k / n_experts)
    cap = max(8, ((cap + 7) // 8) * 8)
    rep = [Replicate()] * mesh.ndim
    tok_pl = xt.placements
    part = [Partial() if isinstance(q, Shard) else q for q in tok_pl]
    # routing on this rank's rows (the same on every "model" rank); the
    # router's gradient is a pending sum over the batch axes
    w, ids, probs = _route({"router": local_part(gather_weight(p["router"]))},
                           xt.to_local(), top_k, normalize)
    me = DTensor.from_local(probs.sum(0) / n_tok, mesh, part)
    ce = DTensor.from_local(
        (ids[:, 0, None] == torch.arange(n_experts, device=ids.device)
         ).float().sum(0) / n_tok, mesh, part)
    aux = n_experts * torch.sum(me.redistribute(mesh, rep)
                                * ce.redistribute(mesh, rep))
    w, ids = (DTensor.from_local(t, mesh, tok_pl) for t in (w, ids))
    if G == 1:
        xl = xt.redistribute(mesh, rep).to_local()
        il = ids.redistribute(mesh, rep).to_local()
        wl = w.redistribute(mesh, rep).to_local()
        xe, slot, flat_t = _dispatch_group(xl, il, top_k=top_k,
                                           n_experts=n_experts, cap=cap)
        xe = _from_local(xe, xt, rep).reshape(n_experts, cap, D)
        xe = shard(xe, "model", None, None)
        ye = _expert_ffn(xe, p, "ecd").reshape(n_experts * cap, D)
        ye = shard(ye, None, None).to_local()
        ye = torch.cat([ye, ye.new_zeros((1, D))], dim=0)
        yt = ye[slot] * wl.reshape(-1)[:, None].to(ye.dtype)
        out = torch.zeros((xl.shape[0], D), dtype=torch.float32,
                          device=xl.device)
        out.index_add_(0, flat_t, yt.float())
        out = _from_local(out, xt, rep).redistribute(mesh, tok_pl)
    else:
        xg = shard(xt.reshape(G, tl, D), "data", None, None)
        gpl = xg.placements
        xl = xg.to_local()
        il = ids.reshape(G, tl, top_k).redistribute(mesh, gpl).to_local()
        wl = w.reshape(G, tl, top_k).redistribute(mesh, gpl).to_local()
        Gl = xl.shape[0]
        xe, slot, flat_t = _dispatch_group(xl, il, top_k=top_k,
                                           n_experts=n_experts, cap=cap)
        xe = _from_local(xe, xt, gpl).reshape(G, n_experts, cap, D)
        # the one resharding: groups on "data" -> experts on "model"
        xe = shard(xe.transpose(0, 1), "model", "data", None, None)
        ye = _expert_ffn(xe, p, "egcd").to(xt.dtype)
        ye = shard(ye, "model", "data", None, None)
        # back to the groups on "data" (kept in bf16) before the combine
        ye = shard(ye.transpose(0, 1), "data", None, None, None)
        ye = ye.reshape(G, n_experts * cap, D).to_local()
        ye = torch.cat([ye, ye.new_zeros((Gl, 1, D))], dim=1)
        g_idx = torch.arange(Gl, device=xl.device)[:, None]
        yt = ye[g_idx, slot] * wl.reshape(Gl, -1)[..., None].to(ye.dtype)
        out = torch.zeros((Gl * tl, D), dtype=torch.float32,
                          device=xl.device)
        out.index_add_(0, (g_idx * tl + flat_t).reshape(-1),
                       yt.float().reshape(-1, D))
        out = _from_local(out, xt, gpl).redistribute(mesh, tok_pl)
    out = out.to(xt.dtype)
    if "shared" in p:
        out = out + apply_mlp(p["shared"], xt, act=act)
    return out.reshape(B, T, D), aux


# ---------------------------------------------------------------------------
# Path 2: Accel-GCN block dispatch (paper technique; K4)
# ---------------------------------------------------------------------------
def block_dispatch(ids: torch.Tensor, n_experts: int, m_tile: int) -> Dict:
    """The dispatch metadata of ``moe_block`` from the router's ids
    ``[T, k]``, computed as the reference computes it:

    * ``order``: stable sort of the (token, slot) rows by expert (degree
      sorting);
    * ``counts``/``starts``: each expert's rows and the first row of its
      run, padded to ``m_tile`` (block partition);
    * ``dst``: the padded destination row of each sorted (token, slot) row;
    * ``block_expert``: int32 expert id per block, clipped to ``E - 1`` for
      the trailing blocks past the last expert (which hold zero rows);
    * ``M``: rows of the padded operand (worst case: every expert partially
      fills one extra block).
    """
    n_tok, top_k = ids.shape
    dev = ids.device
    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order].contiguous()
    S = n_tok * top_k
    M = S + n_experts * m_tile
    M = ((M + m_tile - 1) // m_tile) * m_tile
    counts = torch.bincount(flat_e, minlength=n_experts)
    padded = ((counts + m_tile - 1) // m_tile) * m_tile
    ends = torch.cumsum(padded, 0)
    starts = ends - padded
    rank_in_e = torch.arange(S, device=dev) - torch.searchsorted(
        se, se, side="left")
    dst = starts[se] + rank_in_e
    blk_start = torch.arange(M // m_tile, device=dev) * m_tile
    block_expert = torch.clamp(
        torch.searchsorted(ends, blk_start, side="right"), 0, n_experts - 1
    ).to(torch.int32)
    return {"ids": ids, "order": order, "counts": counts, "starts": starts,
            "dst": dst, "block_expert": block_expert, "M": M}


def moe_block(p, x: torch.Tensor, *, top_k: int, n_experts: int,
              m_tile: int = 128, normalize: bool = True, act: str = "silu",
              use_pallas: bool = True):
    """Dropless block-balanced dispatch via the paper's recipe.

    1. degree sort: stable sort of (token, slot) rows by expert id;
    2. block partition: pad each expert's run to a multiple of ``m_tile``;
       one int32 expert id per block is the whole metadata;
    3. three grouped GEMMs (wi, wg, wo): K4 when ``use_pallas`` (the plain
       version for CPU tensors), else the PyTorch twin.

    Returns ``(out [B, T, D], aux loss)``. The dtype flow is the
    reference's: the GEMM outputs are cast to ``x.dtype`` before the gate,
    silu is taken in fp32, the gate product in ``x.dtype``, the combine in
    fp32 and cast back.
    """
    B, T, D = x.shape
    xt = x.reshape(B * T, D)
    n_tok = B * T
    w, ids, probs = _route(p, xt, top_k, normalize)

    meta = block_dispatch(ids, n_experts, m_tile)
    order, dst = meta["order"], meta["dst"]
    st = order // top_k                       # token of each sorted row
    sw = w.reshape(-1)[order]
    xs = torch.zeros((meta["M"], D), dtype=x.dtype, device=x.device)
    xs[dst] = xt[st]
    block_expert = meta["block_expert"]

    if use_pallas:
        gmm = functools.partial(grouped_matmul_in_range, m_tile=m_tile)
    else:
        gmm = functools.partial(grouped_matmul_blocked, m_tile=m_tile)
    h = gmm(xs, p["wi"], block_expert).to(x.dtype)
    g = gmm(xs, p["wg"], block_expert).to(x.dtype)
    h = F.silu(g.float()).to(h.dtype) * h
    ys = gmm(h, p["wo"], block_expert)

    yt = ys[dst] * sw[:, None]
    out = torch.zeros((n_tok, ys.shape[1]), dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, st, yt)
    out = out.to(x.dtype)
    if "shared" in p:
        out = out + apply_mlp(p["shared"], xt, act=act)
    return out.reshape(B, T, D), aux_load_balance_loss(probs, ids, n_experts)
