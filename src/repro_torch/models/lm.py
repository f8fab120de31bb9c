"""LM assembly for all assigned architectures.

One ``init_lm`` / ``forward_trunk`` / ``lm_loss`` / ``prefill_forward`` /
``decode_step`` API covers five families (dense, moe, ssm, hybrid,
encoder), as in the reference (``repro.models.lm``). Parameters keep the
reference's layer-stacked leading axes (``[L, ...]``; gemma-2 local/global
pairs ``[L/2, 2, ...]``; zamba-2 groups ``[n_groups, g, ...]`` of mamba
layers, each followed by the shared attn+mlp block with its per-site
LoRA), so :func:`params_from_jax` converts the reference's tree leaf by
leaf. Each ``lax.scan`` of the reference is a Python loop over the leading
index, on views (the trunk unbinds each stacked leaf once, so a gradient
into it is one stack in the backward).

``lm_loss`` is differentiable by autograd. With ``remat`` (its default, as
the reference's) each unit the reference wraps in ``jax.checkpoint`` runs
under ``torch.utils.checkpoint`` and is recomputed in the backward.

Decode state is updated in place: ``decode_step`` writes each layer's
cache entry through a view of the stacked cache, and ``reset_decode_slot``
zeroes a slot's recurrent state and sets its start. ``DecodeState.pos`` is
a host int. Use :meth:`DecodeState.clone` to keep an earlier state.

The partitioned program is the same functions on DTensors under a
``DeviceMesh`` context (``sharding.set_mesh_ctx``): parameters placed by
``param_specs``, the decode state by ``cache_specs``, the batch on the
batch axes (``sharding.distribute``). Each entry point then runs under
DTensor's implicit replication (``sharding.partitioned``), and so does
each remat unit, whose recompute runs in the backward.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.plan_cache import DeviceLike, resolve_device
from ..sharding import (cache_specs, contiguous_stride, device_mesh_ctx,
                        get_mesh_ctx, local_part, mesh_of, on_batch_axes,
                        partitioned, placements, shard, shard_offset,
                        use_mesh)
from . import attention as A
from . import moe as M
from . import ssm as S
from .layers import (PARAM_DTYPE, apply_mlp, dense_init, dot, embed_init,
                     gather_weight, init_mlp, is_meta, layer_norm, rms_norm,
                     to_torch)

__all__ = ["init_lm", "param_count", "config_param_count", "params_from_jax",
           "embed_inputs", "forward_trunk", "lm_logits", "lm_forward",
           "lm_loss", "prefill_forward", "DecodeState", "decode_state_from_jax",
           "pad_prefill_caches", "init_decode_state", "track_slot_starts",
           "reset_decode_slot", "decode_step"]


# ---------------------------------------------------------------------------
# trees: dicts of tensors, KVCache / MambaCache named tuples
# ---------------------------------------------------------------------------
def _tree_map(fn, tree, *rest):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    return fn(tree, *rest)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _at(tree, idx):
    """Views of every leaf at leading index ``idx``."""
    depth = len(idx) if isinstance(idx, tuple) else 1
    return _tree_map(lambda t: _index_lead(_lead_whole(t, depth), idx, depth),
                     tree)


def _unbind_lead(t, depth: int):
    """``t``'s leading ``depth`` dims flattened and unbound. A DTensor
    (those dims replicated) is unbound in its local shard, each part put
    back with its placements shifted (a DTensor view of a parameter fails
    under ``torch.inference_mode``; the backward is the same stack)."""
    if not isinstance(t, DTensor):
        return t.flatten(0, depth - 1).unbind(0)
    pl = [Shard(p.dim - depth) if isinstance(p, Shard) else p
          for p in t.placements]
    shape, stride = t.shape[depth:], t.stride()[depth:]
    return tuple(DTensor.from_local(x, t.device_mesh, pl, shape=shape,
                                    stride=stride)
                 for x in t.to_local().flatten(0, depth - 1).unbind(0))


def _index_lead(t, idx, depth: int):
    """``t[idx]`` over ``t``'s leading ``depth`` dims. A DTensor (those dims
    replicated) is indexed in its local shard and put back with its
    placements shifted: a DTensor op on a parameter fails under
    ``torch.inference_mode``."""
    if not isinstance(t, DTensor):
        return t[idx]
    loc = t.to_local()[idx]
    pl = [Shard(p.dim - depth) if isinstance(p, Shard) else p
          for p in t.placements]
    shape = t.shape[depth:]
    return DTensor.from_local(loc, t.device_mesh, pl, shape=shape,
                              stride=t.stride()[depth:])


def _lead_whole(t, depth: int):
    """``t`` with its leading ``depth`` (stack) dims whole on every rank: a
    DTensor sharded there is gathered over those mesh dims first (the
    reference's rules put a stacked shared expert's layer dim on "model");
    anything else as it is."""
    if not isinstance(t, DTensor) or not any(
            isinstance(p, Shard) and p.dim < depth for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim < depth else p
        for p in t.placements])


def _put(store: Dict[str, Any], key: str, lead: Tuple[int, ...], idx,
         value) -> None:
    """``store[key][idx] = value``, allocating ``store[key]`` with leading
    dims ``lead`` on the first put (one layer at a time: never a list of
    layers stacked at the end). A DTensor cache entry is first placed as
    ``cache_specs`` places it, and the stack holds each rank's local
    shards (DTensor has no rule for a copy into an indexed view)."""
    if isinstance(_leaves(value)[0], DTensor):
        value = _place_cache(key, value)
        if key not in store:
            store[key] = _tree_map(lambda t: _stacked(t, lead), value)
        _tree_map(lambda dst, src: dst.to_local()[idx].copy_(src.to_local()),
                  store[key], value)
        return
    if key not in store:
        store[key] = _tree_map(lambda t: t.new_empty(lead + tuple(t.shape)),
                               value)
    _tree_map(lambda dst, src: dst[idx].copy_(src), store[key], value)


def _place_cache(key: str, value):
    """A cache entry (``KVCache`` / ``MambaCache`` of DTensors) redistributed
    to the placements ``cache_specs`` gives it."""
    mesh = _leaves(value)[0].device_mesh
    specs = cache_specs({key: value}, mesh)[key]
    return _tree_map(lambda t, sp: t.redistribute(mesh, placements(sp, mesh)),
                     value, specs)


def _stacked(t: DTensor, lead: Tuple[int, ...]) -> DTensor:
    """An uninitialised DTensor of ``lead + t.shape``, the leading dims
    replicated, each rank holding ``lead + its local shape``."""
    pl = [Shard(p.dim + len(lead)) if isinstance(p, Shard) else p
          for p in t.placements]
    shape = lead + tuple(t.shape)
    loc = t.to_local().new_empty(lead + tuple(t.to_local().shape))
    return DTensor.from_local(loc, t.device_mesh, pl, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def _stack(fn, n: int):
    """``fn()`` drawn ``n`` times, each leaf on a new leading axis."""
    out: Dict[str, Any] = {}
    for i in range(n):
        _put(out, "x", (n,), i, fn())
    return out["x"]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def _init_norm(cfg: ArchConfig, device):
    kw = dict(dtype=PARAM_DTYPE, device=device)
    if cfg.norm == "layer":
        return {"w": torch.ones((cfg.d_model,), **kw),
                "b": torch.zeros((cfg.d_model,), **kw)}
    return {"w": torch.zeros((cfg.d_model,), **kw)}


def _norm(cfg: ArchConfig, p, x):
    if cfg.norm == "layer":
        return layer_norm(x, p["w"], p["b"])
    return rms_norm(x, p["w"])


# ---------------------------------------------------------------------------
# per-layer init
# ---------------------------------------------------------------------------
def _init_attn_layer(cfg: ArchConfig, g, dev):
    p = {
        "ln1": _init_norm(cfg, dev),
        "attn": A.init_attention(g, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.d_head, qkv_bias=cfg.qkv_bias,
                                 device=dev),
        "ln2": _init_norm(cfg, dev),
    }
    if cfg.post_block_norm:
        p["ln1_post"] = _init_norm(cfg, dev)
        p["ln2_post"] = _init_norm(cfg, dev)
    return p


def _init_dense_layer(cfg: ArchConfig, g, dev, d_ff=None):
    p = _init_attn_layer(cfg, g, dev)
    p["mlp"] = init_mlp(g, cfg.d_model, d_ff or cfg.d_ff, gated=cfg.mlp_gated,
                        device=dev)
    return p


def _init_moe_layer(cfg: ArchConfig, g, dev):
    p = _init_attn_layer(cfg, g, dev)
    p["moe"] = M.init_moe(g, cfg.d_model, cfg.d_ff, cfg.n_experts,
                          n_shared=cfg.n_shared_experts, device=dev)
    return p


def _init_mamba_layer(cfg: ArchConfig, g, dev):
    d_inner = cfg.ssm_expand * cfg.d_model
    return {
        "ln1": _init_norm(cfg, dev),
        "mamba": S.init_mamba2(g, cfg.d_model, d_inner, cfg.ssm_head_dim,
                               cfg.ssm_state, cfg.ssm_conv_k, device=dev),
    }


def _hybrid_counts(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(n_groups, mamba_per_group, tail) with n_layers mamba layers total."""
    g = cfg.hybrid_group
    n_groups = cfg.n_layers // g
    return n_groups, g, cfg.n_layers - n_groups * g


def init_lm(cfg: ArchConfig, generator: Optional[torch.Generator] = None, *,
            device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters drawn from ``generator`` (on its device) onto
    ``device`` (``cuda`` unless named), each stacked tensor allocated once
    and filled one layer at a time. On ``meta`` nothing is drawn and the
    generator may be None (see :func:`config_param_count`)."""
    dev = resolve_device(device)
    if generator is None and not is_meta(dev):
        raise ValueError("init_lm needs a torch.Generator off the meta device")
    g = generator
    params: Dict[str, Any] = {"final_norm": _init_norm(cfg, dev)}
    if cfg.frontend == "token":
        params["embed"] = embed_init(g, cfg.vocab, cfg.d_model, device=dev)
    if not cfg.tie_embeddings:
        params["head"] = dense_init(g, cfg.d_model, cfg.vocab, device=dev)

    fam = cfg.family
    if fam in ("dense", "encoder"):
        if cfg.local_global_period == 2:
            if cfg.n_layers % 2:
                raise ValueError("local/global pairs need an even n_layers")
            params["layers"] = _stack(
                lambda: _stack(lambda: _init_dense_layer(cfg, g, dev), 2),
                cfg.n_layers // 2)
        else:
            params["layers"] = _stack(lambda: _init_dense_layer(cfg, g, dev),
                                      cfg.n_layers)
    elif fam == "moe":
        nd = cfg.first_dense_layers
        if nd:
            params["dense_layers"] = _stack(
                lambda: _init_dense_layer(cfg, g, dev, d_ff=cfg.first_dense_ff),
                nd)
        params["layers"] = _stack(lambda: _init_moe_layer(cfg, g, dev),
                                  cfg.n_layers - nd)
    elif fam == "ssm":
        params["layers"] = _stack(lambda: _init_mamba_layer(cfg, g, dev),
                                  cfg.n_layers)
    elif fam == "hybrid":
        n_groups, gs, tail = _hybrid_counts(cfg)
        params["layers"] = _stack(
            lambda: _stack(lambda: _init_mamba_layer(cfg, g, dev), gs),
            n_groups)
        if tail:
            params["tail"] = _stack(lambda: _init_mamba_layer(cfg, g, dev),
                                    tail)
        params["shared"] = _init_dense_layer(cfg, g, dev)
        r = cfg.lora_rank

        def lora_init():
            return {
                "a_q": dense_init(g, cfg.d_model, r, device=dev),
                "b_q": torch.zeros((r, cfg.attn_dim), dtype=PARAM_DTYPE,
                                   device=dev),
                "a_i": dense_init(g, cfg.d_model, r, device=dev),
                "b_i": torch.zeros((r, cfg.d_ff), dtype=PARAM_DTYPE,
                                   device=dev),
            }

        params["lora"] = _stack(lora_init, n_groups)
    else:
        raise ValueError(fam)
    return params


def param_count(params) -> int:
    return sum(t.numel() for t in _leaves(params))


def config_param_count(cfg: ArchConfig) -> int:
    """``cfg``'s parameter count, from ``init_lm`` on the meta device (no
    memory is allocated, nothing is drawn)."""
    return param_count(init_lm(cfg, None, device="meta"))


def params_from_jax(cfg: ArchConfig, tree, device: DeviceLike = None):
    """The reference's ``init_lm(cfg, key)`` tree (leaves of any array type
    numpy reads, bf16 included) as this package's parameters on ``device``,
    each leaf in its own dtype (an fp32 copy of the tree stays fp32).
    Raises ValueError where the tree's keys or shapes are not those
    ``init_lm(cfg)`` makes here."""
    dev = resolve_device(device)
    want = init_lm(cfg, None, device="meta")

    def conv(w, a, path):
        if isinstance(w, dict):
            if not isinstance(a, dict) or set(a) != set(w):
                raise ValueError(f"{path or 'params'}: keys "
                                 f"{sorted(a) if isinstance(a, dict) else a!r}"
                                 f", expected {sorted(w)}")
            return {k: conv(w[k], a[k], f"{path}.{k}" if path else k)
                    for k in w}
        t = to_torch(a)
        if tuple(t.shape) != tuple(w.shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)}, expected "
                             f"{tuple(w.shape)}")
        return t.to(dev)

    return conv(want, tree, "")


# ---------------------------------------------------------------------------
# blocks (forward)
# ---------------------------------------------------------------------------
def _attn_kwargs(cfg: ArchConfig, local: bool):
    return dict(
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
        causal=cfg.causal, rope_theta=cfg.rope_theta,
        window=cfg.sliding_window if local else None,
        softcap=cfg.attn_softcap, scale=cfg.attn_scale,
        use_banded=local,
    )


def _ffn(cfg: ArchConfig, p, h):
    """The block's second half: (out, aux loss or None) through its MoE or
    its MLP."""
    if "moe" in p:
        return M.moe_capacity(p["moe"], h, top_k=cfg.top_k,
                              n_experts=cfg.n_experts,
                              capacity_factor=cfg.moe_capacity_factor,
                              act=cfg.act)
    return apply_mlp(p["mlp"], h, act=cfg.act, gated=cfg.mlp_gated), None


def _dense_block(cfg: ArchConfig, p, h, *, local=False, q_chunk=512,
                 kv_chunk=512, return_kv=False):
    """Attention + MLP (or MoE) block -> (h, aux or None, KVCache or
    None)."""
    a_in = _norm(cfg, p["ln1"], h)
    out = A.attention_forward(p["attn"], a_in, q_chunk=q_chunk,
                              kv_chunk=kv_chunk, return_kv=return_kv,
                              **_attn_kwargs(cfg, local))
    attn_out, kv = out if return_kv else (out, None)
    attn_out = _resid(attn_out)
    if cfg.post_block_norm:
        attn_out = _norm(cfg, p["ln1_post"], attn_out)
    h = h + attn_out
    mlp_out, aux = _ffn(cfg, p, _norm(cfg, p["ln2"], h))
    mlp_out = _resid(mlp_out)
    if cfg.post_block_norm:
        mlp_out = _norm(cfg, p["ln2_post"], mlp_out)
    return h + mlp_out, aux, kv


def _resid(x):
    """A sublayer's output as the residual stream holds it: batch on the
    batch axes, replicated elsewhere. In the partitioned program this is
    the tensor-parallel all-reduce of a row-parallel product, made once
    here rather than by each op that reads a pending sum."""
    return shard(x, "batch", None, None)


def _mamba_block(cfg: ArchConfig, p, h, chunk=128, return_state=False):
    """-> (h, MambaCache or None)."""
    out = S.mamba2_forward(p["mamba"], _norm(cfg, p["ln1"], h),
                           head_dim=cfg.ssm_head_dim, state=cfg.ssm_state,
                           chunk=chunk, return_state=return_state)
    out, mc = out if return_state else (out, None)
    return h + _resid(out), mc


def _shared_params(shared, lora):
    """zamba2's shared attn+mlp block with one site's LoRA on wq and wi."""
    attn = dict(shared["attn"])
    attn["wq"] = attn["wq"] + (lora["a_q"].float()
                               @ lora["b_q"].float()).to(attn["wq"].dtype)
    mlp = dict(shared["mlp"])
    mlp["wi"] = mlp["wi"] + (lora["a_i"].float()
                             @ lora["b_i"].float()).to(mlp["wi"].dtype)
    return {**shared, "attn": attn, "mlp": mlp}


# ---------------------------------------------------------------------------
# trunk
# ---------------------------------------------------------------------------
def _sinusoid(T: int, D: int, device) -> torch.Tensor:
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(D // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10_000.0, 2 * i / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def embed_inputs(cfg: ArchConfig, params, inputs) -> torch.Tensor:
    """tokens [B,T] int (token frontend) or embeddings [B,T,D] (stub)."""
    if cfg.frontend == "token":
        table = params["embed"]
        if isinstance(table, DTensor):
            h = _vocab_parallel_lookup(gather_weight(table), inputs.long())
        else:
            h = table[inputs.long()]
        if cfg.name.startswith("gemma"):
            h = (h.float() * (cfg.d_model ** 0.5)).to(h.dtype)
    else:
        h = inputs
        if cfg.family == "encoder":  # stub frontend: add sinusoidal positions
            h = h + _sinusoid(h.shape[1], cfg.d_model, h.device).to(
                h.dtype)[None]
    return shard(h, "batch", None, None)


def _vocab_parallel_lookup(table: DTensor, idx: DTensor) -> DTensor:
    """``table[idx]`` for a vocab-sharded ("model") ``[V, D]`` table on local
    shards (DTensor's embedding rule takes its gradient as a pending sum it
    cannot convert): each rank looks up the rows it holds, zero elsewhere,
    and the rows are summed over the vocab's mesh dims (one all-reduce;
    one value and zeros, so the same bits as the index). The table's
    gradient is a pending sum over the batch axes, which its FSDP gather
    reduce-scatters."""
    mesh = table.device_mesh
    vd = [i for i, p in enumerate(table.placements)
          if isinstance(p, Shard) and p.dim == 0]
    loc = local_part(table)
    v0 = shard_offset(table, 0)
    il = idx.redistribute(mesh, [Replicate() if i in vd else p for i, p
                                 in enumerate(idx.placements)]).to_local()
    j = il - v0
    mine = (j >= 0) & (j < loc.shape[0])
    rows = loc[j.clamp(0, loc.shape[0] - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    pl = [Partial() if i in vd else p for i, p in enumerate(idx.placements)]
    shape = tuple(idx.shape) + (table.shape[1],)
    return shard(DTensor.from_local(rows, mesh, pl, shape=torch.Size(shape),
                                    stride=contiguous_stride(shape)),
                 "batch", None, None)


def _unstack(stack, depth: int = 1):
    """Per-index trees of a layer-stacked tree, over its leading ``depth``
    dims flattened (index ``i * n2 + j`` for ``[n1, n2, ...]``): one
    ``unbind`` per leaf. A gradient into a stacked leaf is then one stack in
    the backward; a view ``t[i]`` a layer (``_at``) would give each layer's
    backward a zero-filled tensor of the whole leaf to add into it."""
    parts = _tree_map(lambda t: _unbind_lead(_lead_whole(t, depth), depth),
                      stack)
    n = len(_leaves(parts)[0])
    return [_tree_map(lambda p: p[i], parts) for i in range(n)]


def _trunk(cfg: ArchConfig, params, h, *, q_chunk, kv_chunk, ssd_chunk,
           remat: bool = False, caches: Optional[Dict[str, Any]] = None):
    """[B, T, D] -> ([B, T, D] before the final norm, aux). With a
    ``caches`` dict, each layer's decode cache is stored into it (never
    under remat). With ``remat`` and grad enabled, each unit the reference
    wraps in ``jax.checkpoint`` (one dense or MoE layer, gemma-2's
    local/global pair, one mamba layer, one zamba-2 group with its shared
    block, one tail layer) runs under ``torch.utils.checkpoint``: its
    activations are recomputed in the backward."""
    fam = cfg.family
    keep = caches is not None
    ckpt = remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    chunks = dict(q_chunk=q_chunk, kv_chunk=kv_chunk, return_kv=keep)

    def unit(fn, *args):
        if ckpt:   # nothing on the path draws randomness: no RNG stash
            return checkpoint(_in_partitioned(fn), *args, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(*args)

    def dense(p, hh, local=False):
        return _dense_block(cfg, p, hh, local=local, **chunks)

    def pair(p0, p1, hh):
        hh, _, kv0 = dense(p0, hh, True)
        hh, _, kv1 = dense(p1, hh, False)
        return hh, kv0, kv1

    def mamba(p, hh):
        return _mamba_block(cfg, p, hh, chunk=ssd_chunk, return_state=keep)

    def group(ps, shared, lora, hh):
        mcs = []
        for p in ps:
            hh, mc = mamba(p, hh)
            mcs.append(mc)
        hh, _, kv = dense(_shared_params(shared, lora), hh)
        return hh, mcs, kv

    if fam in ("dense", "encoder", "moe"):
        if "dense_layers" in params:
            layers = _unstack(params["dense_layers"])
            for i, lp in enumerate(layers):
                h, _, kv = unit(dense, lp, h)
                if keep:
                    _put(caches, "kv_dense", (len(layers),), i, kv)
        if cfg.local_global_period == 2:
            layers = _unstack(params["layers"], 2)
            n = len(layers) // 2
            for i in range(n):
                h, kv0, kv1 = unit(pair, layers[2 * i], layers[2 * i + 1], h)
                if keep:
                    _put(caches, "kv", (n, 2), (i, 0), kv0)
                    _put(caches, "kv", (n, 2), (i, 1), kv1)
        else:
            layers = _unstack(params["layers"])
            for i, lp in enumerate(layers):
                h, a, kv = unit(dense, lp, h)
                if a is not None:
                    aux = aux + a
                if keep:
                    _put(caches, "kv", (len(layers),), i, kv)
    elif fam == "ssm":
        layers = _unstack(params["layers"])
        for i, lp in enumerate(layers):
            h, mc = unit(mamba, lp, h)
            if keep:
                _put(caches, "mamba", (len(layers),), i, mc)
    elif fam == "hybrid":
        n_groups, gs, tail = _hybrid_counts(cfg)
        layers = _unstack(params["layers"], 2)
        loras = _unstack(params["lora"])
        for gi in range(n_groups):
            h, mcs, kv = unit(group, layers[gi * gs:(gi + 1) * gs],
                              params["shared"], loras[gi], h)
            if keep:
                for j, mc in enumerate(mcs):
                    _put(caches, "mamba", (n_groups, gs), (gi, j), mc)
                _put(caches, "kv", (n_groups,), gi, kv)
        if "tail" in params:
            for i, lp in enumerate(_unstack(params["tail"])):
                h, mc = unit(mamba, lp, h)
                if keep:
                    _put(caches, "mamba_tail", (tail,), i, mc)
    else:
        raise ValueError(fam)
    return h, aux


def _entry(fn):
    """An entry point ``fn(cfg, params, ...)`` of the program: on
    distributed ``params`` it runs under their ``DeviceMesh`` (unless a
    context is set) and :func:`sharding.partitioned`, a plain batch tensor
    argument put on the batch axes; nothing changes otherwise."""
    @functools.wraps(fn)
    def run(cfg, params, *args, **kwargs):
        mesh = None if get_mesh_ctx() is not None else mesh_of(params)
        with use_mesh(mesh), partitioned():
            dm = device_mesh_ctx()
            if dm is not None:   # a whole batch: each rank's rows
                args = tuple(on_batch_axes(a, dm)
                             if isinstance(a, torch.Tensor) else a
                             for a in args)
            return fn(cfg, params, *args, **kwargs)
    return run


def _in_partitioned(fn):
    """``fn`` run under the current mesh context and
    :func:`sharding.partitioned` (a remat unit's recompute runs in the
    backward, outside the entry point's context)."""
    mesh = get_mesh_ctx()

    @functools.wraps(fn)
    def run(*args):
        with use_mesh(mesh), partitioned():
            return fn(*args)
    return run


def forward_trunk(cfg: ArchConfig, params, h, *, remat=True, q_chunk=512,
                  kv_chunk=512, ssd_chunk=128):
    """[B, T, D] -> ([B, T, D] after the final norm, aux_loss)."""
    h, aux = _trunk(cfg, params, h, q_chunk=q_chunk, kv_chunk=kv_chunk,
                    ssd_chunk=ssd_chunk, remat=remat)
    return _norm(cfg, params["final_norm"], h), aux


def _head_weights(cfg: ArchConfig, params):
    if cfg.tie_embeddings:
        return gather_weight(params["embed"]).T
    return gather_weight(params["head"])


def _logits(cfg: ArchConfig, h, W) -> torch.Tensor:
    logits = dot(h, W).float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def lm_logits(cfg: ArchConfig, params, h) -> torch.Tensor:
    logits = _logits(cfg, h, _head_weights(cfg, params))
    return shard(logits, *(["batch"] + [None] * (logits.dim() - 2)
                           + ["model"]))


@_entry
def lm_forward(cfg: ArchConfig, params, inputs, *, remat=False,
               **kw) -> torch.Tensor:
    """Full logits [B, T, V] — tests / small models only."""
    h = embed_inputs(cfg, params, inputs)
    h, _ = forward_trunk(cfg, params, h, remat=remat, **kw)
    return lm_logits(cfg, params, h)


def _vocab_sharded(logits) -> bool:
    """Whether ``logits`` is a DTensor whose vocab dim is split over more
    than one rank."""
    if not isinstance(logits, DTensor):
        return False
    mesh = logits.device_mesh
    return any(isinstance(p, Shard) and p.dim == logits.dim() - 1
               and mesh.size(i) > 1 for i, p in enumerate(logits.placements))


def _vocab_parallel_lse_gold(logits: DTensor, labels: DTensor):
    """logsumexp over a vocab-sharded ``[B, T, V]`` DTensor and each label's
    logit, on local shards (DTensor's ``gather`` takes a sharded vocab for
    an embedding): the max, the sum of exponentials and the label's logit
    (held by one rank, 0 elsewhere) are reduced over the vocab's mesh dims
    (an all-reduce each). Returns two ``[B, T]`` DTensors, batch placed as
    ``logits``', replicated elsewhere."""
    mesh = logits.device_mesh
    vdim = logits.dim() - 1
    vd = [i for i, p in enumerate(logits.placements)
          if isinstance(p, Shard) and p.dim == vdim]
    out_pl = [Replicate() if i in vd else p
              for i, p in enumerate(logits.placements)]
    loc = logits.to_local()
    v0 = shard_offset(logits, vdim)
    yl = labels.redistribute(mesh, out_pl).to_local()

    def reduced(t, op):
        part = DTensor.from_local(
            t, mesh, [Partial(op) if i in vd else p
                      for i, p in enumerate(out_pl)])
        return part.redistribute(mesh, out_pl)

    # the max only shifts the exponentials: no gradient through it
    mx = reduced(loc.detach().amax(-1), "max")
    sumexp = reduced(torch.exp(loc - mx.to_local()[..., None]).sum(-1), "sum")
    lse = mx + torch.log(sumexp)
    idx = yl.clamp(min=0) - v0
    mine = (idx >= 0) & (idx < loc.shape[-1])
    g = torch.gather(loc, -1, idx.clamp(0, loc.shape[-1] - 1)[..., None])
    gold = reduced(torch.where(mine, g[..., 0], torch.zeros_like(g[..., 0])),
                   "sum")
    return lse, gold


@_entry
def lm_loss(cfg: ArchConfig, params, inputs, labels, *, remat=True,
            loss_chunk=512, aux_weight=0.01, **kw):
    """Next-token CE, seq-chunked so [B, Tc, V] logits never exceed a
    chunk; differentiable by autograd (``train.step`` takes its gradients).
    With ``remat`` the trunk's layers are recomputed in the backward; the
    loss-chunk loop is never checkpointed, as the reference's chunk scan
    is not.

    labels: int [B, T], -1 = masked. Returns (loss, {"ce", "aux"}).
    """
    h = embed_inputs(cfg, params, inputs)
    h, aux = forward_trunk(cfg, params, h, remat=remat, **kw)
    T = h.shape[1]
    W = _head_weights(cfg, params)
    c = min(loss_chunk, T)
    if T % c:
        raise ValueError(f"sequence length {T} is not a multiple of the "
                         f"loss chunk {c}")
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for s in range(0, T, c):
        logits = shard(_logits(cfg, h[:, s:s + c], W), "batch", None, "model")
        yc = labels[:, s:s + c].long()
        if _vocab_sharded(logits):
            lse, gold = _vocab_parallel_lse_gold(logits, yc)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, yc.clamp(min=0)[..., None])[..., 0]
        valid = (yc >= 0).float()
        tot = tot + torch.sum((lse - gold) * valid)
        cnt = cnt + torch.sum(valid)
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# decode state
# ---------------------------------------------------------------------------
class DecodeState(NamedTuple):
    caches: Any        # family-specific dict, layer-stacked
    pos: int           # tokens already in cache
    # per-slot sequence start (int32[B]); None = every slot started at 0.
    # A slot reused mid-stream (continuous batching) sets start[b] to the
    # admission position so attention never sees the previous occupant's
    # stale cache entries; see reset_decode_slot.
    start: Optional[torch.Tensor] = None

    def clone(self) -> "DecodeState":
        """A copy sharing no tensor with this state."""
        return DecodeState(_tree_map(torch.clone, self.caches), self.pos,
                           None if self.start is None else self.start.clone())


def decode_state_from_jax(state, device: DeviceLike = None) -> DecodeState:
    """The reference's ``DecodeState`` (any array type numpy reads) as this
    package's, on ``device``."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        fields = getattr(x, "_fields", None)
        if fields == ("k", "v"):
            return A.KVCache(*(to_torch(a).to(dev) for a in x))
        if fields == ("conv", "ssm"):
            return S.MambaCache(*(to_torch(a).to(dev) for a in x))
        raise TypeError(f"unexpected cache node {type(x).__name__}")

    start = None if state.start is None else to_torch(state.start).to(dev)
    return DecodeState(conv(state.caches), int(np.asarray(state.pos)), start)


def pad_prefill_caches(cfg: ArchConfig, state: DecodeState, max_seq: int
                       ) -> DecodeState:
    """Grow prefill KV caches (length T) to the decode budget ``max_seq``."""
    caches = dict(state.caches)

    def grow(t, pad):
        if not isinstance(t, DTensor):
            return F.pad(t, (0, 0, 0, 0, 0, pad))
        # the sequence dim is replicated: pad each rank's shard
        loc = F.pad(t.to_local(), (0, 0, 0, 0, 0, pad))
        shape = t.shape[:-3] + (t.shape[-3] + pad,) + t.shape[-2:]
        return DTensor.from_local(loc, t.device_mesh, t.placements,
                                  shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))

    for key in ("kv", "kv_dense"):
        if key in caches:
            k = caches[key].k
            pad = max_seq - k.shape[k.dim() - 3]      # [..., S, KH, Dh]
            caches[key] = A.KVCache(*(grow(t, pad) for t in caches[key]))
    return DecodeState(caches, state.pos, state.start)


def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int,
                      device: DeviceLike = None) -> DecodeState:
    dev = resolve_device(device)
    fam = cfg.family

    def kv(lead):
        shape = lead + (batch, max_seq, cfg.n_kv_heads, cfg.d_head)
        return A.KVCache(*(torch.zeros(shape, dtype=PARAM_DTYPE, device=dev)
                           for _ in range(2)))

    def mcache(lead):
        d_inner = cfg.ssm_expand * cfg.d_model
        H = d_inner // cfg.ssm_head_dim
        conv_dim = d_inner + 2 * cfg.ssm_state
        return S.MambaCache(
            torch.zeros(lead + (batch, cfg.ssm_conv_k - 1, conv_dim),
                        dtype=PARAM_DTYPE, device=dev),
            torch.zeros(lead + (batch, H, cfg.ssm_state, cfg.ssm_head_dim),
                        dtype=torch.float32, device=dev))

    if fam in ("dense", "moe"):
        nd = cfg.first_dense_layers if fam == "moe" else 0
        lead = ((cfg.n_layers // 2, 2) if cfg.local_global_period == 2
                else (cfg.n_layers - nd,))
        caches: Dict[str, Any] = {"kv": kv(lead)}
        if nd:
            caches["kv_dense"] = kv((nd,))
    elif fam == "ssm":
        caches = {"mamba": mcache((cfg.n_layers,))}
    elif fam == "hybrid":
        n_groups, g, tail = _hybrid_counts(cfg)
        caches = {"mamba": mcache((n_groups, g)), "kv": kv((n_groups,))}
        if tail:
            caches["mamba_tail"] = mcache((tail,))
    else:
        raise ValueError(f"{cfg.family} has no decode step")
    return DecodeState(caches, 0)


def track_slot_starts(state: DecodeState, batch: int) -> DecodeState:
    """Enable per-slot sequence-start tracking on a decode state (required
    before :func:`reset_decode_slot`); all slots start at position 0."""
    if state.start is not None:
        return state
    leaf = _leaves(state.caches)[0]
    if isinstance(leaf, DTensor):   # a plain tensor, whole on every rank
        leaf = leaf.to_local()
    return DecodeState(state.caches, state.pos,
                       torch.zeros((batch,), dtype=torch.int32,
                                   device=leaf.device))


def reset_decode_slot(cfg: ArchConfig, state: DecodeState, slot: int
                      ) -> DecodeState:
    """Recycle batch slot ``slot`` for a NEW sequence starting at the
    current position (continuous-batching slot reuse), in place.

    Attention caches need no rewrite: ``start[slot] = pos`` masks every
    stale cache position for that slot, and rope attention scores depend
    only on position differences, so a sequence admitted at position p is
    equivalent to one started at 0. Recurrent (mamba) state is genuinely
    stateful, so the slot's conv/ssm entries are zeroed — a zero state IS
    the fresh-sequence initial state.
    """
    if state.start is None:
        raise ValueError("state has no per-slot start tracking; wrap it "
                         "with track_slot_starts(state, batch) first")
    caches = state.caches
    # ssm: [n_layers, B, ...]; hybrid groups: [n_groups, g, B, ...]
    for key, axis in (("mamba", 2 if cfg.family == "hybrid" else 1),
                      ("mamba_tail", 1)):
        if key in caches:
            for t in caches[key]:
                _local_slot(t, axis, slot).zero_()
    _local_slot(state.start, 0, slot).fill_(state.pos)
    return state


def _local_slot(t, axis: int, slot: int) -> torch.Tensor:
    """Batch slot ``slot`` of ``t`` along ``axis`` as a writable view: of the
    tensor, or of a DTensor's local shard on the rank that holds the slot
    (an empty view elsewhere). DTensor has no rule for a write into one
    index of a sharded dim."""
    if not isinstance(t, DTensor):
        return t.select(axis, slot)
    loc = t.to_local()
    size = loc.shape[axis]
    lo = shard_offset(t, axis)
    if lo <= slot < lo + size:
        return loc.select(axis, slot - lo)
    return loc.narrow(axis, 0, 0)


# ---------------------------------------------------------------------------
# prefill and decode (serving)
# ---------------------------------------------------------------------------
@_entry
def prefill_forward(cfg: ArchConfig, params, inputs, *, q_chunk=512,
                    kv_chunk=512, ssd_chunk=128):
    """Serving prefill: returns (last-token logits [B, V], DecodeState).

    Encoder family returns (frame logits [B, T, V], None).
    """
    h = embed_inputs(cfg, params, inputs)
    chunks = dict(q_chunk=q_chunk, kv_chunk=kv_chunk, ssd_chunk=ssd_chunk)
    if cfg.family == "encoder":
        hh, _ = forward_trunk(cfg, params, h, remat=False, **chunks)
        return lm_logits(cfg, params, hh), None
    caches: Dict[str, Any] = {}
    h, _ = _trunk(cfg, params, h, caches=caches, **chunks)
    h_last = _norm(cfg, params["final_norm"], h[:, -1:, :])
    logits = lm_logits(cfg, params, h_last)[:, 0]
    return logits, DecodeState(caches, h.shape[1])


def _attn_decode_block(cfg, p, h, kv, pos, tables, *, local=False,
                       start=None):
    """``tables``: the step's shared rope table and masks, built on first
    use (one per window) and reused by every layer of the step."""
    window = cfg.sliding_window if local else None
    if window not in tables:
        tables[window] = A.decode_tables(
            kv.k.shape[1], pos, d_head=cfg.d_head, rope_theta=cfg.rope_theta,
            window=window, start=start, device=h.device)
    attn_out, _ = A.attention_decode(
        p["attn"], _norm(cfg, p["ln1"], h), kv, pos, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
        rope_theta=cfg.rope_theta, softcap=cfg.attn_softcap, window=window,
        scale=cfg.attn_scale, start=start, tables=tables[window])
    attn_out = _resid(attn_out)
    if cfg.post_block_norm:
        attn_out = _norm(cfg, p["ln1_post"], attn_out)
    h = h + attn_out
    mlp_out, _ = _ffn(cfg, p, _norm(cfg, p["ln2"], h))
    mlp_out = _resid(mlp_out)
    if cfg.post_block_norm:
        mlp_out = _norm(cfg, p["ln2_post"], mlp_out)
    return h + mlp_out


def _mamba_decode_block(cfg, p, h, mc):
    out, _ = S.mamba2_decode(p["mamba"], _norm(cfg, p["ln1"], h), mc,
                             head_dim=cfg.ssm_head_dim, state=cfg.ssm_state)
    return h + _resid(out)


@_entry
def decode_step(cfg: ArchConfig, params, tokens: torch.Tensor,
                state: DecodeState) -> Tuple[torch.Tensor, DecodeState]:
    """One-token step for the whole batch. tokens: [B, 1] -> logits [B, V].
    Writes the caches in place; the returned state is at ``pos + 1``."""
    h = embed_inputs(cfg, params, tokens)
    pos, start, caches = state.pos, state.start, state.caches
    fam = cfg.family
    tables: Dict[Any, Any] = {}

    if fam in ("dense", "moe"):
        if "kv_dense" in caches:
            for i in range(caches["kv_dense"].k.shape[0]):
                h = _attn_decode_block(cfg, _at(params["dense_layers"], i), h,
                                       _at(caches["kv_dense"], i), pos,
                                       tables, start=start)
        kv = caches["kv"]
        if cfg.local_global_period == 2:
            for i in range(kv.k.shape[0]):
                for j in (0, 1):
                    h = _attn_decode_block(
                        cfg, _at(params["layers"], (i, j)), h,
                        _at(kv, (i, j)), pos, tables, local=(j == 0),
                        start=start)
        else:
            for i in range(kv.k.shape[0]):
                h = _attn_decode_block(cfg, _at(params["layers"], i), h,
                                       _at(kv, i), pos, tables, start=start)
    elif fam == "ssm":
        for i in range(caches["mamba"].ssm.shape[0]):
            h = _mamba_decode_block(cfg, _at(params["layers"], i), h,
                                    _at(caches["mamba"], i))
    elif fam == "hybrid":
        n_groups, gs, _ = _hybrid_counts(cfg)
        for gi in range(n_groups):
            for j in range(gs):
                h = _mamba_decode_block(cfg, _at(params["layers"], (gi, j)),
                                        h, _at(caches["mamba"], (gi, j)))
            h = _attn_decode_block(
                cfg, _shared_params(params["shared"], _at(params["lora"], gi)),
                h, _at(caches["kv"], gi), pos, tables, start=start)
        if "mamba_tail" in caches:
            for i in range(caches["mamba_tail"].ssm.shape[0]):
                h = _mamba_decode_block(cfg, _at(params["tail"], i), h,
                                        _at(caches["mamba_tail"], i))
    else:
        raise ValueError(f"{fam} has no decode step")

    h = _norm(cfg, params["final_norm"], h)
    logits = lm_logits(cfg, params, h)[:, 0]
    return logits, DecodeState(caches, pos + 1, start)
