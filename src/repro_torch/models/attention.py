"""Attention: GQA with RoPE, sliding windows, logit soft-caps, KV caches.

The reference's three compute paths (``repro.models.attention``), in plain
torch ops that follow its algorithm (no library attention: none has the
soft-cap, and the masks must be the reference's):

* ``attention_forward``  — chunked online-softmax (flash-style) over KV
  blocks; never materializes a [T, T] score matrix. Used for prefill.
  Causality/windowing by masking.
* ``banded_attention``   — sliding-window layers only: gathers a static
  (window + q_chunk) KV band per query chunk, so compute is truly
  sub-quadratic (gemma-2 local layers at long sequence).
* ``attention_decode``   — single-token step against a static-size KV cache,
  written in place.

Each ``lax.scan`` of the reference is a Python loop here.

In the partitioned program (DTensors on a ``DeviceMesh``) the attention
core has no sharding rule DTensor could use without gathering heads, so it
runs on each rank's local shard (batch on the batch axes, heads on
"model") and its result is put back with ``DTensor.from_local`` at the
same placements; the decode cache is written in its local shard.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..sharding import (contiguous_stride, local_part, mesh_coord, shard,
                        shard_heads, spec_placements)
from .layers import (PARAM_DTYPE, apply_rope, dense_init, dot, gather_weight,
                     rope_table)

NEG_INF = -2.3819763e38  # large negative, safe in fp32

# Keep attention operands in bf16 (the cache's dtype in decode) with fp32
# accumulation. The reference sets ``preferred_element_type=float32`` on
# bf16 operands; here the operands are rounded to bf16 and multiplied in
# fp32, which gives the same products (a product of two bf16 values is
# exact in fp32), so the flag changes numerics as the reference's does but
# not the bytes moved.
BF16_EINSUMS = False


def _operand(x: torch.Tensor, dtype: torch.dtype = torch.bfloat16
             ) -> torch.Tensor:
    """``x`` as an fp32 einsum operand, first rounded to ``dtype`` when
    ``BF16_EINSUMS``."""
    if BF16_EINSUMS:
        x = x.to(dtype)
    return x.float()


def init_attention(generator: Optional[torch.Generator], d_model: int,
                   n_heads: int, n_kv_heads: int, d_head: int,
                   qkv_bias: bool = False, dtype: torch.dtype = PARAM_DTYPE,
                   device=None):
    p = {
        "wq": dense_init(generator, d_model, n_heads * d_head, dtype,
                         device=device),
        "wk": dense_init(generator, d_model, n_kv_heads * d_head, dtype,
                         device=device),
        "wv": dense_init(generator, d_model, n_kv_heads * d_head, dtype,
                         device=device),
        "wo": dense_init(generator, n_heads * d_head, d_model, dtype,
                         device=device),
    }
    if qkv_bias:
        dev = p["wq"].device
        p["bq"] = torch.zeros((n_heads * d_head,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((n_kv_heads * d_head,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((n_kv_heads * d_head,), dtype=dtype, device=dev)
    return p


def _project_qkv(p, x, n_heads, n_kv_heads, d_head, rope_cos=None,
                 rope_sin=None):
    B, T, _ = x.shape
    q = dot(x, gather_weight(p["wq"]))
    k = dot(x, gather_weight(p["wk"]))
    v = dot(x, gather_weight(p["wv"]))
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = shard_heads(_split_heads(q, n_heads, d_head))
    k = shard_heads(_split_heads(k, n_kv_heads, d_head))
    v = shard_heads(_split_heads(v, n_kv_heads, d_head))
    if rope_cos is not None:
        q = apply_rope(q, rope_cos, rope_sin)
        k = apply_rope(k, rope_cos, rope_sin)
    return q, k, v


def _split_heads(t, n: int, d_head: int):
    """``[B, T, n * d_head]`` -> ``[B, T, n, d_head]``. A column-parallel
    DTensor whose "model" split the heads do not divide is gathered over
    "model" first (its shards would cut heads)."""
    if isinstance(t, DTensor):
        _, m = mesh_coord(t.device_mesh, "model")
        if n % m:
            t = shard(t, "batch", None, None)
    return t.reshape(t.shape[0], t.shape[1], n, d_head)


def _merge_heads(t):
    """``[B, T, n, d_head]`` -> ``[B, T, n * d_head]``. For a DTensor whose
    heads "model" does not divide, the merged tensor is constrained whole
    on "model" (so is its gradient, which the split above takes back)."""
    B, T, n, d = t.shape
    out = t.reshape(B, T, n * d)
    if isinstance(out, DTensor):
        _, m = mesh_coord(out.device_mesh, "model")
        if n % m:
            out = shard(out, "batch", None, None)
    return out


def _mask(qpos, kpos, causal: bool, window: Optional[int]):
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        m &= qpos[:, None] - kpos[None, :] < window
    return m


def _check_chunks(T, c, what):
    if T % c:
        raise ValueError(f"{what} length {T} is not a multiple of its "
                         f"chunk {c}")


def on_local_heads(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` for ``[B, T, H, D]`` operands: on DTensors, on
    each rank's local shard (no op of the core mixes batch rows or heads),
    put back at the query's placements; plain tensors go straight through.
    Batch on the batch axes; query heads on "model" when it divides them.
    KV heads on "model" too when it divides them; else, where each rank's
    query heads fall in whole groups of one or more KV heads, the KV heads
    are gathered over "model" and each rank takes the ones its queries
    read (their gradients a pending sum over "model"); else everything is
    replicated on "model"."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, **kw)
    mesh = q.device_mesh
    r, m = mesh_coord(mesh, "model")
    H, KH = q.shape[2], k.shape[2]
    G = H // KH
    hl = H // m
    q_split = H % m == 0 and (KH % m == 0 or hl % G == 0 or G % hl == 0)
    qpl = spec_placements(q, ["batch", None, "model" if q_split else None],
                          mesh)
    kv_split = q_split and KH % m == 0
    kpl = spec_placements(k, ["batch", None, "model" if kv_split else None],
                          mesh)
    q = q.redistribute(mesh, qpl)
    k, v = (t.redistribute(mesh, kpl) for t in (k, v))
    ql = q.to_local()
    if q_split and not kv_split:
        lo, hi = (r * hl) // G, ((r + 1) * hl - 1) // G + 1
        kl, vl = (local_part(t, ("model",))[:, :, lo:hi] for t in (k, v))
    else:
        kl, vl = k.to_local(), v.to_local()
    out = fn(ql, kl, vl, **kw).contiguous()
    shape = q.shape[:3] + out.shape[3:]
    return DTensor.from_local(out, mesh, qpl, shape=shape,
                              stride=contiguous_stride(shape))


def chunked_attention(q, k, v, *, causal=True, window=None, softcap=None,
                      q_chunk=512, kv_chunk=512, scale=None):
    """Online-softmax attention. q: [B,Tq,H,D], k/v: [B,Tk,KH,D] ->
    [B,Tq,H,D] in q's dtype."""
    B, Tq, H, D = q.shape
    Tk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else D ** -0.5
    qc = min(q_chunk, Tq)
    kc = min(kv_chunk, Tk)
    _check_chunks(Tq, qc, "query")
    _check_chunks(Tk, kc, "key")
    nq, nk = Tq // qc, Tk // kc
    dev = q.device

    qr = _operand(q.float() * scale).reshape(B, nq, qc, KH, G, D)
    kr = _operand(k).reshape(B, nk, kc, KH, D)
    vr = _operand(v).reshape(B, nk, kc, KH, D)
    ar = torch.arange(max(qc, kc), device=dev)

    outs = []
    for qi in range(nq):
        qch = qr[:, qi]                                  # [B, qc, KH, G, D]
        qpos = qi * qc + ar[:qc]
        m_run = torch.full((B, KH, G, qc), NEG_INF, dtype=torch.float32,
                           device=dev)
        l_run = torch.zeros((B, KH, G, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KH, G, qc, D), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kpos = ki * kc + ar[:kc]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qch, kr[:, ki])
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            msk = _mask(qpos, kpos, causal, window)
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", _operand(p), vr[:, ki])
            m_run = m_new
        outs.append(acc / torch.clamp(l_run[..., None], min=1e-30))
    # [nq, B, KH, G, qc, D] -> [B, Tq, H, D]
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, Tq, H, D)
    return out.to(q.dtype)


def banded_attention(q, k, v, *, window: int, softcap=None, q_chunk=512,
                     scale=None):
    """Sliding-window causal attention with true sub-quadratic compute.

    Per query chunk of qc tokens, only the [window + qc]-wide KV band is
    gathered, so FLOPs are O(T * (window + qc)) not O(T^2).
    """
    B, T, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = scale if scale is not None else D ** -0.5
    qc = min(q_chunk, T)
    _check_chunks(T, qc, "query")
    nq = T // qc
    W = window
    dev = q.device
    # left-pad KV by W so every band slice starts at qi*qc
    kp = F.pad(_operand(k), (0, 0, 0, 0, W, 0))
    vp = F.pad(_operand(v), (0, 0, 0, 0, W, 0))
    qr = _operand(q.float() * scale).reshape(B, nq, qc, KH, G, D)
    band = torch.arange(W + qc, device=dev)

    outs = []
    for qi in range(nq):
        start = qi * qc
        kband = kp[:, start:start + W + qc]
        vband = vp[:, start:start + W + qc]
        qpos = start + band[:qc]
        kpos = start - W + band                 # true positions (<0 = pad)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qr[:, qi], kband)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        msk = ((qpos[:, None] >= kpos[None, :])
               & (qpos[:, None] - kpos[None, :] < W) & (kpos[None, :] >= 0))
        s = torch.where(msk, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhgqk,bkhd->bhgqd", _operand(p), vband))
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, T, H, D)
    return out.to(q.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor      # [B, S, KH, D]
    v: torch.Tensor      # [B, S, KH, D]

    @staticmethod
    def create(batch, max_seq, n_kv_heads, d_head,
               dtype: torch.dtype = PARAM_DTYPE, device=None):
        shape = (batch, max_seq, n_kv_heads, d_head)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))


def decode_tables(S: int, pos: int, *, d_head: int, rope_theta=None,
                  window=None, start=None, device=None):
    """What one decode step at ``pos`` shares across its layers: the rope
    table of the position (``None`` without rope) and the validity mask
    over the ``S`` cache positions, ``[S]`` or, with ``start``, ``[B, S]``
    (positions before each slot's start masked out).

    Returns ((cos, sin) or None, mask)."""
    rope = None
    if rope_theta is not None:
        rope = rope_table(torch.full((1,), pos, device=device), d_head,
                          rope_theta)
    kpos = torch.arange(S, device=device)
    valid = kpos <= pos
    if window is not None:
        valid &= kpos > pos - window
    if start is not None:
        valid = valid[None, :] & (kpos[None, :] >= start[:, None])
    return rope, valid


def attention_decode(p, x, cache: KVCache, pos: int, *, n_heads, n_kv_heads,
                     d_head, rope_theta=None, softcap=None, window=None,
                     scale=None, start=None, tables=None):
    """One-token decode. x: [B, 1, D_model]; pos: the current length.

    Writes this token's k and v into ``cache`` at ``pos`` in place; a
    ``pos`` outside the cache raises (the reference's
    ``dynamic_update_slice`` would clamp it). ``start`` (optional int[B]
    tensor) is the per-slot sequence start: cache positions below
    ``start[b]`` are masked out for batch slot ``b``, which is what makes
    decode-slot reuse sound (see ``lm.reset_decode_slot``). ``tables`` is
    :func:`decode_tables`'s result for these arguments, built once per step
    by a caller that runs many layers; without it they are built here. The
    whole static cache is read and cast to fp32 every step, as in the
    reference.

    Returns (out [B,1,D_model], cache).
    """
    B = x.shape[0]
    S = cache.k.shape[1]
    pos = int(pos)
    if not 0 <= pos < S:
        raise IndexError(f"decode position {pos} outside the KV cache of "
                         f"{S} positions")
    if tables is None:
        tables = decode_tables(S, pos, d_head=d_head, rope_theta=rope_theta,
                               window=window, start=start, device=x.device)
    rope, valid = tables
    cos, sin = rope if rope is not None else (None, None)
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, d_head, cos, sin)
    scale = scale if scale is not None else d_head ** -0.5
    if isinstance(cache.k, DTensor):
        out = _decode_partitioned(q, k, v, cache, pos, valid,
                                  softcap=softcap, scale=scale)
    else:
        cache.k[:, pos] = k[:, 0].to(cache.k.dtype)
        cache.v[:, pos] = v[:, 0].to(cache.v.dtype)
        out = _decode_core(q, cache.k, cache.v, valid, softcap=softcap,
                           scale=scale)
    out = out.reshape(B, 1, n_heads * d_head).to(x.dtype)
    return dot(out, gather_weight(p["wo"])), cache


def _decode_core(q, kc, vc, valid, *, softcap, scale, d_slice=None,
                 reduce_scores=None):
    """One query token against the static cache: q ``[B, 1, H, D]``, the
    cache ``[B, S, KH, D]`` -> ``[B, KH, G, D]`` fp32. The whole cache is
    cast to fp32, as in the reference. With ``d_slice`` the cache holds
    that slice of each head's dims: the scores are partial sums, which
    ``reduce_scores`` completes."""
    B, KH, D = kc.shape[0], kc.shape[2], q.shape[-1]
    G = q.shape[2] // KH
    kc_ = kc.float()
    vc_ = vc.float()
    qh = _operand(q.float() * scale, kc.dtype).reshape(B, KH, G, D)
    if d_slice is not None:
        qh = qh[..., d_slice]
    s = torch.einsum("bhgd,bshd->bhgs", qh, kc_)
    if reduce_scores is not None:
        s = reduce_scores(s)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if valid.dim() == 2:  # per-slot mask [B, S]
        valid = valid[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", _operand(pattn, vc.dtype), vc_)


def _decode_partitioned(q, k, v, cache: KVCache, pos: int, valid, *,
                        softcap, scale):
    """``attention_decode`` on a DTensor cache placed by ``cache_specs``
    (batch on the batch axes; KV heads on "model", or each head's dims
    where "model" does not divide the heads). DTensor has no rule for an
    indexed write into a shard, so this token's k and v are redistributed
    to the cache's placements and written into the local shard; the core
    runs on the local shards. Heads on "model": each rank's query heads
    against its KV heads, put back at the query's placements. Head dims on
    "model": the scores are partial sums over each rank's slice of the
    dims, all-reduced over "model" before the softmax; each rank's slice
    of the output is gathered back. Returns ``[B, 1, H, D]``."""
    mesh = cache.k.device_mesh
    cpl = list(cache.k.placements)
    # a [B, KH, D] row of the cache: its dims after the sequence shift by one
    row = [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1 else p
           for p in cpl]
    for new, c in ((k, cache.k), (v, cache.v)):
        new = new[:, 0].to(c.dtype).redistribute(mesh, row)
        c.to_local()[:, pos] = new.to_local()
    names = list(mesh.mesh_dim_names)
    mi = names.index("model") if "model" in names else None
    mode = cpl[mi] if mi is not None else Replicate()
    # the query: batch as the cache's, heads on "model" in step with the
    # cache's heads, else replicated there
    qpl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
           for p in cpl]
    if isinstance(mode, Shard) and mode.dim == 2:
        qpl[mi] = Shard(2)
    q = q.redistribute(mesh, qpl)
    if valid.dim() == 2:    # per-slot masks: each rank's batch rows
        if not isinstance(valid, DTensor):
            valid = DTensor.from_local(valid, mesh,
                                       [Replicate()] * mesh.ndim)
        valid = valid.redistribute(
            mesh, [Shard(0) if isinstance(p, Shard) and p.dim == 0
                   else Replicate() for p in cpl])
    if isinstance(valid, DTensor):
        valid = valid.to_local()
    kl, vl, ql = cache.k.to_local(), cache.v.to_local(), q.to_local()
    if isinstance(mode, Shard) and mode.dim == 3:
        r, m = mesh_coord(mesh, "model")
        dl = kl.shape[-1]
        spl = [p if i != mi else Partial() for i, p in enumerate(qpl)]

        def all_reduce(sc):
            sc = DTensor.from_local(sc, mesh, spl)
            return sc.redistribute(mesh, qpl).to_local()

        out = _decode_core(ql, kl, vl, valid, softcap=softcap, scale=scale,
                           d_slice=slice(r * dl, (r + 1) * dl),
                           reduce_scores=all_reduce)
        opl = [p if i != mi else Shard(3) for i, p in enumerate(qpl)]
        B, KH, G = q.shape[0], cache.k.shape[2], q.shape[2] // cache.k.shape[2]
        out = DTensor.from_local(out, mesh, opl,
                                 shape=(B, KH, G, q.shape[3]),
                                 stride=contiguous_stride((B, KH, G,
                                                            q.shape[3])))
        out = out.redistribute(mesh, qpl)
        return out.reshape(q.shape)
    out = _decode_core(ql, kl, vl, valid, softcap=softcap, scale=scale)
    out = out.reshape(ql.shape)
    return DTensor.from_local(out, mesh, qpl, shape=q.shape,
                              stride=contiguous_stride(q.shape))


def attention_forward(p, x, *, n_heads, n_kv_heads, d_head, causal=True,
                      rope_theta: Optional[float] = 10_000.0, window=None,
                      softcap=None, q_chunk=512, kv_chunk=512, scale=None,
                      use_banded=False, return_kv=False):
    """Full-sequence attention (prefill). x: [B, T, D_model]."""
    B, T, _ = x.shape
    if rope_theta is not None:
        cos, sin = rope_table(torch.arange(T, device=x.device), d_head,
                              rope_theta)
    else:
        cos = sin = None
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, d_head, cos, sin)
    if use_banded and window is not None and T > window:
        out = on_local_heads(banded_attention, q, k, v, window=window,
                             softcap=softcap, q_chunk=q_chunk, scale=scale)
    else:
        out = on_local_heads(chunked_attention, q, k, v, causal=causal,
                             window=window, softcap=softcap,
                             q_chunk=q_chunk, kv_chunk=kv_chunk, scale=scale)
    out = dot(_merge_heads(out), gather_weight(p["wo"]))
    if return_kv:
        # cache dtype follows the activation dtype (bf16 in production)
        return out, KVCache(k.to(x.dtype), v.to(x.dtype))
    return out
