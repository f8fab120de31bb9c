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
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..sharding import shard_heads
from .layers import PARAM_DTYPE, apply_rope, dense_init, dot, rope_table

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
    q = dot(x, p["wq"])
    k = dot(x, p["wk"])
    v = dot(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = shard_heads(q.reshape(B, T, n_heads, d_head))
    k = shard_heads(k.reshape(B, T, n_kv_heads, d_head))
    v = shard_heads(v.reshape(B, T, n_kv_heads, d_head))
    if rope_cos is not None:
        q = apply_rope(q, rope_cos, rope_sin)
        k = apply_rope(k, rope_cos, rope_sin)
    return q, k, v


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
    cache.k[:, pos] = k[:, 0].to(cache.k.dtype)
    cache.v[:, pos] = v[:, 0].to(cache.v.dtype)
    G = n_heads // n_kv_heads
    scale = scale if scale is not None else d_head ** -0.5
    kc_ = cache.k.float()
    vc_ = cache.v.float()
    qh = _operand(q.float() * scale, cache.k.dtype).reshape(
        B, n_kv_heads, G, d_head)
    s = torch.einsum("bhgd,bshd->bhgs", qh, kc_)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if valid.dim() == 2:  # per-slot mask [B, S]
        valid = valid[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", _operand(pattn, cache.v.dtype),
                       vc_)
    out = out.reshape(B, 1, n_heads * d_head).to(x.dtype)
    return dot(out, p["wo"]), cache


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
        out = banded_attention(q, k, v, window=window, softcap=softcap,
                               q_chunk=q_chunk, scale=scale)
    else:
        out = chunked_attention(q, k, v, causal=causal, window=window,
                                softcap=softcap, q_chunk=q_chunk,
                                kv_chunk=kv_chunk, scale=scale)
    out = dot(out.reshape(B, T, n_heads * d_head), p["wo"])
    if return_kv:
        # cache dtype follows the activation dtype (bf16 in production)
        return out, KVCache(k.to(x.dtype), v.to(x.dtype))
    return out
