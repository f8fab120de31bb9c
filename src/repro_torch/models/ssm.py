"""Mamba-2 (SSD — state-space duality) blocks: chunked scan + decode step.

The SSD chunked algorithm of arXiv:2405.21060, as in the reference
(``repro.models.ssm``): a within-chunk quadratic (attention-like) term plus
a cross-chunk state recurrence, O(T * chunk) work. The reference's
``lax.scan`` over chunks is a Python loop here.

Recurrence convention: h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t (x) x_t,
y_t = C_t . h_t + D * x_t, with A negative (A = -exp(A_log)). The state is
laid out [b, H, N, P] (heads, state, head_dim), as the reference's code
builds it and its decode cache holds it.

In the partitioned program (DTensors on a ``DeviceMesh``) the SSM heads
are on "model", as ``cache_specs`` places the decode state: ``w_in``'s
output is gathered over "model" (z, xBC and dt do not split along its
shards), the depthwise conv runs over every channel, and the SSD scan and
its state run on each rank's heads and batch rows (``to_local()``; no op
of the scan mixes heads, and B and C are shared); the gated output goes
back as a DTensor sharded over "model" for the norm and the row-parallel
``w_out``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..sharding import local_part, mesh_coord, shard, shard_offset
from .layers import (PARAM_DTYPE, dense_init, dot, gather_weight, is_meta,
                     normal, rms_norm)


def init_mamba2(generator: Optional[torch.Generator], d_model: int,
                d_inner: int, head_dim: int, state: int, conv_k: int = 4,
                dtype: torch.dtype = PARAM_DTYPE, device=None):
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * state
    dev = device or generator.device
    w_in = dense_init(generator, d_model, 2 * d_inner + 2 * state + n_heads,
                      dtype, device=dev)
    conv_w = normal(generator, (conv_k, conv_dim), conv_k ** -0.5, dtype, dev)
    # dt bias init so softplus(dt_bias) ~ [1e-3, 1e-1] (mamba default)
    if is_meta(dev):
        dt_bias = torch.empty((n_heads,), device="meta")
    else:
        u = torch.rand((n_heads,), generator=generator, dtype=torch.float32,
                       device=generator.device).to(dev)
        lo, hi = math.log(1e-3), math.log(0.1)
        dt0 = torch.exp(u * (hi - lo) + lo)
        dt_bias = dt0 + torch.log(-torch.expm1(-dt0))  # inverse softplus
    return {
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.arange(1, n_heads + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "dt_bias": dt_bias,
        "norm_w": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "w_out": dense_init(generator, d_inner, d_model, dtype, device=dev),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: [B, T, C]; w: [K, C]."""
    K, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):  # K is tiny (4): unrolled adds
        out = out + xp[:, i:i + T].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def ssd_chunked(x, dt, A, B, C, h0=None, chunk: int = 128):
    """SSD scan. x: [b,T,H,P]; dt: [b,T,H]; A: [H]; B,C: [b,T,N].

    Returns (y [b,T,H,P] fp32, h_final [b,H,N,P] fp32).
    """
    b, T, H, P = x.shape
    N = B.shape[-1]
    L = min(chunk, T)
    if T % L:
        raise ValueError(f"sequence length {T} is not a multiple of the "
                         f"SSD chunk {L}")
    nc = T // L

    a = dt.float() * A[None, None, :]                        # [b,T,H] (<=0)
    xc = x.float().reshape(b, nc, L, H, P)
    dtc = dt.float().reshape(b, nc, L, H)
    Bc = B.float().reshape(b, nc, L, N)
    Cc = C.float().reshape(b, nc, L, N)
    acs = torch.cumsum(a.reshape(b, nc, L, H), dim=2)        # inclusive

    # ---- intra-chunk (attention-like, lower-triangular decay) -------------
    # decay[i, j] = exp(acs[i] - acs[j]) for i >= j
    diff = acs[:, :, :, None, :] - acs[:, :, None, :, :]     # [b,c,i,j,h]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    decay = torch.where(tri[None, None, :, :, None], torch.exp(diff), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)               # [b,c,i,j]
    scores = cb[..., None] * decay * dtc[:, :, None, :, :]    # [b,c,i,j,h]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)

    # ---- chunk states ------------------------------------------------------
    seg_end = acs[:, :, -1:, :]                               # [b,c,1,h]
    w_state = torch.exp(seg_end - acs) * dtc                  # [b,c,l,h]
    S = torch.einsum("bcln,bclh,bclhp->bchnp", Bc, w_state, xc)
    chunk_decay = torch.exp(seg_end[:, :, 0, :])              # [b,c,h]

    # ---- cross-chunk recurrence -------------------------------------------
    h = (torch.zeros((b, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)                                     # state BEFORE c
        h = chunk_decay[:, c, :, None, None] * h + S[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                      # [b,c,h,n,p]

    # ---- inter-chunk contribution -----------------------------------------
    in_decay = torch.exp(acs)                                 # [b,c,l,h]
    y_inter = torch.einsum("bcln,bclh,bchnp->bclhp", Cc, in_decay, h_prev)

    y = (y_intra + y_inter).reshape(b, T, H, P)
    return y, h


class MambaCache(NamedTuple):
    conv: torch.Tensor   # [B, K-1, conv_dim] last inputs
    ssm: torch.Tensor    # [B, H, N, P]

    @staticmethod
    def create(batch, conv_k, conv_dim, n_heads, state, head_dim,
               dtype: torch.dtype = torch.float32, device=None):
        return MambaCache(
            torch.zeros((batch, conv_k - 1, conv_dim), dtype=dtype,
                        device=device),
            torch.zeros((batch, n_heads, state, head_dim),
                        dtype=torch.float32, device=device))


def _split_in(zxbcdt, d_inner, state):
    """w_in's output -> (z, xBC, dt)."""
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * state,
                                zxbcdt.shape[-1] - 2 * d_inner - 2 * state],
                       dim=-1)


def _local_inputs(zx, p, n_heads: int):
    """The mixer's operands as local tensors: ``(zx, conv_w, conv_b,
    dt_bias, A_log, D, heads, out_placements)``. One device: the tensors
    themselves, every head. Partitioned: ``zx`` gathered over "model" and
    each rank's shard of it, the small parameters whole, all with their
    gradients pending sums over the mesh (each rank reads them for its
    batch rows and heads); ``heads`` is the rank's slice of the heads
    ("model" divides them, else all) and ``out_placements`` the
    placements of a ``[B, T, d_inner]`` output of those heads."""
    names = ("conv_w", "conv_b", "dt_bias", "A_log", "D")
    if not isinstance(zx, DTensor):
        return (zx, *(p[k] for k in names), slice(0, n_heads), None)
    mesh = zx.device_mesh
    zx = shard(zx, "batch", *([None] * (zx.dim() - 1)))
    r, m = mesh_coord(mesh, "model")
    if n_heads % m:
        r, m = 0, 1
    hl = n_heads // m
    allp = ("pod", "data", "model")
    rep = [Replicate()] * mesh.ndim
    small = [local_part(p[k].redistribute(mesh, rep), allp) for k in names]
    out_pl = list(zx.placements)
    if m > 1:
        out_pl[list(mesh.mesh_dim_names).index("model")] = Shard(zx.dim() - 1)
    return (local_part(zx, allp), *small, slice(r * hl, (r + 1) * hl),
            out_pl)


def _to_global(y, like: DTensor, placements):
    """A local ``[..., d_inner_local]`` result as a DTensor at
    ``placements`` on ``like``'s mesh (None: ``y`` as it is)."""
    if placements is None:
        return y
    return DTensor.from_local(y, like.device_mesh, placements)


def mamba2_forward(p, x, *, head_dim: int, state: int, chunk: int = 128,
                   return_state: bool = False):
    """Full-sequence Mamba2 block. x: [B, T, D] -> [B, T, D].

    With ``return_state`` also the decode cache after the last token. Its
    conv part is the last K-1 inputs of the conv, so a prompt shorter than
    K-1 tokens raises (the reference keeps fewer rows, which its decode
    step cannot take).
    """
    Bsz, T, D = x.shape
    d_inner = p["w_out"].shape[0]
    H = d_inner // head_dim
    K = p["conv_w"].shape[0]
    if return_state and T < K - 1:
        raise ValueError(f"a prompt of {T} tokens is shorter than the conv "
                         f"history of {K - 1} a Mamba2 decode cache holds")
    zx_g = dot(x, gather_weight(p["w_in"]))
    zx, conv_w, conv_b, dt_bias, A_log, Dp, hs, out_pl = _local_inputs(
        zx_g, p, H)
    Bl = zx.shape[0]
    z, xbc_pre, dt = _split_in(zx, d_inner, state)
    xbc = _causal_conv(xbc_pre, conv_w, conv_b)
    xbc = F.silu(xbc.float())
    xs, Bs, Cs = torch.split(xbc, [d_inner, state, state], dim=-1)
    dsl = slice(hs.start * head_dim, hs.stop * head_dim)
    Hl = hs.stop - hs.start
    dtv = F.softplus(dt[..., hs].float() + dt_bias[hs])
    A = -torch.exp(A_log[hs])
    xh = xs[..., dsl].reshape(Bl, T, Hl, head_dim)
    y, h_fin = ssd_chunked(xh, dtv, A, Bs, Cs, chunk=chunk)
    y = y + Dp[hs][None, None, :, None] * xh
    y = y.reshape(Bl, T, Hl * head_dim) * F.silu(z[..., dsl].float())
    y = _to_global(y.to(x.dtype), zx_g, out_pl)
    y = rms_norm(y, p["norm_w"])
    out = dot(y, gather_weight(p["w_out"]))
    if return_state:
        conv = xbc_pre[:, T - (K - 1):, :]
        if out_pl is not None:
            mesh = zx_g.device_mesh
            conv = DTensor.from_local(conv, mesh, shard(
                zx_g, "batch", None, None).placements)
            st_pl = [Shard(1) if isinstance(q, Shard) and q.dim == 2 else q
                     for q in out_pl]
            h_fin = DTensor.from_local(h_fin, mesh, st_pl)
        return out, MambaCache(conv, h_fin)
    return out


def mamba2_decode(p, x, cache: MambaCache, *, head_dim: int, state: int
                  ) -> Tuple[torch.Tensor, MambaCache]:
    """One-token step. x: [B, 1, D]. Updates ``cache`` in place (each part
    keeps its dtype) and returns (out [B, 1, D], cache). A DTensor cache
    (batch on the batch axes, conv channels and SSM heads on "model") is
    read and written in its local shards: the conv history is gathered
    over "model" for the step, and each rank writes back its channels."""
    d_inner = p["w_out"].shape[0]
    H = d_inner // head_dim
    zx_g = dot(x[:, 0], gather_weight(p["w_in"]))
    zx, conv_w, conv_b, dt_bias, A_log, Dp, hs, out_pl = _local_inputs(
        zx_g, p, H)
    Bsz = zx.shape[0]
    part = isinstance(cache.conv, DTensor)
    if part:
        mesh = cache.conv.device_mesh
        conv_hist = cache.conv.redistribute(mesh, [
            Replicate() if isinstance(q, Shard) and q.dim == 2 else q
            for q in cache.conv.placements]).to_local()
        ssm = cache.ssm.to_local()
    else:
        conv_hist, ssm = cache.conv, cache.ssm
    z, xbc, dt = _split_in(zx, d_inner, state)
    # conv over (cached K-1 inputs + current), in their promoted dtype
    hdt = torch.promote_types(conv_hist.dtype, xbc.dtype)
    hist = torch.cat([conv_hist.to(hdt), xbc[:, None, :].to(hdt)],
                     dim=1)                                   # [B, K, C]
    w = conv_w.float()
    conv_out = (hist.float() * w[None]).sum(1) + conv_b.float()
    xbc_a = F.silu(conv_out)
    xs, Bs, Cs = torch.split(xbc_a, [d_inner, state, state], dim=-1)
    dsl = slice(hs.start * head_dim, hs.stop * head_dim)
    Hl = hs.stop - hs.start
    dtv = F.softplus(dt[..., hs].float() + dt_bias[hs])        # [B,H]
    A = -torch.exp(A_log[hs])
    xh = xs[..., dsl].reshape(Bsz, Hl, head_dim)
    dec = torch.exp(dtv * A[None])                             # [B,H]
    h_new = (dec[:, :, None, None] * ssm
             + torch.einsum("bn,bh,bhp->bhnp", Bs, dtv, xh))
    y = torch.einsum("bn,bhnp->bhp", Cs, h_new) + Dp[hs][None, :, None] * xh
    y = y.reshape(Bsz, Hl * head_dim) * F.silu(z[..., dsl].float())
    y = _to_global(y.to(x.dtype), zx_g, out_pl)
    y = rms_norm(y, p["norm_w"])
    out = dot(y, gather_weight(p["w_out"]))[:, None, :]
    if part:
        new = hist[:, 1:]
        c0 = shard_offset(cache.conv, -1)
        cl = cache.conv.to_local()
        cl.copy_(new[..., c0:c0 + cl.shape[-1]])
        ssm.copy_(h_new)
    else:
        cache.conv.copy_(hist[:, 1:])
        cache.ssm.copy_(h_new)
    return out, cache
