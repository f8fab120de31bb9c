"""Mamba-2 (SSD — state-space duality) blocks: chunked scan + decode step.

The SSD chunked algorithm of arXiv:2405.21060, as in the reference
(``repro.models.ssm``): a within-chunk quadratic (attention-like) term plus
a cross-chunk state recurrence, O(T * chunk) work. The reference's
``lax.scan`` over chunks is a Python loop here.

Recurrence convention: h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t (x) x_t,
y_t = C_t . h_t + D * x_t, with A negative (A = -exp(A_log)). The state is
laid out [b, H, N, P] (heads, state, head_dim), as the reference's code
builds it and its decode cache holds it.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import PARAM_DTYPE, dense_init, dot, is_meta, normal, rms_norm


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
    z, xbc_pre, dt = _split_in(dot(x, p["w_in"]), d_inner, state)
    xbc = _causal_conv(xbc_pre, p["conv_w"], p["conv_b"])
    xbc = F.silu(xbc.float())
    xs, Bs, Cs = torch.split(xbc, [d_inner, state, state], dim=-1)
    dtv = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(Bsz, T, H, head_dim)
    y, h_fin = ssd_chunked(xh, dtv, A, Bs, Cs, chunk=chunk)
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(Bsz, T, d_inner) * F.silu(z.float())
    y = rms_norm(y.to(x.dtype), p["norm_w"])
    out = dot(y, p["w_out"])
    if return_state:
        return out, MambaCache(xbc_pre[:, T - (K - 1):, :], h_fin)
    return out


def mamba2_decode(p, x, cache: MambaCache, *, head_dim: int, state: int
                  ) -> Tuple[torch.Tensor, MambaCache]:
    """One-token step. x: [B, 1, D]. Updates ``cache`` in place (each part
    keeps its dtype) and returns (out [B, 1, D], cache)."""
    Bsz = x.shape[0]
    d_inner = p["w_out"].shape[0]
    H = d_inner // head_dim
    z, xbc, dt = _split_in(dot(x[:, 0], p["w_in"]), d_inner, state)
    # conv over (cached K-1 inputs + current), in their promoted dtype
    hdt = torch.promote_types(cache.conv.dtype, xbc.dtype)
    hist = torch.cat([cache.conv.to(hdt), xbc[:, None, :].to(hdt)],
                     dim=1)                                   # [B, K, C]
    w = p["conv_w"].float()
    conv_out = (hist.float() * w[None]).sum(1) + p["conv_b"].float()
    xbc_a = F.silu(conv_out)
    xs, Bs, Cs = torch.split(xbc_a, [d_inner, state, state], dim=-1)
    dtv = F.softplus(dt.float() + p["dt_bias"])                # [B,H]
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(Bsz, H, head_dim)
    dec = torch.exp(dtv * A[None])                             # [B,H]
    h_new = (dec[:, :, None, None] * cache.ssm
             + torch.einsum("bn,bh,bhp->bhnp", Bs, dtv, xh))
    y = torch.einsum("bn,bhnp->bhp", Cs, h_new) + p["D"][None, :, None] * xh
    y = y.reshape(Bsz, d_inner) * F.silu(z.float())
    y = rms_norm(y.to(x.dtype), p["norm_w"])
    out = dot(y, p["w_out"])[:, None, :]
    cache.conv.copy_(hist[:, 1:])
    cache.ssm.copy_(h_new)
    return out, cache
