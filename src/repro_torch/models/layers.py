"""Shared building blocks: norms, rotary embeddings, parameter
initialisation and the MLP.

Parameters are dicts of tensors; every layer is a pair of ``init_*`` /
``apply`` functions. Weights default to bf16; norms, softmax, rotary and
activations run in fp32 and are cast back to the activation dtype, as in
the reference (``repro.models.layers``).

In the partitioned program (DTensors on a ``DeviceMesh``) every weight
goes through :func:`gather_weight` right before its use: the explicit
FSDP step, an all-gather over the batch axes whose backward is the
gradient's reduce-scatter.

Every initialiser draws in fp32 from an explicit ``torch.Generator`` on the
generator's device, then casts. On the ``meta`` device it draws nothing
(the generator may be None): that is how a full configuration's parameters
are counted without allocating them.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..sharding import contiguous_stride, local_part, shard

PARAM_DTYPE = torch.bfloat16


def to_torch(a) -> torch.Tensor:
    """One array of any type numpy can read, keeping its dtype. numpy holds
    bf16 as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses, so
    it goes through its uint16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def is_meta(device) -> bool:
    return device is not None and torch.device(device).type == "meta"


def normal(generator: Optional[torch.Generator], shape: Sequence[int],
           scale: float, dtype: torch.dtype = PARAM_DTYPE,
           device=None) -> torch.Tensor:
    """``shape`` ~ N(0, 1) * scale, drawn in fp32 from ``generator`` on the
    generator's device, then cast to ``dtype`` and moved to ``device`` (the
    generator's device when None). On ``meta``, an empty tensor."""
    if is_meta(device):
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device) * scale
    return w.to(device=device or generator.device, dtype=dtype)


def dense_init(generator: Optional[torch.Generator], d_in: int, d_out: int,
               dtype: torch.dtype = PARAM_DTYPE,
               scale: Optional[float] = None,
               device=None) -> torch.Tensor:
    """``[d_in, d_out]`` weights ~ N(0, 1) * scale (default
    ``1/sqrt(d_in)``), drawn as :func:`normal` draws."""
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    return normal(generator, (d_in, d_out), scale, dtype, device)


def embed_init(generator: Optional[torch.Generator], vocab: int, d: int,
               dtype: torch.dtype = PARAM_DTYPE, device=None) -> torch.Tensor:
    """``[vocab, d]`` embeddings ~ N(0, 0.02^2)."""
    return normal(generator, (vocab, d), 0.02, dtype, device)


# ---------------------------------------------------------------------------
# norms (fp32 math, cast back)
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x) * (1 + weight)``, in fp32, cast back to ``x.dtype``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) / std * weight + bias``, in fp32, cast back."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def soft_cap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: ``cap * tanh(x / cap)``."""
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------
def rope_table(positions: torch.Tensor, d_head: int, theta: float = 10_000.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: positions ``[*T]`` -> (``[*T, d_head/2]``,
    ``[*T, d_head/2]``), on the positions' device."""
    half = d_head // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: ``[..., T, H, D]``; cos/sin: ``[T, D/2]`` (or broadcastable).
    Rotates the two halves in fp32 and casts back."""
    half = x.shape[-1] // 2
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             gated: bool = True, act: str = "silu",
             dtype: torch.dtype = PARAM_DTYPE,
             device=None) -> Dict[str, torch.Tensor]:
    """``wi`` (and ``wg`` when gated) ``[d_model, d_ff]``, ``wo``
    ``[d_ff, d_model]``, drawn in that order from ``generator``. ``act`` is
    accepted for signature parity; the activation is chosen at apply time."""
    p = {"wi": dense_init(generator, d_model, d_ff, dtype, device=device)}
    if gated:
        p["wg"] = dense_init(generator, d_model, d_ff, dtype, device=device)
    p["wo"] = dense_init(generator, d_ff, d_model, dtype, device=device)
    return p


# jax.nn.gelu defaults to the tanh approximation, so "gelu" is that too
_ACTS = {"silu": F.silu,
         "gelu": lambda x: F.gelu(x, approximate="tanh"),
         "relu": F.relu,
         "gelu_tanh": lambda x: F.gelu(x, approximate="tanh")}


def gather_weight(w: torch.Tensor) -> torch.Tensor:
    """FSDP's gather of one weight: a DTensor's shards over the batch axes
    ("pod", "data") all-gathered (``Replicate()`` there), its "model"
    placement kept; its backward reduce-scatters the gradient back onto
    those axes. A plain tensor is returned as it is. Without it DTensor's
    matmul strategy may gather the activations along "data" instead."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    want = tuple(Replicate() if n in ("pod", "data") else p
                 for n, p in zip(names, w.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def promote(a: torch.Tensor, b: torch.Tensor):
    """Both operands in their promoted dtype, as ``jnp.dot`` and
    ``jnp.einsum`` take mixed dtypes (``torch.matmul`` refuses them)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as ``jnp.dot``. A
    row-parallel product of bf16 DTensors (the contraction split over a
    mesh dim of more than one rank) goes through :func:`_row_parallel`."""
    a, b = promote(a, b)
    if isinstance(a, DTensor) and a.dtype == torch.bfloat16:
        out = _row_parallel(a, b)
        if out is not None:
            return out
    return a @ b


def _row_parallel(a: DTensor, b: DTensor):
    """``a @ b`` for bf16 DTensors whose contraction dim is split over mesh
    dims of more than one rank (``a``'s last dim, ``b``'s first), or None
    where that is not the case. Each rank multiplies its shards with fp32
    sums and the partial products are all-reduced in fp32, then rounded
    to bf16 once: the one-device product's numerics up to the order of its
    fp32 sum (bf16 partial sums would add a rounding per rank, which can
    flip an MoE router's near-tie). The products of bf16 values are exact
    in TF32, so on a card the local product may use it."""
    nd = a.dim() - 1
    mesh = a.device_mesh
    red, out_pl = [], []
    for i, (pa, pb) in enumerate(zip(a.placements, b.placements)):
        a_k = isinstance(pa, Shard) and pa.dim == nd
        b_k = isinstance(pb, Shard) and pb.dim == 0
        if a_k != b_k or not (isinstance(pb, Replicate) or b_k):
            return None
        if a_k:
            if mesh.size(i) > 1:
                red.append(i)
            out_pl.append(Partial())
        else:
            out_pl.append(pa)
    if not red:
        return None
    al = a.to_local()
    bl = local_part(b)
    cuda = al.is_cuda
    prev = torch.backends.cuda.matmul.allow_tf32 if cuda else None
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = al.float() @ bl.float()
    finally:
        if cuda:
            torch.backends.cuda.matmul.allow_tf32 = prev
    shape = tuple(a.shape[:-1]) + (b.shape[-1],)
    out = DTensor.from_local(out, mesh, out_pl, shape=torch.Size(shape),
                             stride=contiguous_stride(shape))
    whole_pl = [Replicate() if isinstance(p, Partial) else p for p in out_pl]
    return out.redistribute(mesh, whole_pl).to(a.dtype)



def apply_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, act: str = "silu",
              gated: bool = True) -> torch.Tensor:
    """``act(x @ wg) * (x @ wi) @ wo`` (gated) or ``act(x @ wi) @ wo``; the
    activation in fp32, cast back to ``x.dtype``; the hidden layer on
    "model", as the reference constrains it."""
    a = _ACTS[act]
    h = dot(x, gather_weight(p["wi"]))
    if gated:
        h = a(dot(x, gather_weight(p["wg"])).float()).to(x.dtype) * h
    else:
        h = a(h.float()).to(x.dtype)
    h = shard(h, *(["batch"] + [None] * (h.dim() - 2) + ["model"]))
    return dot(h, gather_weight(p["wo"]))
