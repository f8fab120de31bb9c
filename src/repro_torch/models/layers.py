"""Shared building blocks: dense parameter initialisation and the MLP.

Weights default to bf16; activation math runs in fp32 and is cast back to
the activation dtype, as in the reference (``repro.models.layers``). The
reference's ``shard(...)`` annotation is a no-op without a device mesh and
has no counterpart here.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

PARAM_DTYPE = torch.bfloat16


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = PARAM_DTYPE,
               scale: Optional[float] = None,
               device=None) -> torch.Tensor:
    """``[d_in, d_out]`` weights ~ N(0, 1) * scale (default ``1/sqrt(d_in)``),
    drawn in fp32 from ``generator`` on the generator's device, then cast to
    ``dtype`` and moved to ``device`` (the generator's device when None)."""
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator,
                    dtype=torch.float32, device=generator.device) * scale
    return w.to(device=device or generator.device, dtype=dtype)


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


def promote(a: torch.Tensor, b: torch.Tensor):
    """Both operands in their promoted dtype, as ``jnp.dot`` and
    ``jnp.einsum`` take mixed dtypes (``torch.matmul`` refuses them)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as ``jnp.dot``."""
    a, b = promote(a, b)
    return a @ b


def apply_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, act: str = "silu",
              gated: bool = True) -> torch.Tensor:
    """``act(x @ wg) * (x @ wi) @ wo`` (gated) or ``act(x @ wi) @ wo``; the
    activation in fp32, cast back to ``x.dtype``."""
    a = _ACTS[act]
    h = dot(x, p["wi"])
    if gated:
        h = a(dot(x, p["wg"]).float()).to(x.dtype) * h
    else:
        h = a(h.float()).to(x.dtype)
    return dot(h, p["wo"])
