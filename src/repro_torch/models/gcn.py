"""GCN / GraphSAGE / GIN on the Accel-GCN SpMM operator.

The paper's target workload: ``X^{l+1} = act(A' . (X^l W^l))`` — linear
transform then sparse feature aggregation (paper §II-A). The aggregation runs
through :class:`repro_torch.core.spmm.AccelSpMM` (degree sorting +
block-level partition + combined-warp feature tiling).

Gradients: ``GraphOp`` is a ``torch.autograd.Function`` whose backward is
a second ``AccelSpMM`` over A'^T (d/dX of A'.X is A'^T.X-bar), so training
runs the paper's operator, and K1 on the card, in both directions. The
kernel launches are opaque to autograd: nothing of the forward is recorded,
and the gradient comes only from ``GraphOp.bwd``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.graph import CSRGraph, csr_transpose
from ..core.plan_cache import DeviceLike, PlanCache, resolve_device
from ..core.spmm import AccelSpMM, make_accel_spmm
from .layers import dense_init


@dataclasses.dataclass
class GraphOp:
    """A' as a differentiable aggregation: the forward runs ``fwd`` (A'),
    the backward runs ``bwd`` (the operator of A'^T)."""

    fwd: AccelSpMM
    bwd: AccelSpMM  # operator for A'^T

    @classmethod
    def build(cls, g_norm: CSRGraph, backend: str = "accel",
              plan_cache: Optional[PlanCache] = None,
              device: DeviceLike = None, **kw) -> "GraphOp":
        """With ``plan_cache``, both A' and A'^T plans are cached: rebuilding
        the op for a recurring graph does zero partitioning work."""
        return cls(
            fwd=make_accel_spmm(g_norm, backend=backend,
                                plan_cache=plan_cache, device=device, **kw),
            bwd=make_accel_spmm(csr_transpose(g_norm), backend=backend,
                                plan_cache=plan_cache, device=device, **kw))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Aggregate.apply(x, self)


class _Aggregate(torch.autograd.Function):
    """``A' @ x`` with the gradient ``A'^T @ g``. ``forward`` runs with grad
    mode off, so the plain version on CPU tensors records no graph of its
    own, and saves nothing of ``x``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, op: GraphOp) -> torch.Tensor:
        ctx.op = op
        return op.fwd(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        # autograd may hand an expanded (stride-0) or strided grad
        return ctx.op.bwd(g.float().contiguous()).to(g.dtype), None


def init_gcn(generator: torch.Generator, dims: List[int],
             variant: str = "gcn", dtype: torch.dtype = torch.float32,
             device: DeviceLike = None) -> List[Dict[str, torch.Tensor]]:
    """dims = [in, hidden..., out]. Returns list of per-layer params on
    ``device``, drawn in order from ``generator``."""
    dev = resolve_device(device)
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        p = {"w": dense_init(generator, a, b, dtype, device=dev),
             "b": torch.zeros((b,), dtype=dtype, device=dev)}
        if variant == "sage":
            p["w_self"] = dense_init(generator, a, b, dtype, device=dev)
        if variant == "gin":
            p["w2"] = dense_init(generator, b, b, dtype, device=dev)
            p["eps"] = torch.zeros((), dtype=dtype, device=dev)
        layers.append(p)
    return layers


def params_from_jax(layers: Sequence[Dict], device: DeviceLike = None
                    ) -> List[Dict[str, torch.Tensor]]:
    """The reference package's ``init_gcn`` output (any array type numpy can
    read) as this package's parameters on ``device``."""
    dev = resolve_device(device)
    return [{k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
             for k, v in p.items()} for p in layers]


def gcn_forward(params, aggr: Callable, x: torch.Tensor,
                variant: str = "gcn",
                act: Callable = torch.relu) -> torch.Tensor:
    """aggr: callable computing A'.X (a GraphOp). Returns node logits."""
    h = x
    n = len(params)
    for i, p in enumerate(params):
        if variant == "gcn":
            h = aggr(h @ p["w"]) + p["b"]
        elif variant == "sage":
            h = aggr(h) @ p["w"] + h @ p["w_self"] + p["b"]
        elif variant == "gin":
            z = (1.0 + p["eps"]) * h + aggr(h)
            h = act(z @ p["w"] + p["b"]) @ p["w2"]
        else:
            raise ValueError(variant)
        if i < n - 1:
            h = act(h)
    return h


def gcn_loss(params, aggr: Callable, x: torch.Tensor, labels: torch.Tensor,
             variant: str = "gcn",
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean NLL of the fp32 log-softmax of the logits at ``labels``; with
    ``mask``, the masked sum over ``max(mask.sum(), 1)``."""
    logits = gcn_forward(params, aggr, x, variant)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
