"""GCN / GraphSAGE / GIN on the Accel-GCN SpMM operator.

The paper's target workload: ``X^{l+1} = act(A' . (X^l W^l))`` — linear
transform then sparse feature aggregation (paper §II-A). The aggregation runs
through :class:`repro_torch.core.spmm.AccelSpMM` (degree sorting +
block-level partition + combined-warp feature tiling).

Placement: ``A'(h W)`` and ``(A' h) W`` are the same function, and the
aggregation's cost follows the width it gathers. ``gcn`` and ``sage``
layers (for ``sage``, the neighbour term; ``h W_self`` stays as it is)
pick the order per layer with :func:`transform_first` from the shape of
``W`` and from which of ``h`` and ``W`` need a gradient: transforming first
aggregates ``d_out`` wide, forward and again backward whenever ``h W``
needs a gradient; aggregating first aggregates ``d_in`` wide, and backward
only where ``h`` needs one (a first layer's raw features do not), but
keeps ``A' h`` (n x d_in) for the gradient of ``W``. No layer holds more
for the backward than its written order does: a ``gcn`` layer (written
transform first) aggregates first only where ``W`` needs no gradient.
Otherwise the narrower order wins, and a tie keeps the written order:
``gcn`` transforms first, ``sage`` aggregates first. GIN's aggregation sits
inside a sum ahead of a nonlinearity, and keeps its place. Each ``gcn`` and
``sage`` layer runs inside a span named by its order,
``layer.transform_first`` or ``layer.aggr_first``, with ``d_in``, ``d_out``
and ``held_bytes``: what the order keeps for the gradient of ``W`` beyond
the layer's input (``A' h``, n x d_in, where it aggregates first; 0
otherwise).

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
from ..spans import span
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
        with span("plan.build", cpu_clock=True):
            fwd = make_accel_spmm(g_norm, backend=backend,
                                  plan_cache=plan_cache, device=device, **kw)
            with span("plan.transpose", cpu_clock=True, nnz=g_norm.nnz):
                g_t = csr_transpose(g_norm)
            bwd = make_accel_spmm(g_t, backend=backend,
                                  plan_cache=plan_cache, device=device, **kw)
        return cls(fwd=fwd, bwd=bwd)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Aggregate.apply(x, self)


class _Aggregate(torch.autograd.Function):
    """``A' @ x`` with the gradient ``A'^T @ g``. ``forward`` runs with grad
    mode off, so the plain version on CPU tensors records no graph of its
    own, and saves nothing of ``x``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, op: GraphOp) -> torch.Tensor:
        ctx.op = op
        with span("aggr.fwd", f=x.shape[1]):
            return op.fwd(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        # autograd may hand an expanded (stride-0) or strided grad
        with span("aggr.bwd", f=g.shape[1]):
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


def transform_first(variant: str, d_in: int, d_out: int, h_grad: bool,
                    w_grad: bool) -> bool:
    """Whether a ``gcn`` or ``sage`` layer ``d_in -> d_out`` computes
    ``A'(h W)`` rather than ``(A' h) W``: the order whose aggregations
    gather fewer columns over the forward and the backward, among those
    that hold no more for the backward than the variant's written order
    (see the module). ``h_grad``, ``w_grad``: whether ``h`` and ``W`` need
    a gradient. Ties keep the written order."""
    written = variant == "gcn"
    if written and w_grad:
        return True
    after = d_out * (2 if h_grad or w_grad else 1)
    before = d_in * (2 if h_grad else 1)
    if after == before:
        return written
    return after < before


def _layer(p: Dict[str, torch.Tensor], aggr: Callable, h: torch.Tensor,
           variant: str, transform: bool) -> torch.Tensor:
    """One ``gcn`` or ``sage`` layer before its activation, aggregating
    after the product with ``W`` where ``transform``, before it otherwise.
    Its partial sums die on return: only the layer's output stays live
    into the next layer."""
    z = aggr(h @ p["w"]) if transform else aggr(h) @ p["w"]
    if variant == "sage":
        z = z + h @ p["w_self"]
    return z + p["b"]


def gcn_forward(params, aggr: Callable, x: torch.Tensor,
                variant: str = "gcn",
                act: Callable = torch.relu) -> torch.Tensor:
    """aggr: callable computing A'.X (a GraphOp). Returns node logits. Each
    ``gcn`` and ``sage`` layer places its aggregation by
    :func:`transform_first` (see the module)."""
    h = x
    n = len(params)
    grad = torch.is_grad_enabled()
    for i, p in enumerate(params):
        if variant in ("gcn", "sage"):
            d_in, d_out = p["w"].shape
            transform = transform_first(
                variant, d_in, d_out, grad and h.requires_grad,
                grad and p["w"].requires_grad)
            held = 0 if transform else h.shape[0] * d_in * h.element_size()
            with span("layer.transform_first" if transform
                      else "layer.aggr_first",
                      d_in=d_in, d_out=d_out, held_bytes=held):
                h = _layer(p, aggr, h, variant, transform)
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
