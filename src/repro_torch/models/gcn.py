"""GCN / GraphSAGE / GIN on the Accel-GCN SpMM operator.

The paper's target workload: ``X^{l+1} = act(A' . (X^l W^l))`` — linear
transform then sparse feature aggregation (paper §II-A). The aggregation runs
through :class:`repro_torch.core.spmm.AccelSpMM` (degree sorting +
block-level partition + combined-warp feature tiling).

``GraphOp`` is forward-only here: the backward through A'^T and the loss
arrive with training (ROADMAP queue 1, slice B).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.graph import CSRGraph
from ..core.plan_cache import DeviceLike, PlanCache, resolve_device
from ..core.spmm import AccelSpMM, make_accel_spmm
from .layers import dense_init


@dataclasses.dataclass
class GraphOp:
    """A' as a callable aggregation (forward only)."""

    fwd: AccelSpMM

    @classmethod
    def build(cls, g_norm: CSRGraph, backend: str = "accel",
              plan_cache: Optional[PlanCache] = None,
              device: DeviceLike = None, **kw) -> "GraphOp":
        """With ``plan_cache`` the plan of A' is cached: rebuilding the op for
        a recurring graph does zero partitioning work."""
        return cls(fwd=make_accel_spmm(g_norm, backend=backend,
                                       plan_cache=plan_cache, device=device,
                                       **kw))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.fwd(x)


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
