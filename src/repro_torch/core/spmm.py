"""Public SpMM API: a preprocessed Accel-GCN operator for a fixed sparse matrix.

``AccelSpMM`` owns the paper's full preprocessing pipeline (degree sorting ->
block-level partition -> slab packing) and exposes ``__call__(x)`` computing
``A @ x`` in the ORIGINAL row order, with selectable backends:

  backend="accel"    K1, the CUDA block-slab kernel, with no routing
  backend="auto"     routed per call from the feature-operand shape by the
                     reference's policy (``kernels/router.py``): resident
                     (K1) / windowed (K2) / hbm (K3)
  backend="pallas"   K1 behind the router's resident check (raises
                     ``VmemBudgetError`` past the resident threshold)
  backend="windowed" K2, the row-window kernel
  backend="hbm"      K3, the HBM-gather kernel
  backend="blocked"  PyTorch twin of the kernel (one-hot block reduction)
  backend="segment"  COO + ``index_add_`` (the cuSPARSE-analogue baseline)
  backend="warp"     warp-level fixed-NZ-group emulation (GNNAdvisor analogue)
  backend="dense"    dense matmul oracle (tiny graphs only)

Every kernel takes its plain PyTorch version for CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch

from .graph import CSRGraph
from .partition import warp_level_partition
from .plan_cache import (
    DeviceLike,
    PartitionConfig,
    PartitionPlan,
    PlanCache,
    build_partition_plan,
    resolve_device,
)
from ..kernels import ops as kops
from ..spans import span

Backend = Literal["accel", "auto", "pallas", "windowed", "hbm",
                  "blocked", "segment", "warp", "dense"]
# slab-dict entry points of the kernel backends
_KERNEL_OPS = {"accel": kops.spmm_accel, "auto": kops.spmm_auto,
               "pallas": kops.spmm_pallas,
               "windowed": kops.spmm_pallas_windowed,
               "hbm": kops.spmm_pallas_hbm}


def _plan_field(name: str) -> property:
    return property(lambda self: getattr(self.plan, name), doc=f"plan.{name}")


@dataclasses.dataclass
class AccelSpMM:
    """Preprocessed sparse operator over one staged plan. Build via
    :func:`make_accel_spmm`."""

    plan: PartitionPlan          # staged preprocessing this op wraps
    backend: Backend
    # baselines
    warp_slabs: Optional[dict] = None
    dense: Optional[torch.Tensor] = None

    n_rows = _plan_field("n_rows")
    n_cols = _plan_field("n_cols")
    nnz = _plan_field("nnz")
    slabs = _plan_field("slabs")          # degree-sorted
    inv_perm = _plan_field("inv_perm")
    partition = _plan_field("partition")
    coo_row = _plan_field("coo_row")
    coo_col = _plan_field("coo_col")
    coo_val = _plan_field("coo_val")

    def __call__(self, x: torch.Tensor,
                 backend: Optional[Backend] = None) -> torch.Tensor:
        be = backend or self.backend
        plan = self.plan
        if be in _KERNEL_OPS or be == "blocked":
            with span("spmm.kernel"):
                if be == "blocked":
                    out_sorted = kops.spmm_blocked(
                        plan.slabs["colidx"], plan.slabs["values"],
                        plan.slabs["rowloc"], plan.slabs["out_row"], x,
                        plan.n_rows)
                else:
                    out_sorted = _KERNEL_OPS[be](plan.slabs, x, plan.n_rows)
            with span("spmm.unpermute"):
                return plan.to_original_order(out_sorted)
        if be == "segment":
            contrib = plan.coo_val[:, None] * x[plan.coo_col].float()
            out = torch.zeros((plan.n_rows, x.shape[1]), dtype=torch.float32,
                              device=x.device)
            return out.index_add_(0, plan.coo_row, contrib)
        if be == "warp":
            ws = self.warp_slabs
            # the warp partition is built un-sorted: original order
            return kops.spmm_blocked(ws["colidx"], ws["values"],
                                     ws["rowloc"], ws["out_row"], x,
                                     plan.n_rows)
        if be == "dense":
            return self.dense @ x.float()
        raise ValueError(f"unknown backend {be!r} (accel|auto|pallas|"
                         f"windowed|hbm|blocked|segment|warp|dense)")


def accel_spmm_from_plan(plan: PartitionPlan,
                         backend: Backend = "accel") -> AccelSpMM:
    """Wrap a finished (possibly cached) partition plan as a callable operator."""
    return AccelSpMM(plan=plan, backend=backend)


def make_accel_spmm(
    g: CSRGraph,
    *,
    mode: str = "tpu",
    max_block_warps: int = 64,
    max_warp_nzs: int = 4,
    backend: Backend = "accel",
    with_baselines: bool = False,
    warp_ng: int = 32,
    plan_cache: Optional[PlanCache] = None,
    device: DeviceLike = None,
) -> AccelSpMM:
    """Build the operator on ``device`` (``cuda`` unless the caller passes
    another; with ``plan_cache`` the plan lives on the cache's device). With
    ``plan_cache`` the O(n) preprocessing runs at most once per distinct
    (graph content, partition config)."""
    cfg = PartitionConfig(mode=mode, max_block_warps=max_block_warps,
                          max_warp_nzs=max_warp_nzs)
    if plan_cache is not None:
        if device is not None and resolve_device(device) != plan_cache.device:
            raise ValueError(f"device {device!r} differs from the plan "
                             f"cache's {plan_cache.device}")
        plan = plan_cache.get_or_build(g, cfg)
    else:
        plan = build_partition_plan(g, cfg, device=device)
    op = accel_spmm_from_plan(plan, backend=backend)

    if with_baselines:
        dev = plan.device
        wp = warp_level_partition(g, ng_size=warp_ng)
        W = wp.num_warps
        ws_col = np.zeros((W, warp_ng), dtype=np.int32)
        ws_val = np.zeros((W, warp_ng), dtype=np.float32)
        for i, (_r, lo, ln) in enumerate(wp.meta):
            ws_col[i, :ln] = g.colidx[lo:lo + ln]
            ws_val[i, :ln] = g.values[lo:lo + ln]
        op.warp_slabs = {
            "colidx": torch.from_numpy(ws_col).to(dev),
            "values": torch.from_numpy(ws_val).to(dev),
            "rowloc": torch.zeros((W, warp_ng), dtype=torch.int32, device=dev),
            "out_row": torch.from_numpy(
                np.ascontiguousarray(wp.meta[:, :1])).to(dev),
        }
        if g.n_rows * g.n_cols <= 4_000_000:
            op.dense = torch.from_numpy(g.to_dense()).to(dev)
    return op
