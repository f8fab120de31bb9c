"""Public SpMM API: a preprocessed Accel-GCN operator for a fixed sparse matrix.

``AccelSpMM`` owns the paper's full preprocessing pipeline (degree sorting ->
block-level partition -> slab packing) and exposes ``__call__(x)`` computing
``A @ x`` in the ORIGINAL row order, with selectable backends:

  backend="accel"    K1, the CUDA block-slab kernel (its plain version for
                     CPU tensors)
  backend="blocked"  PyTorch twin of the kernel (one-hot block reduction)
  backend="segment"  COO + ``index_add_`` (the cuSPARSE-analogue baseline)
  backend="warp"     warp-level fixed-NZ-group emulation (GNNAdvisor analogue)
  backend="dense"    dense matmul oracle (tiny graphs only)

The reference package's TPU router regimes (``auto``, ``pallas``,
``windowed``, ``hbm``) are not ported yet (ROADMAP queue 2).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch

from .graph import CSRGraph
from .partition import BlockPartition, warp_level_partition
from .plan_cache import (
    DeviceLike,
    PartitionConfig,
    PartitionPlan,
    PlanCache,
    build_partition_plan,
    resolve_device,
)
from ..kernels import ops as kops

Backend = Literal["accel", "blocked", "segment", "warp", "dense"]


@dataclasses.dataclass
class AccelSpMM:
    """Preprocessed sparse operator. Build via :func:`make_accel_spmm`."""

    n_rows: int
    n_cols: int
    nnz: int
    backend: Backend
    # degree-sorted slabs (tensors on the plan's device)
    slabs: dict
    inv_perm: torch.Tensor       # original row -> sorted position
    # baselines
    coo_row: Optional[torch.Tensor] = None
    coo_col: Optional[torch.Tensor] = None
    coo_val: Optional[torch.Tensor] = None
    warp_slabs: Optional[dict] = None
    dense: Optional[torch.Tensor] = None
    partition: Optional[BlockPartition] = None
    plan: Optional[PartitionPlan] = None  # staged preprocessing this op wraps

    def __call__(self, x: torch.Tensor,
                 backend: Optional[Backend] = None) -> torch.Tensor:
        be = backend or self.backend
        if be == "accel":
            out_sorted = kops.spmm_accel(self.slabs, x.float().contiguous(),
                                         self.n_rows)
            return out_sorted[self.inv_perm]
        if be == "blocked":
            out_sorted = kops.spmm_blocked(
                self.slabs["colidx"], self.slabs["values"],
                self.slabs["rowloc"], self.slabs["out_row"], x, self.n_rows)
            return out_sorted[self.inv_perm]
        if be == "segment":
            contrib = self.coo_val[:, None] * x[self.coo_col].float()
            out = torch.zeros((self.n_rows, x.shape[1]), dtype=torch.float32,
                              device=x.device)
            return out.index_add_(0, self.coo_row, contrib)
        if be == "warp":
            ws = self.warp_slabs
            # the warp partition is built un-sorted: original order
            return kops.spmm_blocked(ws["colidx"], ws["values"],
                                     ws["rowloc"], ws["out_row"], x,
                                     self.n_rows)
        if be == "dense":
            return self.dense @ x.float()
        raise ValueError(f"unknown backend {be!r} (accel|blocked|segment|"
                         f"warp|dense; the TPU router regimes are ROADMAP "
                         f"queue 2)")


def accel_spmm_from_plan(plan: PartitionPlan,
                         backend: Backend = "accel") -> AccelSpMM:
    """Wrap a finished (possibly cached) partition plan as a callable operator."""
    return AccelSpMM(
        n_rows=plan.n_rows, n_cols=plan.n_cols, nnz=plan.nnz, backend=backend,
        slabs=plan.slabs, inv_perm=plan.inv_perm, partition=plan.partition,
        coo_row=plan.coo_row, coo_col=plan.coo_col, coo_val=plan.coo_val,
        plan=plan,
    )


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
