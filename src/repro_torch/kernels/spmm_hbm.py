"""Accel-GCN block-slab SpMM, HBM-gather variant (K3): the CUDA kernel, its
wrapper and its plain PyTorch version.

K3 (``csrc/spmm_hbm.cu``) replaces the Pallas TPU kernel
``repro.kernels.spmm_hbm._kernel`` (``src/repro/kernels/spmm_hbm.py:48``),
which leaves X in HBM and gathers the C rows of a block's feature tile with
a double-buffered one-row DMA, skipping all-zero padding blocks. On the
card it is the live-row gather pipeline of ``csrc/slab_common.cuh`` in slot
order: each CTA gathers the row segments of its block's live slots into a
shared-memory ring (one bulk copy per segment on mbarriers, or 4-byte
``cp.async`` per thread where F % 4 != 0 or X is not 16-byte aligned:
``gather_instance``), sums each local row's run in registers and adds it
into the output with one fp32 atomic. An all-zero padding block issues no
copy.

What bounds it on an H100 is memory, as for K1: the referenced X rows read
once, the output written once, the slabs read once. The router sends it
every dispatch past the reference's windowed threshold, which covers the
large serving graphs.

K3 computes the same function as K1 and launches the same kernel
(``launch_slot_order``; K3 at ``DEFAULT_F_TILE`` columns per CTA, K1 at
``k1_f_tile(F)``), so its plain version is K1's.
"""
from __future__ import annotations

import torch

from .spmm_accel import (DEFAULT_F_TILE, GATHER_INSTANCES, check_slabs,
                         declare_slot_order, launch_slot_order,
                         spmm_block_slabs_plain)

__all__ = ["DEFAULT_F_TILE", "spmm_block_slabs_hbm",
           "spmm_block_slabs_hbm_plain"]

spmm_block_slabs_hbm_plain = spmm_block_slabs_plain


def spmm_block_slabs_hbm(
    colidx: torch.Tensor,   # int32[B, C]
    values: torch.Tensor,   # f32[B, C]
    rowloc: torch.Tensor,   # int32[B, C]
    out_row: torch.Tensor,  # int32[B, R]
    x: torch.Tensor,        # f32[N, F]
    n_rows: int,
    *,
    f_tile: int = DEFAULT_F_TILE,
) -> torch.Tensor:
    """HBM-gather SpMM over packed slabs; returns ``[n_rows, F]`` fp32 in
    the slabs' row order. CUDA tensors launch K3 on the current stream, in
    the instance ``gather_instance(x, f_tile)`` picks (every f_tile of
    ``check_slabs`` has one); CPU tensors take the plain version. There is
    no fallback between the two."""
    check_slabs(colidx, values, rowloc, out_row, x, n_rows, f_tile,
                "block_major")
    if x.device.type == "cpu":
        return spmm_block_slabs_hbm_plain(colidx, values, rowloc, out_row, x,
                                          n_rows)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_block_slabs_hbm runs on cuda or cpu, got "
                         f"{x.device}")
    return launch_slot_order("K3", "spmm_hbm", "spmm_hbm",
                             spmm_block_slabs_hbm, colidx, values, rowloc,
                             out_row, x, n_rows, f_tile)


spmm_block_slabs_hbm.launches = 0   # K3 launches since the last reset
spmm_block_slabs_hbm.launches_by_instance = dict.fromkeys(GATHER_INSTANCES,
                                                          0)


_declare = declare_slot_order("spmm_hbm")
