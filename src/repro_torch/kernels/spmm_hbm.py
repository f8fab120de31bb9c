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

K3 computes the same function as K1, so its plain version is K1's.
"""
from __future__ import annotations

import ctypes

import torch

from .build import load_kernel
from .spmm_accel import (DEFAULT_F_TILE, GATHER_INSTANCES, check_launch,
                         check_slabs, declare_common, gather_instance,
                         launch_on_stream, spmm_block_slabs_plain)

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
    return _launch(colidx, values, rowloc, out_row, x, n_rows, f_tile)


spmm_block_slabs_hbm.launches = 0   # K3 launches since the last reset
spmm_block_slabs_hbm.launches_by_instance = dict.fromkeys(GATHER_INSTANCES,
                                                          0)


def _declare(lib: ctypes.CDLL) -> None:
    declare_common(lib)
    lib.spmm_hbm_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.spmm_hbm_smem_bytes.restype = ctypes.c_longlong
    lib.spmm_hbm_ctas_per_sm.argtypes = [ctypes.c_int] * 4
    lib.spmm_hbm_ctas_per_sm.restype = ctypes.c_int
    lib.spmm_hbm_launch.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.spmm_hbm_launch.restype = ctypes.c_int


def _launch(colidx, values, rowloc, out_row, x, n_rows: int,
            f_tile: int) -> torch.Tensor:
    B, C = colidx.shape
    R = out_row.shape[1]
    F = x.shape[1]
    out = torch.zeros((n_rows, F), dtype=torch.float32, device=x.device)
    if B == 0 or F == 0 or n_rows == 0:
        return out
    instance = gather_instance(x, f_tile)
    lib = load_kernel("spmm_hbm", _declare)
    check_launch("K3", lib.spmm_hbm_smem_bytes(C, R, f_tile), B, F, f_tile)
    launch_on_stream(
        "K3", lib, lib.spmm_hbm_launch, spmm_block_slabs_hbm, x,
        colidx.data_ptr(), values.data_ptr(), rowloc.data_ptr(),
        out_row.data_ptr(), x.data_ptr(), out.data_ptr(),
        B, C, R, F, n_rows, f_tile, int(instance == "bulk"),
        instance=instance)
    return out
