"""Accel-GCN block-slab SpMM (K1): the CUDA kernel, its wrapper and its
plain PyTorch version.

The kernel (``csrc/spmm_accel.cu``) replaces the Pallas TPU kernel
``repro.kernels.spmm_accel._spmm_kernel`` (``src/repro/kernels/spmm_accel.py:73``)
and its ``scatter_block_rows`` epilogue. It takes the paper's GPU design
rather than the TPU's: one CTA per (block, feature tile) with the feature
tile as the combined warp, the intra-block row reduction in shared memory,
and a fused epilogue that adds each block row into the output with fp32
atomics, so split rows (degree > C) sum across CTAs.

What bounds it on an H100 is memory: per call it must read the referenced
X rows once, write the output once and read the slabs once; it does 2 flops
per slab slot and feature column, far below the card's fp32 rate. Its design
answers that by coalescing every gathered row (32 lanes on 32 neighbouring
floats), keeping several gathers in flight per thread, skipping padding
slots and all-zero padding blocks, and never materialising the ``[B, R, F]``
block rows that the TPU version scatters in a second pass.

The TPU kernel's VMEM bounds (the resident-X budget, the pad of F to 128
lanes and of N to 8 rows) do not apply: the CUDA kernel gathers X rows from
device memory, masks the ragged feature edge itself, and has no bound on N.

The library is compiled with ``nvcc`` for ``sm_90a`` from the repository's
source at first use, into ``build/kernels/`` at the repository root, and
loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

__all__ = ["DEFAULT_F_TILE", "scatter_block_rows", "spmm_block_slabs",
           "spmm_block_slabs_plain", "build_kernel"]

DEFAULT_F_TILE = 128   # threads per CTA: the feature columns one CTA owns

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "spmm_accel.cu"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
_MAX_SMEM = 232_448    # bytes of shared memory one CTA may use on Hopper
_MAX_GRID = 2**31 - 1
# elements of the [blocks, C, F] gather the plain version materialises at once
_PLAIN_CHUNK_ELEMS = 1 << 25

_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_launch_lock = threading.Lock()


def scatter_block_rows(out_slabs: torch.Tensor, out_row: torch.Tensor,
                       n_rows: int, n_features: int) -> torch.Tensor:
    """Epilogue of the slab SpMM: packed ``[B, R, F_pad]`` block rows ->
    global ``[n_rows, n_features]``. Non-split blocks write disjoint rows,
    split-row blocks accumulate, and slot ``n_rows`` is the padding sentinel
    that is dropped. (K1 fuses this step into the kernel.)"""
    B, R, F_pad = out_slabs.shape
    out = out_slabs.new_zeros((n_rows + 1, F_pad))
    out.index_add_(0, out_row.reshape(B * R).long(),
                   out_slabs.reshape(B * R, F_pad))
    return out[:n_rows, :n_features]


def spmm_block_slabs_plain(colidx: torch.Tensor, values: torch.Tensor,
                           rowloc: torch.Tensor, out_row: torch.Tensor,
                           x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plain PyTorch version of K1: gather, scale, ``index_add_`` into the R
    local rows of each block, ``index_add_`` into ``n_rows + 1`` global rows,
    drop the sentinel. Chunked over blocks so the gathered ``[b, C, F]``
    intermediate stays bounded at any graph size."""
    B, C = colidx.shape
    R = out_row.shape[1]
    F = x.shape[1]
    out = torch.zeros((n_rows + 1, F), dtype=torch.float32, device=x.device)
    xf = x.float()
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(1, C * F))
    for lo in range(0, B, chunk):
        hi = min(B, lo + chunk)
        ci = colidx[lo:hi].long()
        gathered = values[lo:hi, :, None].float() * xf[ci]       # [b, C, F]
        local = (torch.arange(hi - lo, device=x.device)[:, None] * R
                 + rowloc[lo:hi].long()).reshape(-1)
        rows = torch.zeros(((hi - lo) * R, F), dtype=torch.float32,
                           device=x.device)
        rows.index_add_(0, local, gathered.reshape(-1, F))
        out.index_add_(0, out_row[lo:hi].reshape(-1).long(), rows)
    return out[:n_rows]


def _check(colidx, values, rowloc, out_row, x, n_rows: int, f_tile: int,
           grid_order: str) -> None:
    if grid_order not in ("block_major", "ft_major"):
        raise ValueError(
            f"grid_order must be block_major|ft_major, got {grid_order!r}")
    if f_tile % 32 or not 32 <= f_tile <= 1024:
        raise ValueError(f"f_tile must be a multiple of 32 in [32, 1024], "
                         f"got {f_tile}")
    for name, t, dt, nd in (("colidx", colidx, torch.int32, 2),
                            ("values", values, torch.float32, 2),
                            ("rowloc", rowloc, torch.int32, 2),
                            ("out_row", out_row, torch.int32, 2),
                            ("x", x, torch.float32, 2)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)!r}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.dim() != nd:
            raise ValueError(f"{name} must be {nd}-D, got shape "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if values.shape != colidx.shape or rowloc.shape != colidx.shape:
        raise ValueError(
            f"colidx/values/rowloc shapes differ: {tuple(colidx.shape)}, "
            f"{tuple(values.shape)}, {tuple(rowloc.shape)}")
    if out_row.shape[0] != colidx.shape[0]:
        raise ValueError(f"out_row has {out_row.shape[0]} blocks, colidx "
                         f"{colidx.shape[0]}")
    if n_rows < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")


def spmm_block_slabs(
    colidx: torch.Tensor,   # int32[B, C]
    values: torch.Tensor,   # f32[B, C]
    rowloc: torch.Tensor,   # int32[B, C]
    out_row: torch.Tensor,  # int32[B, R]
    x: torch.Tensor,        # f32[N, F]
    n_rows: int,
    *,
    f_tile: int = DEFAULT_F_TILE,
    grid_order: str = "block_major",
) -> torch.Tensor:
    """Block-slab SpMM over packed slabs; returns ``[n_rows, F]`` fp32 in
    the slabs' (degree-sorted) row order.

    CUDA tensors launch K1 on the current stream; CPU tensors take the plain
    version. There is no fallback between the two. ``f_tile`` is the number
    of feature columns (threads) per CTA. ``grid_order`` is accepted for
    signature parity with the TPU kernel and has no effect: CTAs on a GPU
    run in no fixed order. The slabs are trusted to come from ``pack_slabs``
    or ``batch_graph_slabs``: every ``rowloc`` is below R, every ``colidx``
    below N, every ``out_row`` at most ``n_rows``.
    """
    _check(colidx, values, rowloc, out_row, x, n_rows, f_tile, grid_order)
    if x.device.type == "cpu":
        return spmm_block_slabs_plain(colidx, values, rowloc, out_row, x,
                                      n_rows)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_block_slabs runs on cuda or cpu, got "
                         f"{x.device}")
    return _launch(colidx, values, rowloc, out_row, x, n_rows, f_tile)


spmm_block_slabs.launches = 0   # K1 launches since the caller last reset it


def _launch(colidx, values, rowloc, out_row, x, n_rows: int,
            f_tile: int) -> torch.Tensor:
    B, C = colidx.shape
    R = out_row.shape[1]
    F = x.shape[1]
    out = torch.zeros((n_rows, F), dtype=torch.float32, device=x.device)
    if B == 0 or F == 0 or n_rows == 0:
        return out
    lib = _load()
    smem = lib.spmm_block_slabs_smem_bytes(C, R, f_tile)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"K1 needs {smem} bytes of shared memory per CTA for C={C}, "
            f"R={R}, f_tile={f_tile}; the card allows {_MAX_SMEM}")
    n_ftiles = -(-F // f_tile)
    if B * n_ftiles > _MAX_GRID:
        raise ValueError(f"{B} blocks x {n_ftiles} feature tiles exceed "
                         f"the grid limit")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.spmm_block_slabs_launch(
            colidx.data_ptr(), values.data_ptr(), rowloc.data_ptr(),
            out_row.data_ptr(), x.data_ptr(), out.data_ptr(),
            B, C, R, F, n_rows, f_tile, stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: "
                           f"{lib.spmm_accel_error_string(err).decode()}")
    with _launch_lock:
        spmm_block_slabs.launches += 1
    return out


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: K1 is compiled from "
                       f"{_SOURCE.name} at first use and needs the CUDA "
                       "toolkit")


def build_kernel() -> Tuple[Path, str]:
    """Compile K1 for ``sm_90a`` (once per source content) and return the
    library path and the compiler's ``-Xptxas -v`` report."""
    src = _SOURCE.read_bytes()
    tag = hashlib.blake2b(src, digest_size=8).hexdigest()
    lib_path = _BUILD_DIR / f"libspmm_accel-{tag}.so"
    log_path = lib_path.with_suffix(".log")
    with _build_lock:
        if not lib_path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", str(tmp), str(_SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib_path)
        log = log_path.read_text() if log_path.exists() else ""
    return lib_path, log


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path, _ = build_kernel()
    with _build_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(path))
            lib.spmm_block_slabs_smem_bytes.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.spmm_block_slabs_smem_bytes.restype = ctypes.c_longlong
            lib.spmm_block_slabs_launch.argtypes = (
                [ctypes.c_void_p] * 6
                + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p])
            lib.spmm_block_slabs_launch.restype = ctypes.c_int
            lib.spmm_accel_error_string.argtypes = [ctypes.c_int]
            lib.spmm_accel_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib
