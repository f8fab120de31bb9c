"""Accel-GCN block-slab SpMM, resident (K1) and windowed (K2): the CUDA
kernels, their wrappers and their plain PyTorch versions.

K1 (``csrc/spmm_accel.cu``) replaces the Pallas TPU kernel
``repro.kernels.spmm_accel._spmm_kernel`` (``src/repro/kernels/spmm_accel.py:73``)
and its ``scatter_block_rows`` epilogue. The TPU kernel keeps a column
slice of X resident in VMEM while it sweeps every block; on the card the
on-chip place for that slice is L2. K1 is the live-row gather pipeline of
``csrc/slab_common.cuh`` in slot order, the kernel K3 launches too: one CTA
per (block, feature tile), feature-tile-major, so that the CTAs in flight
share one column slice of X; each live slot's row segment goes through a
shared-memory ring, each local row's run is summed in registers and added
into the output with one fp32 RED, so split rows (degree > C) sum across
CTAs. Its column slice is ``k1_f_tile(F)`` wide: F in whole warps, at
most ``K1_F_TILE``, so that every warp a CTA launches has columns.

K2 (``csrc/spmm_windowed.cu``) replaces ``_spmm_kernel_windowed``
(``src/repro/kernels/spmm_accel.py:180``): the same product with X swept in
row windows of ``window_rows``. Slots outside window ``w`` add nothing in
sweep ``w`` and each block row sums its window partials in window order.
On the card it is the same pipeline walking the live slots by (local row,
window, slot): only the live slots' row segments are gathered, whatever
the number of windows.

What bounds both on an H100 is memory: per call they must read the
referenced X rows once, write the output once and read the slabs once; they
do 2 flops per slab slot and feature column, far below the card's fp32
rate. The pipeline gathers one row segment per live slot in one of two
instances (``gather_instance``), skips padding slots and all-zero padding
blocks, and never materialises the ``[B, R, F]`` block rows that the TPU
version scatters in a second pass.

The TPU kernels' VMEM bounds (the resident-X budget, the pad of F to 128
lanes and of N to 8 rows) do not apply: the kernels read X from device
memory, mask the ragged feature edge themselves, and have no bound on N.
The routing policy that still decides which kernel a dispatch runs lives in
``router.py``. The libraries are built at first use by ``build.py``.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .build import load_kernel
from .router import resident_window_rows

__all__ = ["DEFAULT_F_TILE", "GATHER_INSTANCES", "K1_F_TILE",
           "MAX_SMEM_PER_CTA",
           "gather_instance", "k1_f_tile", "scatter_block_rows",
           "spmm_block_slabs", "spmm_block_slabs_plain",
           "spmm_block_slabs_windowed", "spmm_block_slabs_windowed_plain"]

DEFAULT_F_TILE = 128   # threads per CTA: the feature columns one CTA owns
K1_F_TILE = 256        # K1's widest column slice of X, in features
MAX_SMEM_PER_CTA = 232_448   # bytes of shared memory one CTA may use on Hopper
_MAX_GRID = 2**31 - 1
_MAX_THREADS = 1024          # threads per CTA
# elements of the [blocks, C, F] gather the plain versions materialise at once
_PLAIN_CHUNK_ELEMS = 1 << 25
# K2's sort key holds a slot and a local row in 16 bits each
_MAX_SORT_FIELD = 1 << 16
# the pipeline's two ways of gathering row segments (slab_common.cuh)
GATHER_INSTANCES = ("bulk", "cp_async")

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


def check_slabs(colidx, values, rowloc, out_row, x, n_rows: int,
                f_tile: int, grid_order: str) -> None:
    """Raise on what the slab kernels do not take: types, shapes, devices,
    contiguity, f_tile and grid_order."""
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


def k1_f_tile(F: int) -> int:
    """K1's column slice for a feature width F: F rounded up to whole warps
    (one thread a column), at most ``K1_F_TILE``. A narrower CTA has no
    warp without columns and a ring sized to its columns, so more CTAs fit
    an SM; past ``K1_F_TILE`` a call takes several slices of
    ``K1_F_TILE``."""
    return min(K1_F_TILE, 32 * max(1, -(-F // 32)))


def spmm_block_slabs(
    colidx: torch.Tensor,   # int32[B, C]
    values: torch.Tensor,   # f32[B, C]
    rowloc: torch.Tensor,   # int32[B, C]
    out_row: torch.Tensor,  # int32[B, R]
    x: torch.Tensor,        # f32[N, F]
    n_rows: int,
    *,
    f_tile: int | None = None,
    grid_order: str = "block_major",
) -> torch.Tensor:
    """Block-slab SpMM over packed slabs; returns ``[n_rows, F]`` fp32 in
    the slabs' (degree-sorted) row order.

    CUDA tensors launch K1 on the current stream, in the instance
    ``gather_instance(x, f_tile)`` picks; CPU tensors take the plain
    version. There is no fallback between the two. ``f_tile`` is the number
    of feature columns per CTA: the width of the column slice of X that the
    CTAs in flight share; ``k1_f_tile(F)`` unless the caller gives one. The
    tile changes no sum: each column of a row's run is summed by one thread
    in slot order at any tile. ``grid_order`` is accepted for
    signature parity with the TPU kernel and has no effect: CTAs on a GPU
    run in no fixed order. The slabs are trusted to come from ``pack_slabs``
    or ``batch_graph_slabs``: every ``rowloc`` is below R, every ``colidx``
    below N, every ``out_row`` at most ``n_rows``.
    """
    check_slabs(colidx, values, rowloc, out_row, x, n_rows,
                K1_F_TILE if f_tile is None else f_tile, grid_order)
    if f_tile is None:
        f_tile = k1_f_tile(x.shape[1])
    if x.device.type == "cpu":
        return spmm_block_slabs_plain(colidx, values, rowloc, out_row, x,
                                      n_rows)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_block_slabs runs on cuda or cpu, got "
                         f"{x.device}")
    return launch_slot_order("K1", "spmm_accel", "spmm_block_slabs",
                             spmm_block_slabs, colidx, values, rowloc,
                             out_row, x, n_rows, f_tile)


spmm_block_slabs.launches = 0   # K1 launches since the caller last reset it
spmm_block_slabs.launches_by_instance = dict.fromkeys(GATHER_INSTANCES, 0)
spmm_block_slabs.launches_by_f_tile = {}   # K1 launches by the tile taken


def check_launch(label: str, smem: int, B: int, F: int,
                 f_tile: int) -> None:
    """Raise before a launch the card would refuse: shared memory past the
    per-CTA limit, or more CTAs than the grid holds."""
    if smem > MAX_SMEM_PER_CTA:
        raise ValueError(f"{label} needs {smem} bytes of shared memory per "
                         f"CTA; the card allows {MAX_SMEM_PER_CTA}")
    n_ftiles = -(-F // f_tile)
    if B * n_ftiles > _MAX_GRID:
        raise ValueError(f"{label}: {B} blocks x {n_ftiles} feature tiles "
                         f"exceed the grid limit")


def gather_instance(x: torch.Tensor, f_tile: int = DEFAULT_F_TILE) -> str:
    """Which instance of the pipeline's gather (K1, K2, K3) takes ``x`` at
    ``f_tile``:
    ``"bulk"`` (one bulk copy per row segment, completing on mbarriers)
    when F % 4 == 0 and x is 16-byte aligned, so every segment starts and
    ends on 16 bytes, and the CTA's f_tile consumer threads plus the
    producer warp fit in 1024 (f_tile <= 992); else ``"cp_async"`` (4-byte
    copies, each of the f_tile threads its own column). A function of
    shape, alignment and f_tile only."""
    aligned = x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0
    return "bulk" if aligned and f_tile + 32 <= _MAX_THREADS else "cp_async"


def launch_on_stream(label: str, lib: ctypes.CDLL, fn, wrapper, x, *args,
                     instance: str | None = None, f_tile: int | None = None):
    """Call the library's launch function ``fn`` on x's current stream,
    raise if the launch was refused, and count it on ``wrapper`` (and on
    ``wrapper.launches_by_instance[instance]`` when given, and on
    ``wrapper.launches_by_f_tile[f_tile]`` where the wrapper keeps one)."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{label} launch failed: "
                           f"{lib.slab_kernel_error_string(err).decode()}")
    with _launch_lock:
        wrapper.launches += 1
        if instance is not None:
            wrapper.launches_by_instance[instance] += 1
        by_tile = getattr(wrapper, "launches_by_f_tile", None)
        if by_tile is not None:
            by_tile[f_tile] = by_tile.get(f_tile, 0) + 1


def declare_common(lib: ctypes.CDLL) -> None:
    lib.slab_kernel_error_string.argtypes = [ctypes.c_int]
    lib.slab_kernel_error_string.restype = ctypes.c_char_p


def declare_slot_order(prefix: str):
    """The ctypes declarations of a library of ``slot_order_kernel``, whose
    C functions are ``<prefix>_smem_bytes``, ``_ctas_per_sm`` and
    ``_launch`` (K1: ``spmm_block_slabs``, K3: ``spmm_hbm``)."""
    def declare(lib: ctypes.CDLL) -> None:
        declare_common(lib)
        smem = getattr(lib, f"{prefix}_smem_bytes")
        smem.argtypes = [ctypes.c_int] * 3
        smem.restype = ctypes.c_longlong
        ctas = getattr(lib, f"{prefix}_ctas_per_sm")
        ctas.argtypes = [ctypes.c_int] * 4
        ctas.restype = ctypes.c_int
        launch = getattr(lib, f"{prefix}_launch")
        launch.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        launch.restype = ctypes.c_int
    return declare


_declare_k1 = declare_slot_order("spmm_block_slabs")


def launch_slot_order(label: str, source: str, prefix: str, wrapper, colidx,
                      values, rowloc, out_row, x, n_rows: int,
                      f_tile: int) -> torch.Tensor:
    """Launch ``slot_order_kernel`` from library ``csrc/<source>.cu`` (K1
    or K3) on x's current stream, in the instance ``gather_instance``
    picks, and count it on ``wrapper``; returns the zero-filled output it
    adds into."""
    B, C = colidx.shape
    R = out_row.shape[1]
    F = x.shape[1]
    out = torch.zeros((n_rows, F), dtype=torch.float32, device=x.device)
    if B == 0 or F == 0 or n_rows == 0:
        return out
    instance = gather_instance(x, f_tile)
    lib = load_kernel(source, declare_slot_order(prefix))
    check_launch(label, getattr(lib, f"{prefix}_smem_bytes")(C, R, f_tile),
                 B, F, f_tile)
    launch_on_stream(
        label, lib, getattr(lib, f"{prefix}_launch"), wrapper, x,
        colidx.data_ptr(), values.data_ptr(), rowloc.data_ptr(),
        out_row.data_ptr(), x.data_ptr(), out.data_ptr(),
        B, C, R, F, n_rows, f_tile, int(instance == "bulk"),
        instance=instance, f_tile=f_tile)
    return out


# ------------------------------------------------------------------ K2
def spmm_block_slabs_windowed_plain(colidx: torch.Tensor,
                                    values: torch.Tensor,
                                    rowloc: torch.Tensor,
                                    out_row: torch.Tensor, x: torch.Tensor,
                                    n_rows: int,
                                    window_rows: int) -> torch.Tensor:
    """Plain PyTorch version of K2: for each row window ``w`` in order, the
    slots whose column lies in the window are gathered, scaled and
    ``index_add_``-ed into the R local rows of each block, and the window
    partial is added into the block rows; then the block rows are
    ``index_add_``-ed into the global rows. Chunked over blocks."""
    B, C = colidx.shape
    R = out_row.shape[1]
    N, F = x.shape
    num_windows = max(1, -(-N // window_rows))
    out = torch.zeros((n_rows + 1, F), dtype=torch.float32, device=x.device)
    xf = x.float()
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(1, C * F))
    for lo in range(0, B, chunk):
        hi = min(B, lo + chunk)
        ci = colidx[lo:hi].long()
        gathered = xf[ci]                                         # [b, C, F]
        local = (torch.arange(hi - lo, device=x.device)[:, None] * R
                 + rowloc[lo:hi].long()).reshape(-1)
        rows = torch.zeros(((hi - lo) * R, F), dtype=torch.float32,
                           device=x.device)
        for w in range(num_windows):
            in_window = (ci >= w * window_rows) & (ci < (w + 1) * window_rows)
            scaled = (values[lo:hi].float() * in_window)[:, :, None] * gathered
            part = torch.zeros_like(rows)
            part.index_add_(0, local, scaled.reshape(-1, F))
            rows += part
        out.index_add_(0, out_row[lo:hi].reshape(-1).long(), rows)
    return out[:n_rows]


def spmm_block_slabs_windowed(
    colidx: torch.Tensor,   # int32[B, C]
    values: torch.Tensor,   # f32[B, C]
    rowloc: torch.Tensor,   # int32[B, C]
    out_row: torch.Tensor,  # int32[B, R]
    x: torch.Tensor,        # f32[N, F]
    n_rows: int,
    *,
    f_tile: int = DEFAULT_F_TILE,
    window_rows: int | None = None,
) -> torch.Tensor:
    """Row-window SpMM over packed slabs; returns ``[n_rows, F]`` fp32.

    ``window_rows`` (default ``resident_window_rows(f_tile, 4)``, 4096 at
    ``f_tile=128``) is the semantic window of the reference kernel: slots
    outside window ``w`` add nothing in sweep ``w`` and each block row sums
    its window partials in window order. CUDA tensors launch K2 on the
    current stream, in the instance ``gather_instance(x, f_tile)`` picks
    (every f_tile of ``check_slabs`` has one); CPU tensors take the plain
    version. There is no fallback between the two.
    """
    check_slabs(colidx, values, rowloc, out_row, x, n_rows, f_tile, "block_major")
    window = window_rows or resident_window_rows(f_tile, x.element_size())
    if window < 1:
        raise ValueError(f"window_rows must be >= 1, got {window_rows}")
    if x.device.type == "cpu":
        return spmm_block_slabs_windowed_plain(colidx, values, rowloc,
                                               out_row, x, n_rows, window)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_block_slabs_windowed runs on cuda or cpu, "
                         f"got {x.device}")
    return _launch_windowed(colidx, values, rowloc, out_row, x, n_rows,
                            f_tile, window)


spmm_block_slabs_windowed.launches = 0   # K2 launches since the last reset
spmm_block_slabs_windowed.launches_by_instance = dict.fromkeys(
    GATHER_INSTANCES, 0)


def _declare_k2(lib: ctypes.CDLL) -> None:
    declare_common(lib)
    lib.spmm_windowed_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.spmm_windowed_smem_bytes.restype = ctypes.c_longlong
    lib.spmm_windowed_ctas_per_sm.argtypes = [ctypes.c_int] * 4
    lib.spmm_windowed_ctas_per_sm.restype = ctypes.c_int
    lib.spmm_windowed_launch.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
           ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
           ctypes.c_void_p])
    lib.spmm_windowed_launch.restype = ctypes.c_int


def _launch_windowed(colidx, values, rowloc, out_row, x, n_rows: int,
                     f_tile: int, window: int) -> torch.Tensor:
    B, C = colidx.shape
    R = out_row.shape[1]
    N, F = x.shape
    out = torch.zeros((n_rows, F), dtype=torch.float32, device=x.device)
    if B == 0 or F == 0 or n_rows == 0 or N == 0:
        return out
    if C >= _MAX_SORT_FIELD or R >= _MAX_SORT_FIELD:
        raise ValueError(f"K2 sorts slots by a key with 16-bit slot and row "
                         f"fields; C={C} and R={R} must be below "
                         f"{_MAX_SORT_FIELD}")
    instance = gather_instance(x, f_tile)
    lib = load_kernel("spmm_windowed", _declare_k2)
    check_launch("K2", lib.spmm_windowed_smem_bytes(C, R, f_tile), B, F,
                 f_tile)
    launch_on_stream(
        "K2", lib, lib.spmm_windowed_launch, spmm_block_slabs_windowed, x,
        colidx.data_ptr(), values.data_ptr(), rowloc.data_ptr(),
        out_row.data_ptr(), x.data_ptr(), out.data_ptr(),
        B, C, R, F, n_rows, f_tile, window, int(instance == "bulk"),
        instance=instance)
    return out
