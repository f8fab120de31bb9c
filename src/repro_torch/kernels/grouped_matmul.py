"""Grouped (expert-blocked) matmul for the MoE block dispatch (K4): the CUDA
kernel, its wrapper and its plain PyTorch version.

Token->expert dispatch is a sparse aggregation with power-law "expert
degrees", the workload shape Accel-GCN targets, and ``models/moe.py``
applies the paper's recipe to it: degree-sort the (token, slot) rows by
expert, pad each expert's run to ``m_tile``-row blocks with one int32 of
metadata (its expert id) per block, and multiply every block by its
expert's weights. Every block has identical work: the balance the paper's
Algorithm 2 gives the SpMM.

K4 (``csrc/grouped_matmul.cu``) replaces the Pallas TPU kernel
``repro.kernels.grouped_matmul._gmm_kernel``
(``src/repro/kernels/grouped_matmul.py:33``), whose weight BlockSpec reads
the scalar-prefetched block expert ids. On the card each CTA reads its
block's expert id once and takes the expert's weights from it. K4 has two
instances, chosen by ``_instance`` from the operands' dtypes, shapes,
``m_tile`` and alignment alone, before the launch:

* ``"wgmma"`` for bf16 x and w with K % 8 == 0, N % 8 == 0,
  m_tile % 64 == 0 and 16-byte aligned bases (the MoE path at every
  registered width): TMA loads into a shared-memory ring and ``wgmma``
  tensor-core products with fp32 accumulators, CTAs ordered so that one
  expert's row blocks share each weight tile in L2. A bf16 x bf16 product
  is exact in fp32, so this computes the reference's function, in another
  summation order; its bound is the 989 TFLOP/s bf16 tensor-core rate at
  prefill and the weights' bytes at decode;
* ``"simt"`` for every other input (fp32 or mixed operands, whose products
  tensor cores would round; odd K or N; other m_tile): the CUDA cores,
  staging x and w tiles through shared memory as fp32 and accumulating
  each output with fmaf over K in order.

The output is fp32 either way.

The plain version is ``ops.grouped_matmul_blocked``'s math: a per-block
weight pick and a dense fp32 product, taken here one run of consecutive
same-expert blocks at a time so each expert's weights are cast once.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .build import load_kernel

__all__ = ["grouped_matmul", "grouped_matmul_in_range",
           "grouped_matmul_plain"]

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID = 2**31 - 1
_INSTANCES = {"simt": 0, "wgmma": 1}

_launch_lock = threading.Lock()


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                         block_expert: torch.Tensor,
                         m_tile: int = 128) -> torch.Tensor:
    """Plain PyTorch version of K4: ``out[b-th m_tile rows] = x[those rows]
    @ w[block_expert[b]]`` in fp32, one dense product per run of
    consecutive blocks with the same expert."""
    M = x.shape[0]
    out = torch.empty((M, w.shape[2]), dtype=torch.float32, device=x.device)
    be = block_expert.tolist()
    nb = len(be)
    lo = 0
    while lo < nb:
        hi = lo + 1
        while hi < nb and be[hi] == be[lo]:
            hi += 1
        rows = slice(lo * m_tile, hi * m_tile)
        out[rows] = x[rows].float() @ w[be[lo]].float()
        lo = hi
    return out


def check_grouped(x, w, block_expert, m_tile: int, k_tile: int,
                  n_tile: int) -> None:
    """Raise on what K4 does not take. The shape checks are the
    reference's assertions (``grouped_matmul.py:69, :73``), as
    ``ValueError``."""
    for name, t in (("x", x), ("w", w), ("block_expert", block_expert)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)!r}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_matmul runs on cuda or cpu, got "
                         f"{x.device}")
    for name, t in (("x", x), ("w", w), ("block_expert", block_expert)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 2 or w.dim() != 3 or block_expert.dim() != 1:
        raise ValueError(f"need x [M, K], w [E, K, N], block_expert [M // "
                         f"m_tile]; got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(block_expert.shape)}")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"x and w must be float32 or bfloat16, got {x.dtype} "
                        f"and {w.dtype}")
    if block_expert.dtype != torch.int32:
        raise TypeError(f"block_expert must be int32, got "
                        f"{block_expert.dtype}")
    M, K = x.shape
    _, K2, N = w.shape
    if m_tile < 1 or K != K2 or M % m_tile:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} need "
                         f"equal K and M % m_tile == 0 (m_tile={m_tile})")
    if block_expert.shape[0] != M // m_tile:
        raise ValueError(f"block_expert has {block_expert.shape[0]} entries "
                         f"for {M // m_tile} row blocks")
    kt, nt = min(k_tile, K), min(n_tile, N)
    if kt < 1 or nt < 1 or K % kt or N % nt:
        raise ValueError(f"K={K} and N={N} must be multiples of k_tile={kt} "
                         f"and n_tile={nt}")


def grouped_matmul(
    x: torch.Tensor,             # [M, K] rows sorted + padded by expert
    w: torch.Tensor,             # [E, K, N]
    block_expert: torch.Tensor,  # int32[M // m_tile], each in [0, E)
    *,
    m_tile: int = 128,
    k_tile: int = 512,
    n_tile: int = 128,
) -> torch.Tensor:
    """Block-balanced grouped GEMM; returns ``[M, N]`` fp32.

    ``k_tile`` and ``n_tile`` are the reference kernel's tiles: they only
    decide which shapes are taken (``K % min(k_tile, K) == 0``,
    ``N % min(n_tile, N) == 0``), as the reference's assertions do; K4 tiles
    the card its own way. CUDA tensors launch K4 on the current stream; CPU
    tensors take the plain version. There is no fallback between the two.
    An expert id outside ``[0, E)`` raises ``ValueError`` on either device.
    """
    check_grouped(x, w, block_expert, m_tile, k_tile, n_tile)
    E = w.shape[0]
    if block_expert.numel() and bool(((block_expert < 0)
                                      | (block_expert >= E)).any()):
        raise ValueError(f"block_expert holds expert ids outside [0, {E})")
    return _run(x, w, block_expert, m_tile)


grouped_matmul.launches = 0   # K4 launches since the caller last reset it
# the same launches by instance; a caller resets both
grouped_matmul.launches_by_instance = {"wgmma": 0, "simt": 0}


def _instance(x: torch.Tensor, w: torch.Tensor, m_tile: int) -> str:
    """Which K4 instance takes these operands: ``"wgmma"`` (tensor cores)
    when x and w are both bf16, K and N are multiples of 8 (TMA needs
    16-byte row strides), ``m_tile`` is a multiple of 64 (a 64-row
    warpgroup tile never spans two blocks), M fits TMA's int32 row
    coordinate and both bases are 16-byte aligned; else ``"simt"``. A
    function of dtypes, shapes, m_tile and alignment only: never of a
    failed build or launch."""
    M, K = x.shape
    N = w.shape[2]
    if (x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
            and K % 8 == 0 and N % 8 == 0 and m_tile % 64 == 0
            and M < 2**31 and x.data_ptr() % 16 == 0
            and w.data_ptr() % 16 == 0):
        return "wgmma"
    return "simt"


def grouped_matmul_in_range(x, w, block_expert, *, m_tile: int = 128,
                            k_tile: int = 512,
                            n_tile: int = 128) -> torch.Tensor:
    """``grouped_matmul`` for a caller that builds ``block_expert`` in
    ``[0, E)`` itself, as ``moe_block`` does by clipping: the same checks
    but the range one, which costs a device sync."""
    check_grouped(x, w, block_expert, m_tile, k_tile, n_tile)
    return _run(x, w, block_expert, m_tile)


def _run(x, w, block_expert, m_tile: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, block_expert, m_tile)
    return _launch(x, w, block_expert, m_tile)


def _declare(lib: ctypes.CDLL) -> None:
    lib.grouped_matmul_error_string.argtypes = [ctypes.c_int]
    lib.grouped_matmul_error_string.restype = ctypes.c_char_p
    lib.grouped_matmul_ctas.argtypes = [ctypes.c_int, ctypes.c_longlong,
                                        ctypes.c_int, ctypes.c_longlong]
    lib.grouped_matmul_ctas.restype = ctypes.c_longlong
    lib.grouped_matmul_launch.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
           ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
        + [ctypes.c_int, ctypes.c_void_p])
    lib.grouped_matmul_launch.restype = ctypes.c_int


def load_grouped_matmul() -> ctypes.CDLL:
    """K4's library, built on first use, with its C interface declared."""
    return load_kernel("grouped_matmul", _declare)


def _launch(x, w, block_expert, m_tile: int) -> torch.Tensor:
    M, K = x.shape
    E, _, N = w.shape
    nb = M // m_tile
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0:
        return out
    instance = _instance(x, w, m_tile)
    lib = load_grouped_matmul()
    n_ctas = lib.grouped_matmul_ctas(_INSTANCES[instance], nb, m_tile, N)
    if n_ctas > _MAX_GRID:
        raise ValueError(f"K4 ({instance}): {n_ctas} CTAs for {nb} row "
                         f"blocks exceed the grid limit")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.grouped_matmul_launch(
            x.data_ptr(), w.data_ptr(), block_expert.data_ptr(),
            out.data_ptr(), int(x.dtype == torch.bfloat16),
            int(w.dtype == torch.bfloat16), E, nb, m_tile, K, N,
            _INSTANCES[instance], stream)
    if err != 0:
        raise RuntimeError(f"K4 ({instance}) launch failed: "
                           f"{lib.grouped_matmul_error_string(err).decode()}")
    with _launch_lock:
        grouped_matmul.launches += 1
        grouped_matmul.launches_by_instance[instance] += 1
    return out
