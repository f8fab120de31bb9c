"""Slab-dict wrappers around the kernels and the portable PyTorch twins.

Like the reference package (``src/repro/kernels/ops.py``), the slab SpMM has
these callables:
  * ``spmm_accel``           — K1, the CUDA kernel, with no routing check
  * ``spmm_pallas``          — K1 after the router's resident check (raises
                               ``VmemBudgetError`` past the resident
                               threshold, as the reference does)
  * ``spmm_pallas_windowed`` — K2, the row-window kernel
  * ``spmm_pallas_hbm``      — K3, the HBM-gather kernel
  * ``spmm_auto``            — routed: resident / windowed / hbm chosen by
                               ``router.route_spmm`` from the feature shape
  * ``spmm_blocked``         — a PyTorch twin with the *same* slab layout and
                               the one-hot block reduction of the reference's
                               jnp twin
  * ``spmm_batched``         — several graphs fused into one dispatch
  * oracle                   — in ref.py (layout-free ground truth)

The grouped GEMM has two:
  * ``grouped_matmul_pallas``  — K4, the CUDA kernel
  * ``grouped_matmul_blocked`` — the PyTorch twin: per-block weight pick and
                                 a dense fp32 product

Every kernel takes its plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from .grouped_matmul import grouped_matmul, grouped_matmul_plain
from .router import assert_resident_fits, resident_window_rows, route_spmm
from .spmm_accel import spmm_block_slabs, spmm_block_slabs_windowed
from .spmm_hbm import spmm_block_slabs_hbm

__all__ = ["spmm_accel", "spmm_pallas", "spmm_pallas_windowed",
           "spmm_pallas_hbm", "spmm_auto", "spmm_blocked", "spmm_batched",
           "grouped_matmul_pallas", "grouped_matmul_blocked"]

# elements of the [blocks, C, F] gather the twin materialises at once
_BLOCKED_CHUNK_ELEMS = 1 << 25


def spmm_batched(slab_list, x_list, n_rows_list, *, backend="accel",
                 pad_blocks_to=None, return_decision=False):
    """Fused multi-graph SpMM (one kernel launch for the whole batch); see
    ``kernels/spmm_batched.py::spmm_batched`` for the backends."""
    from .spmm_batched import spmm_batched as _batched
    return _batched(slab_list, x_list, n_rows_list, backend=backend,
                    pad_blocks_to=pad_blocks_to,
                    return_decision=return_decision)


def _slab_args(slabs):
    return (slabs["colidx"], slabs["values"], slabs["rowloc"],
            slabs["out_row"])


def spmm_accel(slabs, x, n_rows):
    """K1 over one slab dict; returns ``[n_rows, F]`` in slab row order."""
    return spmm_block_slabs(*_slab_args(slabs), x.float().contiguous(),
                            n_rows)


def spmm_pallas(slabs, x, n_rows):
    """The resident regime forced: raises ``VmemBudgetError`` past the
    reference's resident threshold (N_pad <= 4096 at fp32), then runs K1."""
    assert_resident_fits(int(x.shape[0]), int(x.shape[1]), int(slabs["C"]),
                         int(slabs["R"]), itemsize=x.element_size())
    return spmm_accel(slabs, x, n_rows)


def spmm_pallas_windowed(slabs, x, n_rows, *, window_rows=None):
    """K2; the default window follows the caller's dtype, as the
    reference's does (4096 rows at fp32, 8192 at bf16)."""
    window = window_rows or resident_window_rows(128, x.element_size())
    return spmm_block_slabs_windowed(*_slab_args(slabs),
                                     x.float().contiguous(), n_rows,
                                     window_rows=window)


def spmm_pallas_hbm(slabs, x, n_rows):
    """K3: X stays in device memory and each block gathers its rows."""
    return spmm_block_slabs_hbm(*_slab_args(slabs), x.float().contiguous(),
                                n_rows)


def spmm_auto(slabs, x, n_rows, *, return_decision=False):
    """Routed single-graph dispatch: resident / windowed / hbm chosen from
    the feature-operand shape and the caller's dtype itemsize (see
    ``router.route_spmm``); the kernels compute in fp32 either way."""
    decision = route_spmm(
        int(x.shape[0]), int(x.shape[1]),
        int(slabs["C"]), int(slabs["R"]), itemsize=x.element_size())
    fn = {"resident": spmm_pallas, "windowed": spmm_pallas_windowed,
          "hbm": spmm_pallas_hbm}[decision.backend]
    out = fn(slabs, x, n_rows)
    return (out, decision) if return_decision else out


def spmm_blocked(colidx, values, rowloc, out_row, x, n_rows):
    """PyTorch twin of the slab kernel: identical slab math with a one-hot
    ``[R, C] @ [C, F]`` reduction per block, chunked over blocks to bound
    the gathered intermediate."""
    B, C = colidx.shape
    R = out_row.shape[1]
    F = x.shape[1]
    out = torch.zeros((n_rows + 1, F), dtype=torch.float32, device=x.device)
    xf = x.float()
    chunk = max(1, _BLOCKED_CHUNK_ELEMS // max(1, C * max(F, R)))
    for lo in range(0, B, chunk):
        hi = min(B, lo + chunk)
        gathered = values[lo:hi, :, None].float() * xf[colidx[lo:hi].long()]
        onehot = torch.nn.functional.one_hot(rowloc[lo:hi].long(), R).float()
        slab_out = torch.einsum("bcr,bcf->brf", onehot, gathered)
        out.index_add_(0, out_row[lo:hi].reshape(-1).long(),
                       slab_out.reshape(-1, F))
    return out[:n_rows]


def grouped_matmul_pallas(x, w, block_expert, **tiles):
    """K4 (``m_tile``, ``k_tile``, ``n_tile`` as the reference's)."""
    return grouped_matmul(x, w, block_expert, **tiles)


def grouped_matmul_blocked(x, w, block_expert, m_tile: int = 128):
    """PyTorch twin: per-block weight pick + dense fp32 product."""
    return grouped_matmul_plain(x, w, block_expert, m_tile)
