"""Plain PyTorch oracles for the slab SpMM.

Ground truth for the kernel tests: simple, obviously-correct formulations
with no tiling, padding or layout tricks. They are test oracles and never
run on the serving path.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["csr_spmm_ref", "slab_spmm_ref"]


def csr_spmm_ref(rowptr: np.ndarray, colidx: np.ndarray, values: np.ndarray,
                 x: torch.Tensor, *, nnz_chunk: Optional[int] = None
                 ) -> torch.Tensor:
    """CSR SpMM oracle: ``out[r] = sum_k values[k] * x[colidx[k]]`` over the
    non-zeros k of row r, as COO expansion + ``index_add_`` on ``x``'s
    device, in fp32 (fp64 when ``x`` is fp64). ``nnz_chunk`` bounds how many
    non-zeros are gathered at once, so the oracle also runs on graphs whose
    ``[nnz, F]`` gather would not fit; chunks are summed in CSR order."""
    n = len(rowptr) - 1
    dtype = torch.promote_types(x.dtype, torch.float32)
    out = torch.zeros((n, x.shape[1]), dtype=dtype, device=x.device)
    nnz = len(colidx)
    if nnz == 0:
        return out
    row_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(rowptr))
    step = nnz_chunk or nnz
    xf = x.to(dtype)
    for lo in range(0, nnz, step):
        hi = min(nnz, lo + step)
        rows = torch.as_tensor(row_of[lo:hi], device=x.device)
        cols = torch.as_tensor(np.asarray(colidx[lo:hi], dtype=np.int64),
                               device=x.device)
        vals = torch.as_tensor(np.asarray(values[lo:hi]), dtype=dtype,
                               device=x.device)
        out.index_add_(0, rows, vals[:, None] * xf[cols])
    return out


def slab_spmm_ref(colidx: torch.Tensor, values: torch.Tensor,
                  rowloc: torch.Tensor, out_row: torch.Tensor,
                  x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Oracle for the slab layout (the kernel's math step by step, with a
    one-hot reduction into the R local rows of each block).

    colidx/values/rowloc: [B, C]; out_row: [B, R]; x: [N, F].
    """
    B, C = colidx.shape
    R = out_row.shape[1]
    gathered = values[..., None].float() * x[colidx.long()].float()   # [B, C, F]
    onehot = torch.nn.functional.one_hot(rowloc.long(), R).float()   # [B, C, R]
    slab_out = torch.einsum("bcr,bcf->brf", onehot, gathered)          # [B, R, F]
    out = torch.zeros((n_rows + 1, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, out_row.reshape(B * R).long(),
                   slab_out.reshape(B * R, -1))
    return out[:n_rows]
