"""Slab-dict wrappers around K1 and the portable PyTorch twin.

Like the reference package, the slab SpMM has three callables:
  * ``spmm_accel``   — K1, the CUDA kernel (its plain version on CPU tensors)
  * ``spmm_blocked`` — a PyTorch twin with the *same* slab layout and the
                       one-hot block reduction of the reference's jnp twin
  * oracle           — in ref.py (layout-free ground truth)
"""
from __future__ import annotations

import torch

from .spmm_accel import spmm_block_slabs

__all__ = ["spmm_accel", "spmm_blocked"]

# elements of the [blocks, C, F] gather the twin materialises at once
_BLOCKED_CHUNK_ELEMS = 1 << 25


def spmm_accel(slabs, x, n_rows):
    """K1 over one slab dict; returns ``[n_rows, F]`` in slab row order."""
    return spmm_block_slabs(
        slabs["colidx"], slabs["values"], slabs["rowloc"], slabs["out_row"],
        x, n_rows)


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
