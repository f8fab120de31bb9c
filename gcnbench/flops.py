"""Operations and bytes of the cells' work, counted from shapes.

Model FLOPs of a layer ``d_in -> d_out`` over ``n`` nodes and ``nnz``
entries of A':

* ``gcn``: ``h W`` is 2 n d_in d_out, ``A' (h W)`` is 2 nnz d_out;
* ``sage``: ``A h`` is 2 nnz d_in, ``(A h) W`` and ``h W_self`` are
  2 n d_in d_out each.

A training step adds the backward: each dense product once more for its
weight's gradient and once more for its input's gradient, and each
aggregation once more (``A'^T g``) for its input's gradient. The first
layer's input is the raw features, whose gradient nobody needs: its dense
products count twice, not three times, and an aggregation of the raw
features (SAGE's first) once. Bias, ReLU and the loss are left out.

The bytes an aggregation ``A' @ X`` needs are its CSR read once (rowptr,
colidx and values, 4 bytes an element), X read once and Y written once,
in fp32.
"""
from __future__ import annotations

from typing import List


def layer_flops(variant: str, n: int, nnz: int, d_in: int, d_out: int,
                train: bool, first: bool) -> float:
    dense = 2.0 * n * d_in * d_out
    if variant == "gcn":
        # A'(hW): hW needs its gradient (for W) in every layer
        dense_n, aggr = 1, 2.0 * nnz * d_out
        aggr_w = 2 if train else 1
    elif variant == "sage":
        dense_n, aggr = 2, 2.0 * nnz * d_in
        aggr_w = 2 if train and not first else 1
    else:
        raise ValueError(f"unknown variant {variant!r}")
    dense_w = (2 if first else 3) if train else 1
    return dense_n * dense * dense_w + aggr * aggr_w


def model_flops(variant: str, dims: List[int], n: int, nnz: int,
                train: bool) -> float:
    """FLOPs of one forward pass (``train=False``) or one training step."""
    return sum(layer_flops(variant, n, nnz, a, b, train, i == 0)
               for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])))


def aggregation_bytes(n_rows: int, n_cols: int, nnz: int, f: int) -> float:
    """Bytes ``A @ X`` needs: the CSR once, X once, Y once (fp32, int32)."""
    return 4.0 * ((n_rows + 1) + 2 * nnz + n_cols * f + n_rows * f)
