"""The Table I graph analogues and their normalisations, frozen here so that
no change to the program can move the benchmark's data.

``power_law_graph`` is a copy of the program's Table I generator as it
stood when the benchmark was defined: out-degrees ~ zipf(alpha) rescaled to
the edge count, endpoints drawn with a quadratic rank skew and then
permuted. The result is a CSR multigraph (duplicate edges kept), rows in
id order and each row's columns in the order drawn. ``gcn_normalize`` is
Kipf & Welling's D^-1/2 (A + I) D^-1/2; ``row_normalize`` is D^-1 A without
self-loops, the mean aggregator of GraphSAGE.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# (rowptr int64[n+1], colidx int64[nnz], values float32[nnz])
CSR = Tuple[np.ndarray, np.ndarray, np.ndarray]


def power_law_graph(n: int, m_edges: int, seed: int,
                    alpha: float = 1.8) -> CSR:
    """A power-law multigraph of ``n`` nodes and ``m_edges`` edges, unit
    values, from ``seed``."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(alpha, n).astype(np.float64)
    deg = np.maximum(1, np.round(raw * (m_edges / raw.sum()))).astype(np.int64)
    diff = int(deg.sum() - m_edges)
    if diff > 0:
        idx = rng.choice(n, size=diff, replace=True, p=deg / deg.sum())
        np.subtract.at(deg, idx, 1)
        deg = np.maximum(deg, 0)
    elif diff < 0:
        idx = rng.integers(0, n, size=-diff)
        np.add.at(deg, idx, 1)
    n_e = int(deg.sum())
    src = np.repeat(np.arange(n), deg)
    u = rng.random(n_e)
    dst = np.minimum((n * u ** 2.0).astype(np.int64), n - 1)
    dst = rng.permutation(n)[dst]
    # CSR from the edge list: a stable sort by source (already sorted, as
    # ``repeat`` emits sources in order) keeps each row's draw order
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    rowptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=rowptr[1:])
    return rowptr, dst.astype(np.int64), np.ones(n_e, dtype=np.float32)


def gcn_normalize(g: CSR) -> CSR:
    """D^-1/2 (A + I) D^-1/2: a self-loop appended to every row, values
    scaled by the inverse square roots of both endpoints' degrees, the
    degree counted with the self-loop, in float64 and rounded once."""
    rowptr, colidx, values = g
    n = len(rowptr) - 1
    deg = np.diff(rowptr)
    new_rowptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg + 1, out=new_rowptr[1:])
    nnz = len(colidx) + n
    new_col = np.empty(nnz, dtype=np.int64)
    new_val = np.empty(nnz, dtype=np.float32)
    # old entry k of row r moves to new_rowptr[r] + (k - rowptr[r])
    row_of = np.repeat(np.arange(n, dtype=np.int64), deg)
    dst = new_rowptr[:-1][row_of] + (np.arange(len(colidx)) - rowptr[:-1][row_of])
    new_col[dst] = colidx
    new_val[dst] = values
    loop = new_rowptr[1:] - 1
    new_col[loop] = np.arange(n)
    new_val[loop] = 1.0
    d = np.diff(new_rowptr).astype(np.float64)
    dinv = np.zeros(n)
    dinv[d > 0] = 1.0 / np.sqrt(d[d > 0])
    rows = np.repeat(np.arange(n), np.diff(new_rowptr))
    vals = new_val.astype(np.float64) * dinv[rows] * dinv[new_col]
    return new_rowptr, new_col, vals.astype(np.float32)


def row_normalize(g: CSR) -> CSR:
    """D^-1 A: each row's values divided by the row's entry count (the
    mean over its neighbours, duplicates counted), no self-loops."""
    rowptr, colidx, values = g
    deg = np.diff(rowptr)
    inv = np.zeros(len(deg))
    inv[deg > 0] = 1.0 / deg[deg > 0]
    vals = values.astype(np.float64) * np.repeat(inv, deg)
    return rowptr, colidx, vals.astype(np.float32)


NORMALIZATIONS = {"gcn": gcn_normalize, "row": row_normalize}
