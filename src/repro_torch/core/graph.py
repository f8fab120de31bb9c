"""Graph containers and O(n) preprocessing from Accel-GCN §III-C.

Everything here is *host-side* preprocessing (numpy), mirroring the paper's
lightweight on-the-fly stages: degree computation, counting-sort degree
sorting, and GCN symmetric normalization. The outputs feed the partitioner
(`core/partition.py`) and the SpMM backends (`core/spmm.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "CSRGraph",
    "degrees_from_rowptr",
    "counting_sort_by_degree",
    "degree_sort_csr",
    "gcn_normalize",
    "csr_from_edges",
    "csr_apply_edge_delta",
    "csr_transpose",
]


@dataclasses.dataclass
class CSRGraph:
    """A CSR sparse matrix (adjacency) with optional edge values.

    ``rowptr``: int32[n_rows+1], ``colidx``: int32[nnz], ``values``:
    float32[nnz] (defaults to ones). ``perm`` records the degree-sort row
    permutation applied (new_row -> old_row), identity if unsorted.
    """

    rowptr: np.ndarray
    colidx: np.ndarray
    values: np.ndarray
    n_cols: int
    perm: Optional[np.ndarray] = None  # new_row -> old_row

    @property
    def n_rows(self) -> int:
        return len(self.rowptr) - 1

    @property
    def nnz(self) -> int:
        return int(self.rowptr[-1])

    @property
    def degrees(self) -> np.ndarray:
        return degrees_from_rowptr(self.rowptr)

    def validate(self) -> None:
        assert self.rowptr.ndim == 1 and self.colidx.ndim == 1
        assert self.rowptr[0] == 0 and self.rowptr[-1] == len(self.colidx)
        assert np.all(np.diff(self.rowptr) >= 0), "rowptr must be monotone"
        if self.nnz:
            assert self.colidx.min() >= 0 and self.colidx.max() < self.n_cols
        assert len(self.values) == len(self.colidx)

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n_rows, self.n_cols), dtype=self.values.dtype)
        for r in range(self.n_rows):
            lo, hi = self.rowptr[r], self.rowptr[r + 1]
            np.add.at(out[r], self.colidx[lo:hi], self.values[lo:hi])
        return out


def degrees_from_rowptr(rowptr: np.ndarray) -> np.ndarray:
    """Row degrees from the CSR row pointer — step (1) of degree sorting."""
    return np.diff(rowptr).astype(np.int64)


def counting_sort_by_degree(degrees: np.ndarray) -> np.ndarray:
    """Stable counting sort of row ids by ASCENDING degree. O(n + max_deg).

    The paper sorts rows so identical degrees are adjacent; stability keeps
    original order within a degree class (paper §III-C step 2). Returns the
    permutation ``perm`` with ``perm[k]`` = original row id of the k-th sorted
    row. Ascending order groups the small-degree rows (many rows per block)
    first; descending works equally — the partitioner only needs grouping.
    """
    n = len(degrees)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    max_deg = int(degrees.max())
    counts = np.zeros(max_deg + 2, dtype=np.int64)
    np.add.at(counts, degrees + 1, 1)
    starts = np.cumsum(counts)[:-1]  # first slot of each degree class
    perm = np.empty(n, dtype=np.int64)
    # Vectorized stable placement: rows are scanned in original order; the slot
    # for row i is starts[deg[i]] + (#rows with same degree before i).
    order_within = _rank_within_class(degrees)
    perm[starts[degrees] + order_within] = np.arange(n)
    return perm


def _rank_within_class(keys: np.ndarray) -> np.ndarray:
    """rank_within_class[i] = number of j<i with keys[j]==keys[i]. O(n)."""
    # argsort(kind="stable") on small ints is counting-based in numpy; we keep
    # a pure O(n) fallback for clarity and determinism.
    n = len(keys)
    seen = {}
    out = np.empty(n, dtype=np.int64)
    # This python loop is O(n) with tiny constants; used only at preprocessing
    # time. For large graphs we switch to the vectorized variant below.
    if n > 200_000:
        order = np.argsort(keys, kind="stable")
        ranks = np.empty(n, dtype=np.int64)
        sorted_keys = keys[order]
        grp_start = np.concatenate(([0], np.flatnonzero(np.diff(sorted_keys)) + 1))
        idx_in_grp = np.arange(n) - np.repeat(grp_start, np.diff(np.concatenate((grp_start, [n]))))
        ranks[order] = idx_in_grp
        return ranks
    for i, k in enumerate(keys):
        c = seen.get(int(k), 0)
        out[i] = c
        seen[int(k)] = c + 1
    return out


def degree_sort_csr(g: CSRGraph) -> CSRGraph:
    """Degree-sort a CSR matrix: permute rows so equal degrees are adjacent.

    Steps mirror the paper: (1) degrees from rowptr, (2) stable counting sort,
    (3) rebuild rowptr/colidx in the new order. Total O(n + nnz).
    """
    deg = degrees_from_rowptr(g.rowptr)
    perm = counting_sort_by_degree(deg)
    new_deg = deg[perm]
    new_rowptr = np.zeros(g.n_rows + 1, dtype=np.int64)
    np.cumsum(new_deg, out=new_rowptr[1:])
    # Gather each row's slice. Vectorized via fancy indexing on ranges.
    nnz = g.nnz
    src_starts = g.rowptr[perm]
    gather = _concat_ranges(src_starts, new_deg, nnz)
    out = CSRGraph(
        rowptr=new_rowptr.astype(np.int64),
        colidx=g.colidx[gather],
        values=g.values[gather],
        n_cols=g.n_cols,
        perm=perm,
    )
    return out


def _concat_ranges(starts: np.ndarray, lengths: np.ndarray, total: int) -> np.ndarray:
    """Indices equivalent to concatenate([arange(s, s+l) for s, l in zip(...)])."""
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    ends = np.cumsum(lengths)
    # O(total) via repeat (searchsorted would add a log factor)
    base = np.repeat(np.asarray(starts, dtype=np.int64) - (ends - lengths),
                     lengths)
    return base + np.arange(total, dtype=np.int64)


def gcn_normalize(g: CSRGraph, add_self_loops: bool = True) -> CSRGraph:
    """Symmetric GCN normalization A' = D^-1/2 (A + I) D^-1/2 (Kipf-Welling)."""
    if add_self_loops:
        g = _add_self_loops(g)
    deg = degrees_from_rowptr(g.rowptr).astype(np.float64)
    # Weighted degree for normalization uses the value sums; for unweighted
    # graphs this equals the structural degree.
    dinv = np.zeros(g.n_rows)
    nz = deg > 0
    dinv[nz] = 1.0 / np.sqrt(deg[nz])
    row_of = np.repeat(np.arange(g.n_rows), np.diff(g.rowptr))
    vals = g.values.astype(np.float64) * dinv[row_of] * dinv[g.colidx]
    return CSRGraph(g.rowptr, g.colidx, vals.astype(np.float32), g.n_cols, g.perm)


def _add_self_loops(g: CSRGraph) -> CSRGraph:
    assert g.n_rows == g.n_cols, "self loops need a square matrix"
    deg = np.diff(g.rowptr)
    new_rowptr = np.zeros(g.n_rows + 1, dtype=np.int64)
    np.cumsum(deg + 1, out=new_rowptr[1:])
    nnz = g.nnz + g.n_rows
    colidx = np.empty(nnz, dtype=g.colidx.dtype)
    values = np.empty(nnz, dtype=g.values.dtype)
    dst = _concat_ranges(new_rowptr[:-1], deg, g.nnz)
    colidx[dst] = g.colidx
    values[dst] = g.values
    loop_pos = new_rowptr[1:] - 1
    colidx[loop_pos] = np.arange(g.n_rows)
    values[loop_pos] = 1.0
    return CSRGraph(new_rowptr, colidx, values, g.n_cols, g.perm)


def csr_apply_edge_delta(
    g: CSRGraph,
    insert_src: Optional[np.ndarray] = None,
    insert_dst: Optional[np.ndarray] = None,
    insert_val: Optional[np.ndarray] = None,
    delete_src: Optional[np.ndarray] = None,
    delete_dst: Optional[np.ndarray] = None,
    *,
    on_duplicate: str = "error",
    on_missing: str = "error",
) -> CSRGraph:
    """Apply a batched edge delta to a CSR matrix — ONE delta semantics for
    every engine and test instead of hand-rolled CSR surgery.

    Deletes apply first, then inserts (so replace-an-edge-value is
    ``delete + insert`` in a single delta). The result is deterministic:
    within each row, surviving old edges keep their relative order and
    inserted edges append after them in the order given — which is what
    makes an incremental plan repair bit-identical to a full rebuild of the
    post-delta graph.

    Defined edge cases:

    * **duplicate insert** — the edge (after deletes) already exists, or the
      insert list names the same ``(src, dst)`` twice. ``on_duplicate=
      "error"`` (default) raises ``ValueError``; ``"replace"`` overwrites
      the existing value in place (degree unchanged; the LAST occurrence in
      the insert list wins).
    * **missing delete** — ``(src, dst)`` is not present. ``on_missing=
      "error"`` (default) raises ``ValueError``; ``"ignore"`` skips it.
      A delete of an edge the graph holds multiple copies of (builders do
      not dedup) removes EVERY copy.

    Inserts/deletes must name existing node ids (``0 <= src < n_rows``,
    ``0 <= dst < n_cols``) — a delta never grows the matrix shape, so
    feature shapes and in-flight requests stay valid across versions.
    ``insert_val`` defaults to ones. Returns a NEW graph (``perm=None``,
    original row order); ``g`` is never mutated. O(nnz + delta).
    """
    if on_duplicate not in ("error", "replace"):
        raise ValueError(f"on_duplicate must be error|replace, "
                         f"got {on_duplicate!r}")
    if on_missing not in ("error", "ignore"):
        raise ValueError(f"on_missing must be error|ignore, "
                         f"got {on_missing!r}")

    def _pair(name, src, dst):
        src = (np.zeros(0, dtype=np.int64) if src is None
               else np.asarray(src, dtype=np.int64).ravel())
        dst = (np.zeros(0, dtype=np.int64) if dst is None
               else np.asarray(dst, dtype=np.int64).ravel())
        if len(src) != len(dst):
            raise ValueError(f"{name}: {len(src)} src for {len(dst)} dst")
        if len(src):
            if src.min() < 0 or src.max() >= g.n_rows:
                raise ValueError(f"{name}: src out of range [0, {g.n_rows})")
            if dst.min() < 0 or dst.max() >= g.n_cols:
                raise ValueError(f"{name}: dst out of range [0, {g.n_cols})")
        return src, dst

    ins_src, ins_dst = _pair("insert", insert_src, insert_dst)
    del_src, del_dst = _pair("delete", delete_src, delete_dst)
    if insert_val is None:
        ins_val = np.ones(len(ins_src), dtype=np.float32)
    else:
        ins_val = np.asarray(insert_val, dtype=np.float32).ravel()
        if len(ins_val) != len(ins_src):
            raise ValueError(
                f"insert: {len(ins_val)} values for {len(ins_src)} edges")

    # (src, dst) pairs as scalar keys for vectorized membership tests
    n_cols = max(int(g.n_cols), 1)
    old_row = np.repeat(np.arange(g.n_rows, dtype=np.int64),
                        np.diff(g.rowptr))
    old_key = old_row * n_cols + g.colidx.astype(np.int64)

    keep = np.ones(g.nnz, dtype=bool)
    if len(del_src):
        del_key = del_src * n_cols + del_dst
        hit = np.isin(old_key, del_key)
        if on_missing == "error":
            missing = ~np.isin(del_key, old_key)
            if missing.any():
                i = int(np.flatnonzero(missing)[0])
                raise ValueError(
                    f"delete of missing edge ({int(del_src[i])}, "
                    f"{int(del_dst[i])}) (on_missing='error')")
        keep &= ~hit

    new_val = g.values.astype(np.float32, copy=True)
    if len(ins_src):
        ins_key = ins_src * n_cols + ins_dst
        uniq, first = np.unique(ins_key, return_index=True)
        surviving_key = old_key[keep]
        dup_old = np.isin(ins_key, surviving_key)
        if on_duplicate == "error":
            if len(uniq) != len(ins_key):
                dup = np.ones(len(ins_key), dtype=bool)
                dup[first] = False
                i = int(np.flatnonzero(dup)[0])
                raise ValueError(
                    f"duplicate insert of edge ({int(ins_src[i])}, "
                    f"{int(ins_dst[i])}) within the delta "
                    f"(on_duplicate='error')")
            if dup_old.any():
                i = int(np.flatnonzero(dup_old)[0])
                raise ValueError(
                    f"insert of existing edge ({int(ins_src[i])}, "
                    f"{int(ins_dst[i])}) (on_duplicate='error')")
        else:
            # replace: existing edges get the new value in place (LAST
            # occurrence wins, matching sequential single-edge application)
            if dup_old.any():
                surv_pos = np.flatnonzero(keep)
                order = np.argsort(surviving_key, kind="stable")
                for i in np.flatnonzero(dup_old):
                    j = np.searchsorted(surviving_key[order], ins_key[i])
                    # every surviving copy of the edge takes the new value
                    while (j < len(order)
                           and surviving_key[order[j]] == ins_key[i]):
                        new_val[surv_pos[order[j]]] = ins_val[i]
                        j += 1
            fresh = ~dup_old
            # dedup the delta itself: LAST occurrence of a repeated pair wins
            last = np.zeros(len(ins_key), dtype=bool)
            seen: dict = {}
            for i in range(len(ins_key) - 1, -1, -1):
                k = int(ins_key[i])
                if k not in seen:
                    seen[k] = True
                    last[i] = True
            fresh &= last
            ins_src, ins_dst = ins_src[fresh], ins_dst[fresh]
            ins_val = ins_val[fresh]

    # assemble: per row, surviving old edges first, then appended inserts
    surv_counts = np.bincount(old_row[keep], minlength=g.n_rows)
    ins_counts = np.bincount(ins_src, minlength=g.n_rows)
    new_deg = surv_counts + ins_counts
    new_rowptr = np.zeros(g.n_rows + 1, dtype=np.int64)
    np.cumsum(new_deg, out=new_rowptr[1:])
    nnz = int(new_rowptr[-1])
    colidx = np.empty(nnz, dtype=np.int64)
    values = np.empty(nnz, dtype=np.float32)

    surv_dst = _concat_ranges(new_rowptr[:-1], surv_counts, int(keep.sum()))
    colidx[surv_dst] = g.colidx[keep]
    values[surv_dst] = new_val[keep]
    if len(ins_src):
        order = np.argsort(ins_src, kind="stable")
        ins_starts = new_rowptr[:-1] + surv_counts
        ins_dst_pos = _concat_ranges(ins_starts, ins_counts, len(ins_src))
        colidx[ins_dst_pos] = ins_dst[order]
        values[ins_dst_pos] = ins_val[order]

    return CSRGraph(new_rowptr, colidx, values, g.n_cols)


def csr_transpose(g: CSRGraph) -> CSRGraph:
    """CSC view of ``g`` as a CSRGraph: row ``v`` of the result lists the
    rows of ``g`` that have an edge INTO ``v`` (the in-adjacency view the
    neighbor sampler walks). O(E) counting build, no sort.

    Within each transposed row the entries appear in ascending source-row
    order (the row-major CSR scan is stable), so transposing twice
    round-trips a canonically ordered CSR exactly. Edge values ride along
    unchanged; ``perm`` does not survive (the result is a different matrix).
    """
    n_rows_t = g.n_cols
    row_of = np.repeat(np.arange(g.n_rows, dtype=np.int64),
                       np.diff(g.rowptr))
    counts = np.bincount(g.colidx, minlength=n_rows_t)
    rowptr_t = np.zeros(n_rows_t + 1, dtype=np.int64)
    np.cumsum(counts, out=rowptr_t[1:])
    # slot of edge e = start of its destination's class + #earlier edges
    # with the same destination (stable placement, same trick as the
    # counting degree sort above)
    rank = _rank_within_class(np.asarray(g.colidx, dtype=np.int64))
    pos = rowptr_t[np.asarray(g.colidx, dtype=np.int64)] + rank
    colidx_t = np.empty(g.nnz, dtype=np.int64)
    values_t = np.empty(g.nnz, dtype=np.float32)
    colidx_t[pos] = row_of
    values_t[pos] = g.values
    return CSRGraph(rowptr_t, colidx_t, values_t, g.n_rows)


def csr_from_edges(src: np.ndarray, dst: np.ndarray, n: int,
                   values: Optional[np.ndarray] = None) -> CSRGraph:
    """Build CSR from a COO edge list (dedup not performed). O(E)."""
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    if values is None:
        values = np.ones(len(src), dtype=np.float32)
    else:
        values = values[order]
    counts = np.bincount(src, minlength=n)
    rowptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=rowptr[1:])
    return CSRGraph(rowptr, dst.astype(np.int64), values.astype(np.float32), n)
