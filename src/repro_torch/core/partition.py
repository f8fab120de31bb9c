"""Accel-GCN workload partitioning (paper §III-C, Algorithms 1 and 2).

Two partitioners are provided:

* ``warp_level_partition`` — the GNNAdvisor-style fixed non-zero-group
  baseline the paper compares against (one metadata record per warp).
* ``block_level_partition`` — the paper's contribution: a pattern table
  (Algorithm 1) decides, per row degree, how many rows share one block and
  how many non-zeros each workload unit ("warp") takes; a single O(n) pass
  (Algorithm 2) then emits one 128-bit metadata record *per block*.

Pattern modes:

* ``mode="paper"`` — Algorithm 1 verbatim: enumerate the factors of
  ``max_block_warps``; degree ``d`` is handled by the smallest factor ``f``
  with ``f * max_warp_nzs >= d`` using ``block_rows = max_block_warps / f``
  and ``warp_nzs = ceil(d / f)``.
* ``mode="tpu"`` — the TPU re-parameterization (DESIGN.md §2): the block is a
  fixed-capacity VMEM slab of ``C = deg_bound`` non-zeros and the pattern
  packs ``block_rows = clamp(C // d, 1, max_rows)`` rows densely.  There is
  no warp-granularity constraint on TPU, so slab utilization improves from
  ``d / next_factor_quantum(d)`` to ``>= 1 - (d-1)/C``.

Both modes share the same metadata format and the same Algorithm-2 emission
loop, so every downstream consumer (the torch twins, the CUDA block-slab
kernel) is mode-agnostic.

Either mode accepts an explicit per-degree ``warp_nzs_override`` vector (the
upstream kernel's "v1..v5 workload" knob): entry ``d`` caps how many
non-zeros one workload unit takes for rows of degree ``d``.  Overrides are
validated against Algorithm 1's admissibility guard — some factor ``f`` of
``max_block_warps`` must satisfy ``f * warp_nzs[d] >= d``, which reduces to
``max_block_warps * warp_nzs[d] >= d`` — so every admissible override still
covers each row with one block and the kernels stay oblivious.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import CSRGraph, _concat_ranges

__all__ = [
    "PartitionPatterns",
    "BlockPartition",
    "WarpPartition",
    "get_partition_patterns",
    "validate_warp_nzs_override",
    "block_level_partition",
    "warp_level_partition",
    "pack_slabs",
    "balance_stats",
    "metadata_bytes",
]


# ---------------------------------------------------------------------------
# Algorithm 1 — pattern table
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PartitionPatterns:
    """Per-degree partition patterns for degrees 1 .. deg_bound INCLUSIVE.

    ``block_rows[d]`` rows of degree ``d`` share one block; each of the
    ``factor[d]`` workload units covers ``warp_nzs[d]`` non-zeros of a row.

    The boundary degree ``d == deg_bound`` is pattern-eligible: Algorithm 1
    admits any ``d`` with ``f * max_warp_nzs >= d`` for some factor ``f`` of
    ``max_block_warps``, and ``f = max_block_warps`` satisfies exactly
    ``max_block_warps * max_warp_nzs = deg_bound >= d``. Only ``d >
    deg_bound`` overflows a block's slab capacity and must split.
    """

    max_block_warps: int
    max_warp_nzs: int
    deg_bound: int
    block_rows: np.ndarray  # int32[deg_bound + 1]
    warp_nzs: np.ndarray    # int32[deg_bound + 1]
    factor: np.ndarray      # int32[deg_bound + 1]
    mode: str


def _factors(n: int) -> List[int]:
    return [f for f in range(1, n + 1) if n % f == 0]


def validate_warp_nzs_override(
    max_block_warps: int,
    max_warp_nzs: int,
    warp_nzs_override: Sequence[int],
) -> np.ndarray:
    """Validate a per-degree warp_nzs vector against Algorithm 1's guard.

    Accepts a vector of length ``deg_bound`` (entries for degrees 1 ..
    deg_bound) or ``deg_bound + 1`` (index 0 ignored). Every entry must be
    an integer with ``1 <= warp_nzs[d] <= max_warp_nzs`` and satisfy the
    admissibility guard ``max_block_warps * warp_nzs[d] >= d`` (i.e. SOME
    factor ``f`` of ``max_block_warps`` has ``f * warp_nzs[d] >= d``, so
    degree ``d`` still fits one block).  Returns the normalized int64 table
    indexed 0 .. deg_bound; raises ``ValueError`` otherwise.
    """
    deg_bound = max_block_warps * max_warp_nzs
    arr = np.asarray(warp_nzs_override)
    if arr.ndim != 1 or len(arr) not in (deg_bound, deg_bound + 1):
        raise ValueError(
            f"warp_nzs override must be a 1-D vector of length {deg_bound} "
            f"(degrees 1..deg_bound) or {deg_bound + 1} (index 0 ignored); "
            f"got shape {arr.shape}")
    if not np.issubdtype(arr.dtype, np.integer):
        if not np.all(np.isfinite(arr)) or np.any(arr != np.floor(arr)):
            raise ValueError("warp_nzs override entries must be integers")
    arr = arr.astype(np.int64)
    if len(arr) == deg_bound:
        arr = np.concatenate(([0], arr))
    d = np.arange(1, deg_bound + 1, dtype=np.int64)
    wnz = arr[1:]
    bad = (wnz < 1) | (wnz > max_warp_nzs) | (max_block_warps * wnz < d)
    if bad.any():
        offenders = d[bad][:8].tolist()
        raise ValueError(
            f"inadmissible warp_nzs override at degrees {offenders}"
            f"{'...' if int(bad.sum()) > 8 else ''}: need 1 <= warp_nzs[d] "
            f"<= max_warp_nzs={max_warp_nzs} and max_block_warps * "
            f"warp_nzs[d] >= d (max_block_warps={max_block_warps})")
    return arr


def get_partition_patterns(
    max_block_warps: int,
    max_warp_nzs: int,
    mode: str = "paper",
    max_rows_per_block: int | None = None,
    warp_nzs_override: Optional[Sequence[int]] = None,
) -> PartitionPatterns:
    """Algorithm 1: build the degree -> (block_rows, warp_nzs) table.

    The table covers degrees 1 .. deg_bound inclusive: ``f *
    max_warp_nzs >= d`` holds at ``d == deg_bound`` with ``f =
    max_block_warps``, so the boundary degree is one ordinary pattern block
    (block_rows=1, warp_nzs=max_warp_nzs), not a split row.

    ``warp_nzs_override`` (validated by :func:`validate_warp_nzs_override`)
    replaces the derived per-degree warp_nzs cap: in paper mode, degree ``d``
    takes the smallest factor ``f`` with ``f * warp_nzs_override[d] >= d``
    (the default table is exactly ``warp_nzs_override[d] == max_warp_nzs``
    everywhere); in tpu mode the per-block non-zero budget becomes
    ``warp_nzs_override[d] * max_block_warps`` instead of the full slab.
    Lower entries trade slab density for more, smaller blocks.
    """
    deg_bound = max_block_warps * max_warp_nzs
    block_rows = np.zeros(deg_bound + 1, dtype=np.int32)
    warp_nzs = np.zeros(deg_bound + 1, dtype=np.int32)
    factor = np.zeros(deg_bound + 1, dtype=np.int32)
    override = None
    if warp_nzs_override is not None:
        override = validate_warp_nzs_override(
            max_block_warps, max_warp_nzs, warp_nzs_override)

    if mode == "paper":
        factors = _factors(max_block_warps)
        if override is None:
            i = 0
            deg = 1
            # Verbatim transcription of Algorithm 1 (inclusive upper bound:
            # the guard admits deg_bound itself via the largest factor).
            while deg <= deg_bound:
                if factors[i] * max_warp_nzs >= deg:
                    block_rows[deg] = max_block_warps // factors[i]
                    warp_nzs[deg] = math.ceil(deg / factors[i])
                    factor[deg] = factors[i]
                    deg += 1
                else:
                    i += 1
        else:
            # Same guard with the per-degree cap; admissibility guarantees
            # the largest factor always qualifies, so the scan terminates.
            for deg in range(1, deg_bound + 1):
                f = next(fc for fc in factors
                         if fc * int(override[deg]) >= deg)
                block_rows[deg] = max_block_warps // f
                warp_nzs[deg] = math.ceil(deg / f)
                factor[deg] = f
    elif mode == "tpu":
        # Dense VMEM-slab packing: as many rows as fit the slab, capped so
        # the one-hot segment matmul operand stays MXU-sized.  An override
        # shrinks the per-block non-zero budget below the full slab.
        cap = max_rows_per_block or max_block_warps
        for deg in range(1, deg_bound + 1):
            budget = (deg_bound if override is None
                      else int(override[deg]) * max_block_warps)
            br = max(1, min(cap, budget // deg))
            block_rows[deg] = br
            warp_nzs[deg] = deg  # one unit per row on TPU
            factor[deg] = 1
    else:
        raise ValueError(f"unknown pattern mode {mode!r}")

    return PartitionPatterns(
        max_block_warps=max_block_warps,
        max_warp_nzs=max_warp_nzs,
        deg_bound=deg_bound,
        block_rows=block_rows,
        warp_nzs=warp_nzs,
        factor=factor,
        mode=mode,
    )


# ---------------------------------------------------------------------------
# Algorithm 2 — block emission
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BlockPartition:
    """Block-level partition of a degree-sorted CSR matrix.

    ``meta`` mirrors the paper's int4 (4 x int32 = 128-bit) record per block:
      meta[:, 0] = deg   (row degree; for split blocks the full row degree)
      meta[:, 1] = loc   (starting non-zero offset)
      meta[:, 2] = row   (starting row id, in degree-sorted order)
      meta[:, 3] = info  (deg <= bound: warp_nzs << 16 | n_rows;
                          deg >  bound: non-zeros assigned to this block)
    Unpacked convenience arrays are kept alongside.
    """

    meta: np.ndarray        # int32[B, 4]
    n_rows_blk: np.ndarray  # int32[B] rows this block produces output for
    nnz_blk: np.ndarray     # int32[B] non-zeros this block consumes
    is_split: np.ndarray    # bool[B]  part of a row with deg > deg_bound
    patterns: PartitionPatterns
    n_rows: int
    nnz: int

    @property
    def num_blocks(self) -> int:
        return len(self.meta)


def block_level_partition(g: CSRGraph, patterns: PartitionPatterns) -> BlockPartition:
    """Algorithm 2: one pass over degree-sorted rows, emit per-block metadata.

    ``g`` must already be degree-sorted (rows with equal degree adjacent);
    this is asserted cheaply. Complexity O(n + B).
    """
    deg = np.diff(g.rowptr).astype(np.int64)
    n = g.n_rows
    bound = patterns.deg_bound

    recs: List[Tuple[int, int, int, int, int, int, bool]] = []
    r = 0
    while r < n:
        d = int(deg[r])
        if d == 0:  # empty rows produce no work; outputs stay zero
            r += 1
            continue
        if d <= bound:
            # pattern-eligible (Algorithm 1 admits d == bound via the
            # largest factor: one row per block, slab filled exactly);
            # run length of this degree class (degree-sorted => contiguous)
            r_end = r
            while r_end < n and deg[r_end] == d:
                r_end += 1
            br = int(patterns.block_rows[d])
            wnz = int(patterns.warp_nzs[d])
            rows_remaining = r_end - r
            row = r
            while rows_remaining > 0:
                take = min(br, rows_remaining)
                loc = int(g.rowptr[row])
                info = (wnz << 16) | take
                recs.append((d, loc, row, info, take, take * d, False))
                row += take
                rows_remaining -= take
            r = r_end
        else:
            # Row degree EXCEEDS a block's capacity (d > bound): split
            # across blocks with revisit-accumulation in the kernels.
            loc = int(g.rowptr[r])
            remaining = d
            while remaining > 0:
                take_nz = min(bound, remaining)
                recs.append((d, loc, r, take_nz, 1, take_nz, True))
                loc += take_nz
                remaining -= take_nz
            r += 1

    if recs:
        arr = np.array([rec[:4] for rec in recs], dtype=np.int64)
        meta = np.empty((len(recs), 4), dtype=np.int32)
        meta[:, 0] = np.minimum(arr[:, 0], np.iinfo(np.int32).max)
        meta[:, 1:] = arr[:, 1:].astype(np.int32)
        n_rows_blk = np.array([rec[4] for rec in recs], dtype=np.int32)
        nnz_blk = np.array([rec[5] for rec in recs], dtype=np.int32)
        is_split = np.array([rec[6] for rec in recs], dtype=bool)
    else:
        meta = np.zeros((0, 4), dtype=np.int32)
        n_rows_blk = np.zeros(0, dtype=np.int32)
        nnz_blk = np.zeros(0, dtype=np.int32)
        is_split = np.zeros(0, dtype=bool)

    return BlockPartition(
        meta=meta,
        n_rows_blk=n_rows_blk,
        nnz_blk=nnz_blk,
        is_split=is_split,
        patterns=patterns,
        n_rows=n,
        nnz=g.nnz,
    )


# ---------------------------------------------------------------------------
# Baseline: warp-level partition (GNNAdvisor-style non-zero groups)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class WarpPartition:
    """Fixed NZ-group partition: one record {row, col_off, len} per warp.

    The paper notes each 96-bit record pads to 128 bits on a 128-bit bus,
    which is what ``metadata_bytes`` accounts for.
    """

    meta: np.ndarray  # int32[W, 3] (row, loc, len)
    ng_size: int
    n_rows: int
    nnz: int

    @property
    def num_warps(self) -> int:
        return len(self.meta)


def warp_level_partition(g: CSRGraph, ng_size: int = 32) -> WarpPartition:
    deg = np.diff(g.rowptr).astype(np.int64)
    groups_per_row = np.ceil(deg / ng_size).astype(np.int64)
    total = int(groups_per_row.sum())
    meta = np.empty((total, 3), dtype=np.int32)
    w = 0
    for r in range(g.n_rows):
        lo, hi = int(g.rowptr[r]), int(g.rowptr[r + 1])
        for s in range(lo, hi, ng_size):
            meta[w] = (r, s, min(ng_size, hi - s))
            w += 1
    return WarpPartition(meta=meta, ng_size=ng_size, n_rows=g.n_rows, nnz=g.nnz)


# ---------------------------------------------------------------------------
# Kernel-side packed slabs
# ---------------------------------------------------------------------------
def pack_slabs(
    g: CSRGraph, bp: BlockPartition, R: int | None = None
) -> Dict[str, np.ndarray]:
    """Materialize fixed-capacity per-block slabs for the slab kernels.

    Returns dict with, for B = num_blocks, C = deg_bound, R = max rows/block:
      colidx  int32[B, C]  column index per slab slot (0 for padding)
      values  f32[B, C]    non-zero value per slot (0 for padding)
      rowloc  int32[B, C]  local output row per slot (R-1 sentinel on padding
                           with value 0, so padded lanes contribute nothing)
      out_row int32[B, R]  global output row per local row (n sentinel = drop)
      R, C                 python ints
    Every non-zero lands in exactly one slab slot.

    ``R`` may be forced wider than this partition strictly needs — incremental
    plan repair packs just the dirty block range with the FULL plan's R so the
    spliced slabs stay rectangular (and the rowloc/out_row sentinels match the
    untouched blocks bit for bit).
    """
    B = bp.num_blocks
    C = bp.patterns.deg_bound
    need = int(bp.n_rows_blk.max()) if B else 1
    if R is None:
        R = need
    elif R < need:
        raise ValueError(f"forced R={R} < max rows/block {need}")
    if B == 0:
        return {"colidx": np.zeros((0, C), dtype=np.int32),
                "values": np.zeros((0, C), dtype=np.float32),
                "rowloc": np.full((0, C), R - 1 if R > 0 else 0,
                                  dtype=np.int32),
                "out_row": np.full((0, R), bp.n_rows, dtype=np.int32),
                "R": R, "C": C}

    # Fully vectorized: block b's non-zeros live at CSR offsets
    # [loc_b, loc_b + nnz_b). A padded (B, C) gather + validity mask
    # replaces the per-block python loop — slot j of block b reads CSR
    # offset loc_b + j when j < nnz_b, else keeps the pad value.
    loc = bp.meta[:, 1].astype(np.int64)
    slot = np.arange(C, dtype=np.int32)[None, :]
    valid = slot < bp.nnz_blk[:, None]
    idx = np.minimum(loc[:, None] + slot, max(g.nnz - 1, 0))
    colidx = np.where(valid, g.colidx[idx], 0).astype(np.int32, copy=False)
    values = np.where(valid, g.values[idx], np.float32(0)).astype(
        np.float32, copy=False)
    # local output row per slot: slot j of a pattern block of degree d
    # serves local row j // d; split blocks emit a single local row 0
    d = np.maximum(bp.meta[:, 0], 1)[:, None]
    local = np.where(bp.is_split[:, None], 0, slot // d)
    rowloc = np.where(valid, local, R - 1).astype(np.int32, copy=False)
    # global output row per local row: row_b + arange(n_rows_blk_b)
    slot_r = np.arange(R, dtype=np.int32)[None, :]
    valid_r = slot_r < bp.n_rows_blk[:, None]
    out_row = np.where(valid_r, bp.meta[:, 2][:, None] + slot_r,
                       bp.n_rows).astype(np.int32, copy=False)
    return {"colidx": colidx, "values": values, "rowloc": rowloc,
            "out_row": out_row, "R": R, "C": C}


# ---------------------------------------------------------------------------
# Structural metrics (paper Eq. 1, Fig. 4(d)/(e) analogues)
# ---------------------------------------------------------------------------
def metadata_bytes(p) -> int:
    """Metadata footprint: 128 bits per record for both schemes (paper §III-C)."""
    if isinstance(p, BlockPartition):
        return 16 * p.num_blocks
    if isinstance(p, WarpPartition):
        return 16 * p.num_warps  # 96-bit record padded to the 128-bit bus
    raise TypeError(type(p))


def balance_stats(p) -> Dict[str, float]:
    """Workload balance: fraction of issue slots doing useful work.

    warp-level: each warp owns ``ng_size`` slots; block-level: each block owns
    ``deg_bound`` slab slots (the paper's max_block_warps x max_warp_nzs).
    """
    if isinstance(p, WarpPartition):
        slots = p.num_warps * p.ng_size
        return {
            "records": p.num_warps,
            "slots": float(slots),
            "utilization": p.nnz / slots if slots else 1.0,
            "metadata_bytes": float(metadata_bytes(p)),
        }
    if isinstance(p, BlockPartition):
        slots = p.num_blocks * p.patterns.deg_bound
        # Paper-mode blocks only *reserve* block_rows*warp_nzs*factor slots;
        # report both the reserved-slot and slab-capacity utilization.
        reserved = int(
            np.sum(np.where(p.is_split, p.nnz_blk,
                            p.n_rows_blk.astype(np.int64)
                            * (p.meta[:, 3] >> 16).astype(np.int64)
                            * p.patterns.factor[np.minimum(p.meta[:, 0],
                                                           p.patterns.deg_bound)]))
        )
        return {
            "records": p.num_blocks,
            "slots": float(slots),
            "utilization": p.nnz / slots if slots else 1.0,
            "reserved_slots": float(reserved),
            "reserved_utilization": p.nnz / reserved if reserved else 1.0,
            "metadata_bytes": float(metadata_bytes(p)),
        }
    raise TypeError(type(p))
