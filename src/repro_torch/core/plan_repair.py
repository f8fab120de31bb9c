"""Incremental partition-plan repair for streaming edge updates.

A :class:`~repro_torch.core.plan_cache.PartitionPlan` is expensive because of the
python-loop stages (Algorithm 2 block emission, slab packing) that walk every
row and block. An edge delta touches few rows — but a naive "rebuild the
dirty degree classes" repair degenerates on power-law graphs: one touched
degree-5 row dirties the entire degree-5 class (often a third of the graph),
so class-granular repair falls back to a full rebuild for even 0.1% deltas.

:func:`repair_plan` instead repairs at **stable output positions**. Every
kernel backend adds block outputs into the rows the plan's ``out_row`` slab
names (K1-K3 drop a slot whose ``out_row`` is the sentinel ``n``), so
neither block ORDER nor the monotonicity of output positions matters to the
SpMM result — only that each row's non-zeros land in some block whose
``out_row`` names that row's position. That licenses:

1. keep the old permutation verbatim: every row keeps its output position,
   ``inv_perm`` is reused by reference (touched rows' positions become
   output *slots*, not sort ranks);
2. MASK instead of rewrite: rewriting every touched row's slots to the
   drop sentinel ``n`` (an O(B x R) vectorized lookup over ``out_row``
   alone) deletes the row's old edges from the SpMM output without
   touching ``colidx``/``values``/``rowloc`` — untouched rows sharing the
   same blocks keep their lanes, so there is no re-emission amplification,
   and the lookup works unchanged on already-repaired plans (chained
   repairs need no extra bookkeeping);
3. re-emit ONLY the touched rows (not their blocks' cohabitants): build a
   degree-sorted sub-CSR of just those rows, run
   ``block_level_partition`` + ``pack_slabs`` over it with ``block_rows``
   clamped to the old plan's R (so the slabs stay rectangular with
   matching sentinels), then remap the sub plan's local ``out_row``
   indices to the rows' stable global positions;
4. splice = append: the big [B, C] slabs are concatenated with
   ``torch.cat`` on the plan's device (the old blocks survive
   byte-for-byte, dead lanes silenced purely through the patched
   ``out_row``), the re-emitted blocks ride behind. Only ``out_row``
   ([B, R]) is copied to the host, for the mask. The appended blocks come
   from ``pack_slabs``, so in every block the live slots' ``rowloc`` stays
   non-decreasing, which the kernels' slot-order walk relies on.

The repaired plan is **SpMM-output-identical** to a fresh
``build_partition_plan`` on the post-delta graph, and byte-identical to the
plan the reference package's ``repair_plan`` makes from the same plan and
delta.
It is NOT bit-identical: untouched rows keep their old positions, so the
degree-sort order degrades gradually under churn — a performance property,
restored by the periodic full-rebuild fallbacks below. After a repair,
``partition.meta[:, 1]`` (nnz offset) and ``meta[:, 2]`` (start row) are no
longer globally meaningful; nothing consumes them after packing (kernels
read only the slabs; ``balance_stats`` reads ``meta[:, 0]``/``[:, 3]``,
which stay valid).

Fallbacks to a full rebuild (``PlanVersion.repaired == False``):

* the re-emitted row set exceeds ``churn_threshold`` of the rows (repair
  would cost about as much as the rebuild it replaces);
* block fragmentation: chained repairs accumulate partial blocks (each
  repair emits its own short tail blocks); when the block count drifts past
  2x the fresh-build estimate the slab footprint justifies re-compacting.

Every repair/rebuild stamps ``plan.version = old.version + 1`` — the
monotone version chain the cache publish / directory invalidation /
``mutate()`` path is built on.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from .graph import CSRGraph, csr_apply_edge_delta, _concat_ranges
from .partition import BlockPartition, block_level_partition, pack_slabs
from .plan_cache import (PartitionPlan, _stage, build_partition_plan,
                         graph_content_hash)

__all__ = ["EdgeDelta", "PlanVersion", "repair_plan", "apply_and_repair",
           "delta_chain_hash"]


def _arr(x, dtype) -> np.ndarray:
    return (np.zeros(0, dtype=dtype) if x is None
            else np.asarray(x, dtype=dtype).ravel())


@dataclasses.dataclass
class EdgeDelta:
    """A batched edge mutation: deletes apply first, then inserts.

    ``on_duplicate`` / ``on_missing`` carry the
    :func:`~repro_torch.core.graph.csr_apply_edge_delta` policies with the delta,
    so the serving ``mutate()`` path and the tests share one semantics
    end to end. ``"replace"``/``"ignore"`` are the forgiving streaming
    policies; the strict defaults surface caller bugs.
    """

    insert_src: np.ndarray = None
    insert_dst: np.ndarray = None
    insert_val: Optional[np.ndarray] = None
    delete_src: np.ndarray = None
    delete_dst: np.ndarray = None
    on_duplicate: str = "error"
    on_missing: str = "error"

    def __post_init__(self):
        self.insert_src = _arr(self.insert_src, np.int64)
        self.insert_dst = _arr(self.insert_dst, np.int64)
        self.delete_src = _arr(self.delete_src, np.int64)
        self.delete_dst = _arr(self.delete_dst, np.int64)
        if self.insert_val is not None:
            self.insert_val = _arr(self.insert_val, np.float32)
            if len(self.insert_val) != len(self.insert_src):
                raise ValueError(
                    f"{len(self.insert_val)} insert values for "
                    f"{len(self.insert_src)} insert edges")
        if len(self.insert_src) != len(self.insert_dst):
            raise ValueError(f"{len(self.insert_src)} insert src for "
                             f"{len(self.insert_dst)} dst")
        if len(self.delete_src) != len(self.delete_dst):
            raise ValueError(f"{len(self.delete_src)} delete src for "
                             f"{len(self.delete_dst)} dst")

    @property
    def n_inserts(self) -> int:
        return len(self.insert_src)

    @property
    def n_deletes(self) -> int:
        return len(self.delete_src)

    @property
    def size(self) -> int:
        return self.n_inserts + self.n_deletes

    def touched_rows(self) -> np.ndarray:
        """Sorted unique row ids whose degree or content the delta touches."""
        return np.unique(np.concatenate([self.insert_src, self.delete_src]))

    def apply(self, g: CSRGraph) -> CSRGraph:
        """The post-delta graph (``g`` is never mutated)."""
        return csr_apply_edge_delta(
            g,
            insert_src=self.insert_src, insert_dst=self.insert_dst,
            insert_val=self.insert_val,
            delete_src=self.delete_src, delete_dst=self.delete_dst,
            on_duplicate=self.on_duplicate, on_missing=self.on_missing)


@dataclasses.dataclass
class PlanVersion:
    """One link of a graph's plan chain: the plan plus how it was produced."""

    plan: PartitionPlan
    version: int
    repaired: bool        # False = fell back to a full rebuild
    reason: str           # why (repair scope, or the fallback trigger)
    dirty_rows: int = 0   # rows re-partitioned (repair path only)
    reused_blocks: int = 0
    rebuilt_blocks: int = 0


def delta_chain_hash(parent_hash: str, delta: "EdgeDelta") -> str:
    """Content key of the graph ``delta`` produces from the graph keyed by
    ``parent_hash`` — in O(delta) instead of O(nnz).

    ``graph_content_hash`` walks every edge; on the streaming mutation path
    that re-hash would rival the repair itself. Chaining
    ``H(parent || delta)`` keeps the plan key collision-resistant and — the
    property multihost convergence rests on — DETERMINISTIC: every host
    applies the same delta sequence to the same base, so every host derives
    the same key without exchanging anything beyond the deltas. A chained
    key no longer equals ``graph_content_hash(g_new)``, which only means a
    from-scratch registration of identical content starts a fresh lineage.
    """
    h = hashlib.blake2b(parent_hash.encode(), digest_size=16)
    for a in (delta.insert_src, delta.insert_dst, delta.delete_src,
              delta.delete_dst):
        h.update(a.tobytes())
    h.update(b"" if delta.insert_val is None else delta.insert_val.tobytes())
    h.update(f"{delta.on_duplicate}|{delta.on_missing}".encode())
    return h.hexdigest()


def _rebuild(plan: PartitionPlan, g_new: CSRGraph, reason: str,
             graph_hash: Optional[str] = None) -> PlanVersion:
    new = build_partition_plan(g_new, plan.config, graph_hash=graph_hash,
                               device=plan.device)
    new.version = plan.version + 1
    return PlanVersion(plan=new, version=new.version, repaired=False,
                       reason=reason, dirty_rows=g_new.n_rows,
                       rebuilt_blocks=new.num_blocks)


def _min_blocks(deg: np.ndarray, patterns, R: int) -> int:
    """Lower bound on the block count a fresh build (with block_rows clamped
    to ``R``) would emit for row degrees ``deg`` — the fragmentation
    yardstick. Per pattern class d: ceil(count_d / block_rows_d); per split
    row (d > bound): ceil(d / bound) chunks."""
    bound = patterns.deg_bound
    low = deg[(deg > 0) & (deg <= bound)]
    total = 0
    if len(low):
        cnt = np.bincount(low, minlength=bound + 1)
        br = np.maximum(np.minimum(
            patterns.block_rows.astype(np.int64), R), 1)
        total += int(np.sum(-(-cnt[1:] // br[1:])))
    high = deg[deg > bound]
    if len(high):
        total += int(np.sum(-(-high // bound)))
    return total


def repair_plan(plan: PartitionPlan, g_old: CSRGraph, g_new: CSRGraph,
                touched_rows, *,
                churn_threshold: float = 0.25,
                graph_hash: Optional[str] = None) -> PlanVersion:
    """Repair ``plan`` (built for ``g_old``) into a plan for ``g_new``.

    ``touched_rows`` names every row whose degree OR edge content differs
    between the two graphs (``EdgeDelta.touched_rows()``); rows outside it
    must be identical in both. Both graphs are in ORIGINAL row order.
    Returns a :class:`PlanVersion` whose plan produces the same SpMM output
    as ``build_partition_plan(g_new, plan.config)`` — via stable-position
    block splicing when the dirty block set is small, via an actual full
    rebuild otherwise.

    ``graph_hash`` supplies the new plan's content key (usually a
    :func:`delta_chain_hash`) so the O(nnz) re-hash stays off the repair
    path; omitted, ``graph_content_hash(g_new)`` is computed here.
    """
    n = plan.n_rows
    if g_old.n_rows != n or g_new.n_rows != n:
        raise ValueError(
            f"row count changed: plan={n} old={g_old.n_rows} "
            f"new={g_new.n_rows} (deltas never resize the matrix)")
    if g_old.n_cols != g_new.n_cols:
        raise ValueError(f"n_cols changed: {g_old.n_cols} -> {g_new.n_cols}")
    if g_old.nnz != plan.nnz:
        raise ValueError(
            f"plan was built for nnz={plan.nnz}, g_old has {g_old.nnz}")

    touched = np.unique(_arr(touched_rows, np.int64))
    if len(touched) and (touched[0] < 0 or touched[-1] >= n):
        raise ValueError(f"touched rows outside [0, {n})")

    if graph_hash is None:
        graph_hash = graph_content_hash(g_new)

    if not len(touched):
        # empty delta: same graph, same arrays — just advance the version
        new = dataclasses.replace(
            plan, key=(graph_hash, plan.config),
            version=plan.version + 1)
        return PlanVersion(plan=new, version=new.version, repaired=True,
                           reason="empty delta",
                           reused_blocks=plan.num_blocks)

    if len(touched) > churn_threshold * max(n, 1):
        return _rebuild(
            plan, g_new,
            f"churn {len(touched)}/{n} rows > threshold {churn_threshold}",
            graph_hash=graph_hash)

    bp = plan.partition
    pats = bp.patterns
    R_old = int(plan.slabs["R"])
    deg_new = np.diff(g_new.rowptr).astype(np.int64)

    # row -> stable output position (kept verbatim; see module docstring)
    inv_old = plan.inv_perm.cpu().numpy().astype(np.int64, copy=False)

    # MASK the touched rows out of every block they occupy: a lane whose
    # out_row slot is the drop sentinel contributes nothing to segment_sum,
    # so pointing a row's slots at ``n`` deletes its old edges from the
    # output without touching colidx/values/rowloc. Untouched rows of the
    # same block keep their slots — no re-emission amplification.
    old_out_row = plan.slabs["out_row"].cpu().numpy()
    touched_pos = np.zeros(n + 1, dtype=bool)  # slot n = drop sentinel
    touched_pos[inv_old[touched]] = True
    dead = touched_pos[old_out_row]
    patched_out = np.where(dead, np.int32(n), old_out_row).astype(
        np.int32, copy=False)
    masked_blocks = int(dead.any(axis=1).sum())

    # re-emit ONLY the touched rows (empty rows emit nothing), appended as
    # fresh blocks from a degree-sorted sub-CSR
    sub_rows = touched[deg_new[touched] > 0]
    sub_rows = sub_rows[np.lexsort((sub_rows, deg_new[sub_rows]))]
    degs = deg_new[sub_rows]
    total = int(degs.sum())
    sub_rowptr = np.zeros(len(sub_rows) + 1, dtype=np.int64)
    np.cumsum(degs, out=sub_rowptr[1:])
    gather = _concat_ranges(g_new.rowptr[sub_rows], degs, total)
    # columns stay GLOBAL: SpMM's dense operand is the full feature matrix,
    # so sub-slabs index it directly — no column remap on splice
    sub_g = CSRGraph(sub_rowptr, g_new.colidx[gather],
                     g_new.values[gather], g_new.n_cols)
    clamped = dataclasses.replace(
        pats, block_rows=np.minimum(
            pats.block_rows, np.int32(max(R_old, 1))))
    sub_bp = block_level_partition(sub_g, clamped)
    sub_slabs = pack_slabs(sub_g, sub_bp, R=R_old)

    reused = bp.num_blocks
    rebuilt = sub_bp.num_blocks
    if reused + rebuilt > 2 * _min_blocks(deg_new, pats, R_old) + 16:
        # chained repairs accumulate appended blocks and dead lanes; once
        # the count drifts past 2x a fresh build's, re-compact
        return _rebuild(
            plan, g_new,
            f"fragmentation {reused + rebuilt} blocks after repair",
            graph_hash=graph_hash)

    # remap the sub plan's local row indices to stable global positions
    pos_map = inv_old[sub_rows].astype(np.int32)
    n_sub = len(sub_rows)
    if n_sub:
        sub_out_row = np.where(
            sub_slabs["out_row"] == n_sub, np.int32(n),
            pos_map[np.minimum(sub_slabs["out_row"], n_sub - 1)]
        ).astype(np.int32)
    else:
        sub_out_row = sub_slabs["out_row"]  # (0, R) — nothing to remap
    sub_meta = sub_bp.meta.copy()
    if len(sub_meta):
        sub_meta[:, 1] = -1  # sub-CSR nnz offsets are meaningless globally
        sub_meta[:, 2] = pos_map[sub_meta[:, 2]]

    # splice: every old block survives verbatim (dead lanes masked via
    # patched_out), re-emitted blocks appended — block order is irrelevant,
    # every kernel adds through out_row. The big [B, C] slabs are
    # concatenated ON DEVICE; only out_row ([B, R], an order of magnitude
    # smaller) ever visits the host, for the mask.
    C = int(plan.slabs["C"])
    dev = plan.device
    sub = _stage({k: sub_slabs[k] for k in ("colidx", "values", "rowloc")},
                 dev)
    slabs = {k: torch.cat([plan.slabs[k], sub[k]])
             for k in ("colidx", "values", "rowloc")}
    slabs.update(_stage(
        {"out_row": np.concatenate([patched_out, sub_out_row])}, dev))
    slabs["R"], slabs["C"] = R_old, C

    new_bp = BlockPartition(
        meta=np.concatenate([bp.meta, sub_meta]),
        n_rows_blk=np.concatenate([bp.n_rows_blk, sub_bp.n_rows_blk]),
        nnz_blk=np.concatenate([bp.nnz_blk, sub_bp.nnz_blk]),
        is_split=np.concatenate([bp.is_split, sub_bp.is_split]),
        patterns=pats, n_rows=n, nnz=g_new.nnz)

    row_of = np.repeat(np.arange(n, dtype=np.int64), deg_new)
    coo = _stage({"coo_row": row_of,
                  "coo_col": np.asarray(g_new.colidx, dtype=np.int64),
                  "coo_val": np.asarray(g_new.values, dtype=np.float32)},
                 dev)
    new_plan = PartitionPlan(
        key=(graph_hash, plan.config),
        n_rows=n, n_cols=g_new.n_cols, nnz=g_new.nnz,
        slabs=slabs,
        inv_perm=plan.inv_perm,  # positions are stable: shared by reference
        partition=new_bp,
        version=plan.version + 1,
        **coo,
    )
    return PlanVersion(
        plan=new_plan, version=new_plan.version, repaired=True,
        reason=f"masked {len(touched)} row(s) across {masked_blocks} "
               f"block(s), re-emitted {rebuilt} block(s)",
        dirty_rows=len(touched), reused_blocks=reused,
        rebuilt_blocks=rebuilt)


def apply_and_repair(plan: PartitionPlan, g_old: CSRGraph, delta: EdgeDelta,
                     *, churn_threshold: float = 0.25
                     ) -> Tuple[CSRGraph, PlanVersion]:
    """Apply ``delta`` to ``g_old`` and repair ``plan`` to match, in one
    step (the serving mutation path's workhorse). The new plan is keyed by
    :func:`delta_chain_hash` (O(delta)); a caller that wants the O(nnz)
    content key calls :func:`repair_plan` with ``graph_hash=None``."""
    g_new = delta.apply(g_old)
    pv = repair_plan(plan, g_old, g_new, delta.touched_rows(),
                     churn_threshold=churn_threshold,
                     graph_hash=delta_chain_hash(plan.graph_hash, delta))
    return g_new, pv
