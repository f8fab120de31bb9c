"""Partition-plan cache: amortize Accel-GCN preprocessing across requests.

The paper's block-level partition (§III-C) exists to cut per-inference
metadata overhead — but rebuilding the degree sort + pattern table + slab
packing on *every* call throws that win away in a serving setting where the
same graphs recur. This module factors the whole preprocessing pipeline into
a content-addressed :class:`PartitionPlan` and caches finished plans in an
LRU :class:`PlanCache` keyed by (graph content hash, partition config):

* ``graph_content_hash`` — blake2b over the CSR arrays (structure AND edge
  values), so A' and A'^T of the same graph, or the same topology with
  different normalization, get distinct plans;
* ``build_partition_plan`` — the one place the pipeline runs: degree sort ->
  Algorithm 1 pattern table -> Algorithm 2 block emission -> slab packing ->
  staging on the plan's device. Everything downstream (AccelSpMM, the
  batched multi-graph path, GraphServeEngine) consumes plans;
* ``PlanCache`` — LRU with hit/miss/eviction counters and a ``builds``
  counter tests and the serving engine use to assert "partitioned exactly
  once per distinct (graph, config)".

Plans live on one device. Entry points stage on ``cuda`` unless the caller
passes ``device="cpu"``; asking for CUDA on a machine without it raises.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .graph import CSRGraph, degree_sort_csr
from .partition import (
    BlockPartition,
    block_level_partition,
    get_partition_patterns,
    pack_slabs,
)

__all__ = [
    "PartitionConfig",
    "PartitionPlan",
    "PlanCache",
    "graph_content_hash",
    "build_partition_plan",
    "resolve_device",
]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            f"pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    """Static knobs that change the partition layout (part of the cache key).

    ``warp_nzs_table`` is a per-degree warp_nzs override (see
    ``partition.validate_warp_nzs_override``); ``None`` means the derived
    Algorithm-1 table. It is a tuple so configs stay hashable cache keys.
    """

    mode: str = "tpu"
    max_block_warps: int = 64
    max_warp_nzs: int = 4
    max_rows_per_block: Optional[int] = None
    warp_nzs_table: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.warp_nzs_table is not None and \
                not isinstance(self.warp_nzs_table, tuple):
            object.__setattr__(self, "warp_nzs_table",
                               tuple(int(v) for v in self.warp_nzs_table))

    @property
    def deg_bound(self) -> int:
        return self.max_block_warps * self.max_warp_nzs


def graph_content_hash(g: CSRGraph) -> str:
    """Content hash of a CSR matrix: shapes, structure and edge values.

    Two graphs with the same topology but different values (e.g. before and
    after GCN normalization) hash differently — the packed slabs differ.
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64([g.n_rows, g.n_cols, g.nnz]).tobytes())
    h.update(np.ascontiguousarray(g.rowptr, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(g.colidx, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(g.values, dtype=np.float32).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class PartitionPlan:
    """A finished, device-staged partition of one graph under one config.

    Immutable once built; shared freely between operators and serve batches.
    ``slabs`` holds the kernel inputs (colidx/values/rowloc/out_row as
    tensors on ``device`` plus python ints R, C); ``inv_perm`` undoes the
    degree sort so callers always see the ORIGINAL row order.
    """

    key: Tuple[str, PartitionConfig]
    n_rows: int
    n_cols: int
    nnz: int
    slabs: Dict
    inv_perm: torch.Tensor       # original row -> sorted position
    partition: BlockPartition
    coo_row: torch.Tensor
    coo_col: torch.Tensor
    coo_val: torch.Tensor
    # monotone stamp in a graph's plan chain (0 = first build; incremental
    # repair / mutation bumps it — see core/plan_repair.py). The content
    # hash in ``key`` still changes with every version: the version is the
    # lineage, the hash is the identity.
    version: int = 0

    @property
    def graph_hash(self) -> str:
        return self.key[0]

    @property
    def config(self) -> PartitionConfig:
        return self.key[1]

    @property
    def device(self) -> torch.device:
        return self.inv_perm.device

    @property
    def num_blocks(self) -> int:
        return int(self.slabs["colidx"].shape[0])

    def device_bytes(self) -> int:
        """Device footprint of the staged plan (for cache stats)."""
        tensors = [v for v in self.slabs.values()
                   if isinstance(v, torch.Tensor)]
        tensors += [self.inv_perm, self.coo_row, self.coo_col, self.coo_val]
        return sum(t.numel() * t.element_size() for t in tensors)


def _stage(arrays: Dict[str, np.ndarray], device: torch.device
           ) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def build_partition_plan(g: CSRGraph, cfg: PartitionConfig,
                         graph_hash: Optional[str] = None,
                         device: DeviceLike = None) -> PartitionPlan:
    """Run the full O(n) preprocessing pipeline once and stage the slabs,
    ``inv_perm`` and COO arrays as tensors on ``device``."""
    dev = resolve_device(device)
    g.validate()
    gs = degree_sort_csr(g)
    pats = get_partition_patterns(
        cfg.max_block_warps, cfg.max_warp_nzs, mode=cfg.mode,
        max_rows_per_block=cfg.max_rows_per_block,
        warp_nzs_override=cfg.warp_nzs_table)
    bp = block_level_partition(gs, pats)
    slabs_np = pack_slabs(gs, bp)
    slabs = _stage({k: v for k, v in slabs_np.items()
                    if isinstance(v, np.ndarray)}, dev)
    slabs["R"], slabs["C"] = slabs_np["R"], slabs_np["C"]

    inv_perm = np.empty(gs.n_rows, dtype=np.int64)
    inv_perm[gs.perm] = np.arange(gs.n_rows)

    # COO is cheap to keep and doubles as the baseline path
    row_of = np.repeat(np.arange(g.n_rows, dtype=np.int64), np.diff(g.rowptr))
    staged = _stage({"inv_perm": inv_perm, "coo_row": row_of,
                     "coo_col": np.asarray(g.colidx, dtype=np.int64),
                     "coo_val": np.asarray(g.values, dtype=np.float32)}, dev)
    return PartitionPlan(
        key=(graph_hash or graph_content_hash(g), cfg),
        n_rows=g.n_rows, n_cols=g.n_cols, nnz=g.nnz,
        slabs=slabs, partition=bp, **staged)


def _config_tag(cfg: PartitionConfig) -> str:
    """Stable short fingerprint of a PartitionConfig (part of spill names)."""
    h = hashlib.blake2b(repr(cfg).encode(), digest_size=8)
    return h.hexdigest()


class PlanCache:
    """LRU cache of :class:`PartitionPlan` keyed by (content hash, config).

    ``capacity`` counts plans, not bytes: partition metadata scales with nnz
    and serving workloads typically hold a small working set of graphs. All
    counters are monotone; ``stats()`` snapshots them. Every plan the cache
    builds or reloads is staged on ``device``.

    Thread safety: every lookup/insert/evict runs under one lock, so
    concurrent flush threads can share a cache. Builds are *single-flight*:
    parallel ``get_or_build`` of the same (graph, config) runs the O(n)
    partition pipeline exactly once — the first caller builds (one ``miss``
    + one ``build``), the rest wait on the in-flight build and then count as
    ``hits``. The build itself runs outside the cache lock, so distinct
    graphs still partition in parallel.

    Disk persistence (``save_dir``): evicted plans spill to
    ``<graph_hash>-<config_tag>.npz`` (content-hash-named — safe to share
    between processes serving the same graphs); a later miss reloads the
    spilled plan instead of re-running the partition pipeline. ``spills`` /
    ``disk_hits`` counters track both sides; a disk reload still counts as
    a ``miss`` but not as a ``build``.
    """

    def __init__(self, capacity: int = 32, save_dir: Optional[str] = None,
                 device: DeviceLike = None):
        if capacity < 1:
            raise ValueError("PlanCache capacity must be >= 1")
        self.capacity = capacity
        self.save_dir = save_dir
        self.device = resolve_device(device)
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
        self._plans: "OrderedDict[Tuple[str, PartitionConfig], PartitionPlan]" = \
            OrderedDict()
        self._lock = threading.RLock()
        self._inflight: Dict[Tuple[str, PartitionConfig], threading.Event] = {}
        # version lifecycle: reader refcounts per key (a dispatch pins the
        # plan version it resolved for its whole duration) and retired
        # versions parked until their last pin drains
        self._pins: Dict[Tuple[str, PartitionConfig], int] = {}
        self._retired: Dict[Tuple[str, PartitionConfig], PartitionPlan] = {}
        self.lookups = 0        # == hits + misses, bumped under the SAME
        #                         lock hold (the stats-atomicity witness)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.builds = 0
        self.spills = 0
        self.disk_hits = 0
        self.publishes = 0
        self.retired_versions = 0   # old versions parked behind live pins
        self.retired_reclaimed = 0  # parked versions whose pins drained

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._plans

    def get_or_build(self, g: CSRGraph, cfg: PartitionConfig) -> PartitionPlan:
        """Return the cached plan for (g, cfg), building it on first sight."""
        key = (graph_content_hash(g), cfg)
        return self.get_by_key(
            key, lambda: build_partition_plan(g, cfg, graph_hash=key[0],
                                              device=self.device))

    def get_by_key(self, key: Tuple[str, PartitionConfig],
                   build_fn: Callable[[], PartitionPlan]) -> PartitionPlan:
        """Counter-tracked lookup for callers that already hold the key (the
        serving engine hashes each graph once at registration, not per
        request); ``build_fn`` runs only on a miss, and only in ONE thread
        when several miss the same key at once."""
        while True:
            with self._lock:
                plan = self._plans.get(key)
                if plan is not None:
                    self.hits += 1
                    self.lookups += 1
                    self._plans.move_to_end(key)
                    return plan
                pending = self._inflight.get(key)
                if pending is None:
                    event = threading.Event()
                    self._inflight[key] = event
                    self.misses += 1
                    self.lookups += 1
            if pending is not None:
                pending.wait()      # another thread is building this key;
                continue            # loop back — next pass is a hit
            try:
                plan = self._load_from_disk(key)
                built = plan is None
                if built:
                    plan = build_fn()
                with self._lock:
                    if built:
                        self.builds += 1
                    else:
                        self.disk_hits += 1
                    evicted = self._insert_locked(key, plan)
                self._spill_evicted(evicted)
            finally:
                with self._lock:
                    del self._inflight[key]
                event.set()
            return plan

    def _insert_locked(self, key, plan: PartitionPlan) -> list:
        """Insert under the lock; returns evicted plans for the caller to
        spill AFTER releasing it (an O(nnz) .npz write must not stall every
        concurrent lookup)."""
        if key in self._plans:
            self._plans.move_to_end(key)
        self._plans[key] = plan
        evicted = []
        while len(self._plans) > self.capacity:
            _, old = self._plans.popitem(last=False)
            self.evictions += 1
            evicted.append(old)
        return evicted

    def _spill_evicted(self, evicted: list) -> None:
        if self.save_dir is None:
            return
        for plan in evicted:
            if self._spill(plan):
                with self._lock:
                    self.spills += 1

    # -------------------------------------------------------- version chain
    def pin(self, key) -> int:
        """A reader (one in-flight dispatch) holds this plan version: its
        key cannot be silently discarded by :meth:`retire` until the
        matching :meth:`unpin`. Returns the new refcount. Pin/unpin must
        balance."""
        with self._lock:
            c = self._pins.get(key, 0) + 1
            self._pins[key] = c
            return c

    def unpin(self, key) -> int:
        """Release one reader pin; when the last pin of a RETIRED version
        drains, the parked plan is reclaimed. Returns the remaining count."""
        with self._lock:
            c = self._pins.get(key, 0) - 1
            if c > 0:
                self._pins[key] = c
                return c
            self._pins.pop(key, None)
            if self._retired.pop(key, None) is not None:
                self.retired_reclaimed += 1
            return 0

    def retire(self, key) -> bool:
        """Remove a superseded version from the serving set. Unpinned
        versions drop immediately (no spill — stale content must not be
        resurrected by a disk hit racing the publish); pinned versions PARK
        until their readers drain, so an in-flight dispatch keeps a
        reachable plan for its whole duration. Returns True if the key was
        resident or parked."""
        with self._lock:
            plan = self._plans.pop(key, None)
            if plan is None:
                return key in self._retired
            if self._pins.get(key, 0) > 0:
                self._retired[key] = plan
                self.retired_versions += 1
            return True

    def publish(self, plan: PartitionPlan, retire_key=None) -> PartitionPlan:
        """Atomically make ``plan`` the current version and retire the one
        it supersedes: readers either resolve the old key (still parked if
        pinned) or the new one — never a torn in-between. Spilling of any
        capacity eviction happens outside the lock as usual."""
        with self._lock:
            evicted = self._insert_locked(plan.key, plan)
            if retire_key is not None and retire_key != plan.key:
                old = self._plans.pop(retire_key, None)
                if old is not None and self._pins.get(retire_key, 0) > 0:
                    self._retired[retire_key] = old
                    self.retired_versions += 1
            self.publishes += 1
        self._spill_evicted(evicted)
        return plan

    def apply_delta(self, key, g_old: CSRGraph, delta, *,
                    churn_threshold: float = 0.25):
        """Repair the plan under ``key`` for an edge delta and publish the
        next version in one step. ``g_old`` is the pre-delta graph the key
        was built from (rebuilt here if the plan was evicted meanwhile).
        Returns ``(g_new, PlanVersion)`` — the caller re-binds its
        graph_id to ``pv.plan.key`` and pushes the new graph content.
        """
        from .plan_repair import apply_and_repair   # circular at module load
        plan = self.get_by_key(
            key, lambda: build_partition_plan(g_old, key[1],
                                              graph_hash=key[0],
                                              device=self.device))
        g_new, pv = apply_and_repair(plan, g_old, delta,
                                     churn_threshold=churn_threshold)
        self.publish(pv.plan, retire_key=key)
        return g_new, pv

    def keys(self):
        with self._lock:
            return list(self._plans.keys())

    # ------------------------------------------------------------ disk spill
    def _spill_path(self, key: Tuple[str, PartitionConfig]) -> str:
        graph_hash, cfg = key
        return os.path.join(self.save_dir, f"{graph_hash}-{_config_tag(cfg)}.npz")

    def _spill(self, plan: PartitionPlan) -> bool:
        """Write an evicted plan as a content-hash-named .npz (atomic)."""
        path = self._spill_path(plan.key)
        if os.path.exists(path):
            return False        # same content already spilled (idempotent)
        bp = plan.partition
        payload = {
            "n_rows": np.int64(plan.n_rows),
            "n_cols": np.int64(plan.n_cols),
            "nnz": np.int64(plan.nnz),
            "version": np.int64(plan.version),
            "slab_R": np.int64(plan.slabs["R"]),
            "slab_C": np.int64(plan.slabs["C"]),
            "bp_meta": bp.meta,
            "bp_n_rows_blk": bp.n_rows_blk,
            "bp_nnz_blk": bp.nnz_blk,
            "bp_is_split": bp.is_split,
            "bp_n_rows": np.int64(bp.n_rows),
            "bp_nnz": np.int64(bp.nnz),
        }
        for k in ("colidx", "values", "rowloc", "out_row"):
            payload[f"slab_{k}"] = plan.slabs[k].cpu().numpy()
        for k in ("inv_perm", "coo_row", "coo_col", "coo_val"):
            payload[k] = getattr(plan, k).cpu().numpy()
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, path)
            return True
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False

    def _load_from_disk(self, key: Tuple[str, PartitionConfig]
                        ) -> Optional[PartitionPlan]:
        """Reload a spilled plan onto the cache's device; None when
        absent/unreadable (then rebuild)."""
        if self.save_dir is None:
            return None
        path = self._spill_path(key)
        if not os.path.exists(path):
            return None
        _, cfg = key
        try:
            with np.load(path) as z:
                slabs = _stage({k: z[f"slab_{k}"] for k in
                                ("colidx", "values", "rowloc", "out_row")},
                               self.device)
                slabs["R"], slabs["C"] = int(z["slab_R"]), int(z["slab_C"])
                bp = BlockPartition(
                    meta=z["bp_meta"],
                    n_rows_blk=z["bp_n_rows_blk"],
                    nnz_blk=z["bp_nnz_blk"],
                    is_split=z["bp_is_split"],
                    patterns=get_partition_patterns(
                        cfg.max_block_warps, cfg.max_warp_nzs, mode=cfg.mode,
                        max_rows_per_block=cfg.max_rows_per_block,
                        warp_nzs_override=cfg.warp_nzs_table),
                    n_rows=int(z["bp_n_rows"]),
                    nnz=int(z["bp_nnz"]),
                )
                staged = _stage({k: z[k] for k in ("inv_perm", "coo_row",
                                                   "coo_col", "coo_val")},
                                self.device)
                return PartitionPlan(
                    key=key,
                    n_rows=int(z["n_rows"]), n_cols=int(z["n_cols"]),
                    nnz=int(z["nnz"]), slabs=slabs, partition=bp,
                    # pre-versioning spills reload as version 0
                    version=int(z["version"]) if "version" in z else 0,
                    **staged)
        except Exception:       # corrupt/partial/alien spill (BadZipFile,
            return None         # KeyError, OSError, ...): rebuild instead

    def stats(self) -> Dict[str, float]:
        """ATOMIC snapshot of every counter, taken under one lock hold, so a
        flush thread mutating counters mid-``stats()`` can never produce a
        torn read (e.g. ``hits + misses != lookups``)."""
        with self._lock:
            total = self.hits + self.misses
            return {
                "size": len(self._plans),
                "capacity": self.capacity,
                "lookups": self.lookups,
                "hits": self.hits,
                "misses": self.misses,
                "builds": self.builds,
                "evictions": self.evictions,
                "spills": self.spills,
                "disk_hits": self.disk_hits,
                "publishes": self.publishes,
                "pins": sum(self._pins.values()),
                "retired_versions": self.retired_versions,
                "retired_reclaimed": self.retired_reclaimed,
                "retired_live": len(self._retired),
                "hit_rate": self.hits / total if total else 0.0,
                "device_bytes": sum(p.device_bytes()
                                    for p in self._plans.values()),
            }
