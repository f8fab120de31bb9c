"""Routing policy of the block-slab SpMM: which of the three kernels a
dispatch runs, picked from the workload at call time.

This module is the reference package's ``repro.kernels.router``
(``src/repro/kernels/router.py``) carried over decision for decision. Its
thresholds are the reference's **routing policy**, kept under their public
names so that ``backend="auto"`` picks, for every dispatch shape, the same
kernel the reference picks:

  regime      kernel on the card                       reference thresholds
  ----------  ---------------------------------------  ---------------------
  resident    K1 ``spmm_accel.spmm_block_slabs``       N_pad <= window
  windowed    K2 ``spmm_accel.spmm_block_slabs_windowed``  <= MAX_WINDOWS
                                                          windows
  hbm         K3 ``spmm_hbm.spmm_block_slabs_hbm``     everything larger

The byte counts below (``estimate_vmem_bytes``, ``X_TILE_BUDGET_BYTES``,
``TOTAL_VMEM_BUDGET_BYTES``, ``MAX_WINDOWS``; reference lines 64-71 and
105-128) are the reference's model of its own kernels' per-step working
set. They are policy inputs, not facts about the card: the CUDA kernels
keep X in device memory and check their own shared-memory need against the
card's per-CTA limit in their wrappers. ``VmemBudgetError`` keeps its name
and messages so that a caller forcing the resident kernel
(``backend="pallas"``) on an oversized dispatch fails exactly where the
reference fails.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = [
    "VMEM_BYTES_PER_CORE",
    "X_TILE_BUDGET_BYTES",
    "TOTAL_VMEM_BUDGET_BYTES",
    "MAX_WINDOWS",
    "VmemBudgetError",
    "RoutingDecision",
    "pad_rows",
    "pad_features",
    "resident_window_rows",
    "estimate_vmem_bytes",
    "route_spmm",
    "assert_resident_fits",
    "FleetDecision",
    "route_fleet",
]

# The reference's routing thresholds (src/repro/kernels/router.py:64-71):
# the per-buffer X-tile budget that caps the resident regime and sets the
# window height, the whole-step budget every routed regime must satisfy,
# and the most row windows the windowed regime may sweep.
VMEM_BYTES_PER_CORE = 16 * 1024 * 1024
X_TILE_BUDGET_BYTES = 2 * 1024 * 1024
TOTAL_VMEM_BUDGET_BYTES = VMEM_BYTES_PER_CORE // 2
MAX_WINDOWS = 4

_SUBLANE = 8  # row counts pad to multiples of this (reference :73)


class VmemBudgetError(ValueError):
    """A forced-resident dispatch past the routing policy's resident
    threshold, or a block capacity no regime of the policy admits."""


def pad_rows(n: int) -> int:
    """Rows pad to multiples of 8, as the reference pads them."""
    return ((int(n) + _SUBLANE - 1) // _SUBLANE) * _SUBLANE


def pad_features(f: int, f_tile: int) -> int:
    """Features pad to whole ``f_tile`` tiles, as the reference pads them."""
    return max(f_tile, ((int(f) + f_tile - 1) // f_tile) * f_tile)


def resident_window_rows(f_tile: int = 128, itemsize: int = 4,
                         budget_bytes: int = X_TILE_BUDGET_BYTES) -> int:
    """Largest 8-aligned row count whose X tile fits the policy's budget.

    This is both the resident regime's cap and the window height of the
    windowed kernel (4096 at fp32 and ``f_tile=128``).
    """
    rows = budget_bytes // (f_tile * itemsize)
    return max(_SUBLANE, (rows // _SUBLANE) * _SUBLANE)


def estimate_vmem_bytes(backend: str, n_pad: int, C: int, R: int,
                        *, f_tile: int = 128, itemsize: int = 4,
                        window_rows: int | None = None) -> int:
    """The reference's per-step working-set model of one dispatch
    (reference :105-128): the X tile (regime-dependent), double-buffered
    slab metadata and output block, the gathered slab and the one-hot
    operand. Routing compares it with ``TOTAL_VMEM_BUDGET_BYTES``."""
    meta = 2 * 3 * C * 4            # colidx/values/rowloc, double-buffered
    out = 2 * R * f_tile * 4        # output block, double-buffered
    gathered = C * f_tile * 4       # [C, f_tile] gathered slab
    onehot = C * R * 4              # [R, C] segment-reduction operand
    if backend == "resident":
        x_cost = n_pad * f_tile * itemsize
    elif backend == "windowed":
        w = window_rows or resident_window_rows(f_tile, itemsize)
        x_cost = 2 * min(n_pad, w) * f_tile * itemsize  # streamed -> 2 bufs
    elif backend == "hbm":
        x_cost = 2 * 1 * f_tile * itemsize              # 2 one-row buffers
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return x_cost + meta + out + gathered + onehot


@dataclasses.dataclass(frozen=True)
class RoutingDecision:
    """One dispatch's routing outcome (also the stats/logging record)."""

    backend: str          # "resident" | "windowed" | "hbm"
    n_rows: int           # unpadded X rows of the dispatch (sum over batch)
    n_pad: int
    f_pad: int
    C: int
    R: int
    f_tile: int
    itemsize: int
    num_windows: int      # 1 for resident; >1 windowed; 0 for hbm
    window_rows: int
    vmem_bytes: int       # policy estimate for the chosen backend
    resident_bytes: int   # what the forced-resident tile would have cost
    budget_bytes: int     # per-buffer X-tile budget (resident/window cap)
    total_budget_bytes: int   # whole-step cap every regime must satisfy
    reason: str

    def describe(self) -> str:
        return (f"{self.backend}: N_pad={self.n_pad} F_pad={self.f_pad} "
                f"C={self.C} R={self.R} vmem~{self.vmem_bytes / 1024:.0f}KiB "
                f"({self.reason})")


def route_spmm(n_x_rows: int, n_features: int, C: int, R: int,
               *, f_tile: int = 128, itemsize: int = 4,
               budget_bytes: int = X_TILE_BUDGET_BYTES,
               max_windows: int = MAX_WINDOWS,
               force: str | None = None) -> RoutingDecision:
    """Pick the kernel regime for one dispatch (reference :157-256).

    ``n_x_rows`` is the row count of the dense feature operand; for a
    batched dispatch that is ``sum(n_cols_g)`` of the concatenated batch,
    which is how a batch of small graphs can leave the resident regime
    that each graph alone stays in.

    Routing picks the first of resident -> windowed -> hbm whose X-tile
    threshold holds and whose whole-step estimate fits
    ``TOTAL_VMEM_BUDGET_BYTES``; a block capacity so large that even hbm
    does not fit raises :class:`VmemBudgetError`.

    ``force="resident"`` validates instead of routing: it raises
    :class:`VmemBudgetError` past the resident threshold, which is what
    ``backend="pallas"`` does. ``force="windowed"`` and ``force="hbm"``
    always succeed.
    """
    n_pad = pad_rows(n_x_rows)
    f_pad = pad_features(n_features, f_tile)
    window = resident_window_rows(f_tile, itemsize, budget_bytes)
    resident_bytes = estimate_vmem_bytes(
        "resident", n_pad, C, R, f_tile=f_tile, itemsize=itemsize)

    def _decision(backend: str, num_windows: int, reason: str) -> RoutingDecision:
        return RoutingDecision(
            backend=backend, n_rows=int(n_x_rows), n_pad=n_pad, f_pad=f_pad,
            C=int(C), R=int(R), f_tile=f_tile, itemsize=itemsize,
            num_windows=num_windows, window_rows=window,
            vmem_bytes=estimate_vmem_bytes(
                backend, n_pad, C, R, f_tile=f_tile, itemsize=itemsize,
                window_rows=window),
            resident_bytes=resident_bytes, budget_bytes=budget_bytes,
            total_budget_bytes=TOTAL_VMEM_BUDGET_BYTES,
            reason=reason)

    if force is not None:
        if force == "resident":
            if n_pad > window:
                suggested = route_spmm(
                    n_x_rows, n_features, C, R, f_tile=f_tile,
                    itemsize=itemsize, budget_bytes=budget_bytes,
                    max_windows=max_windows).backend
                raise VmemBudgetError(
                    f"resident SpMM kernel forced on an oversized dispatch: "
                    f"X tile [N_pad={n_pad}, f_tile={f_tile}] x {itemsize}B "
                    f"= {n_pad * f_tile * itemsize / 1024:.0f} KiB exceeds "
                    f"the {budget_bytes // 1024} KiB VMEM budget "
                    f"(N_pad <= {window} fits; F_pad={f_pad}, C={C}, R={R}). "
                    f"Use backend='auto' or the '{suggested}' backend for "
                    f"this shape.")
            return _decision("resident", 1, "forced")
        if force == "windowed":
            return _decision(
                "windowed", max(1, math.ceil(n_pad / window)), "forced")
        if force == "hbm":
            return _decision("hbm", 0, "forced")
        raise ValueError(f"unknown forced backend {force!r}")

    num_windows = max(1, math.ceil(n_pad / window))
    candidates = []
    if n_pad <= window:
        candidates.append(
            ("resident", 1, f"X tile fits VMEM budget (N_pad <= {window})"))
    elif num_windows <= max_windows:
        candidates.append(
            ("windowed", num_windows,
             f"{num_windows} row windows of {window} (<= {max_windows})"))
    if num_windows > max_windows:
        hbm_reason = (f"N_pad={n_pad} needs {num_windows} windows "
                      f"(> {max_windows}); per-block DMA gather scales with "
                      f"nnz, not N")
    else:
        hbm_reason = (f"leaner regimes exceed the total VMEM budget at "
                      f"C={C}, R={R}")
    candidates.append(("hbm", 0, hbm_reason))

    for backend, nw, reason in candidates:
        if estimate_vmem_bytes(backend, n_pad, C, R, f_tile=f_tile,
                               itemsize=itemsize,
                               window_rows=window) <= TOTAL_VMEM_BUDGET_BYTES:
            return _decision(backend, nw, reason)
    hbm_bytes = estimate_vmem_bytes("hbm", n_pad, C, R, f_tile=f_tile,
                                    itemsize=itemsize)
    raise VmemBudgetError(
        f"no SpMM regime fits the total VMEM budget "
        f"({TOTAL_VMEM_BUDGET_BYTES // 1024} KiB): block capacity C={C}, "
        f"R={R} costs {hbm_bytes // 1024} KiB per grid step even with X in "
        f"HBM (one-hot [R, C] and gathered [C, {f_tile}] MXU operands are "
        f"regime-independent); repartition with a smaller "
        f"max_block_warps x max_warp_nzs.")


@dataclasses.dataclass(frozen=True)
class FleetDecision:
    """One dispatch's fleet routing outcome: how many devices it spans and
    how each device's share executes (reference :259-284).

    ``per_device`` is the :class:`RoutingDecision` for one device's slice
    of the work (the whole dispatch for ``strategy="single"``); ``single``
    is what one device alone would run. ``n_hosts`` > 1 marks a dispatch
    whose devices span several processes.
    """

    strategy: str             # "single" | "feature" | "block"
    n_devices: int            # devices the dispatch spans (1 for single)
    per_device: RoutingDecision
    single: RoutingDecision
    num_blocks: int
    reason: str
    n_hosts: int = 1          # processes the devices span (1 == one host)

    def describe(self) -> str:
        span = (f"x{self.n_devices}dev/{self.n_hosts}host"
                if self.n_hosts > 1 else f"x{self.n_devices}")
        return (f"{self.strategy}{span}: "
                f"per-device {self.per_device.backend} ({self.reason})")


def route_fleet(n_x_rows: int, n_features: int, C: int, R: int,
                num_blocks: int, n_devices: int,
                *, f_tile: int = 128, itemsize: int = 4,
                min_blocks_per_device: int = 4,
                n_hosts: int = 1) -> FleetDecision:
    """Pick single-device vs feature-sharded vs block-sharded execution
    (reference :287-379).

    * **feature**: each device owns ``F_pad / n_devices`` feature columns
      and runs the full block schedule on them, with no communication.
      Chosen when the padded width carries at least one ``f_tile`` per
      device, and only within one host (a column-split answer across hosts
      would pay a cross-host gather on every request).
    * **block**: for one large graph with narrow features, once the
      single-device decision has left the resident regime: blocks go
      round-robin across devices, X is replicated and the partial rows are
      summed across devices. Needs ``min_blocks_per_device`` blocks per
      device.
    * **single**: everything else.

    The per-device regime is still :func:`route_spmm` on the per-device
    share; feature sharding does not change the X row count.
    """
    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
    single = route_spmm(n_x_rows, n_features, C, R,
                        f_tile=f_tile, itemsize=itemsize)
    if n_devices <= 1:
        return FleetDecision("single", 1, single, single, num_blocks,
                             "one device")
    f_pad = pad_features(n_features, f_tile)
    f_tiles = f_pad // f_tile
    if f_tiles >= n_devices and n_hosts == 1:
        per = route_spmm(n_x_rows, f_pad // n_devices, C, R,
                         f_tile=f_tile, itemsize=itemsize)
        return FleetDecision(
            "feature", n_devices, per, single, num_blocks,
            f"{f_tiles} feature tiles over {n_devices} devices: "
            f"zero-communication column split, per-device F="
            f"{f_pad // n_devices}")
    if (single.backend != "resident"
            and num_blocks >= min_blocks_per_device * n_devices):
        # the per-step footprint does not depend on the block count: one
        # device's share routes like the whole dispatch, with B/n blocks
        span = (f"{n_devices} devices"
                if n_hosts == 1 else
                f"{n_devices} devices on {n_hosts} hosts (global mesh, "
                f"SPMD-collective)")
        feat_note = (
            f"features are narrow ({f_tiles} tile(s) < {n_devices} devices)"
            if f_tiles < n_devices else
            f"feature split is disabled across {n_hosts} hosts "
            f"({f_tiles} tiles would shard, but column-split answers pay "
            f"a cross-host gather)")
        return FleetDecision(
            "block", n_devices, single, single, num_blocks,
            f"single-device estimate demotes to {single.backend} and "
            f"{feat_note}: {num_blocks} blocks round-robin over {span}, "
            f"X replicated, partials psum", n_hosts=n_hosts)
    why_not_feature = ("" if f_tiles < n_devices else
                       "; feature split skipped: cross-host column "
                       "gather would tax every answer")
    return FleetDecision(
        "single", 1, single, single, num_blocks,
        f"{single.backend} on one device ({f_tiles} feature tile(s), "
        f"{num_blocks} block(s)): sharding would cost more than it "
        f"saves{why_not_feature}")


def assert_resident_fits(n_x_rows: int, n_features: int, C: int, R: int,
                         *, f_tile: int = 128, itemsize: int = 4,
                         budget_bytes: int = X_TILE_BUDGET_BYTES) -> None:
    """Raise :class:`VmemBudgetError` unless the dispatch is within the
    policy's resident threshold."""
    route_spmm(n_x_rows, n_features, C, R, f_tile=f_tile, itemsize=itemsize,
               budget_bytes=budget_bytes, force="resident")
