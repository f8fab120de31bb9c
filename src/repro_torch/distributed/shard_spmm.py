"""Sharded SpMM dispatch: the Accel-GCN block schedule over a fleet's slots.

Two strategies over a slot list (:func:`repro_torch.launch.mesh.graph_mesh`),
each slot running the slab kernel its share routes to on its own device
(``regime``: ``resident`` is K1, ``windowed`` K2, ``hbm`` K3, ``blocked``
the PyTorch twin; on the CPU each kernel's wrapper takes its plain
version):

* **feature sharding** (:func:`spmm_feature_sharded`) — the paper's
  combined-warp column parallelism lifted to device granularity. X is
  padded to ``d * ceil(F/d)`` columns, each slot owns a contiguous column
  shard and runs the FULL block schedule on it with the slabs replicated:
  no cross-slot sums. The shards' outputs are concatenated and sliced to F.

* **block sharding** (:func:`spmm_block_sharded`) — for one giant graph
  whose features are too narrow to split. The plan's blocks are dealt
  round-robin across slots (:func:`round_robin_block_order`): the
  partitioner emits blocks in degree-sorted order, so interleaving spreads
  the heavy dense-row blocks and the light multi-row blocks evenly —
  AWB-GCN's rebalancing at device granularity. X is replicated, each slot
  adds its block subset into a full-height partial, and the partials are
  summed in slot order on the first slot (the reference's ``psum``; split
  rows — degree > C, continued across blocks that may now live on
  different slots — are why the combine is an add).

The reference runs its jnp slab twin inside ``shard_map``; here every slot
launches the kernel of its regime, so on the card no share runs the plain
version. ``streams`` gives each slot a CUDA stream: the shares then run
concurrently, each after the caller's stream has produced X, and the
caller's stream waits for every share before it combines them.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.ops import spmm_blocked
from ..kernels.spmm_batched import _KERNELS

__all__ = [
    "round_robin_block_order",
    "prepare_feature_shards",
    "prepare_block_shards",
    "spmm_feature_sharded",
    "spmm_block_sharded",
]

_SLAB_KEYS = ("colidx", "values", "rowloc", "out_row")
_REGIMES = dict(_KERNELS, blocked=spmm_blocked)

Shard = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def round_robin_block_order(num_blocks: int, n_devices: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Round-robin block -> slot placement, as a slot-contiguous order.

    Block ``i`` goes to slot ``i % n_devices``; blocks are then laid out
    slot-major so a contiguous split along the block axis hands slot ``k``
    exactly its assignment. The block count is padded up to a multiple of
    ``n_devices`` (padding indices ``>= num_blocks`` are sentinel blocks
    the caller must append).

    Returns ``(order, live_counts)``: ``order`` is the int64 permutation of
    ``ceil(B/d)*d`` block slots (slot-major), ``live_counts[k]`` the number
    of REAL blocks slot ``k`` received. Round-robin guarantees
    ``max(live_counts) - min(live_counts) <= 1`` for every (B, d).
    """
    if num_blocks < 0 or n_devices < 1:
        raise ValueError(f"bad {num_blocks=} / {n_devices=}")
    per = -(-num_blocks // n_devices) if num_blocks else 1
    b_pad = per * n_devices
    idx = np.arange(b_pad, dtype=np.int64)
    # stable sort by assigned slot keeps each slot's blocks in original
    # (degree-sorted) order — fp reduction order within a slot unchanged
    order = np.argsort(idx % n_devices, kind="stable")
    live = np.bincount(idx[idx < num_blocks] % n_devices,
                       minlength=n_devices).astype(np.int64)
    return order, live


def _pad_blocks(slabs: Dict, b_pad: int, n_rows: int
                ) -> Dict[str, torch.Tensor]:
    """The slab tensors padded to ``b_pad`` blocks, on the slabs' device.

    Padding blocks carry value 0, colidx 0, rowloc pointing at the last
    slab row, and the drop sentinel ``n_rows`` as their output row — the
    same convention as the batched merge, so they contribute nothing.
    """
    colidx, values, rowloc, out_row = (slabs[k] for k in _SLAB_KEYS)
    B, C = colidx.shape
    R = out_row.shape[1]
    pad = b_pad - B
    if pad <= 0:
        return dict(zip(_SLAB_KEYS, (colidx, values, rowloc, out_row)))
    dev = colidx.device
    return {
        "colidx": torch.cat([colidx, torch.zeros(
            (pad, C), dtype=colidx.dtype, device=dev)]),
        "values": torch.cat([values, torch.zeros(
            (pad, C), dtype=values.dtype, device=dev)]),
        "rowloc": torch.cat([rowloc, torch.full(
            (pad, C), R - 1, dtype=rowloc.dtype, device=dev)]),
        "out_row": torch.cat([out_row, torch.full(
            (pad, R), n_rows, dtype=out_row.dtype, device=dev)]),
    }


def prepare_feature_shards(slabs: Dict, devices: Sequence[torch.device]
                           ) -> List[Shard]:
    """The slab tensors on every slot's device (each slot runs the full
    block schedule). A slot on the slabs' own card gets the same tensors,
    no copy. Memoize per plan: the slabs are immutable once built."""
    return [tuple(slabs[k].to(dev) for k in _SLAB_KEYS) for dev in devices]


def prepare_block_shards(slabs: Dict, n_rows: int,
                         devices: Sequence[torch.device]
                         ) -> Tuple[List[Shard], np.ndarray]:
    """Round-robin-reorder and pad the slabs for a block-sharded dispatch:
    ``(per-slot slab tensors on each slot's device, live block counts)``.

    Slot ``k`` holds rows ``[k*per, (k+1)*per)`` of the slot-major padded
    stack, the reference's ``shard_map`` split. Deterministic per (plan,
    slot count) — memoize per plan so a recurring giant graph pays the
    reorder once.
    """
    d = len(devices)
    B = int(slabs["colidx"].shape[0])
    order, live = round_robin_block_order(B, d)
    padded = _pad_blocks(slabs, len(order), int(n_rows))
    idx = torch.from_numpy(order).to(slabs["colidx"].device)
    ordered = [padded[k].index_select(0, idx) for k in _SLAB_KEYS]
    per = len(order) // d
    shards = [tuple(t[k * per:(k + 1) * per].to(dev) for t in ordered)
              for k, dev in enumerate(devices)]
    return shards, live


def _run_slots(devices: Sequence[torch.device],
               streams: Optional[Sequence], share: Callable[[int], torch.Tensor]
               ) -> List[torch.Tensor]:
    """Run ``share(k)`` for every slot, on ``streams[k]`` where given, and
    bring each result to the first slot's device, ready on the caller's
    current stream there."""
    primary = devices[0]
    caller = (torch.cuda.current_stream(primary)
              if streams is not None and primary.type == "cuda" else None)
    parts = []
    for k in range(len(devices)):
        stream = streams[k] if caller is not None else None
        with torch.cuda.stream(stream):           # no-op for None
            if stream is not None:
                stream.wait_stream(caller)        # X and the shards are ready
            part = share(k).to(primary)
        if stream is not None:
            caller.wait_stream(stream)
            # allocated on the slot's stream, read and freed on the caller's
            part.record_stream(caller)
        parts.append(part)
    return parts


def _kernel(regime: str):
    try:
        return _REGIMES[regime]
    except KeyError:
        raise ValueError(f"regime must be one of {'|'.join(_REGIMES)}, got "
                         f"{regime!r}") from None


def spmm_feature_sharded(slabs: Dict, x: torch.Tensor, n_rows: int,
                         devices: Sequence[torch.device], *,
                         prepared: Optional[List[Shard]] = None,
                         regime: str = "resident",
                         streams: Optional[Sequence] = None) -> torch.Tensor:
    """A'.X with X column-sharded over the slots; no cross-slot sums.

    Each slot runs the full block schedule on its contiguous column shard
    through ``regime``'s kernel; the result comes back on the first slot's
    device, sliced to the caller's F. Per-column summation is the
    single-slot kernel's, so each column matches it. ``prepared`` takes a
    memoized :func:`prepare_feature_shards` result.
    """
    kernel = _kernel(regime)
    d = len(devices)
    F = int(x.shape[1])
    f_shard = -(-F // d)
    x_p = x.float().to(devices[0])
    if f_shard * d != F:
        x_p = torch.nn.functional.pad(x_p, (0, f_shard * d - F))
    shards = (prepared if prepared is not None
              else prepare_feature_shards(slabs, devices))

    def share(k: int) -> torch.Tensor:
        xk = x_p[:, k * f_shard:(k + 1) * f_shard].to(
            devices[k]).contiguous()
        return kernel(*shards[k], xk, int(n_rows))

    parts = _run_slots(devices, streams, share)
    return torch.cat(parts, dim=1)[:, :F]


def spmm_block_sharded(slabs: Dict, x: torch.Tensor, n_rows: int,
                       devices: Sequence[torch.device], *,
                       prepared: Optional[Tuple[List[Shard],
                                                np.ndarray]] = None,
                       regime: str = "resident",
                       streams: Optional[Sequence] = None
                       ) -> Tuple[torch.Tensor, np.ndarray]:
    """A'.X with the plan's blocks round-robin across the slots.

    X is replicated to every slot; each slot adds its block subset into a
    full ``[n_rows, F]`` partial through ``regime``'s kernel, and the
    partials are summed in slot order on the first slot's device. Returns
    ``(out, live_counts)`` — the per-slot REAL block counts, the balance
    evidence the fleet stats export. ``prepared`` takes a memoized
    :func:`prepare_block_shards` result.
    """
    kernel = _kernel(regime)
    shards, live = (prepared if prepared is not None
                    else prepare_block_shards(slabs, n_rows, devices))
    x = x.float().contiguous()

    def share(k: int) -> torch.Tensor:
        return kernel(*shards[k], x.to(devices[k]), int(n_rows))

    parts = _run_slots(devices, streams, share)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out, live
