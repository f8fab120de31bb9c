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

**Across processes.** Block sharding also runs over the GLOBAL slots of a
multi-host fleet (:func:`repro_torch.launch.mesh.multihost_graph_mesh`,
``(process_index, local_slot)`` pairs): the round-robin order is over every
process's slots, each process runs its own slots' shares
(:func:`commit_block_shards_global` stages them), and the cross-process sum
— the reference's ``psum`` — is a gather: each process stages its partials
to the host, ``all_gather``s them over gloo (which takes no CUDA tensor in
``all_gather``; NCCL refuses two ranks on one card) and folds all of them
left to right in global slot order on its first slot. The fold is the
single-process fold over the same slot count, so the answer equals
:func:`spmm_block_sharded` over that many slots in one process, bit for bit
wherever the shares' kernels give the same partials (every integer-valued
graph). Every process must enter such a call with the same arguments.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels.ops import spmm_blocked
from ..kernels.spmm_batched import _KERNELS
from .multihost import GlobalSlot

__all__ = [
    "round_robin_block_order",
    "prepare_feature_shards",
    "prepare_block_shards",
    "commit_block_shards_global",
    "spmm_feature_sharded",
    "spmm_block_sharded",
]

_SLAB_KEYS = ("colidx", "values", "rowloc", "out_row")
_REGIMES = dict(_KERNELS, blocked=spmm_blocked)

Shard = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
Slot = Union[torch.device, GlobalSlot]


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


def _mesh_spans_processes(slots: Sequence[Slot]) -> bool:
    """True when ``slots`` are global ``(process_index, local_slot)`` pairs
    of more than one process — the global serving slots of a multi-host
    fleet."""
    procs = {s[0] for s in slots if isinstance(s, tuple)}
    return len(procs) > 1


def commit_block_shards_global(slabs: Dict, n_rows: int,
                               global_slots: Sequence[GlobalSlot],
                               process_index: int,
                               local_devices: Sequence[torch.device]
                               ) -> Tuple[Dict[int, Shard], np.ndarray]:
    """This process's shares of a block-sharded dispatch over the GLOBAL
    slots: ``({global slot index: slab shard on its local slot's device},
    live block counts of every global slot)``.

    The round-robin order is over ``len(global_slots)`` slots, so share
    ``k`` holds the blocks :func:`prepare_block_shards` hands slot ``k`` of
    a single process with that many slots. Every process builds the same
    plan from the same graph and keeps only its own shares. Memoize per
    plan (the fleet engine keeps it in its prep cache): the slabs are
    immutable, so the staging is paid once.
    """
    d = len(global_slots)
    B = int(slabs["colidx"].shape[0])
    order, live = round_robin_block_order(B, d)
    padded = _pad_blocks(slabs, len(order), int(n_rows))
    per = len(order) // d
    src = slabs["colidx"].device
    shares = {}
    for k, (proc, local) in enumerate(global_slots):
        if proc != process_index:
            continue
        idx = torch.from_numpy(order[k * per:(k + 1) * per]).to(src)
        shares[k] = tuple(padded[key].index_select(0, idx).to(
            local_devices[local]) for key in _SLAB_KEYS)
    return shares, live


def _mark(device: torch.device):
    """A point on ``device``'s current stream: a CUDA event on the card,
    the host clock elsewhere."""
    if device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _elapsed_ms(start, end) -> float:
    if isinstance(start, float):
        return (end - start) * 1e3
    end.synchronize()
    return start.elapsed_time(end)


def _block_sharded_global(
        slabs: Dict, x: torch.Tensor, n_rows: int,
        global_slots: Sequence[GlobalSlot], kernel, *,
        prepared: Optional[Tuple[Dict[int, Shard], np.ndarray]],
        streams: Optional[Sequence], local_devices: Sequence[torch.device],
        timings: Optional[Dict[str, float]]
        ) -> Tuple[torch.Tensor, np.ndarray]:
    """The multi-host branch of :func:`spmm_block_sharded`: this process's
    shares, then the host-staged gather and the slot-order fold."""
    import torch.distributed as dist
    rank = dist.get_rank()
    shares, live = (prepared if prepared is not None
                    else commit_block_shards_global(
                        slabs, n_rows, global_slots, rank, local_devices))
    own = sorted(shares)
    slots = [global_slots[k][1] for k in own]
    primary = local_devices[0]
    x = x.float().contiguous()
    t0 = _mark(primary)
    parts = _run_slots(
        [local_devices[i] for i in slots],
        [streams[i] for i in slots] if streams is not None else None,
        lambda j: kernel(*shares[own[j]], x.to(local_devices[slots[j]]),
                         int(n_rows)))
    t1 = _mark(primary)
    # stage to the host (the copy waits for the caller's stream, which
    # waited for every share), then gather every process's partials
    h0 = time.perf_counter()
    by_proc: Dict[int, List[int]] = {}
    for k, (proc, _) in enumerate(global_slots):
        by_proc.setdefault(proc, []).append(k)
    width = max(len(ks) for ks in by_proc.values())
    F = int(x.shape[1])
    staged = torch.zeros((width, int(n_rows), F), dtype=torch.float32)
    for j, part in enumerate(parts):
        staged[j].copy_(part)
    gathered = [torch.empty_like(staged)
                for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, staged)
    h1 = time.perf_counter()
    # fold left to right in global slot order, as the single-process fold
    # does; this process's own partials are taken from the device
    mine = dict(zip(own, parts))
    t2 = _mark(primary)
    out = None
    for k, (proc, _) in enumerate(global_slots):
        part = mine.get(k)
        if part is None:
            part = gathered[proc][by_proc[proc].index(k)].to(primary)
        out = part if out is None else out + part
    if timings is not None:
        t3 = _mark(primary)
        timings.update(shares_ms=_elapsed_ms(t0, t1),
                       gather_ms=(h1 - h0) * 1e3,
                       fold_ms=_elapsed_ms(t2, t3),
                       gather_bytes=staged.numel() * 4 * (len(gathered) - 1))
    return out, live


def spmm_block_sharded(slabs: Dict, x: torch.Tensor, n_rows: int,
                       devices: Sequence[Slot], *,
                       prepared: Optional[Tuple] = None,
                       regime: str = "resident",
                       streams: Optional[Sequence] = None,
                       local_devices: Optional[Sequence[torch.device]] = None,
                       timings: Optional[Dict[str, float]] = None
                       ) -> Tuple[torch.Tensor, np.ndarray]:
    """A'.X with the plan's blocks round-robin across the slots.

    X is replicated to every slot; each slot adds its block subset into a
    full ``[n_rows, F]`` partial through ``regime``'s kernel, and the
    partials are summed in slot order on the first slot's device. Returns
    ``(out, live_counts)`` — the per-slot REAL block counts, the balance
    evidence the fleet stats export. ``prepared`` takes a memoized
    :func:`prepare_block_shards` result.

    ``devices`` may be the GLOBAL slots of a multi-host fleet
    (:func:`repro_torch.launch.mesh.multihost_graph_mesh`): this process
    then runs its own slots' shares on ``local_devices`` (``streams``
    indexed by local slot), ``prepared`` takes a memoized
    :func:`commit_block_shards_global` result, and the partials of every
    process are gathered over the default process group and
    folded in global slot order; the answer lies on ``local_devices[0]``
    of every process. That call is SPMD-collective: EVERY process must
    enter it with identical arguments (the ``serve_global`` contract).
    ``timings``, where given, receives the shares' ms, the host staging and
    gather's ms, the fold's ms and the bytes received.
    """
    kernel = _kernel(regime)
    if _mesh_spans_processes(devices):
        if local_devices is None:
            raise ValueError("global slots need this process's "
                             "local_devices")
        return _block_sharded_global(
            slabs, x, n_rows, devices, kernel, prepared=prepared,
            streams=streams, local_devices=local_devices, timings=timings)
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
