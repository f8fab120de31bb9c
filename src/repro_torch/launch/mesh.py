"""Meshes: the training meshes as axis-size mappings, and slot lists for
fleet graph serving.

*Training.* The reference builds ``jax`` meshes; the port's sharding rules
(:mod:`repro_torch.sharding`) read a mesh as a mapping of axis names to
sizes. :func:`make_host_mesh` is ``{"data": n // model, "model": model}``
over the process group's world size, or over the visible cards (one on the
CPU) when no group is initialised; :func:`make_production_mesh` is the
reference's pod layout, ``{"data": 16, "model": 16}`` (with ``"pod": 2`` in
front across two pods). :func:`make_device_mesh` turns such a mapping
into the ``DeviceMesh`` the partitioned program runs on, over the current
process group (one rank a device).

*Serving.* The reference builds a 1-D ``jax.sharding.Mesh`` over its
devices; the port's fleet runs over **slots**: a list of ``torch.device``s
in which one device may appear more than once. One slot per card is the
real fleet; several slots of one card (or of the CPU) give the placement,
routing, sharding and replication of that many devices on one card, as the
reference's forced host device count does on the CPU. Slots that share a
card share its SMs and memory, so they answer as a fleet of that size
would, but are not faster than one slot. A multi-host fleet's global slots
(:func:`multihost_graph_mesh`) are ``(process_index, local_slot)`` pairs,
process-major.

Functions, not module-level constants, so importing never touches CUDA.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.plan_cache import DeviceLike, resolve_device

__all__ = ["make_production_mesh", "make_host_mesh", "make_device_mesh",
           "graph_mesh",
           "multihost_graph_mesh", "resolve_slots"]


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """The reference's production mesh (256 chips a pod) as axis sizes;
    ``multi_pod`` adds a leading ``"pod"`` axis of 2."""
    return {**({"pod": 2} if multi_pod else {}), "data": 16, "model": 16}


def make_host_mesh(model: int = 1, *,
                   device: DeviceLike = None) -> Dict[str, int]:
    """``{"data": n // model, "model": model}``: n is the world size of the
    initialised process group (one rank a device), else the visible cards
    (``device`` is ``cuda`` unless the caller names another type; n is 1
    on the CPU)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        n = dist.get_world_size()
    else:
        kind = resolve_device(device).type
        n = torch.cuda.device_count() if kind == "cuda" else 1
    if model < 1:
        raise ValueError(f"model axis size must be >= 1, got {model}")
    if n % model != 0:
        raise ValueError(
            f"cannot build a ({n // model}, {model}) host mesh: {n} "
            f"available device(s) not divisible by model={model}")
    return {"data": n // model, "model": model}


def make_device_mesh(sizes: Dict[str, int], *, device: DeviceLike = None):
    """The ``DeviceMesh`` of the axis sizes ``sizes`` (``{"data": d,
    "model": m}``, with ``"pod"`` in front where present), in that order,
    over the current process group: ``init_device_mesh`` on ``device``'s
    type (``cuda`` unless named; ``meta`` tensors take a ``cpu`` mesh). The
    group's world size must equal the product of the sizes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    kind = ("cpu" if device is not None and torch.device(device).type
            == "meta" else resolve_device(device).type)
    n = int(np.prod(list(sizes.values()), dtype=int))
    if not dist.is_initialized():
        raise RuntimeError(f"make_device_mesh({sizes}): no process group "
                           f"(torch.distributed.init_process_group first)")
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {sizes} needs {n} ranks, the process group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(kind, tuple(int(v) for v in sizes.values()),
                            mesh_dim_names=tuple(sizes))


def resolve_slots(devices: Sequence[DeviceLike]) -> List[torch.device]:
    """Each slot as a ``torch.device`` with an index on ``cuda`` (``"cuda"``
    means the current card), raising where CUDA is named and absent."""
    slots = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        slots.append(dev)
    if not slots:
        raise ValueError("a fleet needs >= 1 slot")
    return slots


def multihost_graph_mesh(context=None, device: DeviceLike = None) -> list:
    """The global slot list spanning EVERY process's slots.

    The cross-host analogue of :func:`graph_mesh`: after
    :func:`~repro_torch.distributed.multihost.initialize_multihost`,
    ``context.global_devices`` — ``(process_index, local_slot)`` pairs in
    process-major order. A dispatch over these slots is SPMD-collective:
    every process must enter it with the same arguments (the
    ``MultihostGraphEngine.serve_global`` contract). On a single process
    it degenerates to that process's own slots: ``context.local_devices``,
    or ``graph_mesh(device=device)`` without a context.
    """
    if context is None:
        return graph_mesh(device=device)
    if context.process_count <= 1:
        return list(context.local_devices)
    return list(context.global_devices)


def graph_mesh(n_devices: Optional[int] = None,
               device: DeviceLike = None) -> List[torch.device]:
    """The slots of a fleet: the first ``n_devices`` visible cards.

    Unlike the train meshes there is no data/model split: graph serving
    parallelism is the paper's column (feature) parallelism and block-level
    balancing lifted to device granularity, both of which want a flat list.
    ``device`` is ``cuda`` unless the caller names another type; on
    ``cuda`` the default is every visible card and more than
    ``torch.cuda.device_count()`` raises, on ``cpu`` it is ``n_devices``
    slots (default 1) of the one CPU.
    """
    kind = resolve_device(device).type
    if kind == "cuda":
        avail = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    elif kind == "cpu":
        avail = None
    else:
        raise ValueError(f"graph_mesh runs on cuda or cpu, got {kind!r}")
    n = (len(avail) if avail is not None else 1) if n_devices is None \
        else int(n_devices)
    if n < 1:
        raise ValueError(f"graph_mesh needs >= 1 device, got n_devices={n}")
    if avail is None:
        return [torch.device("cpu")] * n
    if n > len(avail):
        raise ValueError(
            f"graph_mesh(n_devices={n}) exceeds the {len(avail)} visible "
            f"device(s)")
    return avail[:n]
