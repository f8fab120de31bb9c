"""Logical-axis -> mesh-axis sharding rules with divisibility fallback.

The same decisions as the reference (``repro.sharding.rules``), as pure
functions. The scheme is FSDP + TP:

* column-parallel weights [d_in, d_out]  -> ("data", "model")
* row-parallel weights    [d_in, d_out]  -> ("model", "data")
* expert weights [E, ...]                -> experts on "model" (EP)
* embeddings [V, D]                      -> ("model", "data") (vocab-TP)
* activations: batch on ("pod", "data"), feature/expert/vocab on "model",
  attention heads on "model" when divisible, else replicated.

A mesh is a mapping from axis names to sizes, or a
``torch.distributed.device_mesh.DeviceMesh`` whose dim names are the axis
names (an object with ``axis_names`` and ``devices`` of that shape, as a
``jax.sharding.Mesh`` has, is read the same way). A spec is a tuple with
one entry per dimension: None, an axis name or a tuple of axis names;
``()`` means replicated. An axis that does not divide its dimension is
dropped.

The partitioned program is DTensors on a ``DeviceMesh``:
:func:`placements` turns a spec into DTensor placements, :func:`distribute`
places a tree of tensors by a tree of specs, and under a ``DeviceMesh``
context (:func:`set_mesh_ctx`) :func:`shard` and :func:`shard_heads`
redistribute a DTensor to the placements the reference's sharding
constraint names (a plain tensor there raises: a leaf was not
distributed). With no context, or a size mapping of one device, they
return their input unchanged; under a size mapping of more than one
device they raise (specs to read, not a run).
"""
from __future__ import annotations

import contextlib
import re
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

Spec = Tuple[Any, ...]

_CTX: dict = {"mesh": None, "devices": 1}


def set_mesh_ctx(mesh) -> None:
    """The mesh of the program that follows: a ``DeviceMesh`` (the
    partitioned program) or a size mapping (specs only); None clears."""
    _CTX["mesh"] = mesh
    _CTX["devices"] = (1 if mesh is None else
                       int(np.prod(list(_sizes(mesh).values()), dtype=int)))


def get_mesh_ctx():
    return _CTX["mesh"]


def clear_mesh_ctx() -> None:
    _CTX["mesh"], _CTX["devices"] = None, 1


@contextlib.contextmanager
def use_mesh(mesh):
    """``set_mesh_ctx(mesh)`` for the block, the previous context restored
    after it (None leaves the context as it is)."""
    if mesh is None:
        yield
        return
    prev = _CTX["mesh"]
    set_mesh_ctx(mesh)
    try:
        yield
    finally:
        set_mesh_ctx(prev)


def mesh_of(tree):
    """The ``DeviceMesh`` of the first DTensor leaf of ``tree`` (dicts, named
    tuples, lists and tuples), or None."""
    if isinstance(tree, DTensor):
        return tree.device_mesh
    if isinstance(tree, Mapping):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            m = mesh_of(v)
            if m is not None:
                return m
    return None


def device_mesh_ctx():
    """The context's ``DeviceMesh``, or None (no context, or a size
    mapping)."""
    m = _CTX["mesh"]
    return m if isinstance(m, DeviceMesh) else None


def _one_card(what: str) -> None:
    if _CTX["devices"] > 1 and device_mesh_ctx() is None:
        raise NotImplementedError(
            f"{what} under a mesh of {_CTX['devices']} devices given as axis "
            f"sizes: specs only; the partitioned program runs under a "
            f"DeviceMesh context (launch.mesh.make_device_mesh)")


def _sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, np.shape(mesh.devices)))


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry the batch: ("pod", "data") when pod exists."""
    names = _sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _canonical(ax):
    """An entry as ``PartitionSpec`` holds it: a tuple of one axis is that
    axis, an empty tuple is None."""
    if isinstance(ax, tuple) and len(ax) <= 1:
        return ax[0] if ax else None
    return ax


def resolve_spec(shape: Sequence[int], want: Sequence, mesh) -> Spec:
    """Validate a candidate spec against divisibility; drop failing axes."""
    return tuple(None if ax is None or dim % _axis_size(mesh, ax)
                 else _canonical(ax) for dim, ax in zip(shape, want))


def placements(spec: Sequence, device_mesh) -> List:
    """DTensor placements of ``spec`` on ``device_mesh``: ``Shard(d)`` on
    each mesh dim that entry ``d`` names (a tuple such as ``("pod",
    "data")`` shards its dim major to minor, in the mesh's dim order),
    ``Replicate()`` on every other mesh dim."""
    out: List[Any] = [Replicate()] * device_mesh.ndim
    names = list(device_mesh.mesh_dim_names)
    for d, ax in enumerate(spec):
        for a in ((ax,) if isinstance(ax, str) else (ax or ())):
            out[names.index(a)] = Shard(d)
    return out


def distribute(tree, specs, device_mesh):
    """Every tensor leaf of ``tree`` as a DTensor on ``device_mesh``, placed
    by the matching entry of ``specs`` (a tree of the same structure, as
    :func:`param_specs` and :func:`cache_specs` give). Each rank keeps the
    chunk of the whole leaf it holds (every rank passes the same whole
    leaf; nothing is sent), which may share storage with the leaf. A host
    int (``DecodeState.pos``) stays as it is."""
    def place(path, t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        if isinstance(t, DTensor):
            raise ValueError(f"{path or 'leaf'} is already distributed")
        return distribute_tensor(t, device_mesh,
                                 placements(spec, device_mesh),
                                 src_data_rank=None)

    return _zip_map(place, tree, specs)


def on_batch_axes(t, device_mesh):
    """A whole batch tensor (every rank passes the same) as a DTensor with
    its leading dim on the batch axes (each rank keeps its rows; the axes
    that do not divide it are dropped); a DTensor as it is."""
    if isinstance(t, DTensor):
        return t
    spec = resolve_spec(tuple(t.shape),
                        [batch_axes(device_mesh)] + [None] * (t.dim() - 1),
                        device_mesh)
    return distribute_tensor(t, device_mesh, placements(spec, device_mesh),
                             src_data_rank=None)


def _zip_map(fn, tree, specs, path: str = ""):
    """``fn(path, leaf, spec)`` over the dicts and named tuples of ``tree``
    and the same structure in ``specs`` (a spec tuple is a leaf)."""
    def sub(key):
        return f"{path}.{key}" if path else str(key)
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _zip_map(fn, v, specs[k], sub(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, getattr(tree, f), getattr(specs, f),
                                     sub(f)) for f in tree._fields))
    return fn(path, tree, specs)


def partitioned():
    """The context the partitioned program runs in: DTensor's implicit
    replication, so constants a step makes on the spot (rope tables,
    masks, ``arange``, zero accumulators) act as replicated; a no-op
    without a ``DeviceMesh`` context."""
    if device_mesh_ctx() is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def mesh_coord(device_mesh, axis: str) -> Tuple[int, int]:
    """(this rank's index, size) along ``axis`` of ``device_mesh``; (0, 1)
    where the mesh has no such axis."""
    names = list(device_mesh.mesh_dim_names)
    if axis not in names:
        return 0, 1
    i = names.index(axis)
    return device_mesh.get_local_rank(i), device_mesh.size(i)


def contiguous_stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (a DTensor's global
    metadata for ``DTensor.from_local``)."""
    stride, n = [], 1
    for d in reversed(tuple(shape)):
        stride.append(n)
        n *= d
    return tuple(reversed(stride))


def shard_offset(t, dim: int) -> int:
    """The global index of the first element of this rank's shard of the
    DTensor ``t`` along ``dim`` (even shards; mesh dims major to minor)."""
    off, n = 0, t.shape[dim]
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim % t.dim():
            n //= t.device_mesh.size(i)
            off += t.device_mesh.get_local_rank(i) * n
    return off


def local_part(x, partial_on: Sequence[str] = ("pod", "data")):
    """``x.to_local()`` (a plain tensor as it is) for a computation on each
    rank's shard whose gradient is a pending sum over the mesh dims in
    ``partial_on`` where ``x`` is replicated: a weight replicated over the
    batch axes gets a different gradient from each rank's batch rows."""
    if not isinstance(x, DTensor):
        return x
    names = x.device_mesh.mesh_dim_names
    grad = [Partial() if isinstance(p, Replicate) and n in partial_on else p
            for n, p in zip(names, x.placements)]
    return x.to_local(grad_placements=grad)


def spec_placements(x, want, device_mesh) -> List:
    """The placements of ``x`` under the reference's constraint ``want``:
    :func:`placements` of ``want`` resolved against ``x``'s shape ("batch"
    = the batch axes; missing entries replicated)."""
    baxes = batch_axes(device_mesh)
    resolved = [baxes if ax == "batch" else ax for ax in want]
    resolved += [None] * (x.dim() - len(resolved))
    return placements(resolve_spec(tuple(x.shape), resolved, device_mesh),
                      device_mesh)


class _Constrain(torch.autograd.Function):
    """A sharding constraint and its transpose: the value redistributed to
    ``target`` in the forward, its gradient to the same ``target`` in the
    backward (``with_sharding_constraint`` constrains the cotangent too).
    So a pending sum of gradients is all-reduced where the constraint
    stands, not by whichever op reads it next."""

    @staticmethod
    def forward(ctx, x, target):
        ctx.target = target
        return x.redistribute(x.device_mesh, target)

    @staticmethod
    def backward(ctx, g):
        if g is not None and tuple(g.placements) != tuple(ctx.target):
            g = g.redistribute(g.device_mesh, ctx.target)
        return g, None


def _redistribute(x, target, what: str):
    if not isinstance(x, DTensor):
        raise TypeError(f"{what}: a plain tensor {tuple(x.shape)} under a "
                        f"DeviceMesh of {_CTX['devices']} devices (a leaf "
                        f"was not distributed)")
    target = tuple(target)
    if tuple(x.placements) == target and not x.requires_grad:
        return x
    return _Constrain.apply(x, target)


def shard(x, *want):
    """The reference's activation sharding constraint. No context (or one
    card): ``x`` unchanged. Under a ``DeviceMesh`` context: ``x`` (a
    DTensor) redistributed to ``want`` resolved against the mesh (entries:
    None, an axis, a tuple of axes or ``"batch"``; a missing or None entry
    is replicated, as a full ``PartitionSpec`` constrains it; a pending sum
    becomes an all-reduce, or a reduce-scatter onto a sharded dim). Under
    a size mapping of more than one device it raises."""
    dm = device_mesh_ctx()
    if dm is None:
        _one_card("shard")
        return x
    return _redistribute(x, spec_placements(x, want, dm), "shard")


def shard_heads(x, head_axis: int = 2, dim_axis: int = 3):
    """Head sharding of ``[B, T, H, Dh]``, the reference's rule: batch on
    the batch axes always, heads on "model" when it divides them; otherwise
    the head dims keep the placement they arrive with (the reference leaves
    them unconstrained). As :func:`shard` without a ``DeviceMesh``."""
    dm = device_mesh_ctx()
    if dm is None:
        _one_card("shard_heads")
        return x
    if not isinstance(x, DTensor):
        return _redistribute(x, (), "shard_heads")
    msz = _axis_size(dm, "model")
    want = [batch_axes(dm)] + [None] * (x.dim() - 1)
    if x.shape[head_axis] % msz == 0:
        want[head_axis] = "model"
    target = spec_placements(x, want, dm)
    if x.shape[head_axis] % msz:
        names = list(dm.mesh_dim_names)
        if "model" in names:
            i = names.index("model")
            target[i] = x.placements[i]
    return _redistribute(x, target, "shard_heads")


# ---------------------------------------------------------------------------
# parameter sharding rules
# ---------------------------------------------------------------------------
# (regex on the param's key-path leaf(s), spec for the trailing dims).
# Leading stacked-layer dims are replicated automatically.
_RULES = [
    (r"(wq|wk|wv|wi|wg)$", ("data", "model")),
    (r"wo$", ("model", "data")),
    (r"w_in$", ("data", "model")),
    (r"w_out$", ("model", "data")),
    (r"embed$", ("model", "data")),
    (r"head$", ("data", "model")),
    (r"router$", ("data", None)),
    (r"conv_w$", (None, "model")),
    (r"(a_q|a_i)$", ("data", None)),      # LoRA A
    (r"(b_q|b_i)$", (None, "model")),     # LoRA B
]
_MOE_RULES = [  # expert-stacked weights, matched when rank >= 3 tail (E, d, f)
    (r"(wi|wg)$", ("model", "data", None)),
    (r"wo$", ("model", None, "data")),
]

# ZeRO-1 for expert weights: when True, MoE expert *parameters* are
# replicated along "data" (sharded on "model" only) while optimizer state
# (paths under "opt") stays data-sharded.
ZERO1_MOE = False


def _leaf_spec(path: str, shape: Tuple[int, ...], mesh) -> Spec:
    # expert-parallel weights: inside an "moe" scope with >= 3 dims
    if ".moe." in path or path.endswith("moe"):
        is_param_side = ".opt." not in path and not path.startswith("opt.")
        if ZERO1_MOE and is_param_side:
            for pat, tail in _MOE_RULES:
                if re.search(pat, path) and len(shape) >= len(tail):
                    want = [None] * (len(shape) - 3) + ["model", None, None]
                    return resolve_spec(shape, want, mesh)
        for pat, tail in _MOE_RULES:
            if re.search(pat, path) and len(shape) >= len(tail):
                want = [None] * (len(shape) - len(tail)) + list(tail)
                return resolve_spec(shape, want, mesh)
    for pat, tail in _RULES:
        if re.search(pat, path) and len(shape) >= len(tail):
            want = [None] * (len(shape) - len(tail)) + list(tail)
            return resolve_spec(shape, want, mesh)
    return ()  # norms, biases, scalars: replicated


def _map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, named tuples, lists and
    tuples, keeping its structure; None stays None. Paths join the keys,
    field names and indices with "."."""
    def sub(key):
        return f"{path}.{key}" if path else str(key)
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f), sub(f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, sub(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def cache_specs(tree, mesh):
    """Decode-state specs: batch on ("pod", "data"); KV heads on "model"
    (falling back to head_dim), SSM heads / conv channels on "model".

    Positions are taken from the right so leading layer-stack dims never
    matter: kv [..., B, S, KH, Dh]; conv [..., B, K-1, C]; ssm
    [..., B, H, N, P]. A tree of the same structure as ``tree``.
    """
    b_ax = batch_axes(mesh)
    msz = _axis_size(mesh, "model")

    def spec_for(path: str, leaf) -> Spec:
        shape = tuple(np.shape(leaf))
        nd = len(shape)
        want: list = [None] * nd
        if path.endswith(".k") or path.endswith(".v"):
            want[nd - 4] = b_ax
            if shape[nd - 2] % msz == 0:
                want[nd - 2] = "model"
            elif shape[nd - 1] % msz == 0:
                want[nd - 1] = "model"
        elif path.endswith(".conv"):
            want[nd - 3] = b_ax
            want[nd - 1] = "model"
        elif path.endswith(".ssm"):
            want[nd - 4] = b_ax
            want[nd - 3] = "model"
        elif path.endswith("pos") or nd == 0:
            return ()
        return resolve_spec(shape, want, mesh)

    return _map_with_path(spec_for, tree)


def param_specs(params, mesh):
    """A tree of specs matching ``params``."""
    return _map_with_path(
        lambda path, leaf: _leaf_spec(path, tuple(leaf.shape), mesh), params)
