"""Logical-axis -> mesh-axis sharding rules with divisibility fallback.

The same decisions as the reference (``repro.sharding.rules``), as pure
functions. The scheme is FSDP + TP:

* column-parallel weights [d_in, d_out]  -> ("data", "model")
* row-parallel weights    [d_in, d_out]  -> ("model", "data")
* expert weights [E, ...]                -> experts on "model" (EP)
* embeddings [V, D]                      -> ("model", "data") (vocab-TP)
* activations: batch on ("pod", "data"), feature/expert/vocab on "model",
  attention heads on "model" when divisible, else replicated.

A mesh is a mapping from axis names to sizes (an object with
``axis_names`` and ``devices`` of that shape, as a ``jax.sharding.Mesh``
has, is read the same way). A spec is a tuple with one entry per
dimension: None, an axis name or a tuple of axis names; ``()`` means
replicated. An axis that does not divide its dimension is dropped.

The port runs on one card, so :func:`shard` and :func:`shard_heads`
return their input unchanged, and raise under a mesh context
(:func:`set_mesh_ctx`) of more than one device; the specs say where a
sharded run would put each tensor.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np

Spec = Tuple[Any, ...]

_CTX: dict = {"mesh": None, "devices": 1}


def set_mesh_ctx(mesh) -> None:
    _CTX["mesh"] = mesh
    _CTX["devices"] = int(np.prod(list(_sizes(mesh).values()), dtype=int))


def get_mesh_ctx():
    return _CTX["mesh"]


def clear_mesh_ctx() -> None:
    _CTX["mesh"], _CTX["devices"] = None, 1


def _one_card(what: str) -> None:
    if _CTX["devices"] > 1:
        raise NotImplementedError(
            f"{what} under a mesh of {_CTX['devices']} devices: the port "
            f"runs on one card and has no sharded path")


def _sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
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


def shard(x, *want):
    """Activation sharding annotation: ``x`` unchanged on one card; under
    a mesh context of more than one device it raises."""
    _one_card("shard")
    return x


def shard_heads(x, head_axis: int = 2, dim_axis: int = 3):
    """Head sharding annotation of ``[B, T, H, Dh]``: as :func:`shard`."""
    _one_card("shard_heads")
    return x


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
