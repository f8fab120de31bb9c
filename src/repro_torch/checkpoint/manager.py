"""Fault-tolerant checkpointing: atomic, keep-k, device-independent.

* checkpoints are written to ``<dir>/step_<n>.tmp`` then atomically renamed,
  so a preempted writer never corrupts the latest checkpoint;
* arrays are saved as host arrays, so a restore may put them on other
  devices: each restored leaf goes to the device of the matching leaf of
  the caller's ``like`` tree;
* ``latest_step`` scans for complete checkpoints only (those with a
  ``MANIFEST.json``); a training loop restarts from there after a failure.

Format: one ``arrays.npz`` per checkpoint plus a JSON manifest. Nested
lists, tuples (named tuples such as a ``TrainState`` included) and dicts
flatten in the leaf order of the reference package's
``jax.tree_util.tree_flatten`` (sequences in order, dict keys sorted, None
holds no leaf), so ``a<i>`` names the same parameter in a checkpoint of
either package, and a checkpoint written by one restores into the other.
bf16 leaves are stored as fp32 (npz has no bf16) and restored as bf16.

A partitioned state (DTensor leaves, one process a rank) is saved in the
same format: every rank calls ``save`` (each leaf is gathered whole, one
leaf at a time, which is a collective), rank 0 writes, and all ranks wait
for its rename. ``restore`` reads the whole leaves on every rank and places
each as the matching leaf of ``like`` is placed (``distribute_tensor``,
each rank keeping its chunk), so a checkpoint crosses between one card
and any mesh.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

__all__ = ["CheckpointManager"]


def _flatten(tree: Any) -> List[Any]:
    """Leaves of ``tree`` in ``jax.tree_util.tree_flatten`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [tree]


def _unflatten(like: Any, leaves: Iterator[Any]) -> Any:
    """``like``'s structure with its leaves replaced, in ``_flatten``
    order, by the items of ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _partitioned(leaves: List[Any]) -> bool:
    return any(isinstance(t, DTensor) for t in leaves)


def _writer() -> bool:
    """Whether this process writes: rank 0 of a group, or the only one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf as the host array to store and the name of its dtype; a
    DTensor gathered whole first (a collective)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        a = t.numpy()
        return a, a.dtype.name
    a = np.asarray(leaf)
    return a, a.dtype.name


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "MANIFEST.json")):
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any) -> str:
        final = self._path(step)
        tmp = final + ".tmp"
        leaves = _flatten(tree)
        part = _partitioned(leaves)
        write = _writer() if part else True
        if write:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        arrs = {}
        dtypes = []
        for i, leaf in enumerate(leaves):
            a, dtype = _to_host(leaf)       # every rank: a gather
            dtypes.append(dtype)
            if write:
                arrs[f"a{i}"] = a
        if write:
            np.savez(os.path.join(tmp, "arrays.npz"), **arrs)
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump({"step": step, "n_leaves": len(leaves),
                           "dtypes": dtypes}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)      # atomic publish
            self._gc()
        if part:
            dist.barrier()             # the checkpoint exists for every rank
        return final

    def _gc(self):
        steps = sorted(
            int(m.group(1)) for name in os.listdir(self.dir)
            if (m := re.fullmatch(r"step_(\d+)", name)))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of ``like``: each leaf as a tensor of
        its saved dtype on the device of ``like``'s leaf (the CPU where that
        leaf is not a tensor; a DTensor leaf placed as it is). Raises
        ``ValueError`` when the checkpoint holds another number of
        leaves."""
        path = self._path(step)
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)
        like_leaves = _flatten(like)
        if manifest["n_leaves"] != len(like_leaves):
            raise ValueError(f"checkpoint/model mismatch: step {step} holds "
                             f"{manifest['n_leaves']} leaves, the model "
                             f"{len(like_leaves)}")
        out = []
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for i, leaf in enumerate(like_leaves):
                want = manifest["dtypes"][i]
                a = data[f"a{i}"]
                if want == "bfloat16":
                    t = torch.from_numpy(a.astype(np.float32)).bfloat16()
                else:
                    t = torch.from_numpy(a.astype(want))
                if isinstance(leaf, DTensor):
                    loc = leaf.to_local()
                    out.append(distribute_tensor(
                        t.to(loc.device), leaf.device_mesh, leaf.placements,
                        src_data_rank=None))
                    continue
                dev = (leaf.device if isinstance(leaf, torch.Tensor)
                       else torch.device("cpu"))
                out.append(t.to(dev))
        return _unflatten(like, iter(out))
