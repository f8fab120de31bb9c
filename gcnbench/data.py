"""The cell's inputs: the configuration's graph (cached as arrays under
``gcnbench/.data/``) and, from ``--seed``, its weights, features and labels,
made on the device in a few large draws."""
from __future__ import annotations

import json
import os
import shutil
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .reference import graphs

DATA_DIR = Path(__file__).resolve().parent / ".data"


@dataclass
class GraphArrays:
    """A normalised CSR matrix on the host: int64 rowptr and colidx, fp32
    values, square (n x n)."""

    rowptr: np.ndarray
    colidx: np.ndarray
    values: np.ndarray

    @property
    def n(self) -> int:
        return len(self.rowptr) - 1

    @property
    def nnz(self) -> int:
        return int(self.rowptr[-1])


def graph_key(g: dict) -> str:
    return (f"{g['name']}-n{g['nodes']}-e{g['edges']}-a{g['alpha']}"
            f"-s{g['dataset_seed']}-{g['normalization']}")


def load_graph(gspec: dict, data_dir: Optional[Path] = None) -> GraphArrays:
    """The normalised graph of ``gspec`` (the configuration's ``graph``):
    read from the cache, or generated and written there once. The cache
    directory is fixed, so every run after the first in a checkout reads
    it."""
    root = Path(data_dir or DATA_DIR)
    path = root / graph_key(gspec)
    if (path / "meta.json").exists():
        return GraphArrays(np.load(path / "rowptr.npy"),
                           np.load(path / "colidx.npy").astype(np.int64),
                           np.load(path / "values.npy"))
    t0 = time.perf_counter()
    g = graphs.power_law_graph(gspec["nodes"], gspec["edges"],
                               gspec["dataset_seed"], gspec["alpha"])
    rowptr, colidx, values = graphs.NORMALIZATIONS[gspec["normalization"]](g)
    tmp = root / f".{path.name}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    np.save(tmp / "rowptr.npy", rowptr)
    np.save(tmp / "colidx.npy", colidx.astype(np.int32))
    np.save(tmp / "values.npy", values)
    (tmp / "meta.json").write_text(json.dumps(
        {"spec": gspec, "nnz": int(rowptr[-1]),
         "generated_s": time.perf_counter() - t0}))
    try:
        tmp.rename(path)
    except OSError:          # another process wrote it first
        shutil.rmtree(tmp, ignore_errors=True)
    return GraphArrays(rowptr, colidx, values)


def draw_params(gen: torch.Generator, dims: List[int], variant: str,
                device) -> List[Dict[str, torch.Tensor]]:
    """Every layer's weights ~ N(0, 1/d_in) and biases ~ N(0, 0.1^2), from
    one draw on the device, in layer order (``w``, ``w_self`` for SAGE,
    then ``b``)."""
    shapes = []
    for a, b in zip(dims[:-1], dims[1:]):
        shapes.append(("w", (a, b), a ** -0.5))
        if variant == "sage":
            shapes.append(("w_self", (a, b), a ** -0.5))
        shapes.append(("b", (b,), 0.1))
    total = sum(int(np.prod(s)) for _, s, _ in shapes)
    flat = torch.randn(total, generator=gen, device=device)
    layers: List[Dict[str, torch.Tensor]] = []
    off = 0
    per_layer = 3 if variant == "sage" else 2
    for j, (name, shape, scale) in enumerate(shapes):
        if j % per_layer == 0:
            layers.append({})
        size = int(np.prod(shape))
        layers[-1][name] = (flat[off:off + size].view(shape) * scale).clone()
        off += size
    return layers


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
