"""What the drivers share: the run's context, the harness's host ranges
around the program's aggregation operators, and the program's graph."""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import torch

from ..data import GraphArrays
from ..spec import Cell


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float                     # process start, host clock
    log: Callable[[str], None] = field(
        default=lambda s: print(s, file=sys.stderr, flush=True))
    data_dir: Optional[str] = None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Ranged:
    """An aggregation operator called inside the host range ``name``; while
    ``calls`` is a list, each call's (rows, cols, nnz, F) is appended."""

    def __init__(self, op, name: str):
        self.op = op
        self.name = name
        self.calls: Optional[List[Tuple[int, int, int, int]]] = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with torch.profiler.record_function(self.name):
            out = self.op(x)
        if self.calls is not None:
            self.calls.append((self.op.n_rows, self.op.n_cols, self.op.nnz,
                               int(x.shape[1])))
        return out


def program_graph(g: GraphArrays):
    """The benchmark's graph as the program's CSR type."""
    from repro_torch.core.graph import CSRGraph
    return CSRGraph(g.rowptr, g.colidx, g.values, g.n)


def timed(device: torch.device, fn):
    """``fn()`` and its host seconds, ending in a synchronise."""
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0
