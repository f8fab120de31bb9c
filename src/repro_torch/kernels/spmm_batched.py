"""Batched multi-graph SpMM: many graphs through ONE kernel launch.

Serving traffic arrives as independent per-graph requests, but each graph's
block partition is just a ``[B_g, C_g]`` slab stack — a shape the kernel
grid already iterates block by block. So a batch of graphs fuses by
construction:

1. pad every graph's slabs to the batch-wide ``(C, R)`` capacity;
2. shift each graph's ``colidx`` by its feature-row offset and its
   ``out_row`` by its output-row offset (the per-graph drop sentinel
   ``n_rows_g`` is remapped to the single batch-wide sentinel ``N_out``),
   then concatenate along the block axis;
3. run the merged ``[B_total, C]`` slabs and the row-concatenated features
   through one launch of a slab kernel. The concatenated feature matrix is
   where a batch of graphs that each stay in the resident regime leaves it
   (N_pad grows with the batch), so ``backend="auto"`` asks
   ``router.route_spmm`` to pick resident (K1) / windowed (K2) / hbm (K3)
   from the merged shape, and ``backend="pallas"`` (forced resident) raises
   ``VmemBudgetError`` past the resident threshold, as the reference does;
4. slice each graph's rows back out of the batched output.

The merge runs on the slabs' device with ``torch.cat`` and offset
arithmetic, so a dispatch never copies slabs to the host; the merged slabs
are bit-identical to the reference package's host-side merge.

Padding slab slots carry value 0 and padding block rows scatter to the
sentinel row, so fused outputs are identical in structure to per-graph
runs. ``pad_blocks_to`` rounds the merged block count up to a bucket.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .ops import spmm_blocked
from .router import RoutingDecision, route_spmm
from .spmm_accel import spmm_block_slabs, spmm_block_slabs_windowed
from .spmm_hbm import spmm_block_slabs_hbm

__all__ = ["batch_graph_slabs", "spmm_batched", "bucket_blocks"]

_BACKENDS = ("auto", "pallas", "windowed", "hbm", "accel", "blocked")
# the routed backends: None routes, a regime name forces it
_FORCE = {"auto": None, "pallas": "resident", "windowed": "windowed",
          "hbm": "hbm"}
_KERNELS = {
    "resident": spmm_block_slabs,
    "windowed": spmm_block_slabs_windowed,
    "hbm": spmm_block_slabs_hbm,
}


def bucket_blocks(b_total: int, min_bucket: int = 8) -> int:
    """Next power-of-two block bucket (>= min_bucket).

    Power-of-two tiers bound padding waste below 2x the live block count
    (for ``b_total >= min_bucket``) while keeping the set of dispatched
    shapes logarithmic.
    """
    bucket = min_bucket
    while bucket < b_total:
        bucket *= 2
    return bucket


def _pad_cols(t: torch.Tensor, width: int, fill: int) -> torch.Tensor:
    if t.shape[1] == width:
        return t
    out = torch.full((t.shape[0], width), fill, dtype=t.dtype, device=t.device)
    out[:, :t.shape[1]] = t
    return out


def batch_graph_slabs(
    slab_list: Sequence[Dict],
    n_rows_list: Sequence[int],
    n_cols_list: Sequence[int],
    pad_blocks_to: Optional[int] = None,
) -> Tuple[Dict, np.ndarray, np.ndarray, int]:
    """Merge per-graph slab dicts into one batch-wide slab dict.

    Returns ``(merged, out_offsets, col_offsets, n_out_total)`` where
    ``merged`` has the same keys as a single-graph slab dict (colidx, values,
    rowloc, out_row, R, C) on the slabs' device, and graph ``i``'s output
    rows live at ``[out_offsets[i], out_offsets[i] + n_rows_list[i])`` of the
    batched result. Cost is O(sum B_g * C) device copies.
    """
    G = len(slab_list)
    if not (G == len(n_rows_list) == len(n_cols_list) and G > 0):
        raise ValueError(f"need one n_rows and n_cols per slab dict, got "
                         f"{G}, {len(n_rows_list)}, {len(n_cols_list)}")
    C = max(int(s["C"]) for s in slab_list)
    R = max(int(s["R"]) for s in slab_list)
    out_offsets = np.concatenate(([0], np.cumsum(n_rows_list))).astype(np.int64)
    col_offsets = np.concatenate(([0], np.cumsum(n_cols_list))).astype(np.int64)
    n_out = int(out_offsets[-1])
    if n_out >= 2**31 or col_offsets[-1] >= 2**31:
        raise ValueError("a fused batch must hold fewer than 2^31 rows")

    cols, vals, rlocs, orows = [], [], [], []
    for i, s in enumerate(slab_list):
        # out_row: per-graph sentinel n_rows_g -> batch sentinel n_out, live
        # rows shift by the graph's output offset
        orw = s["out_row"]
        orw = torch.where(orw == int(n_rows_list[i]),
                          torch.full_like(orw, n_out),
                          orw + int(out_offsets[i]))
        # colidx shifts into the concatenated feature rows; padding slots
        # (value 0) keep a valid index so the gather stays in bounds
        off = int(col_offsets[i])
        cols.append(_pad_cols(s["colidx"] + off, C, off))
        vals.append(_pad_cols(s["values"], C, 0))
        rlocs.append(_pad_cols(s["rowloc"], C, R - 1))
        orows.append(_pad_cols(orw, R, n_out))

    B = sum(int(c.shape[0]) for c in cols)
    if pad_blocks_to is not None and pad_blocks_to > B:
        pad = pad_blocks_to - B
        dev = cols[0].device
        cols.append(torch.zeros((pad, C), dtype=torch.int32, device=dev))
        vals.append(torch.zeros((pad, C), dtype=torch.float32, device=dev))
        rlocs.append(torch.full((pad, C), R - 1, dtype=torch.int32,
                                device=dev))
        orows.append(torch.full((pad, R), n_out, dtype=torch.int32,
                                device=dev))

    merged = {"colidx": torch.cat(cols), "values": torch.cat(vals),
              "rowloc": torch.cat(rlocs), "out_row": torch.cat(orows),
              "R": R, "C": C}
    return merged, out_offsets, col_offsets, n_out


def spmm_batched(
    slab_list: Sequence[Dict],
    x_list: Sequence[torch.Tensor],
    n_rows_list: Sequence[int],
    *,
    backend: str = "accel",
    pad_blocks_to: Optional[int] = None,
    return_decision: bool = False,
    grid_order: str = "block_major",
) -> Union[List[torch.Tensor],
           Tuple[List[torch.Tensor], Optional[RoutingDecision]]]:
    """Fused SpMM over several graphs; returns one ``[n_rows_g, F_g]`` output
    per graph (degree-sorted row order, same as the single-graph kernel).

    Feature matrices may differ in width; they are right-padded to the batch
    max ``F`` (padding columns are sliced off on the way out).

    Backends: ``auto`` routes the merged dispatch (resident K1 / windowed
    K2 / hbm K3) on ``n_x = sum(n_cols)`` at fp32; ``pallas`` forces the
    resident regime and raises ``VmemBudgetError`` past its threshold;
    ``windowed`` / ``hbm`` force K2 / K3; ``accel`` is K1 with no routing;
    ``blocked`` is the PyTorch twin. With ``return_decision=True`` the
    routing record (``None`` for ``accel`` and ``blocked``) comes back
    alongside the outputs. ``grid_order`` reaches K1 only. Every kernel
    takes its plain version for CPU tensors.
    """
    if backend not in _BACKENDS:
        raise ValueError(f"batched spmm backend must be "
                         f"{'|'.join(_BACKENDS)}, got {backend!r}")
    G = len(slab_list)
    if not (G == len(x_list) == len(n_rows_list) and G > 0):
        raise ValueError("need one feature matrix and n_rows per slab dict")
    n_cols_list = [int(x.shape[0]) for x in x_list]
    f_list = [int(x.shape[1]) for x in x_list]
    F = max(f_list)

    merged, out_off, _, n_out = batch_graph_slabs(
        slab_list, list(n_rows_list), n_cols_list, pad_blocks_to=pad_blocks_to)

    x_cat = torch.cat(
        [torch.nn.functional.pad(x.float(), (0, F - f)) if f < F
         else x.float() for x, f in zip(x_list, f_list)], dim=0)

    args = (merged["colidx"], merged["values"], merged["rowloc"],
            merged["out_row"], x_cat, n_out)
    decision: Optional[RoutingDecision] = None
    if backend in _FORCE:
        # n_x = sum of n_cols: the quantity that overflows the resident regime
        decision = route_spmm(int(x_cat.shape[0]), F, int(merged["C"]),
                              int(merged["R"]), force=_FORCE[backend])
        kwargs = ({"grid_order": grid_order}
                  if decision.backend == "resident" else {})
        out = _KERNELS[decision.backend](*args, **kwargs)
    elif backend == "accel":
        out = spmm_block_slabs(*args, grid_order=grid_order)
    else:
        out = spmm_blocked(*args)

    outs = [out[int(out_off[i]):int(out_off[i + 1]), :f_list[i]]
            for i in range(G)]
    return (outs, decision) if return_decision else outs
