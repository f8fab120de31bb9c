"""Plain fp32 GCN and GraphSAGE-mean: forward, loss, gradients, SGD.

The aggregation ``A @ x`` is a CSR product written in plain PyTorch. Each
row's terms ``a_rc * x[c]`` are summed in segments of at most ``L`` terms
(one ``sum`` over a padded ``[segments, L, F]`` gather, taken in chunks so
that it fits), and a row's segment sums are then added pairwise, so that
a row of millions of entries is summed by a tree and not by a chain of
atomic adds. The gradient of ``A @ x`` is ``A^T @ g``, with ``A^T`` built
here by a stable sort of the entries by column. Dense products run through
``matmul``, which a control may replace by a lower precision.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

Params = List[Dict[str, torch.Tensor]]
# elements of the [segments, L, F] gather made at once
CHUNK_ELEMS = 1 << 27


@dataclass
class Csr:
    """A sparse matrix on a device: ``rowptr`` int64[n+1], ``col`` int64,
    ``val`` fp32, ``n_cols``; ``seg_len`` is the segment length L."""

    rowptr: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    n_cols: int
    seg_len: int

    @property
    def n_rows(self) -> int:
        return self.rowptr.numel() - 1


def segment_length(rowptr: torch.Tensor, choices=(4, 8, 16, 32, 64, 128, 256)
                   ) -> int:
    """The longest L among ``choices`` whose padded slots (every row takes
    ceil(degree / L) segments of L) are at most twice the entries, so that
    the segment sums stay few; the shortest L where none is."""
    deg = rowptr[1:] - rowptr[:-1]
    nnz = int(deg.sum())
    for L in sorted(choices, reverse=True):
        if int(((deg + L - 1) // L).sum()) * L <= 2 * nnz:
            return L
    return min(choices)


def make_csr(rowptr, col, val, n_cols: int, device) -> Csr:
    rp = torch.as_tensor(rowptr, dtype=torch.int64).to(device)
    return Csr(rp, torch.as_tensor(col, dtype=torch.int64).to(device),
               torch.as_tensor(val, dtype=torch.float32).to(device),
               int(n_cols), segment_length(rp))


def transpose(a: Csr) -> Csr:
    """``A^T`` in CSR: entries sorted stably by column."""
    rows = torch.repeat_interleave(
        torch.arange(a.n_rows, device=a.col.device), a.rowptr.diff())
    order = torch.sort(a.col, stable=True).indices
    rowptr = torch.zeros(a.n_cols + 1, dtype=torch.int64, device=a.col.device)
    rowptr[1:] = torch.cumsum(torch.bincount(a.col, minlength=a.n_cols), 0)
    return Csr(rowptr, rows[order], a.val[order], a.n_rows,
               segment_length(rowptr))


def spmm(a: Csr, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` in fp32, each row summed by segments and then pairwise."""
    dev = x.device
    x = x.float()
    F = x.shape[1]
    L = a.seg_len
    deg = a.rowptr.diff()
    nseg = (deg + L - 1) // L
    seg_row = torch.repeat_interleave(torch.arange(a.n_rows, device=dev), nseg)
    first = torch.cumsum(nseg, 0) - nseg           # first segment of a row
    seg_lo = a.rowptr[:-1][seg_row] + (
        torch.arange(seg_row.numel(), device=dev) - first[seg_row]) * L
    seg_n = torch.minimum(seg_lo + L, a.rowptr[1:][seg_row]) - seg_lo
    S = seg_row.numel()
    sums = torch.empty((S, F), dtype=torch.float32, device=dev)
    lanes = torch.arange(L, device=dev)
    step = max(1, CHUNK_ELEMS // max(1, L * F))
    for lo in range(0, S, step):
        hi = min(S, lo + step)
        valid = lanes[None, :] < seg_n[lo:hi, None]
        idx = torch.where(valid, seg_lo[lo:hi, None] + lanes[None, :], 0)
        w = torch.where(valid, a.val[idx], 0.0)
        sums[lo:hi] = (w[:, :, None] * x[a.col[idx]]).sum(1)
    out = torch.zeros((a.n_rows, F), dtype=torch.float32, device=dev)
    # pairwise: a row's segments 2k and 2k+1 become its segment k, until
    # every row has one
    while S:
        count = torch.bincount(seg_row, minlength=a.n_rows)
        single = count[seg_row] == 1
        out[seg_row[single]] = sums[single]
        keep = ~single
        if not bool(keep.any()):
            break
        sums, seg_row = sums[keep], seg_row[keep]
        count = torch.bincount(seg_row, minlength=a.n_rows)
        start = torch.cumsum(count, 0) - count
        pos = torch.arange(seg_row.numel(), device=dev) - start[seg_row]
        even = torch.nonzero(pos % 2 == 0).squeeze(1)
        has_pair = (pos[even] + 1) < count[seg_row[even]]
        merged = sums[even]
        merged[has_pair] += sums[even[has_pair] + 1]
        sums, seg_row = merged, seg_row[even]
        S = seg_row.numel()
    return out


class _Aggregate(torch.autograd.Function):
    """``A @ x`` with the gradient ``A^T @ g``."""

    @staticmethod
    def forward(ctx, x, a: Csr, at: Csr):
        ctx.at = at
        return spmm(a, x)

    @staticmethod
    def backward(ctx, g):
        return spmm(ctx.at, g.contiguous()), None, None


@dataclass
class Graph:
    """A' and its transpose, for the forward and the backward."""

    a: Csr
    at: Csr

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Aggregate.apply(x, self.a, self.at)


def build_graph(rowptr, col, val, n_cols: int, device) -> Graph:
    a = make_csr(rowptr, col, val, n_cols, device)
    return Graph(a, transpose(a))


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits, nearest, ties away from
    zero), kept in fp32: what a TF32 tensor core reads of an input."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    """``a @ b`` with the inputs of the product and of both gradient
    products rounded to TF32, summed in fp32, as TF32 tensor cores do."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = tf32_round(g)
        return rg @ rb.transpose(-1, -2), ra.transpose(-1, -2) @ rg


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A product whose inputs are rounded to TF32 and summed in fp32."""
    return _Tf32Matmul.apply(a, b)


def forward(params: Params, aggr: Callable, x: torch.Tensor, variant: str,
            matmul: Callable = torch.matmul) -> torch.Tensor:
    """Node logits. ``gcn``: h <- A'(h W) + b; ``sage``: h <- (A h) W +
    h W_self + b; ReLU between layers."""
    h = x
    for i, p in enumerate(params):
        if variant == "gcn":
            h = aggr(matmul(h, p["w"])) + p["b"]
        elif variant == "sage":
            h = matmul(aggr(h), p["w"]) + matmul(h, p["w_self"]) + p["b"]
        else:
            raise ValueError(f"unknown variant {variant!r}")
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of the log-softmax at ``labels``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0].mean()


def leaves(params: Params) -> List[Tuple[int, str]]:
    return [(i, k) for i, p in enumerate(params) for k in sorted(p)]


def sgd_steps(params: Params, graph: Graph, x: torch.Tensor,
              labels: torch.Tensor, variant: str, lr: float, steps: int,
              matmul: Callable = torch.matmul
              ) -> Tuple[List[float], List[Params], Params]:
    """``steps`` steps of ``p - lr * g`` from copies of ``params``: the loss
    before each step, the gradient of each step, and the parameters after
    the last."""
    cur = [{k: v.detach().clone() for k, v in p.items()} for p in params]
    losses: List[float] = []
    grads: List[Params] = []
    for _ in range(steps):
        live = [{k: v.clone().requires_grad_() for k, v in p.items()}
                for p in cur]
        loss = loss_fn(forward(live, graph, x, variant, matmul), labels)
        names = leaves(live)
        g = torch.autograd.grad(loss, [live[i][k] for i, k in names])
        step_grads: Params = [{} for _ in cur]
        for (i, k), gk in zip(names, g):
            step_grads[i][k] = gk
            cur[i][k] = cur[i][k] - lr * gk
        losses.append(float(loss.detach()))
        grads.append(step_grads)
    return losses, grads, cur


def logits_of(params: Params, graph: Graph, x: torch.Tensor, variant: str,
              matmul: Callable = torch.matmul) -> torch.Tensor:
    with torch.no_grad():
        return forward(params, graph, x, variant, matmul)


def rel_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def norm_gap(prog: Params, ref: Params, floor_of: Optional[Params] = None
             ) -> Tuple[float, List[Tuple[int, str]]]:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and its median
    leaf norm. Leaves whose gradient in ``floor_of`` (the reference's
    first gradient) is under a thousandth of the median leaf's are left
    out; they are returned beside the gap."""
    names = leaves(ref)
    norms = {n: float(ref[n[0]][n[1]].norm()) for n in names}
    med = sorted(norms.values())[len(norms) // 2]
    skipped: List[Tuple[int, str]] = []
    if floor_of is not None:
        gn = {n: float(floor_of[n[0]][n[1]].norm()) for n in names}
        gmed = sorted(gn.values())[len(gn) // 2]
        skipped = [n for n in names if gn[n] < 1e-3 * gmed]
    worst = 0.0
    for n in names:
        if n in skipped:
            continue
        p = float(prog[n[0]][n[1]].norm())
        worst = max(worst, abs(p - norms[n]) / max(norms[n], med, 1e-30))
    return worst, skipped
