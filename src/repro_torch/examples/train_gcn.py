"""End-to-end trainer: train a GCN with the Accel-GCN aggregation operator.

    PYTHONPATH=src python -m repro_torch.examples.train_gcn --preset tiny --device cpu
    PYTHONPATH=src python -m repro_torch.examples.train_gcn --preset 100m

The counterpart of the reference's ``examples/train_gcn.py``: the same
presets, graph, features, labels and update (plain SGD, ``p - lr * g``),
with a checkpoint every 100 steps. The aggregation runs forward on A' and
backward on A'^T through ``--backend`` (K1 by default) on ``--device``
(``cuda`` by default). The 100m preset is a ~106M-parameter GCN: each step
launches K1 18 times, 9 on A' and 9 on A'^T (a trained ``gcn`` layer
aggregates after its product, ``models/gcn.py::transform_first``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..checkpoint.manager import CheckpointManager
from ..core.graph import CSRGraph, gcn_normalize
from ..core.plan_cache import DeviceLike, resolve_device
from ..data.graphs import make_power_law_graph, node_features, node_labels
from ..models.gcn import GraphOp, gcn_loss, init_gcn
from ..spans import span

PRESETS = {
    # name: (nodes, edges, dims, classes, steps)
    "tiny": (2_000, 12_000, [64, 128, 16], 16, 60),
    "25m": (8_000, 64_000, [1024, 2048, 2048, 2048, 2048, 256], 256, 200),
    "100m": (5_000, 40_000, [1024] + [4096] * 7 + [256], 256, 300),
}
BACKENDS = ("accel", "auto", "pallas", "windowed", "hbm", "blocked",
            "segment")

Params = List[Dict[str, torch.Tensor]]


@dataclasses.dataclass
class Problem:
    """One preset's graph, operator, features, labels and parameters."""

    graph: CSRGraph            # A', GCN-normalized
    aggr: GraphOp
    x: torch.Tensor            # [nodes, dims[0]] fp32
    labels: torch.Tensor       # [nodes] int32
    params: Params


def build_problem(preset: str, variant: str = "gcn",
                  backend: str = "accel", device: DeviceLike = None
                  ) -> Problem:
    """The preset's power-law graph, features and labels from seed 0, A'
    and A'^T plans on ``device``, and parameters from a generator seeded
    with 0, as the reference's trainer makes them."""
    n, e, dims, classes, _ = PRESETS[preset]
    dev = resolve_device(device)
    g = gcn_normalize(make_power_law_graph(n, e, seed=0))
    aggr = GraphOp.build(g, backend=backend, device=dev)
    x = torch.from_numpy(node_features(n, dims[0], 0)).to(dev)
    y = torch.from_numpy(node_labels(n, classes, 0)).to(dev)
    params = init_gcn(torch.Generator().manual_seed(0), dims + [classes],
                      variant, device=dev)
    return Problem(g, aggr, x, y, params)


def loss_and_grads(params: Params, aggr: Callable, x: torch.Tensor,
                   labels: torch.Tensor, variant: str = "gcn"
                   ) -> Tuple[torch.Tensor, Params]:
    """The loss and its gradient for every parameter (same structure)."""
    leaves = [(i, k) for i, p in enumerate(params) for k in sorted(p)]
    live = [params[i][k].detach().requires_grad_() for i, k in leaves]
    tree = [dict(p) for p in params]
    for (i, k), t in zip(leaves, live):
        tree[i][k] = t
    with span("train.forward"):
        loss = gcn_loss(tree, aggr, x, labels, variant)
    with span("train.backward"):
        grads = torch.autograd.grad(loss, live)
    out: Params = [{} for _ in params]
    for (i, k), gr in zip(leaves, grads):
        out[i][k] = gr
    return loss.detach(), out


def sgd_step(params: Params, aggr: Callable, x: torch.Tensor,
             labels: torch.Tensor, variant: str, lr: float) -> float:
    """One step of ``p - lr * g`` on every parameter, in place; returns
    the loss before the step."""
    with span("train.step"):
        loss, grads = loss_and_grads(params, aggr, x, labels, variant)
        with span("train.update"), torch.no_grad():
            for p, gp in zip(params, grads):
                for k in p:
                    p[k] -= lr * gp[k]
        with span("train.readback"):
            return float(loss)


def train(params: Params, aggr: Callable, x: torch.Tensor,
          labels: torch.Tensor, *, variant: str, lr: float, steps: int,
          ckpt: Optional[CheckpointManager] = None,
          on_step: Optional[Callable[[int, float], None]] = None
          ) -> List[float]:
    """``steps`` SGD steps, a checkpoint every 100; ``on_step(s, loss)``
    after each. Returns the loss of every step."""
    losses = []
    for s in range(steps):
        losses.append(sgd_step(params, aggr, x, labels, variant, lr))
        if on_step is not None:
            on_step(s, losses[-1])
        if ckpt is not None and (s + 1) % 100 == 0:
            ckpt.save(s + 1, params)
    return losses


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=PRESETS)
    ap.add_argument("--variant", default="gcn", choices=["gcn", "sage", "gin"])
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="accel", choices=BACKENDS)
    args = ap.parse_args(argv)

    n, e, dims, classes, steps = PRESETS[args.preset]
    steps = args.steps or steps
    print(f"[train_gcn] graph: {n} nodes / {e} edges; dims={dims}+[{classes}]"
          f"; {args.backend} on {args.device}")
    prob = build_problem(args.preset, args.variant, args.backend,
                         args.device)
    n_params = sum(t.numel() for p in prob.params for t in p.values())
    print(f"[train_gcn] {n_params/1e6:.1f}M parameters, {steps} steps")
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    t0 = time.perf_counter()

    def report(s: int, loss: float) -> None:
        if s % 20 == 0 or s == steps - 1:
            dt = time.perf_counter() - t0
            print(f"  step {s:4d} loss={loss:.4f} ({dt:.1f}s)")

    losses = train(prob.params, prob.aggr, prob.x, prob.labels,
                   variant=args.variant, lr=args.lr, steps=steps, ckpt=ckpt,
                   on_step=report)
    with torch.no_grad():
        final = float(gcn_loss(prob.params, prob.aggr, prob.x, prob.labels,
                               args.variant))
    print(f"[train_gcn] final loss {final:.4f} "
          f"in {time.perf_counter()-t0:.1f}s")
    return losses


if __name__ == "__main__":
    main()
