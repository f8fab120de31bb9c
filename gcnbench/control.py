"""The readings that the comparison limits are set from, at a training
cell's own size on the card: the program's numbers over many seeds (the lower
reading), the control's and each planted fault's (the upper reading).

    python3 gcnbench/control.py --workload <name> --seeds 1,2,... \\
        [--modes program,ref_tf32,tf32,unchanged,half_batch,altered,...] \\
        [--fault-seeds 1,2,3]

One process builds the cell once and reads every seed and mode, printing
one JSON line per reading. A training reading has no window: its window
step is the step after the checked ones. Modes:

* ``program``: the program as the benchmark runs it;
* ``ref_tf32``: the control, the reference put in the program's place with
  its dense products on TF32-rounded inputs (the precision below fp32);
* ``tf32``: the program with ``allow_tf32`` switched on (the card only);
* ``unchanged``: a training step that returns its state unchanged;
* ``half_batch``: the loss taken over half the nodes, the mean over
  those;
* ``altered``: one row of every aggregation's output altered where the
  kernel produces it (+1);
* ``altered_late``: the same, only in the training steps after the first
  ``LATE_AFTER`` (those past the checked steps), as a fault that comes
  with a plan or state the window reaches.

Not part of a benchmark run; ``tests/test_gcnbench_control.py`` runs it
at a tiny size on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


_MISSING = object()
# steps before ``altered_late`` sets in: the checked steps of the traffic
LATE_AFTER = 3


@contextlib.contextmanager
def _patched(obj, name, value):
    """``obj.name`` set to ``value`` for the body; the attribute as it was
    stored (a staticmethod stays one) put back after."""
    old = vars(obj).get(name, _MISSING)
    setattr(obj, name, value)
    try:
        yield
    finally:
        if old is _MISSING:
            delattr(obj, name)
        else:
            setattr(obj, name, old)


@contextlib.contextmanager
def _tf32_on():
    import torch
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@contextlib.contextmanager
def planted(mode: str):
    """The program with ``mode``'s fault planted (or TF32 switched on)."""
    import torch
    from repro_torch.examples import train_gcn
    from repro_torch.kernels import ops
    with contextlib.ExitStack() as stack:
        if mode == "tf32":
            stack.enter_context(_tf32_on())
        elif mode == "unchanged":
            def still(params, aggr, x, labels, variant, lr):
                loss, _ = train_gcn.loss_and_grads(params, aggr, x, labels,
                                                   variant)
                return float(loss)
            stack.enter_context(_patched(train_gcn, "sgd_step", still))
        elif mode == "half_batch":
            real_loss = train_gcn.gcn_loss

            def half(params, aggr, x, labels, variant="gcn", mask=None):
                m = torch.zeros(labels.shape[0], device=labels.device)
                m[: labels.shape[0] // 2] = 1.0
                return real_loss(params, aggr, x, labels, variant, mask=m)
            stack.enter_context(_patched(train_gcn, "gcn_loss", half))
        elif mode in ("altered", "altered_late"):
            real = ops.spmm_block_slabs
            late = {"on": mode == "altered"}

            def altered(*args, **kw):
                out = real(*args, **kw)
                if late["on"]:
                    out[0] += 1.0
                return out
            if mode == "altered_late":
                real_step, steps = train_gcn.sgd_step, [0]

                def counted(*args, **kw):
                    steps[0] += 1
                    late["on"] = steps[0] > LATE_AFTER
                    return real_step(*args, **kw)
                stack.enter_context(_patched(train_gcn, "sgd_step", counted))
            stack.enter_context(_patched(ops, "spmm_block_slabs", altered))
        elif mode not in ("program", "ref_tf32"):
            raise ValueError(f"unknown mode {mode!r}")
        yield


def train_reading(tc, seed: int, mode: str) -> dict:
    """One seed's numbers for a training cell in ``mode``."""
    from gcnbench.reference import model as ref
    params, x, y = tc.inputs(seed)
    if mode == "ref_tf32":
        if tc.ref_graph is None:
            tc.ref_graph = ref.build_graph(tc.g.rowptr, tc.g.colidx,
                                           tc.g.values, tc.g.n, tc.device)

        def step(params, x, y):
            losses, _, new = ref.sgd_steps(params, tc.ref_graph, x, y,
                                           tc.variant, tc.lr, 1,
                                           ref.tf32_matmul)
            for p, q in zip(params, new):
                for k in p:
                    p[k].copy_(q[k])
            return losses[0]
        with _patched(tc, "step", step):
            first = tc.first_steps(params, x, y)
            last = tc.window_step(params, x, y)
    else:
        with planted(mode):
            first = tc.first_steps(params, x, y)
            last = tc.window_step(params, x, y)
    del params
    return tc.check(first, last, x, y)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    sys.path[:1] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from gcnbench import spec
    from gcnbench.drivers.common import sync
    from gcnbench.drivers.train import TrainCell
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    def log(s):
        print(s, file=sys.stderr, flush=True)

    tc = TrainCell(spec.load_cell(args.workload), dev, log)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    fault_seeds = [int(s) for s in args.fault_seeds.split(",") if s]
    for mode in args.modes.split(","):
        for seed in (seeds if mode == "program" else fault_seeds):
            t0 = time.perf_counter()
            r = train_reading(tc, seed, mode)
            sync(dev)
            print(json.dumps({"workload": args.workload, "mode": mode,
                              "seed": seed, **r,
                              "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
