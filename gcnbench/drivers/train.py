"""Full-batch training: the program's SGD step (``examples/train_gcn.py::
sgd_step``) back to back on the whole graph, its aggregations through
``GraphOp`` (A' forward, A'^T backward).

Set-up builds the operator (both plans), draws the weights, features and
labels from the seed, and runs the first ``checked_steps`` steps, which
also warm up every shape. The window then runs the same objects on, and
once it has closed the same call runs one more step on the state the
window left (the window step). With the program's state freed, the
reference repeats the first steps from the same weights and the window
step from the state before it, and the run compares each step's loss
(``loss_gap``), the gradient of the first step and of the window step as
SGD applied it, ``(p_before - p_after) / lr`` (``grad_gap``), and the
change of the parameters over the checked steps (``update_gap``).
"""
from __future__ import annotations

import gc
import math
import time
from typing import Callable, Dict, List

import torch

from ..data import draw_params, generator, load_graph
from ..reference import model as ref
from ..tracing import traced
from .common import Context, Ranged, program_graph, sync, timed

RANGE = "gcnbench.aggr"
# the traced stretch: about this many seconds of steps, within these counts
TRACE_SECONDS = 2.0
TRACE_STEPS = (3, 50)


def _snap(params) -> ref.Params:
    return [{k: v.detach().clone() for k, v in p.items()} for p in params]


class TrainCell:
    """The program's operator and graph for one configuration, reused over
    seeds by the control script."""

    def __init__(self, cell, device: torch.device, log: Callable[[str], None],
                 data_dir=None):
        t0 = time.perf_counter()
        from repro_torch.models.gcn import GraphOp
        log(f"set-up: the program imported in "
            f"{time.perf_counter() - t0:.3f} s")
        cfg = cell.config
        self.device = device
        self.variant = cfg["model"]["variant"]
        self.dims: List[int] = cfg["model"]["dims"]
        self.lr = float(cell.traffic["lr"])
        self.checked = int(cell.traffic["checked_steps"])
        self.g, data_s = timed(device, lambda: load_graph(cfg["graph"],
                                                          data_dir))
        log(f"set-up: graph {cfg['graph']['name']} {self.g.n} nodes, "
            f"{self.g.nnz} nnz, read or made in {data_s:.3f} s")
        cpu0 = time.process_time()
        op, self.plan_build_s = timed(
            device, lambda: GraphOp.build(program_graph(self.g),
                                          device=device))
        log(f"set-up: GraphOp.build (plans of A' and A'^T) "
            f"{self.plan_build_s:.3f} s; the process's CPU time "
            f"{time.process_time() - cpu0:.3f} s")
        self.fwd = Ranged(op.fwd, RANGE)
        self.bwd = Ranged(op.bwd, RANGE)
        self.aggr = GraphOp(fwd=self.fwd, bwd=self.bwd)
        self.ref_graph = None

    def inputs(self, seed: int):
        gen = generator(seed, self.device)
        params = draw_params(gen, self.dims, self.variant, self.device)
        x = torch.randn((self.g.n, self.dims[0]), generator=gen,
                        device=self.device)
        y = torch.randint(0, self.dims[-1], (self.g.n,), generator=gen,
                          device=self.device)
        return params, x, y

    def step(self, params, x, y) -> float:
        from repro_torch.examples import train_gcn
        return train_gcn.sgd_step(params, self.aggr, x, y, self.variant,
                                  self.lr)

    def first_steps(self, params, x, y) -> Dict:
        """The checked steps, on the program's own objects: the loss of
        each, and snapshots before, after the first and after the last."""
        first = {"p0": _snap(params), "losses": []}
        for i in range(self.checked):
            first["losses"].append(self.step(params, x, y))
            if i == 0:
                first["p1"] = _snap(params)
        first["pN"] = _snap(params)
        return first

    def window_step(self, params, x, y) -> Dict:
        """One more step through the window's own call, on the state the
        window left: its loss and snapshots before and after."""
        last = {"p0": _snap(params)}
        last["losses"] = [self.step(params, x, y)]
        last["p1"] = _snap(params)
        return last

    def free_program(self) -> None:
        self.aggr = self.fwd = self.bwd = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, start: Dict, x, y, steps: int = 0,
                  matmul: Callable = torch.matmul) -> Dict:
        """``steps`` (the checked steps by default) reference steps from
        ``start["p0"]``."""
        if self.ref_graph is None:
            self.ref_graph = ref.build_graph(self.g.rowptr, self.g.colidx,
                                             self.g.values, self.g.n,
                                             self.device)
        losses, grads, pN = ref.sgd_steps(start["p0"], self.ref_graph, x, y,
                                          self.variant, self.lr,
                                          steps or self.checked, matmul)
        return {"losses": losses, "grad1": grads[0], "pN": pN}

    def _from_state(self, p0, p1) -> ref.Params:
        """The gradient as SGD applied it, ``(p0 - p1) / lr``."""
        return [{k: (p0[i][k] - p1[i][k]) / self.lr for k in p}
                for i, p in enumerate(p0)]

    def _grad_gap(self, run: Dict, r: Dict, ref_from_state: bool) -> float:
        """The gap of the program's gradient worked out from its state. The
        reference's is its own gradient, or with ``ref_from_state`` worked
        out from its state in the same way: late in training a step moves
        the parameters by few of their last bits, and the rounding of that
        move then weighs on both sides alike."""
        g_ref = (self._from_state(run["p0"], r["pN"]) if ref_from_state
                 else r["grad1"])
        gap, left_out = ref.norm_gap(self._from_state(run["p0"], run["p1"]),
                                     g_ref, r["grad1"])
        self.left_out += [n for n in left_out if n not in self.left_out]
        return gap

    def compare(self, first: Dict, r: Dict, last: Dict = None,
                r_last: Dict = None) -> Dict[str, float]:
        """The numbers compared: ``first`` (the checked steps) against the
        reference ``r``, and the window step ``last``, where there is one,
        against ``r_last``."""
        p0 = first["p0"]
        self.left_out = []
        d_prog = [{k: first["pN"][i][k] - p0[i][k] for k in p}
                  for i, p in enumerate(p0)]
        d_ref = [{k: r["pN"][i][k] - p0[i][k] for k in p}
                 for i, p in enumerate(p0)]
        losses, ref_losses = list(first["losses"]), list(r["losses"])
        grad_gap = self._grad_gap(first, r, False)
        if last is not None:
            losses += last["losses"]
            ref_losses += r_last["losses"]
            grad_gap = max(grad_gap, self._grad_gap(last, r_last, True))
        return {"loss_gap": ref.rel_gap(losses, ref_losses),
                "grad_gap": grad_gap,
                "update_gap": ref.norm_gap(d_prog, d_ref, r["grad1"])[0]}

    def check(self, first: Dict, last: Dict, x, y,
              matmul: Callable = torch.matmul) -> Dict[str, float]:
        """The reference run for ``first`` and ``last``, and the compared
        numbers."""
        return self.compare(first, self.reference(first, x, y, 0, matmul),
                            last, self.reference(last, x, y, 1, matmul))


def run(ctx: Context) -> Dict:
    dev = ctx.device
    tc = TrainCell(ctx.cell, dev, ctx.log, ctx.data_dir)
    params, x, y = tc.inputs(ctx.seed)
    first, warm_s = timed(dev, lambda: tc.first_steps(params, x, y))
    ctx.log(f"set-up: {tc.checked} checked steps (warm-up) {warm_s:.3f} s, "
            f"losses {first['losses']}")
    setup_s = time.perf_counter() - ctx.t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    steps = bad = 0
    t0 = time.perf_counter()
    while True:
        loss = tc.step(params, x, y)
        steps += 1
        bad += not math.isfinite(loss)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    step_s = window_s / steps
    win_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    ctx.log(f"window: {steps} steps in {window_s:.3f} s, last loss {loss}")

    trace, calls, n_traced = None, [], 0
    if ctx.trace:
        n_traced = min(max(math.ceil(TRACE_SECONDS / step_s),
                           TRACE_STEPS[0]), TRACE_STEPS[1])
        tc.fwd.calls = tc.bwd.calls = calls
        trace = {}
        with traced(trace):
            for _ in range(n_traced):
                tc.step(params, x, y)
        tc.fwd.calls = tc.bwd.calls = None
        ctx.log(f"trace: {n_traced} steps, window {trace.get('window_s')} s,"
                f" busy {trace.get('busy_s')} s")

    last = tc.window_step(params, x, y)
    ctx.log(f"window step: loss {last['losses'][0]}")
    del params
    tc.free_program()
    checks, ref_s = timed(dev, lambda: tc.check(first, last, x, y))
    ctx.log(f"reference: {tc.checked} + 1 steps in {ref_s:.3f} s; leaves "
            f"left out of the norms (reference gradient under a thousandth of "
            f"the median leaf's): {tc.left_out or 'none'}")
    return {
        "setup_s": setup_s, "attempted": steps, "failed": bad,
        "e2e": {"setup_s": setup_s, "train_step_ms": step_s * 1e3,
                "train_peak_gib": win_peak / 2 ** 30},
        "memory_peak_bytes": max(peak, win_peak),
        "checks": checks,
        "trace": trace,
        "record": {"config": ctx.cell.config, "n": tc.g.n, "nnz": tc.g.nnz,
                   "plan_build_s": tc.plan_build_s, "step_s": step_s,
                   "traced_steps": n_traced, "aggr_calls": calls,
                   "trace": trace},
    }
