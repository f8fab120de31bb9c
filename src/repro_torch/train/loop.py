"""Fault-tolerant training loop: checkpoint/restart, stateless data seeding,
straggler accounting.

The reference's contract (``repro.train.loop``):
* the loop is *restartable at any step*: data batches are derived from
  (seed, step) alone, so a restart replays bit-identical inputs;
* checkpoints are atomic (see checkpoint.manager) and saved every
  ``ckpt_every`` steps plus at the end;
* per-step wall-times are recorded; steps slower than
  ``straggler_factor x median`` are counted and surfaced;
* ``crash_at`` (test hook) raises mid-run to exercise restart-resume.

Where the reference blocks on the step's loss, the loop reads every
metric to the host in one copy a step (which waits for the step); that is
the only synchronisation it adds. The port's train step updates its state
in place, so after a crash the caller's state object holds the last
finished step: a resume restores from the checkpoint, as in the reference.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager

__all__ = ["train_loop"]


def _host_metrics(metrics) -> Dict[str, float]:
    """Every metric as a Python float, read in one device-to-host copy."""
    vals = [torch.as_tensor(v) for v in metrics.values()]
    if not vals:
        return {}
    dev = vals[0].device
    flat = torch.stack([v.detach().to(dev, torch.float64).reshape(())
                        for v in vals]).tolist()
    return dict(zip(metrics, flat))


def train_loop(
    *,
    state,
    train_step: Callable,
    batch_fn: Callable,          # (step:int) -> batch  (stateless!)
    n_steps: int,
    ckpt: Optional[CheckpointManager] = None,
    ckpt_every: int = 50,
    log_every: int = 10,
    straggler_factor: float = 3.0,
    crash_at: Optional[int] = None,
    log_fn: Callable[[str], None] = print,
) -> Dict:
    """Runs (or resumes) training; returns {'state', 'history', 'stragglers'}."""
    start = 0
    if ckpt is not None:
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(latest, state)
            start = latest
            log_fn(f"[loop] resumed from checkpoint step {latest}")

    history = []
    times = []
    stragglers = 0
    for step in range(start, n_steps):
        if crash_at is not None and step == crash_at:
            raise RuntimeError(f"simulated failure at step {step}")
        t0 = time.perf_counter()
        batch = batch_fn(step)
        state, metrics = train_step(state, batch)
        host = _host_metrics(metrics)        # waits for the step
        dt = time.perf_counter() - t0
        times.append(dt)
        med = float(np.median(times[-50:]))
        if len(times) > 5 and dt > straggler_factor * med:
            stragglers += 1
            log_fn(f"[loop] straggler step {step}: {dt:.3f}s vs median {med:.3f}s")
        history.append(host)
        if step % log_every == 0:
            log_fn(f"[loop] step {step}: " +
                   " ".join(f"{k}={v:.4g}" for k, v in host.items()))
        if ckpt is not None and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, state)
    if ckpt is not None:
        ckpt.save(n_steps, state)
    return {"state": state, "history": history, "stragglers": stragglers}
