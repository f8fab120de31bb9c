"""Serve a small LM through the continuous-batching decode engine.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch mamba2-780m

Two phases, as the reference example (``examples/serve_lm.py``): the
synchronous ``generate()`` (a thin wrapper over the scheduler), then
asynchronous ``submit() -> Future`` traffic where more requests than decode
slots are in flight — finished slots are refilled mid-round (slot-reuse
admission) instead of waiting for the whole batch. The reduced config's
weights are drawn from seed 0 on ``--device`` (``cuda`` by default).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import torch

from ..configs import ARCH_IDS, get_reduced
from ..core.plan_cache import resolve_device
from ..models import lm
from ..serve.engine import Request, ServeEngine


def drive(engine: ServeEngine, batch: int, max_new: int) -> Dict:
    """The example's traffic on ``engine``: ``batch - 1`` requests through
    ``generate()``, then ``2 * batch`` concurrent ``submit()``s. Returns the
    answered requests, the async lengths asked and answers, and the
    engine's stats."""
    reqs = [Request(prompt=[1 + i, 7, 42], max_new=max_new - i * 2)
            for i in range(batch - 1)]
    t0 = time.perf_counter()
    out = engine.generate(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(r.out) for r in out)
    for i, r in enumerate(out):
        print(f"  req{i}: prompt={r.prompt} -> {r.out}")
    print(f"[serve] {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s batched greedy decode)")

    # async: 2x more requests than slots; early finishers free slots that
    # are refilled mid-round from the admission queue
    n_async = batch * 2
    prompts = [[3 + i, 11, 5] for i in range(n_async)]
    lengths = [4 + 3 * (i % 3) for i in range(n_async)]
    t0 = time.perf_counter()
    futs = [engine.submit(p, max_new=n) for p, n in zip(prompts, lengths)]
    outs = [f.result() for f in futs]
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in outs)
    st = engine.stats()
    print(f"[serve] async: {n_async} requests through {batch} slots in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s)")
    print(f"[serve] rounds={st['rounds']} slots_reused={st['slots_reused']} "
          f"slot_utilization={st['slot_utilization']:.2f} "
          f"p99 latency={st['sched_p99_latency_s'] * 1e3:.0f}ms")
    return {"sync": out, "async_lengths": lengths, "async": outs,
            "stats": st}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_reduced(args.arch)
    print(f"[serve] arch={cfg.name} (reduced config, vocab={cfg.vocab}) "
          f"on {dev}")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_lm(cfg, gen, device=dev)
    engine = ServeEngine(cfg, params, batch=args.batch, max_seq=128,
                         eos_id=-1, device=dev)
    try:
        return drive(engine, args.batch, args.max_new)
    finally:
        engine.close()


if __name__ == "__main__":
    main()
