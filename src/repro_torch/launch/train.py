"""LM training launcher: the reference's (``repro.launch.train``) substrate
on one card: train state, train step, fault-tolerant loop, checkpointing,
stateless data.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
        --steps 20 --batch 4 --seq 64 [--device cpu] [--ckpt-dir DIR]

``--reduced`` (the default) runs the arch's reduced config; ``--full`` its
full config. Both run on ``make_host_mesh()`` of the visible cards: the
reference runs ``--full`` on its production mesh under
``jax.distributed``, which here would only make ``sharding.shard`` raise
(the port has no sharded path). ``--device`` defaults to ``cuda``.
``main(argv)`` returns the loop's result.
"""
from __future__ import annotations

import argparse

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs import ARCH_IDS, get_config, get_reduced
from ..core.plan_cache import resolve_device
from ..data.tokens import token_batch_fn
from ..models import lm
from ..sharding import clear_mesh_ctx, param_specs, set_mesh_ctx
from ..train.loop import train_loop
from ..train.step import init_train_state, make_train_step
from .mesh import make_host_mesh


def _specs(tree):
    """The spec tuples of a ``param_specs`` tree (dicts, named tuples)."""
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _specs(v)]
    if hasattr(tree, "_fields"):
        return [s for v in tree for s in _specs(v)]
    return [tree]


def _batch_fn(cfg, batch: int, seq: int, dev: torch.device):
    """(step) -> batch on ``dev``: token batches from ``token_batch_fn``;
    for a stub frontend, bf16 frame embeddings and labels drawn from a
    ``torch.Generator`` seeded by the step."""
    if cfg.frontend == "token":
        bf_np = token_batch_fn(batch=batch, seq=seq, vocab=cfg.vocab)
        return lambda s: {k: torch.from_numpy(v).to(dev)
                          for k, v in bf_np(s).items()}

    def bf(s):
        g = torch.Generator(device=dev).manual_seed(s)
        x = torch.randn((batch, seq, cfg.d_model), generator=g,
                        dtype=torch.float32, device=dev).to(torch.bfloat16)
        y = torch.randint(0, cfg.vocab, (batch, seq), generator=g,
                          device=dev)
        return {"inputs": x, "labels": y}
    return bf


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="phi3-mini-3.8b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="full config, on make_host_mesh() of the visible "
                         "card(s): the reference's production mesh would "
                         "only make shard() raise here (no sharded path)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    mesh = make_host_mesh(device=dev)
    set_mesh_ctx(mesh)
    try:
        print(f"[train] {cfg.name} on mesh {mesh} ({dev})")
        state = init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        specs = _specs(param_specs(state, mesh))
        print(f"[train] {lm.param_count(state.params)} parameters; "
              f"{sum(any(a is not None for a in s) for s in specs)} of "
              f"{len(specs)} state leaves have a sharded spec")
        step = make_train_step(cfg, peak_lr=args.lr,
                               microbatch=args.microbatch,
                               loss_chunk=min(512, args.seq),
                               q_chunk=min(512, args.seq),
                               kv_chunk=min(512, args.seq), ssd_chunk=8)
        ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
        out = train_loop(state=state, train_step=step,
                         batch_fn=_batch_fn(cfg, args.batch, args.seq, dev),
                         n_steps=args.steps, ckpt=ckpt, ckpt_every=50,
                         log_every=5)
    finally:
        clear_mesh_ctx()
    last = (f"final loss {out['history'][-1]['loss']:.4f}"
            if out["history"] else "no step left to run")
    print(f"[train] done; {last}, stragglers={out['stragglers']}")
    return out


if __name__ == "__main__":
    main()
