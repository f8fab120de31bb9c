"""LM training launcher: the reference's (``repro.launch.train``) substrate:
train state, train step, fault-tolerant loop, checkpointing, stateless
data.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
        --steps 20 --batch 4 --seq 64 [--device cpu] [--ckpt-dir DIR]

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node N \\
        -m repro_torch.launch.train --full --model-axis M

``--reduced`` (the default) runs the arch's reduced config; ``--full`` its
full config. Without a process group it runs on one card. Under
``torch.distributed.run`` (``RANK`` / ``WORLD_SIZE`` set) each process is
one rank: the group is ``nccl`` on ``cuda`` (one card a rank, the card of
``LOCAL_RANK``), ``gloo`` on ``cpu``, and the step is partitioned over
``make_host_mesh(model=--model-axis)``: FSDP on "data", TP/EP on "model"
(the reference's ``--full`` at the mesh those ranks make). Rank 0 prints
and writes the checkpoints. ``--device`` defaults to ``cuda``.
``main(argv)`` returns the loop's result.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from ..checkpoint.manager import CheckpointManager
from ..configs import ARCH_IDS, get_config, get_reduced
from ..core.plan_cache import resolve_device
from ..data.tokens import token_batch_fn
from ..models import lm
from ..sharding import clear_mesh_ctx, param_specs, set_mesh_ctx
from ..train.loop import train_loop
from ..train.step import init_train_state, make_train_step
from .mesh import make_device_mesh, make_host_mesh


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
                    help="full config; under torch.distributed.run, "
                         "partitioned over the mesh the ranks make")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="size of the mesh's \"model\" axis (TP/EP) "
                         "under a process group; \"data\" (FSDP) takes "
                         "the rest of the ranks")
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
    made = _init_group(dev)
    group = dist.is_initialized()
    if group:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dev.type == "cuda" else dev)
    rank0 = not group or dist.get_rank() == 0

    def say(msg):
        if rank0:
            print(msg)

    sizes = make_host_mesh(args.model_axis if group else 1, device=dev)
    device_mesh = make_device_mesh(sizes, device=dev) if group else None
    set_mesh_ctx(device_mesh if group else sizes)
    try:
        say(f"[train] {cfg.name} on mesh {sizes} ({dev}"
            f"{f', {dist.get_world_size()} ranks' if group else ''})")
        state = init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
            mesh=device_mesh)
        specs = _specs(param_specs(state, sizes))
        say(f"[train] {lm.param_count(state.params)} parameters; "
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
                         log_every=5, log_fn=say)
    finally:
        clear_mesh_ctx()
        if made:
            dist.destroy_process_group()
    last = (f"final loss {out['history'][-1]['loss']:.4f}"
            if out["history"] else "no step left to run")
    say(f"[train] done; {last}, stragglers={out['stragglers']}")
    return out


def _init_group(dev: torch.device) -> bool:
    """``init_process_group`` from the environment ``torch.distributed.run``
    sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``):
    ``nccl`` with the card of ``LOCAL_RANK`` on ``cuda``, ``gloo`` on
    ``cpu``. Whether it made a group: not where ``WORLD_SIZE`` is not set
    (one card) or a group already exists (the caller's)."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return True


if __name__ == "__main__":
    main()
