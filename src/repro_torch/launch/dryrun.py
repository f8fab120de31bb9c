"""The dry run: per-device memory, cost and the roofline of every
(architecture x input shape) cell, traced on the meta device.

The reference (``repro.launch.dryrun``) lowers and compiles each cell's
jitted step on the production meshes and reads XLA's ``memory_analysis()``
and ``cost_analysis()``; its roofline extrapolates depth-reduced, unrolled
probes to full depth, because XLA counts a ``while`` body once. The port's
program is eager and runs on one card, so here:

* the ``"h100"`` row runs the cell's step once on ``meta`` tensors under
  :class:`~repro_torch.analysis.counters.CountingMode` at the production
  chunks (512; SSD 128): argument, output and temporary bytes per device
  and the step's cost vector (``rolled_cost``, the reference's name). No
  memory is allocated and nothing is computed;
* the production rows (``"pod16x16"``, ``"multipod2x16x16"``) trace
  **rank 0's partitioned program** (:func:`trace_partitioned`): a
  ``fake`` process group of 256 or 512 ranks (made and destroyed inside
  the row, so the rest of the process sees no group), the state placed by
  ``param_specs`` / ``cache_specs`` and the batch on the batch axes as
  DTensors of meta shards, ``DISPATCH_GROUPS`` the "data" size, the step
  counted on ``meta`` under the same mode: per-device argument, output,
  temporary and peak bytes, and a ``rolled_cost`` with the collectives
  (``coll``, ``coll_<kind>``) by the reference's ``collective_bytes``
  rule. The fake group computes nothing: its counts are those of the
  program, not of any values;
* :func:`probe_roofline` traces the WHOLE depth at the reference's probe
  chunks (``min(4096, T)``, SSD 128): an eager trace counts every layer,
  so nothing is extrapolated (``_probe_plan`` is kept as the reference's,
  and the tests hold its extrapolation to the direct count);
* the roofline is the one-card program's compute and memory terms, with
  the collective term of the ``pod16x16`` row's partitioned program
  (``collective_s = coll / link_bw``, its ``coll_breakdown``), against a
  card of :data:`~repro_torch.analysis.roofline.HARDWARE` (``--hw``; the
  card this process runs on when not named).

FLOPs are the eager program's (every attention block, remat's recompute),
not XLA's; bytes are op-by-op traffic (see ``analysis/counters.py``).

Usage:
  python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --hw "NVIDIA H100 80GB HBM3"
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import traceback
from typing import Any, Dict, Tuple

import torch

from ..analysis.counters import Counts, count_call
from ..analysis.roofline import (HwLike, hw_row, model_flops_estimate,
                                 roofline_terms)
from ..configs import ARCH_IDS, SHAPES_BY_NAME, get_config, shape_skips
from ..configs.base import ArchConfig, ShapeConfig
from ..core.plan_cache import DeviceLike, resolve_device
from ..models import lm
from ..models import moe as moe_mod
from ..sharding import (batch_axes, cache_specs, distribute, on_batch_axes,
                        param_specs, resolve_spec, use_mesh)
from ..train.step import init_train_state, make_train_step
from .mesh import make_device_mesh, make_production_mesh

__all__ = ["input_specs", "build_cell", "trace_cell", "trace_partitioned",
           "fake_group", "cost_vector", "cost_roofline",
           "active_param_count", "probe_roofline", "sharded_argument_bytes",
           "run_cell", "main"]

ONE_CARD = {"data": 1, "model": 1}   # the mesh of the port's program


# ---------------------------------------------------------------------------
# input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------
def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                device: DeviceLike = "meta") -> Dict[str, Any]:
    """The cell's inputs, the reference's ``ShapeDtypeStruct``s as tensors
    on ``device`` (zeros off ``meta``): int32 tokens ``[B, T]`` (bf16
    frames ``[B, T, d_model]`` for a stub frontend) and int32 labels for
    train; decode: int32 ``[B, 1]`` tokens against a ``T``-long
    ``init_decode_state``."""
    dev = resolve_device(device)
    B, T = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "token":
            inp = torch.zeros((B, T), dtype=torch.int32, device=dev)
        else:  # stub modality frontend: precomputed frame/patch embeddings
            inp = torch.zeros((B, T, cfg.d_model), dtype=torch.bfloat16,
                              device=dev)
        if shape.kind == "train":
            return {"inputs": inp, "labels": torch.zeros(
                (B, T), dtype=torch.int32, device=dev)}
        return {"inputs": inp}
    # decode: one new token against a T-long cache
    return {"tokens": torch.zeros((B, 1), dtype=torch.int32, device=dev),
            "state": lm.init_decode_state(cfg, B, T, device=dev)}


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------
def build_cell(cfg: ArchConfig, shape: ShapeConfig, *, chunks=None,
               device: DeviceLike = "meta", mesh=None):
    """Returns ``(fn, args)``: the cell's step and its arguments on
    ``device`` (parameters drawn from seed 0 off ``meta``). Train:
    ``make_train_step`` on ``init_train_state``; prefill:
    ``lm.prefill_forward``; decode: ``decode_step`` then the argmax as
    int32. With a ``DeviceMesh``: the partitioned program, the state
    placed by ``param_specs`` / ``cache_specs`` and the batch on the batch
    axes (each rank's shards of the whole arguments); a microbatched train
    step takes its batch whole and places each microbatch itself."""
    chunks = chunks or {}
    q = chunks.get("q_chunk", 512)
    kv = chunks.get("kv_chunk", 512)
    lc = chunks.get("loss_chunk", 512)
    sc = chunks.get("ssd_chunk", 128)
    mb = chunks.get("microbatch", None)
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(0)
    specs = input_specs(cfg, shape, dev)

    def batch(t):
        return t if mesh is None else on_batch_axes(t, mesh)

    if shape.kind == "train":
        state = init_train_state(cfg, gen, device=dev, mesh=mesh)
        fn = make_train_step(cfg, loss_chunk=lc, q_chunk=q, kv_chunk=kv,
                             ssd_chunk=sc, microbatch=mb)
        whole = mb and mb < shape.global_batch
        return fn, (state, {k: v if whole else batch(v)
                            for k, v in specs.items()})

    params = lm.init_lm(cfg, gen, device=dev)
    if mesh is not None:
        params = distribute(params, param_specs(params, mesh), mesh)
    if shape.kind == "prefill":
        fn = functools.partial(lm.prefill_forward, cfg, q_chunk=q,
                               kv_chunk=kv, ssd_chunk=sc)
        return fn, (params, batch(specs["inputs"]))

    def fn(params, state, tokens):
        logits, st = lm.decode_step(cfg, params, tokens, state)
        return torch.argmax(logits, -1).to(torch.int32), st

    st = specs["state"]
    if mesh is not None:
        st = distribute(st, cache_specs(st, mesh), mesh)
    return fn, (params, st, batch(specs["tokens"]))


def run_counted(fn, args, kind: str, mesh=None) -> Counts:
    """``fn(*args)`` once under the counting mode (and ``mesh``'s context);
    autograd only for train (the reference's prefill and decode are pure
    forwards)."""
    with torch.set_grad_enabled(kind == "train"), use_mesh(mesh):
        _, counts = count_call(fn, *args)
    return counts


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """A ``fake`` process group of ``world`` ranks as rank ``rank`` for the
    block (collectives return without moving or computing anything),
    destroyed after it. Raises where a group already exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group already exists in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def trace_partitioned(cfg: ArchConfig, shape: ShapeConfig,
                      sizes: Dict[str, int], *, chunks=None,
                      device: DeviceLike = "meta", rank: int = 0
                      ) -> Tuple[Counts, float]:
    """Rank ``rank``'s share of the cell's partitioned program over a mesh
    of axis sizes ``sizes``, traced once on ``device`` (``meta``: nothing
    allocated) under a fake process group of that many ranks, with the
    reference's ``DISPATCH_GROUPS`` handling: its :class:`Counts` and the
    seconds the trace took."""
    prev_groups = moe_mod.DISPATCH_GROUPS
    if moe_mod.DISPATCH_GROUPS == 1:
        moe_mod.DISPATCH_GROUPS = sizes.get("data", 1)
    try:
        with fake_group(math.prod(sizes.values()), rank):
            mesh = make_device_mesh(sizes, device=device)
            fn, args = build_cell(cfg, shape, chunks=chunks, device=device,
                                  mesh=mesh)
            counts = run_counted(fn, args, shape.kind, mesh)
        return counts, counts.seconds
    finally:
        moe_mod.DISPATCH_GROUPS = prev_groups


def trace_cell(cfg: ArchConfig, shape: ShapeConfig, *, chunks=None
               ) -> Tuple[Counts, float]:
    """The cell's step traced once on ``meta``: its :class:`Counts` and the
    seconds the trace took (the reference's ``lower_and_compile``)."""
    # optimized-default (the reference's): grouped MoE dispatch, one group
    # per data shard; one card has one
    prev_groups = moe_mod.DISPATCH_GROUPS
    if moe_mod.DISPATCH_GROUPS == 1:
        moe_mod.DISPATCH_GROUPS = ONE_CARD.get("data", 1)
    try:
        fn, args = build_cell(cfg, shape, chunks=chunks)
        counts = run_counted(fn, args, shape.kind)
        return counts, counts.seconds
    finally:
        moe_mod.DISPATCH_GROUPS = prev_groups


def cost_vector(counts: Counts) -> Dict[str, float]:
    """The reference's ``_cost_vector`` keys: ``flops``, ``bytes``, ``coll``
    (0 for the one-card program) and ``coll_<kind>`` for each kind of
    collective the program ran."""
    return {"flops": float(counts.flops), "bytes": float(counts.bytes),
            "coll": float(counts.coll),
            **{f"coll_{k}": float(v) for k, v in counts.coll_bytes.items()}}


def cost_roofline(cost: Dict[str, float], *, model_flops=None,
                  hw: HwLike = None):
    """``roofline_terms`` of a :func:`cost_vector` for the one-card
    program (``chips=1``, no HLO); a vector with ``coll`` (a partitioned
    row's, :func:`probe_roofline`'s ``coll=``) also gets the collective
    term, ``coll / link_bw``, and its ``coll_breakdown``."""
    rl = roofline_terms({"flops": cost["flops"],
                         "bytes accessed": cost["bytes"]}, "", chips=1,
                        model_flops=model_flops, hw=hw)
    if cost.get("coll"):
        rl.bytes_coll = cost["coll"]
        rl.coll_breakdown = {k[5:]: v for k, v in cost.items()
                             if k.startswith("coll_")}
        rl.collective_s = cost["coll"] / hw_row(hw)["link_bw"]
        terms = {"compute": rl.compute_s, "memory": rl.memory_s,
                 "collective": rl.collective_s}
        rl.bottleneck = max(terms, key=terms.get)
    return rl


# ---------------------------------------------------------------------------
# model-FLOPs accounting (6*N_active*D)
# ---------------------------------------------------------------------------
def _walk(tree, path=""):
    """(path, leaf) over dicts and named tuples, keys joined with "."; a
    spec tuple is a leaf, and so is a host int (``DecodeState.pos``);
    None is dropped."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        if tree is not None:
            yield path, tree
        return
    for k, v in items:
        yield from _walk(v, f"{path}.{k}" if path else str(k))


def active_param_count(cfg: ArchConfig) -> float:
    """Matmul parameters a token activates: routed experts count at
    top_k / n_experts, embedding and head are skipped (lookups are not
    matmul FLOPs). The reference's definition, from the meta-device
    parameter tree."""
    total = 0.0
    for pstr, leaf in _walk(lm.init_lm(cfg, None, device="meta")):
        n = float(leaf.numel())
        if ".moe." in pstr and any(pstr.endswith(s) for s in ("wi", "wg", "wo")):
            n *= cfg.top_k / cfg.n_experts   # routed experts: only top-k active
        if "embed" in pstr or "head" in pstr:
            continue                          # embedding lookups are not matmul FLOPs
        total += n
    return total


# ---------------------------------------------------------------------------
# roofline probes
# ---------------------------------------------------------------------------
def _probe_plan(cfg: ArchConfig):
    """[(probe_cfg, units)] + full_units; cost is linear in ``units``."""
    if cfg.family == "hybrid":
        n_groups, g, tail = cfg.n_layers // cfg.hybrid_group, cfg.hybrid_group, \
            cfg.n_layers % cfg.hybrid_group
        # 3 probes solve (fixed, per_mamba, per_shared); the tests hold the
        # reference's solver to the direct full-depth count
        return "hybrid", [
            cfg.replace(n_layers=3, hybrid_group=3),   # 1 shared + 3 mamba
            cfg.replace(n_layers=6, hybrid_group=6),   # 1 shared + 6 mamba
            cfg.replace(n_layers=6, hybrid_group=3),   # 2 shared + 6 mamba
        ], (n_groups, cfg.n_layers)
    if cfg.local_global_period == 2:
        return "linear", [cfg.replace(n_layers=2), cfg.replace(n_layers=4)], \
            cfg.n_layers // 2  # units = pairs
    if cfg.family == "moe" and cfg.first_dense_layers:
        nd = cfg.first_dense_layers
        return "linear", [cfg.replace(n_layers=nd + 1), cfg.replace(n_layers=nd + 2)], \
            cfg.n_layers - nd  # units = moe layers
    return "linear", [cfg.replace(n_layers=1), cfg.replace(n_layers=2)], cfg.n_layers


def probe_chunks(shape: ShapeConfig, microbatch_div: int = 0
                 ) -> Dict[str, int]:
    """The reference's probe chunks (full-attention FLOPs are
    chunk-invariant; larger chunks trace faster); with ``microbatch_div``,
    microbatches of ``global_batch // microbatch_div`` rows."""
    T = shape.seq_len
    chunks = {"q_chunk": min(4096, T), "kv_chunk": min(4096, T),
              "loss_chunk": min(4096, T), "ssd_chunk": 128}
    if microbatch_div:
        chunks["microbatch"] = max(1, shape.global_batch // microbatch_div)
    return chunks


def probe_roofline(cfg: ArchConfig, shape: ShapeConfig,
                   coll: Dict[str, float] = None) -> Dict[str, float]:
    """Full-depth one-card cost vector at the reference's probe chunks
    (every layer traced: nothing to extrapolate); ``coll``, a partitioned
    row's ``rolled_cost``, gives it that row's collectives (``coll`` and
    ``coll_<kind>``)."""
    counts, _ = trace_cell(cfg, shape, chunks=probe_chunks(shape))
    vec = cost_vector(counts)
    if coll is not None:
        vec.update({k: v for k, v in coll.items() if k.startswith("coll")})
    return vec


# ---------------------------------------------------------------------------
# production meshes: per-device argument bytes from the specs
# ---------------------------------------------------------------------------
def _axes_product(spec, mesh) -> int:
    n = 1
    for ax in spec:
        for a in ((ax,) if isinstance(ax, str) else (ax or ())):
            n *= mesh[a]
    return n


def _per_device_bytes(tree, specs, mesh) -> int:
    """Each tensor leaf's bytes over the product of its spec's axes
    (``specs`` has ``tree``'s structure)."""
    return sum(t.numel() * t.element_size() // _axes_product(spec, mesh)
               for (_, t), (_, spec) in zip(_walk(tree), _walk(specs))
               if isinstance(t, torch.Tensor))


def sharded_argument_bytes(cfg: ArchConfig, shape: ShapeConfig,
                           mesh: Dict[str, int]) -> int:
    """Per-device argument bytes of the cell under the reference's
    partitioning over ``mesh`` (axis sizes): parameters (train: the whole
    ``TrainState``) by ``param_specs``, the decode state by
    ``cache_specs``, the batch on the batch axes."""
    specs = input_specs(cfg, shape)
    baxes = batch_axes(mesh)

    def batch(t):
        want = [baxes] + [None] * (t.dim() - 1)
        return t.numel() * t.element_size() // _axes_product(
            resolve_spec(tuple(t.shape), want, mesh), mesh)

    if shape.kind == "train":
        state = init_train_state(cfg, None, device="meta")
        return (_per_device_bytes(state, param_specs(state, mesh), mesh)
                + batch(specs["inputs"]) + batch(specs["labels"]))
    params = lm.init_lm(cfg, None, device="meta")
    total = _per_device_bytes(params, param_specs(params, mesh), mesh)
    if shape.kind == "prefill":
        return total + batch(specs["inputs"])
    st = specs["state"]
    return (total + _per_device_bytes(st, cache_specs(st, mesh), mesh)
            + batch(specs["tokens"]))


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------
def run_cell(arch: str, shape_name: str, *, do_multipod=True,
             do_roofline=True, hw: HwLike = None) -> Dict[str, Any]:
    """One cell's record, with the reference's keys (see the module
    docstring); ``hw`` as for ``roofline_terms``."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "kind": shape.kind}
    skip = shape_skips(cfg, shape)
    if skip:
        rec["skipped"] = skip
        return rec
    row = hw_row(hw)

    counts, dt = trace_cell(cfg, shape)
    cv = cost_vector(counts)
    print(f"[dryrun] {arch} x {shape_name} x h100 (one card, meta): "
          f"trace {dt:.1f}s")
    print(f"         counts: args={counts.argument_bytes/1e9:.3f}GB "
          f"out={counts.output_bytes/1e9:.3f}GB "
          f"temp={counts.temp_bytes/1e9:.3f}GB (per device)")
    print(f"         cost: flops={cv['flops']:.3e} bytes={cv['bytes']:.3e} "
          f"coll={cv['coll']:.3e}")
    rec["h100"] = {
        "trace_s": dt,
        "argument_bytes_per_dev": counts.argument_bytes,
        "output_bytes_per_dev": counts.output_bytes,
        "temp_bytes_per_dev": counts.temp_bytes,
        "peak_bytes_per_dev": counts.peak_live_bytes,
        "rolled_cost": cv,
        "chips": 1,
    }

    meshes = [("pod16x16", make_production_mesh(multi_pod=False))]
    if do_multipod:
        meshes.append(("multipod2x16x16", make_production_mesh(multi_pod=True)))
    for mname, mesh in meshes:
        chips = math.prod(mesh.values())
        pc, dt = trace_partitioned(cfg, shape, mesh)
        pv = cost_vector(pc)
        print(f"[dryrun] {arch} x {shape_name} x {mname} (rank 0 of {chips}, "
              f"fake group, meta): trace {dt:.1f}s")
        print(f"         counts: args={pc.argument_bytes/1e9:.3f}GB "
              f"out={pc.output_bytes/1e9:.3f}GB "
              f"temp={pc.temp_bytes/1e9:.3f}GB (per device)")
        print(f"         cost: flops={pv['flops']:.3e} bytes={pv['bytes']:.3e} "
              f"coll={pv['coll']:.3e}")
        rec[mname] = {
            "trace_s": dt,
            "argument_bytes_per_dev": pc.argument_bytes,
            "output_bytes_per_dev": pc.output_bytes,
            "temp_bytes_per_dev": pc.temp_bytes,
            "peak_bytes_per_dev": pc.peak_live_bytes,
            "rolled_cost": pv,
            "chips": chips,
        }

    if do_roofline:
        pod = rec["pod16x16"]["rolled_cost"]
        full_cost = probe_roofline(cfg, shape, coll=pod)
        n_act = active_param_count(cfg)
        tokens = (shape.global_batch * shape.seq_len
                  if shape.kind in ("train", "prefill") else shape.global_batch)
        mf = model_flops_estimate(n_act, tokens,
                                  "train" if shape.kind == "train" else "infer")
        rl = cost_roofline(full_cost, model_flops=mf, hw=row)
        rec["roofline"] = {**rl.to_row(), "active_params": n_act,
                           "tokens": tokens, "hw": row.get("name"),
                           "fits": counts.peak_live_bytes
                           <= row["memory_bytes"]}
        print(f"         roofline ({row.get('name')}): "
              f"compute={rl.compute_s*1e3:.2f}ms "
              f"memory={rl.memory_s*1e3:.2f}ms "
              f"collective={rl.collective_s*1e3:.2f}ms (pod16x16) "
              f"-> {rl.bottleneck}-bound; useful={rl.useful_ratio:.2f}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-multipod", action="store_true")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--hw", default=None,
                    help="a row of repro_torch.analysis.roofline.HARDWARE "
                         "(default: the card this process runs on)")
    ap.add_argument("--out", default="benchmarks/results/dryrun_torch.json")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for a in ARCH_IDS:
            for s in SHAPES_BY_NAME:
                cells.append((a, s))
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape (or --all)")
    hw = hw_row(args.hw)

    results = []
    for a, s in cells:
        try:
            results.append(run_cell(a, s, do_multipod=not args.no_multipod,
                                    do_roofline=not args.no_roofline, hw=hw))
        except Exception as e:  # noqa: BLE001 — a failing cell is a bug, recorded
            traceback.print_exc()
            results.append({"arch": a, "shape": s, "error": repr(e)})
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    # merge with existing results (per-cell reruns update in place)
    merged: Dict[Tuple[str, str], Dict] = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            for r in json.load(f):
                merged[(r["arch"], r["shape"])] = r
    for r in results:
        merged[(r["arch"], r["shape"])] = r
    with open(args.out, "w") as f:
        json.dump(list(merged.values()), f, indent=1)
    n_err = sum("error" in r for r in results)
    print(f"[dryrun] wrote {args.out}; {len(results)} cells, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
