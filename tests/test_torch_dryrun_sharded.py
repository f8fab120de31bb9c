"""The dry run's production rows: rank 0's partitioned program traced on
``meta`` under a ``fake`` process group (``repro_torch.launch.dryrun.
trace_partitioned``), against the reference's partitioning.

* Local shard shapes: every leaf of the full-size phi3-mini-3.8b and
  dbrx-132b ``TrainState`` (and a ``decode_32k`` decode state) distributed
  on meta over a fake 256-rank ``(16, 16)`` mesh has, on rank 0, the local
  shape the reference's ``param_specs`` / ``cache_specs`` spec gives:
  each dim over the product of the mesh axes its entry names.
* Production rows: ``run_cell`` at full width (depth and sequence cut so a
  train cell traces in seconds) gives ``pod16x16`` and
  ``multipod2x16x16`` rows with the reference's keys, per-device argument
  bytes equal to ``sharded_argument_bytes`` exactly, collectives, and a
  roofline whose collective term is > 0; no row says "not in the port".
  No process group outlives a row.
* A microbatched row (chunks carrying ``microbatch``, the batch handed to
  the step whole): the plain row's FLOPs; every weight gathered over
  "data" and every gradient reduce-scattered there once per microbatch
  (``nmb`` times the plain row's all-gather and reduce-scatter bytes); the
  whole batch among the arguments; a lower peak.

The fake count against a real four-process ``gloo`` run of the same step
is in ``tests/test_torch_sharded_step.py``, which has those processes.
"""
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.sharding.rules as R
from repro.configs import get_config
from repro.models import lm as rlm
from repro_torch import sharding as S
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_device_mesh, make_production_mesh
from repro_torch.models import lm as plm
from repro_torch.train.step import init_train_state

H100 = "NVIDIA H100 80GB HBM3"


def _flat(tree, path=""):
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{path}.{k}" if path else str(k)))
    return out


def _ref_specs(fn, tree, sizes):
    """The reference's specs of ``tree`` (a jax shape tree) on a mesh of
    ``sizes``, as bare ``PartitionSpec`` tuples."""
    mesh = types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.zeros(tuple(sizes.values())))
    prev = R.NamedSharding
    R.NamedSharding = lambda m, spec: spec
    try:
        return {k: tuple(v) for k, v in _flat(fn(tree, mesh)).items()}
    finally:
        R.NamedSharding = prev


def _divided(shape, spec, sizes):
    out = list(shape)
    for d, ax in enumerate(spec):
        for a in ((ax,) if isinstance(ax, str) else (ax or ())):
            out[d] //= sizes[a]
    return tuple(out)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "dbrx-132b"])
def test_local_shard_shapes_are_the_reference_specs(arch):
    import jax
    from repro.optim.adamw import adamw_init as ref_adamw_init
    from repro.train.step import TrainState as RefState
    sizes = make_production_mesh()
    cfg = get_config(arch)
    rtree = jax.eval_shape(lambda k: RefState(
        rlm.init_lm(cfg, k), ref_adamw_init(rlm.init_lm(cfg, k))),
        jax.random.PRNGKey(0))
    want = _ref_specs(R.param_specs, rtree, sizes)
    rdec = jax.eval_shape(lambda: rlm.init_decode_state(cfg, 128, 4096))
    want_dec = _ref_specs(R.cache_specs, rdec, sizes)
    with D.fake_group(256):
        mesh = make_device_mesh(sizes, device="meta")
        state = init_train_state(port_config(arch), None, device="meta",
                                 mesh=mesh)
        st = plm.init_decode_state(port_config(arch), 128, 4096,
                                   device="meta")
        st = S.distribute(st, S.cache_specs(st, sizes), mesh)
        for tree, specs, n in ((state, want, 20), (st, want_dec, 2)):
            got = _flat(tree)
            leaves = {k: v for k, v in got.items()
                      if isinstance(v, torch.Tensor)}
            assert set(leaves) <= set(specs)
            assert len(leaves) >= n
            for k, t in leaves.items():
                loc = t.to_local() if hasattr(t, "to_local") else t
                assert loc.device.type == "meta"
                assert tuple(loc.shape) == _divided(t.shape, specs[k],
                                                    sizes), k
    assert not dist.is_initialized()


@pytest.fixture
def cut_cells(monkeypatch):
    """phi3-mini-3.8b at full width, 2 layers; train_4k at B=256, T=512 (the
    batch still divides both production meshes' batch axes)."""
    cfg = port_config("phi3-mini-3.8b").replace(n_layers=2)
    monkeypatch.setattr(D, "get_config", lambda name: cfg)
    shapes = dict(D.SHAPES_BY_NAME)
    shapes["train_4k"] = ShapeConfig("train_4k", "train", 512, 256)
    shapes["decode_32k"] = ShapeConfig("decode_32k", "decode", 1024, 128)
    monkeypatch.setattr(D, "SHAPES_BY_NAME", shapes)
    return cfg, shapes


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_production_rows_trace_rank_zero(cut_cells, shape):
    cfg, shapes = cut_cells
    rec = D.run_cell("phi3-mini-3.8b", shape, hw=H100)
    assert not dist.is_initialized()
    assert "not in the port" not in repr(rec)
    keys = {"trace_s", "argument_bytes_per_dev", "output_bytes_per_dev",
            "temp_bytes_per_dev", "peak_bytes_per_dev", "rolled_cost",
            "chips"}
    one = rec["h100"]
    for m, chips in (("pod16x16", 256), ("multipod2x16x16", 512)):
        row = rec[m]
        assert keys <= set(row) and row["chips"] == chips
        assert row["argument_bytes_per_dev"] == D.sharded_argument_bytes(
            cfg, shapes[shape], make_production_mesh(multi_pod=m != "pod16x16"))
        assert 0 < row["argument_bytes_per_dev"] \
            < one["argument_bytes_per_dev"]
        assert row["peak_bytes_per_dev"] >= row["argument_bytes_per_dev"]
        c = row["rolled_cost"]
        assert c["coll"] > 0 and c["coll"] == sum(
            v for k, v in c.items() if k.startswith("coll_"))
        assert 0 < c["flops"] < one["rolled_cost"]["flops"]
    rl = rec["roofline"]
    assert rl["collective_s"] > 0 and rl["coll_bytes_per_dev"] == \
        rec["pod16x16"]["rolled_cost"]["coll"]
    assert set(rl["coll_breakdown"]) == {
        k[5:] for k in rec["pod16x16"]["rolled_cost"] if k.startswith("coll_")}
    if shape == "train_4k":
        assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(
            rl["coll_breakdown"])
        # the per-device FLOPs: the one-card program's over the 256 ranks
        # (every matmul and attention block split over batch or heads)
        assert rec["pod16x16"]["rolled_cost"]["flops"] * 256 == \
            pytest.approx(one["rolled_cost"]["flops"], rel=1e-3)


def test_microbatched_row_traces_rank_zero(cut_cells):
    """phi3 at full width, 2 layers, ``train_4k`` cut to T=512 on
    ``pod16x16`` with ``microbatch`` = 64 (hillclimb's ``microbatch4``:
    rank 0 computes 4 rows of each of 4 microbatches)."""
    cfg, shapes = cut_cells
    shape, sizes = shapes["train_4k"], make_production_mesh()
    nmb = 4
    chunks = {"microbatch": shape.global_batch // nmb}
    plain, _ = D.trace_partitioned(cfg, shape, sizes)
    mb, _ = D.trace_partitioned(cfg, shape, sizes, chunks=chunks)
    assert not dist.is_initialized()
    assert mb.flops == plain.flops > 0
    for kind in ("all-gather", "reduce-scatter"):
        assert mb.coll_bytes[kind] == nmb * plain.coll_bytes[kind], kind
    # every rank holds the whole batch, not its 1/16 of it
    whole = sum(t.numel() * t.element_size()
                for t in D.input_specs(cfg, shape).values())
    assert mb.argument_bytes - plain.argument_bytes == whole - whole // 16
    assert mb.peak_live_bytes < plain.peak_live_bytes


def test_microbatch_must_divide_over_the_batch_axes():
    """A microbatch the batch axes do not divide, or a batch already placed
    on them, is refused with the numbers named."""
    from repro_torch.configs import get_reduced
    cfg = get_reduced("phi3-mini-3.8b")
    shape = ShapeConfig("c", "train", 16, 8)
    with pytest.raises(ValueError, match="microbatch 2 does not divide "
                                         "over the 4 ranks"):
        D.trace_partitioned(cfg, shape, {"data": 4, "model": 1},
                            chunks={"microbatch": 2})
    assert not dist.is_initialized()
    with D.fake_group(2):
        mesh = make_device_mesh({"data": 2, "model": 1}, device="meta")
        fn, (state, batch) = D.build_cell(cfg, shape,
                                          chunks={"microbatch": 4},
                                          mesh=mesh)
        placed = {k: S.on_batch_axes(v, mesh) for k, v in batch.items()}
        with pytest.raises(ValueError, match="takes the batch whole"):
            D.run_counted(fn, (state, placed), "train", mesh)


def test_shard_redistributes_under_a_device_mesh():
    """Under a ``DeviceMesh`` context ``shard`` redistributes a DTensor to
    the reference's constraint and ``shard_heads`` follows the reference's
    rule (batch always; heads on "model" when it divides them, else as they
    arrive); a plain tensor there raises; a size mapping of more than one
    device still raises (``tests/test_torch_sharding.py``)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with D.fake_group(4):
        mesh = make_device_mesh({"data": 2, "model": 2}, device="meta")
        x = distribute_tensor(torch.empty(4, 8, 6, 16, device="meta"), mesh,
                              [Replicate(), Replicate()])
        S.set_mesh_ctx(mesh)
        try:
            y = S.shard(x, "batch", None, "model")
            assert tuple(y.placements) == (Shard(0), Shard(2))
            assert tuple(S.shard(y, "batch").placements) == \
                (Shard(0), Replicate())
            assert tuple(S.shard_heads(x).placements) == (Shard(0), Shard(2))
            odd = distribute_tensor(torch.empty(4, 8, 3, 16, device="meta"),
                                    mesh, [Replicate(), Shard(3)])
            assert tuple(S.shard_heads(odd).placements) == \
                (Shard(0), Shard(3))
            with pytest.raises(TypeError, match="not distributed"):
                S.shard(torch.empty(4, 8), "batch")
        finally:
            S.clear_mesh_ctx()
    S.set_mesh_ctx({"data": 2, "model": 2})
    try:
        with pytest.raises(NotImplementedError):
            S.shard(torch.empty(4, 8), "batch")
    finally:
        S.clear_mesh_ctx()


_PHASE21 = """
import json, os, sys
sys.path[:0] = [{src!r}, {root!r}]
import torch
import chip_smoke as cs
import repro_torch.configs as configs
from repro_torch.configs.base import ShapeConfig
configs.get_config = configs.get_reduced      # full widths only on the card
cs.SHARD_T, cs.SHARD_PROMPT = 32, 16
for cell, shape in (("train_4k", ShapeConfig("train_4k", "train", 64, 256)),
                    ("decode_32k", ShapeConfig("decode_32k", "decode", 128,
                                               128))):
    configs.SHAPES_BY_NAME[cell] = shape
out = {{}}
cs.shard_real_worker(0, 1, os.path.join({tmp!r}, "init"),
                     os.path.join({tmp!r}, "a.json"), device="cpu")
with open(os.path.join({tmp!r}, "a.json")) as f:
    out["a"] = json.load(f)
for cell in cs.SHARD_CELLS:
    cs.shard_meta_worker(cell, out=os.path.join({tmp!r}, "m.json"))
    cs.shard_card_worker(cell, out=os.path.join({tmp!r}, "c.json"),
                         device="cpu")
    with open(os.path.join({tmp!r}, "m.json")) as f, \\
            open(os.path.join({tmp!r}, "c.json")) as g:
        out[cell] = [json.load(f), json.load(g)]
print(json.dumps(out))
"""


def test_phase21_on_cpu_at_reduced_configs(tmp_path):
    """``chip_smoke.py`` phase 21's child processes on the CPU in a fresh
    process (gloo for (a); the card's run is the script's own): the 1x1
    mesh bit-equal to the one-card program; rank 0 of pod16x16 (a fake
    group of 256, reduced phi3, cut shapes) counted the same on meta and on
    the CPU tensors, the tracker's peaks equal."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(root, "src")
    code = _PHASE21.format(src=src, root=root, tmp=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=root,
                       env=dict(os.environ, PYTHONPATH=src))
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    a = out["a"]
    assert a["world"] == 1 and a["mesh"] == {"data": 1, "model": 1}
    assert a["loss_equal"] and a["tokens_equal"] and a["logit_err"] == 0
    assert set(a["leaf_err"].values()) == {0.0}
    assert a["flops"]["partitioned"] == a["flops"]["one card"] > 0
    assert a["k_launches"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    for cell in ("train_4k", "decode_32k"):
        m, c = out[cell]
        assert c["flops"] == m["flops"] > 0
        assert c["coll_bytes"] == m["coll_bytes"] and m["coll_bytes"]
        assert c["argument"] == m["argument"] == c["live"]
        assert c["tracker_peak"] == m["peak"] == c["requested_peak"]
        assert c["peak"] == m["peak_blocks"] >= m["peak"]
