"""The port's dry run (``repro_torch.launch.dryrun``) and its counting mode
(``repro_torch.analysis.counters``) against the reference's dry run
(``repro.launch.dryrun``).

The reference's module sets ``XLA_FLAGS`` (512 host devices) when it is
imported; the fixture below imports it only after this process's JAX
backend has started, and puts the variable back, so nothing leaks into
this process or the subprocesses of other tests. Its compiles use a
1-device mesh with ``Auto`` axes: the installed jax's ``make_mesh``
defaults to ``Explicit`` axes, under which its ``with_sharding_constraint``
raises (the reference's own ``test_dryrun_smoke`` fails so).

Tolerances: the counts are integers and are held exactly (meta against
CPU, the port's argument bytes against XLA's, the port's specs against the
reference's); the reference's probe extrapolation is float arithmetic on
integer counts and is held within 1e-12 of the direct count.
"""
import functools
import importlib
import json
import os
import subprocess
import sys
import types
import weakref

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import repro.sharding.rules as R
from repro.configs import get_config as ref_config
from repro.configs import get_reduced as ref_reduced
from repro.configs.base import ShapeConfig as RefShape
from repro.models import lm as rlm
from repro.train.step import init_train_state as ref_train_state
from repro_torch.analysis.counters import count_call
from repro_torch.analysis.roofline import Roofline
from repro_torch.configs import ARCH_IDS, SHAPES_BY_NAME, get_config, \
    get_reduced, shape_skips
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
H100 = "NVIDIA H100 80GB HBM3"
CHUNKS = {"q_chunk": 16, "kv_chunk": 16, "loss_chunk": 16, "ssd_chunk": 8}


@pytest.fixture(scope="module")
def ref_dryrun():
    jax.devices()     # the backend starts first: the flag cannot reach it
    prev = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev


def _flat(tree, path=""):
    """{path: leaf} over dicts and named tuples, None dropped."""
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


def _sig(leaf):
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")
    return tuple(leaf.shape), np.dtype(leaf.dtype).name


# ---------------------------------------------------------------------------
# inputs, skips and active parameters at full size, all ten archs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_skips_match_the_reference(arch, ref_dryrun):
    """Shapes and dtypes of every input leaf of all four shapes. The
    reference's ``DecodeState.pos`` is an int32 scalar; the port's is a
    host int (ROADMAP, behaviours of the port)."""
    cfg, rcfg = get_config(arch), ref_config(arch)
    for name, shape in SHAPES_BY_NAME.items():
        rshape = RefShape(name, shape.kind, shape.seq_len, shape.global_batch)
        skip = shape_skips(cfg, shape)
        assert skip == ref_dryrun.shape_skips(rcfg, rshape)
        if skip:
            continue
        got = _flat(D.input_specs(cfg, shape))
        want = _flat(ref_dryrun.input_specs(rcfg, rshape))
        if shape.kind == "decode":
            assert isinstance(got.pop("state.pos"), int)
            assert _sig(want.pop("state.pos")) == ((), "int32")
        assert got.keys() == want.keys(), name
        assert all(t.device.type == "meta" for t in got.values())
        assert {k: _sig(v) for k, v in got.items()} == \
            {k: _sig(v) for k, v in want.items()}, name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_param_count_is_the_references(arch, ref_dryrun):
    assert D.active_param_count(get_config(arch)) == \
        ref_dryrun.active_param_count(ref_config(arch))


# ---------------------------------------------------------------------------
# argument bytes against XLA's memory_analysis, 1-device Auto-axis mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,kind,T,B", [
    ("qwen1.5-32b", "train", 64, 8),
    ("gemma2-27b", "prefill", 64, 4),
    ("zamba2-7b", "decode", 64, 8),
])
def test_argument_bytes_equal_memory_analysis(arch, kind, T, B, ref_dryrun):
    from jax.sharding import AxisType
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3,
                         devices=jax.devices()[:1])
    _, compiled, _ = ref_dryrun.lower_and_compile(
        ref_reduced(arch), RefShape("c", kind, T, B), mesh, chunks=CHUNKS)
    want = compiled.memory_analysis().argument_size_in_bytes
    counts, _ = D.trace_cell(get_reduced(arch), ShapeConfig("c", kind, T, B),
                             chunks=CHUNKS)
    # the reference's decode state carries pos as a 4-byte int32 scalar
    assert counts.argument_bytes + (4 if kind == "decode" else 0) == want
    if arch == "qwen1.5-32b":
        assert counts.argument_bytes == 1_619_588


# ---------------------------------------------------------------------------
# per-device argument bytes from the specs, against the reference's specs
# ---------------------------------------------------------------------------
def _fake_mesh(sizes):
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.zeros(tuple(sizes.values())))


def _ref_per_device(tree, specs, sizes):
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda s: isinstance(s, PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        n = 1
        for ax in spec:
            for a in ((ax,) if isinstance(ax, str) else (ax or ())):
                n *= sizes[a]
        total += int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize // n
    return total


def _ref_sharded_bytes(ref_dryrun, rcfg, rshape, sizes):
    """The reference's per-device argument bytes: its ``param_specs`` /
    ``cache_specs`` / batch specs over its ``eval_shape`` trees."""
    mesh = _fake_mesh(sizes)
    specs = ref_dryrun.input_specs(rcfg, rshape)
    key = jax.random.PRNGKey(0)
    if rshape.kind == "train":
        state = jax.eval_shape(functools.partial(ref_train_state, rcfg), key)
        tree = (state, specs)
        sh = (R.param_specs(state, mesh),
              ref_dryrun._batch_sharding(mesh, specs))
    else:
        params = jax.eval_shape(functools.partial(rlm.init_lm, rcfg), key)
        if rshape.kind == "prefill":
            tree = (params, specs["inputs"])
            sh = (R.param_specs(params, mesh),
                  ref_dryrun._batch_sharding(mesh, specs["inputs"]))
        else:
            tree = (params, specs["state"], specs["tokens"])
            sh = (R.param_specs(params, mesh),
                  R.cache_specs(specs["state"], mesh),
                  ref_dryrun._batch_sharding(mesh, specs["tokens"]))
    return _ref_per_device(tree, sh, sizes)


@pytest.mark.parametrize("arch,shape", [
    ("qwen1.5-32b", "train_4k"), ("phi3-mini-3.8b", "decode_32k"),
    ("gemma2-27b", "prefill_32k"), ("deepseek-moe-16b", "train_4k"),
    ("dbrx-132b", "decode_32k"), ("zamba2-7b", "long_500k"),
    ("mamba2-780m", "train_4k"), ("hubert-xlarge", "prefill_32k"),
])
def test_sharded_argument_bytes_match_the_reference_specs(
        arch, shape, ref_dryrun, monkeypatch):
    monkeypatch.setattr(R, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(ref_dryrun, "NamedSharding", lambda mesh, spec: spec)
    cfg, rcfg = get_config(arch), ref_config(arch)
    s = SHAPES_BY_NAME[shape]
    rshape = RefShape(shape, s.kind, s.seq_len, s.global_batch)
    for sizes in ({"pod": 2, "data": 2, "model": 2},
                  make_production_mesh(multi_pod=False),
                  make_production_mesh(multi_pod=True)):
        got = D.sharded_argument_bytes(cfg, s, sizes)
        want = _ref_sharded_bytes(ref_dryrun, rcfg, rshape, sizes)
        # the reference's replicated int32 pos scalar (decode)
        assert got + (4 if s.kind == "decode" else 0) == want, sizes


# ---------------------------------------------------------------------------
# the counting mode: meta against the CPU, and the live set
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen1.5-32b", "deepseek-moe-16b",
                                  "mamba2-780m", "zamba2-7b",
                                  "hubert-xlarge"])
def test_meta_counts_equal_cpu_counts(arch):
    """One reduced config of each family, every kind it has: the same
    FLOPs, bytes, argument, output and peak bytes and op count on ``meta``
    as on real CPU tensors."""
    cfg = get_reduced(arch)
    for kind, T, B in (("train", 32, 4), ("prefill", 32, 2),
                       ("decode", 32, 4)):
        if cfg.family == "encoder" and kind == "decode":
            continue
        shape = ShapeConfig("c", kind, T, B)
        got = []
        for dev in ("meta", "cpu"):
            fn, args = D.build_cell(cfg, shape, chunks=CHUNKS, device=dev)
            c = D.run_counted(fn, args, kind)
            got.append((c.flops, c.bytes, c.argument_bytes, c.output_bytes,
                        c.peak_live_bytes, c.ops))
        assert got[0] == got[1], (kind, got)
        assert got[0][0] > 0 and got[0][4] > got[0][2]


def _extrapolate(kind, vecs, full):
    """The reference's probe arithmetic (``repro.launch.dryrun``
    ``probe_roofline``)."""
    out = {}
    keys = sorted(set().union(*[set(v) for v in vecs]))
    if kind == "linear":
        (ca, ua), (cb, ub) = (vecs[0], 1), (vecs[1], 2)
        for k in keys:
            per = (cb.get(k, 0.0) - ca.get(k, 0.0)) / (ub - ua)
            out[k] = ca.get(k, 0.0) + (full - ua) * per
    else:  # hybrid: cA = f + s + 3m ; cB = f + s + 6m ; cC = f + 2s + 6m
        cA, cB, cC = vecs
        n_shared, n_mamba = full
        for k in keys:
            m = (cB.get(k, 0.0) - cA.get(k, 0.0)) / 3.0
            s = cC.get(k, 0.0) - cB.get(k, 0.0)
            f = cA.get(k, 0.0) - s - 3 * m
            out[k] = f + n_shared * s + n_mamba * m
    return out


@pytest.mark.parametrize("arch,n_layers,kind", [
    ("qwen1.5-32b", 5, "train"),          # dense: units = layers
    ("gemma2-27b", 6, "prefill"),         # local/global pairs
    ("deepseek-moe-16b", 5, "train"),     # first dense layer + moe layers
    ("zamba2-7b", 7, "decode"),           # hybrid: groups of 3, a tail
])
def test_probe_extrapolation_equals_the_full_depth_count(arch, n_layers, kind):
    cfg = get_reduced(arch).replace(n_layers=n_layers)
    if cfg.family == "hybrid":
        cfg = cfg.replace(hybrid_group=3)
    shape = ShapeConfig("c", kind, 32, 2)
    plan, probes, full = D._probe_plan(cfg)
    vecs = [D.cost_vector(D.trace_cell(p, shape, chunks=CHUNKS)[0])
            for p in probes]
    direct = D.cost_vector(D.trace_cell(cfg, shape, chunks=CHUNKS)[0])
    got = _extrapolate(plan, vecs, full)
    assert plan == ("hybrid" if cfg.family == "hybrid" else "linear")
    for k in ("flops", "bytes"):
        assert got[k] == pytest.approx(direct[k], rel=1e-12, abs=0), k


def test_peak_keeps_a_saved_storage_whose_tensor_is_gone():
    """``exp`` saves its result for the backward through a C++ tensor of
    its own: once the Python tensor is deleted its storage stays live, and
    the tracker counts it until the graph goes."""
    n = 1024                                   # 4 KiB of fp32

    def f(x):
        y = x.exp()
        gone = weakref.ref(y)
        z = y.sum()
        del y
        assert gone() is None                  # the Python object is gone
        w = torch.zeros(4 * n)                 # 16 KiB
        return z, w

    for grad, saved in ((True, 4 * n), (False, 0)):
        x = torch.ones(n, requires_grad=grad)
        (z, w), c = count_call(f, x)
        # x + (the saved result) + z + w at w's allocation
        assert c.peak_live_bytes == 4 * n + saved + 4 + 16 * n, grad
        assert c.argument_bytes == 4 * n and c.output_bytes == 4 + 16 * n
        # with grad, autograd detaches the saved result: a view, 0 bytes
        assert c.flops == 0 and c.ops == (4 if grad else 3)
        # exp reads x, writes y; sum reads y, writes z; zeros writes w
        assert c.bytes == 4 * n * 2 + (4 * n + 4) + 16 * n
        if grad:
            z.backward()
            assert torch.equal(x.grad, torch.full((n,), np.e,
                                                  dtype=torch.float32))


def test_peak_follows_frees_and_views():
    """A view adds no storage; a freed tensor leaves the live set before
    the next allocation."""
    def f(x):
        v = x[3:]
        a = torch.zeros(256)
        del a
        return v, torch.zeros(64)

    (v, b), c = count_call(f, torch.zeros(256))
    assert c.peak_live_bytes == 1024 + 1024       # x and a, never b with a
    assert c.argument_bytes == 1024 and c.output_bytes == 256
    assert c.bytes == 1024 + 256                  # the view moves nothing


def test_block_peak_rounds_each_storage_to_the_allocators_granule():
    """``peak_block_bytes`` counts each live storage as the CUDA caching
    allocator's block for it, rounded up to 512 bytes (none for an empty
    storage), and peaks where the rounded sum does: here with ``b``,
    whose raw bytes are fewer than ``a``'s."""
    from repro_torch.analysis.counters import block_bytes, storage_bytes
    assert [block_bytes(n) for n in (0, 1, 512, 513, 4096)] == \
        [0, 512, 512, 1024, 4096]

    def f(x):
        a = torch.zeros(129)                      # 516 B: a 1024-B block
        del a
        b = [torch.zeros(1) for _ in range(3)]    # 12 B: 3 blocks
        return b, torch.zeros(0)

    x = torch.zeros(100)                          # 400 B: a 512-B block
    (b, e), c = count_call(f, x)
    assert c.peak_live_bytes == 400 + 516
    assert c.peak_block_bytes == 512 + 3 * 512
    assert storage_bytes((x, b, e)) == 412
    assert storage_bytes((x, b, e), blocks=True) == 4 * 512


def test_the_train_step_counts_remat_once():
    """With remat the forward of each layer runs twice (once more in the
    backward): the count is the step's, and the same step without remat
    runs fewer FLOPs but keeps more live."""
    cfg = get_reduced("qwen1.5-32b")
    shape = ShapeConfig("c", "train", 32, 2)
    c = D.trace_cell(cfg, shape, chunks=CHUNKS)[0]
    from repro_torch.models import lm as plm
    orig = plm.lm_loss

    def no_remat(*a, **kw):
        kw["remat"] = False
        return orig(*a, **kw)

    plm.lm_loss = no_remat
    try:
        c0 = D.trace_cell(cfg, shape, chunks=CHUNKS)[0]
    finally:
        plm.lm_loss = orig
    assert c.flops > c0.flops
    assert c.peak_live_bytes < c0.peak_live_bytes
    assert c.argument_bytes == c0.argument_bytes


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
REF_ROOFLINE_KEYS = set(Roofline(0, 0, 0, {}, 0, 0, 0, "").to_row())


def test_cli_writes_a_record_with_the_reference_keys(tmp_path):
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=SRC)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "phi3-mini-3.8b", "--shape", "decode_32k", "--out", str(out)]
    r = subprocess.run(cmd + ["--hw", H100], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    [rec] = json.loads(out.read_text())
    assert {"arch", "shape", "kind", "h100", "pod16x16", "multipod2x16x16",
            "roofline"} <= set(rec)
    assert (rec["arch"], rec["shape"], rec["kind"]) == \
        ("phi3-mini-3.8b", "decode_32k", "decode")
    h = rec["h100"]
    assert {"trace_s", "argument_bytes_per_dev", "output_bytes_per_dev",
            "temp_bytes_per_dev", "rolled_cost", "chips"} <= set(h)
    assert set(h["rolled_cost"]) == {"flops", "bytes", "coll"}
    assert h["chips"] == 1 and h["rolled_cost"]["coll"] == 0
    assert rec["pod16x16"]["chips"] == 256
    assert rec["multipod2x16x16"]["chips"] == 512
    for m in ("pod16x16", "multipod2x16x16"):
        # rank 0's partitioned program, traced under a fake group
        assert {"trace_s", "argument_bytes_per_dev", "output_bytes_per_dev",
                "temp_bytes_per_dev", "peak_bytes_per_dev", "rolled_cost",
                "chips"} <= set(rec[m])
        assert 0 < rec[m]["argument_bytes_per_dev"] < h["argument_bytes_per_dev"]
        assert rec[m]["rolled_cost"]["coll"] > 0
    rl = rec["roofline"]
    assert REF_ROOFLINE_KEYS | {"active_params", "tokens", "fits", "hw"} \
        == set(rl)
    assert rl["hw"] == H100 and rl["tokens"] == 128
    assert rl["bottleneck"] == "memory" and rl["collective_s"] > 0
    # without a card and without --hw the run refuses, and writes nothing
    out.unlink()
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode != 0 and "no CUDA card" in r.stderr
    assert not out.exists()


_PHASE20 = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
import torch
import chip_smoke
import repro_torch.configs as configs
import repro_torch.analysis.roofline as roofline
configs.get_config = configs.get_reduced     # full widths only on the card
# no card here: the card's row, named; the CLI is told it too
roofline.hw_for = lambda device="cuda": roofline.hw_row({hw!r})
chip_smoke.DRYRUN_CLI += ["--hw", {hw!r}]
chip_smoke.DRYRUN_OUT = {out!r}
rec = chip_smoke.phase_dryrun(torch, "CPU", [])
print(json.dumps({{"cells": rec["cells"], "cli": rec["cli"]["record"]}}))
"""


def test_phase20_on_cpu_at_reduced_configs(tmp_path):
    """``chip_smoke.py`` phase 20 (a) and (c) on the CPU: (a) at the
    reduced configs, (c) the CLI's full-size cell on ``meta``."""
    root = os.path.dirname(SRC)
    script = _PHASE20.format(src=SRC, root=root, hw=H100,
                             out=str(tmp_path / "dryrun_torch.json"))
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=SRC))
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    cells = rec["cells"]
    assert len(cells) == 6
    assert "skipped" in cells["phi3-mini-3.8b:long_500k"]
    for key, c in cells.items():
        if "skipped" not in c:
            assert c["flops_per_dev"] > 0 and c["collective_s"] == 0, key
            assert 0 < c["useful_ratio"] <= 1, key
    assert rec["cli"]["arch"] == "phi3-mini-3.8b"
    assert rec["cli"]["roofline"]["hw"] == H100
