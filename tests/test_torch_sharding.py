"""The port's sharding rules against the reference's
(``repro.sharding.rules``): the same decisions, as tuples, entry for entry.

The reference builds a ``NamedSharding`` per leaf, which needs real
devices; these tests replace that name in the reference module with one
that returns the bare ``PartitionSpec``, so its ``param_specs`` and
``cache_specs`` run on the meshes of ``tests/test_sharding.py`` (an object
with ``axis_names`` and ``devices``). The port reads the same mesh as a
mapping of axis sizes. Specs are compared as tuples: exact.
"""
import functools
import types

import jax
import numpy as np
import pytest
import torch

import repro.sharding.rules as R
from repro.configs import ARCH_IDS, get_config, get_reduced
from repro.models import lm as rlm
import repro_torch.sharding as S
import repro_torch.sharding.rules as PR
from repro_torch.configs import get_config as port_config
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.models import lm as plm


def fake_mesh(data=16, model=16, pod=None):
    shape = ((pod,) if pod else ()) + (data, model)
    names = (("pod",) if pod else ()) + ("data", "model")
    return types.SimpleNamespace(axis_names=names, devices=np.zeros(shape))


def sizes(m):
    return dict(zip(m.axis_names, m.devices.shape))


MESHES = [fake_mesh(), fake_mesh(2, 4), fake_mesh(4, 2, pod=2),
          fake_mesh(8, 1)]


@pytest.fixture
def bare_specs(monkeypatch):
    monkeypatch.setattr(R, "NamedSharding", lambda mesh, spec: spec)


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


def _same(port_tree, ref_tree):
    got = _flat(port_tree)
    want = {k: tuple(v) for k, v in _flat(ref_tree).items()}
    assert got.keys() == want.keys()
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


@pytest.mark.parametrize("shape,want", [
    ((64, 4096), ("data", "model")),
    ((64, 4096, 40, 128), (("data",), None, "model", None)),
    ((64, 4096, 40, 128), (None, None, None, "model")),
    ((7, 4096), ("data", "model")),
])
@pytest.mark.parametrize("mesh", MESHES[:2], ids=["16x16", "2x4"])
def test_resolve_spec(shape, want, mesh):
    assert PR.resolve_spec(shape, want, sizes(mesh)) == \
        tuple(R.resolve_spec(shape, want, mesh))
    # the mesh object itself reads the same way
    assert PR.resolve_spec(shape, want, mesh) == \
        PR.resolve_spec(shape, want, sizes(mesh))


def test_batch_axes_multipod():
    m = fake_mesh(pod=2)
    assert S.batch_axes(sizes(m)) == R.batch_axes(m) == ("pod", "data")
    assert S.resolve_spec((256, 10), (("pod", "data"), None), sizes(m)) == \
        (("pod", "data"), None)
    assert S.resolve_spec((1, 10), (("pod", "data"), None), sizes(m)) == \
        (None, None)
    assert S.batch_axes({"data": 4, "model": 2}) == ("data",)


@pytest.mark.parametrize("path,shape", [
    ("layers.attn.wq", (32, 4096, 4096)), ("layers.attn.wo", (32, 4096, 4096)),
    ("layers.moe.wi", (40, 16, 6144, 10752)),
    ("layers.moe.wo", (40, 16, 10752, 6144)),
    ("layers.moe.router", (40, 6144, 16)), ("layers.ln1.w", (32, 4096)),
    ("embed", (152064, 5120)), ("head", (1280, 504)),
    ("layers.mamba.conv_w", (48, 4, 3328)), ("lora.a_q", (13, 3584, 128)),
    ("lora.b_i", (13, 128, 14336)), ("opt.layers.moe.wi", (40, 16, 64, 96)),
])
@pytest.mark.parametrize("zero1", [False, True])
def test_leaf_spec(path, shape, zero1, monkeypatch):
    monkeypatch.setattr(R, "ZERO1_MOE", zero1)
    monkeypatch.setattr(PR, "ZERO1_MOE", zero1)
    for m in MESHES:
        assert PR._leaf_spec(path, shape, sizes(m)) == \
            tuple(R._leaf_spec(path, shape, m))


@pytest.mark.parametrize("name", ARCH_IDS)
def test_param_specs_full_config(name, bare_specs):
    """Every leaf of the full configuration's tree (shapes only: the
    reference's ``eval_shape``, the port's meta-device init)."""
    ref = jax.eval_shape(functools.partial(rlm.init_lm, get_config(name)),
                         jax.random.PRNGKey(0))
    port = plm.init_lm(port_config(name), None, device="meta")
    for m in MESHES:
        _same(S.param_specs(port, sizes(m)), R.param_specs(ref, m))


@pytest.mark.parametrize("name", ARCH_IDS)
def test_cache_specs(name, bare_specs):
    """Decode-state specs of the reduced config (real state) and of the full
    config at batch 128 x 4,096 positions (shapes only)."""
    cfg, pcfg = get_reduced(name), port_reduced(name)
    if cfg.family == "encoder":
        with pytest.raises(ValueError):
            plm.init_decode_state(pcfg, 2, 16, device="cpu")
        return
    rst = rlm.track_slot_starts(rlm.init_decode_state(cfg, 4, 16), 4)
    pst = plm.track_slot_starts(plm.init_decode_state(pcfg, 4, 16,
                                                      device="cpu"), 4)
    full = jax.eval_shape(lambda: rlm.init_decode_state(get_config(name),
                                                        128, 4096))
    pfull = plm.init_decode_state(port_config(name), 128, 4096,
                                  device="meta")
    for m in MESHES:
        _same(S.cache_specs(pst, sizes(m)), R.cache_specs(rst, m))
        _same(S.cache_specs(pfull, sizes(m)), R.cache_specs(full, m))


def test_shard_returns_its_input():
    x = torch.randn(4, 8, 2, 16)
    assert S.shard(x, "batch") is x
    S.set_mesh_ctx({"data": 1, "model": 1})
    try:
        assert S.get_mesh_ctx() == {"data": 1, "model": 1}
        assert S.shard(x, "batch", None, None, "model") is x
        assert S.shard_heads(x) is x
        # one card: a mesh of several devices has no sharded path here
        S.set_mesh_ctx({"data": 2, "model": 2})
        with pytest.raises(NotImplementedError):
            S.shard(x, "batch")
        with pytest.raises(NotImplementedError):
            S.shard_heads(x)
    finally:
        S.clear_mesh_ctx()
    assert S.get_mesh_ctx() is None
    assert S.shard(x, "batch") is x
