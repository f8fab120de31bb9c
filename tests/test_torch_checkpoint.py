"""The port's checkpoint manager: atomic publish, keep-k GC, bf16 roundtrip
and resume (the four tests of the reference's ``tests/test_checkpoint.py``
on torch trees), and checkpoints that cross between the packages: a tree
saved by either restores into the other bit for bit, leaf by leaf in
``jax.tree_util.tree_flatten`` order."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.models import gcn as ref_gcn
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models import gcn as port_gcn


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "nested": {"b": torch.arange(6, dtype=torch.int32),
                       "c": torch.randn((3,), generator=g).bfloat16()},
            "step": torch.tensor(7, dtype=torch.int32)}


def _leaves(tree):
    """Leaves in the reference's order (tensors are leaves to jax)."""
    return jax.tree_util.tree_leaves(tree)


def test_roundtrip_including_bf16(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    mgr.save(10, t)
    assert mgr.latest_step() == 10
    r = mgr.restore(10, t)
    assert sorted(r) == sorted(t) and sorted(r["nested"]) == ["b", "c"]
    for a, b in zip(_leaves(t), _leaves(r)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.device == b.device
        assert torch.equal(a, b)


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]


def test_incomplete_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, _tree())
    # simulate a crashed writer: directory without manifest
    os.makedirs(tmp_path / "step_00000009")
    assert mgr.latest_step() == 5


def test_structure_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    with pytest.raises(ValueError, match="mismatch"):
        mgr.restore(1, {"only": torch.zeros(3)})


def _ref_tree(seed=0):
    k = jax.random.PRNGKey(seed)
    return {"a": jax.random.normal(k, (4, 8)),
            "nested": {"b": jnp.arange(6, dtype=jnp.int32),
                       "c": jax.random.normal(k, (3,)).astype(jnp.bfloat16)},
            "step": jnp.asarray(7, jnp.int32)}


def _like_port():
    """A torch tree of ``_ref_tree``'s structure (zeros)."""
    return {"a": torch.zeros(4, 8),
            "nested": {"b": torch.zeros(6, dtype=torch.int32),
                       "c": torch.zeros(3, dtype=torch.bfloat16)},
            "step": torch.tensor(0, dtype=torch.int32)}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_crosses_packages_bit_for_bit(tmp_path, writer):
    ref_t = _ref_tree(3)
    port_t = {"a": torch.from_numpy(np.array(ref_t["a"])),
              "nested": {"b": torch.arange(6, dtype=torch.int32),
                         "c": torch.from_numpy(np.asarray(
                             ref_t["nested"]["c"], np.float32)).bfloat16()},
              "step": torch.tensor(7, dtype=torch.int32)}
    if writer == "reference":
        RefManager(str(tmp_path)).save(4, ref_t)
        got = CheckpointManager(str(tmp_path)).restore(4, _like_port())
        for a, b in zip(_leaves(port_t), _leaves(got)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        CheckpointManager(str(tmp_path)).save(4, port_t)
        got = RefManager(str(tmp_path)).restore(4, ref_t)
        for a, b in zip(jax.tree_util.tree_leaves(ref_t),
                        jax.tree_util.tree_leaves(got)):
            assert a.dtype == b.dtype
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("variant", ["gcn", "sage", "gin"])
def test_gcn_parameters_cross_packages(tmp_path, variant):
    """The GCN's list of per-layer dicts: a reference checkpoint restores
    into the port's parameters as ``params_from_jax`` makes them."""
    params = ref_gcn.init_gcn(jax.random.PRNGKey(1), [6, 12, 4], variant)
    RefManager(str(tmp_path)).save(2, params)
    like = port_gcn.init_gcn(torch.Generator().manual_seed(0), [6, 12, 4],
                             variant, device="cpu")
    got = CheckpointManager(str(tmp_path)).restore(2, like)
    want = port_gcn.params_from_jax(params, "cpu")
    assert [sorted(p) for p in got] == [sorted(p) for p in want]
    for pg, pw in zip(got, want):
        for k in pw:
            assert torch.equal(pg[k], pw[k]), k
