"""The port's training meshes and launcher (``repro_torch.launch.mesh``'s
``make_host_mesh``/``make_production_mesh``, ``repro_torch.launch.train``):
the reference's host-mesh tests (``tests/test_mesh.py``) port-side, the
production mappings, ``param_specs`` of a ``TrainState`` against the
reference's entry for entry, and the launcher on the CPU."""
import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.sharding.rules as R
from repro.configs import ARCH_IDS, get_config, get_reduced
from repro.train.step import init_train_state as ref_init_train_state
import repro_torch.sharding as S
from repro_torch.configs import get_config as port_config
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.train.step import init_train_state

from test_torch_sharding import MESHES, _same, sizes

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


# -- tests/test_mesh.py's host-mesh tests, port-side ---------------------------
def test_make_host_mesh_default():
    mesh = make_host_mesh(device="cpu")
    assert list(mesh) == ["data", "model"]
    assert int(np.prod(list(mesh.values()))) == 1     # the one CPU


def test_make_host_mesh_indivisible_raises_value_error():
    n = 1
    bad = n + 1   # never divides n (n >= 1)
    with pytest.raises(ValueError) as ei:
        make_host_mesh(model=bad, device="cpu")
    msg = str(ei.value)
    assert str(n) in msg and f"model={bad}" in msg, \
        "error must carry the device/model counts"


def test_make_host_mesh_nonpositive_model_raises():
    with pytest.raises(ValueError):
        make_host_mesh(model=0, device="cpu")


def test_make_host_mesh_defaults_to_cuda():
    if torch.cuda.is_available():
        assert make_host_mesh() == {"data": torch.cuda.device_count(),
                                    "model": 1}
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()


def test_make_production_mesh():
    assert make_production_mesh() == {"data": 16, "model": 16}
    mp = make_production_mesh(multi_pod=True)
    assert list(mp.items()) == [("pod", 2), ("data", 16), ("model", 16)]
    # the reference's axis names and sizes, in order
    assert list(mp) == ["pod", "data", "model"]
    assert S.batch_axes(mp) == ("pod", "data")


def test_shard_raises_under_the_production_mesh():
    x = torch.zeros(2, 4, 8)
    S.set_mesh_ctx(make_production_mesh())
    try:
        with pytest.raises(NotImplementedError, match="256 devices"):
            S.shard(x, "batch", None, None)
    finally:
        S.clear_mesh_ctx()


# -- param_specs of a TrainState ---------------------------------------------
@pytest.fixture
def bare_specs(monkeypatch):
    monkeypatch.setattr(R, "NamedSharding", lambda mesh, spec: spec)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_train_state_specs_against_reference(name, bare_specs):
    """Every leaf of a ``TrainState`` (params, and the optimizer's step,
    moments and masters, whose ``opt.`` paths the MoE rule reads):
    the reduced config's real state, and the full config's shapes (the
    reference's ``eval_shape``, the port's meta-device init)."""
    ref = ref_init_train_state(get_reduced(name), jax.random.PRNGKey(0))
    port = init_train_state(port_reduced(name),
                            torch.Generator().manual_seed(0), device="cpu")
    ref_full = jax.eval_shape(functools.partial(
        ref_init_train_state, get_config(name)), jax.random.PRNGKey(0))
    port_full = init_train_state(port_config(name), None, device="meta")
    for m in MESHES:
        _same(S.param_specs(port, sizes(m)), R.param_specs(ref, m))
        _same(S.param_specs(port_full, sizes(m)), R.param_specs(ref_full, m))


@pytest.mark.parametrize("zero1", [False, True])
def test_train_state_specs_on_production_mapping(zero1, bare_specs,
                                                 monkeypatch):
    """dbrx-132b's full state on the production mapping, with and without
    ZeRO-1 for the expert weights (params replicated on "data", the
    optimizer's leaves sharded)."""
    import repro_torch.sharding.rules as PR
    monkeypatch.setattr(R, "ZERO1_MOE", zero1)
    monkeypatch.setattr(PR, "ZERO1_MOE", zero1)
    ref_full = jax.eval_shape(functools.partial(
        ref_init_train_state, get_config("dbrx-132b")), jax.random.PRNGKey(0))
    port_full = init_train_state(port_config("dbrx-132b"), None,
                                 device="meta")
    for multi_pod in (False, True):
        mapping = make_production_mesh(multi_pod=multi_pod)
        mesh = type("M", (), {"axis_names": tuple(mapping),
                              "devices": np.zeros(tuple(mapping.values()))})
        _same(S.param_specs(port_full, mapping), R.param_specs(ref_full, mesh))


# -- the launcher ---------------------------------------------------------------
def test_launcher_module_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "3", "--batch", "2", "--seq", "16"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[train] phi3-mini-reduced on mesh {'data': 1, 'model': 1} (cpu)" \
        in out.stdout
    assert "[train] done; final loss" in out.stdout


def test_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    base = ["--device", "cpu", "--batch", "2", "--seq", "16"]
    whole = launcher.main(base + ["--steps", "5"])
    first = launcher.main(base + ["--steps", "3", "--ckpt-dir",
                                  str(tmp_path)])
    assert len(first["history"]) == 3
    capsys.readouterr()
    second = launcher.main(base + ["--steps", "5", "--ckpt-dir",
                                   str(tmp_path)])
    assert "[loop] resumed from checkpoint step 3" in capsys.readouterr().out
    assert second["history"] == whole["history"][3:]
    assert S.get_mesh_ctx() is None


def test_launcher_stub_frontend_and_microbatch():
    out = launcher.main(["--device", "cpu", "--arch", "hubert-xlarge",
                         "--steps", "2", "--batch", "2", "--seq", "16",
                         "--microbatch", "1"])
    assert len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])
