"""The port stands alone: importing ``repro_torch`` and every one of its
modules loads neither JAX nor the reference package."""
import os
import pkgutil
import subprocess
import sys

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), ",".join(bad))
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.strip().split(" ", 1) \
        if " " in out.stdout.strip() else (out.stdout.strip(), "")
    assert int(n_modules) >= 14
    assert bad == "", f"repro_torch pulled in {bad}"


def test_every_reference_module_of_the_slice_has_a_counterpart():
    import repro_torch
    have = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")}
    for mod in ("core.graph", "core.partition", "core.plan_cache",
                "core.plan_repair", "checkpoint.manager", "core.spmm", "data.graphs", "kernels.ref", "kernels.ops",
                "kernels.spmm_accel", "kernels.spmm_batched",
                "kernels.router", "kernels.spmm_hbm",
                "kernels.grouped_matmul", "models.layers", "models.gcn",
                "models.moe", "serve.scheduler", "serve.graph_engine",
                "configs.base", "configs.dbrx_132b",
                "configs.deepseek_moe_16b", "configs.qwen1p5_32b",
                "configs.phi3_mini_3p8b", "configs.gemma2_27b",
                "configs.internlm2_20b", "configs.zamba2_7b",
                "configs.hubert_xlarge", "configs.chameleon_34b",
                "configs.mamba2_780m", "tuning.search", "tuning.tuner",
                "sampling.store", "sampling.sampler", "sampling.service",
                "distributed.replication", "distributed.placement",
                "distributed.shard_spmm", "distributed.directory",
                "distributed.multihost", "launch.mesh", "serve.fleet",
                "statics.findings", "statics.lock_rules",
                "statics.future_rules", "statics.analyzer",
                "statics.witness", "models.attention", "models.ssm",
                "models.lm", "sharding.rules", "train.step",
                "serve.engine", "optim.adamw", "train.loop", "data.tokens",
                "launch.train"):
        assert f"repro_torch.{mod}" in have
        ref_path = os.path.join(SRC, "repro", *mod.split(".")) + ".py"
        assert os.path.exists(ref_path), ref_path
    # the port's own rule family, in place of the reference's Pallas one
    assert "repro_torch.statics.launch_rules" in have
    assert "repro_torch.statics.__main__" in have
    assert "repro_torch.sharding" in have and "repro_torch.train" in have


def test_statics_loads_no_other_port_module():
    """The witness is installed before the rest of the port loads, so the
    statics package imports the standard library only."""
    probe = ("import sys, repro_torch.statics, repro_torch.statics.__main__\n"
             "print(','.join(sorted(m for m in sys.modules if m.split('.')[0]"
             " in ('repro_torch', 'repro', 'jax', 'torch', 'numpy'))))")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.strip().split(",")
    assert all(m == "repro_torch" or m.startswith("repro_torch.statics")
               for m in loaded), loaded
