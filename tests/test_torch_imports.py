"""The port stands alone: importing ``repro_torch`` and every one of its
modules loads neither JAX nor the reference package."""
import os
import pkgutil
import subprocess
import sys

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

PROBE = """
import importlib, os, pkgutil, sys
env = dict(os.environ)
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
# no module sets an environment variable when it is imported
bad += sorted(k for k in set(env) | set(os.environ)
              if env.get(k) != os.environ.get(k))
print(len(names), ",".join(bad))
"""

# the one reference module whose counterpart has another name: the port's
# rule family for its ctypes launches, in place of the Pallas one
RENAMED = {"statics.pallas_rules": "statics.launch_rules"}


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
    """Every module under ``src/repro`` has one at the same path under
    ``src/repro_torch`` (``RENAMED`` names the one exception)."""
    import repro_torch
    have = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")}
    root = os.path.join(SRC, "repro")
    ref = []
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), root)[:-3]
                mod = rel.replace(os.sep, ".")
                ref.append(mod[:-len(".__init__")] if
                           mod.endswith(".__init__") else mod)
    assert len(ref) >= 74 and "launch.dryrun" in ref \
        and "analysis.roofline" in ref
    missing = [m for m in ref if m != "__init__"
               and f"repro_torch.{RENAMED.get(m, m)}" not in have]
    assert missing == [], missing
    # the port's own modules beside the reference's
    for mod in ("statics.launch_rules", "statics.__main__",
                "analysis.counters", "kernels.build", "spans"):
        assert f"repro_torch.{mod}" in have


# the reference's user scripts whose counterpart is not a module of
# ``repro_torch.scripts``: the invariant checker is the port's analyzer
# (``python -m repro_torch.statics``); the benchmark gate waits for the
# port's benchmark
SCRIPT_EXCEPTIONS = {"check_invariants.py": "repro_torch.statics",
                     "check_bench.py": None}


def test_every_example_and_script_has_a_counterpart():
    """Every ``examples/*.py`` has a module of the same name under
    ``repro_torch.examples``, every ``scripts/*.py`` one under
    ``repro_torch.scripts`` or the counterpart ``SCRIPT_EXCEPTIONS``
    names (None: none yet, and said why)."""
    import repro_torch
    have = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")}
    root = os.path.dirname(SRC)
    missing = []
    for folder in ("examples", "scripts"):
        files = sorted(f for f in os.listdir(os.path.join(root, folder))
                       if f.endswith(".py") and f != "__init__.py")
        assert len(files) >= 6, (folder, files)
        for f in files:
            want = f"repro_torch.{folder}.{f[:-3]}"
            if folder == "scripts" and f in SCRIPT_EXCEPTIONS:
                want = SCRIPT_EXCEPTIONS[f]
                if want is None:
                    continue
            if want not in have:
                missing.append(f"{folder}/{f} -> {want}")
    assert missing == [], missing
    assert set(SCRIPT_EXCEPTIONS) <= set(os.listdir(
        os.path.join(root, "scripts")))


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
