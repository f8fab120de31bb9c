"""The port's invariant analyzer (``repro_torch.statics``) against the
reference's (``repro.statics``), and its launch-rule family.

* **Parity.** Over the reference's seeded corpus
  (``tests/fixtures/statics/``) the two analyzers give the same
  ``(rule, file, line, message)`` list for the families they share
  (``lock``, ``future``, ``meta``); over ``src/repro_torch`` both find
  nothing in those families.
* **The launch family.** A corpus written here to ``tmp_path``: one bad
  file per rule, each tripping exactly its own rule, a clean file in the
  kernels' idiom (a ``launch_on_stream`` helper, ``getattr`` symbols with a
  literal prefix), a suppressed file, and a file that does not import
  ``ctypes`` (the family does not apply). The port's own kernel wrappers
  are clean.
* **The CLI.** ``python -m repro_torch.statics`` exits 0 on its default
  paths and 1 on the corpus; ``--list-rules`` shows the four families.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro import statics as ref_statics
from repro_torch import statics as port_statics
from repro_torch.statics import ALL_RULES, RULE_FAMILIES, analyze_paths

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "statics"
PORT = REPO / "src" / "repro_torch"
SHARED = set(RULE_FAMILIES["lock"] + RULE_FAMILIES["future"]
             + RULE_FAMILIES["meta"])

_DECLARE = """
import ctypes

import torch

_MAX_GRID = 2**31 - 1


def _declare(lib):
    lib.toy_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_void_p]
    lib.toy_launch.restype = ctypes.c_int
    lib.toy_ctas.argtypes = [ctypes.c_longlong]
    lib.toy_ctas.restype = ctypes.c_longlong
"""

LAUNCH_CORPUS = {
    # the status of the launch is dropped
    "bad_unchecked_status.py": _DECLARE + """

def launch(lib, x, n):
    n_ctas = lib.toy_ctas(n)
    if n_ctas > _MAX_GRID:
        raise ValueError("toy: grid too large")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        lib.toy_launch(x.data_ptr(), n_ctas, stream)
""",
    # launched on stream 0, outside the device block
    "bad_off_stream.py": _DECLARE + """

def launch(lib, x, n):
    n_ctas = lib.toy_ctas(n)
    if n_ctas > _MAX_GRID:
        raise ValueError("toy: grid too large")
    err = lib.toy_launch(x.data_ptr(), n_ctas, None)
    if err != 0:
        raise RuntimeError(f"toy launch failed: {err}")
""",
    # no check_launch and no comparison with _MAX_GRID
    "bad_unguarded_grid.py": _DECLARE + """

def launch(lib, x, n):
    n_ctas = lib.toy_ctas(n)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.toy_launch(x.data_ptr(), n_ctas, stream)
    if err:
        raise RuntimeError(f"toy launch failed: {err}")
""",
    # toy_smem returns a long long but has no restype
    "bad_undeclared_ctypes.py": _DECLARE + """

def _declare_smem(lib):
    lib.toy_smem.argtypes = [ctypes.c_int]


def launch(lib, x, n):
    if lib.toy_smem(n) > 232448:
        raise ValueError("toy: too much shared memory")
    n_ctas = lib.toy_ctas(n)
    if n_ctas > _MAX_GRID:
        raise ValueError("toy: grid too large")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.toy_launch(x.data_ptr(), n_ctas, stream)
    if err != 0:
        raise RuntimeError(f"toy launch failed: {err}")
""",
    # the kernels' idiom: a checking helper, getattr with a literal prefix
    "clean_launch.py": """
import ctypes

import torch

_MAX_GRID = 2**31 - 1


def check_launch(label, smem, n_ctas):
    if smem > 232448 or n_ctas > _MAX_GRID:
        raise ValueError(f"{label}: the card would refuse this launch")


def launch_on_stream(label, lib, fn, x, *args):
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{label} launch failed: "
                           f"{lib.toy_error_string(err).decode()}")


def declare(prefix):
    def run(lib):
        lib.toy_error_string.argtypes = [ctypes.c_int]
        lib.toy_error_string.restype = ctypes.c_char_p
        smem = getattr(lib, f"{prefix}_smem_bytes")
        smem.argtypes = [ctypes.c_int]
        smem.restype = ctypes.c_longlong
        launch = getattr(lib, f"{prefix}_launch")
        launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        launch.restype = ctypes.c_int
    return run


_declare_k = declare("toy_k")


def launch(lib, prefix, x, n_ctas):
    check_launch("toy", getattr(lib, f"{prefix}_smem_bytes")(n_ctas),
                 n_ctas)
    launch_on_stream("toy", lib, getattr(lib, f"{prefix}_launch"), x,
                     x.data_ptr())


def launch_k(lib, x):
    return launch(lib, "toy_k", x, 4)
""",
    "suppressed_launch.py": _DECLARE + """

def launch(lib, x, n):
    n_ctas = lib.toy_ctas(n)
    if n_ctas > _MAX_GRID:
        raise ValueError("toy: grid too large")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        lib.toy_launch(x.data_ptr(), n_ctas, stream)  # statics: ignore[launch-unchecked-status] -- the toy kernel cannot fail
""",
    # no ctypes import: a bare launch of some other library is not ours
    "no_ctypes.py": """
def launch(lib, x):
    lib.toy_launch(x, None)
""",
}

EXPECTED = {
    "bad_unchecked_status.py": ["launch-unchecked-status"],
    "bad_off_stream.py": ["launch-off-stream"],
    "bad_unguarded_grid.py": ["launch-unguarded-grid"],
    "bad_undeclared_ctypes.py": ["launch-undeclared-ctypes"],
    "clean_launch.py": [],
    "suppressed_launch.py": [],
    "no_ctypes.py": [],
}


@pytest.fixture
def corpus(tmp_path):
    for name, src in LAUNCH_CORPUS.items():
        (tmp_path / name).write_text(textwrap.dedent(src).lstrip())
    return tmp_path


def _rows(findings):
    return [(f.rule, Path(f.path).name, f.line, f.message) for f in findings]


# ------------------------------------------------------------------ parity
def test_rule_table_is_the_references_less_pallas_plus_launch():
    ref = dict(ref_statics.RULE_FAMILIES)
    assert list(RULE_FAMILIES) == ["lock", "launch", "future", "meta"]
    for family in ("lock", "future", "meta"):
        assert RULE_FAMILIES[family] == ref[family]
    assert set(ALL_RULES) == (set(ref_statics.ALL_RULES)
                              - set(ref["pallas"])
                              | set(RULE_FAMILIES["launch"]))
    assert port_statics.DEFAULT_GUARDED_ATTRS == \
        ref_statics.DEFAULT_GUARDED_ATTRS
    assert port_statics.LAUNCH_RULES == RULE_FAMILIES["launch"]


@pytest.mark.parametrize("target", ["corpus", "one_file"])
def test_shared_families_match_reference_on_fixtures(target):
    paths = [FIXTURES] if target == "corpus" else \
        [FIXTURES / "bad_blocking_under_lock.py"]
    got, n_got = analyze_paths(paths, rules=SHARED)
    want, n_want = ref_statics.analyze_paths(paths, rules=SHARED)
    assert n_got == n_want
    assert got, "the corpus trips lock/future/meta rules"
    assert _rows(got) == _rows(want)


@pytest.mark.parametrize("name", ["suppressed.py", "clean_serving.py",
                                  "bad_suppression.py"])
def test_suppressions_match_reference(name):
    got, _ = analyze_paths([FIXTURES / name])
    want, _ = ref_statics.analyze_paths([FIXTURES / name], rules=SHARED)
    assert _rows(got) == _rows(want)


def test_port_tree_is_clean_under_both_analyzers():
    got, n = analyze_paths([PORT])
    assert n >= 60
    assert got == [], [f.format() for f in got]
    want, _ = ref_statics.analyze_paths([PORT], rules=SHARED)
    assert want == [], [f.format() for f in want]


def test_multihost_connect_carries_reasoned_suppressions():
    """The per-channel connect and its backoff block under the channel's
    mutex by design; both lines say why, as the reference's do."""
    src = (PORT / "distributed" / "multihost.py").read_text().splitlines()
    sups = [ln for ln in src if "statics: ignore[blocking-call-under-lock]"
            in ln]
    assert len(sups) == 2
    assert all(" -- " in ln for ln in sups)
    findings, _ = analyze_paths([PORT / "distributed" / "multihost.py"],
                                guarded_attrs={})
    assert findings == []


# ------------------------------------------------------------ launch rules
@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_launch_corpus_file_trips_exactly_its_rule(corpus, name):
    findings, n_files = analyze_paths([corpus / name])
    assert n_files == 1
    assert [f.rule for f in findings] == EXPECTED[name], \
        [f.format() for f in findings]


def test_launch_corpus_covers_every_launch_rule(corpus):
    findings, _ = analyze_paths([corpus], rules=set(RULE_FAMILIES["launch"]))
    assert {f.rule for f in findings} == set(RULE_FAMILIES["launch"])


def test_undeclared_names_the_symbol_and_what_is_missing(corpus):
    findings, _ = analyze_paths([corpus / "bad_undeclared_ctypes.py"])
    (f,) = findings
    assert "lib.toy_smem" in f.message and "restype" in f.message
    assert "argtypes" not in f.message


def test_unresolved_getattr_prefix_is_skipped(tmp_path):
    """A symbol built from a prefix the module never binds to a literal is
    not checked (the docstring's rule); the same call with a literal
    prefix is."""
    src = textwrap.dedent("""
        import ctypes

        def smem(lib, prefix, n):
            return getattr(lib, f"{prefix}_smem_bytes")(n)
    """)
    (tmp_path / "free.py").write_text(src)
    (tmp_path / "bound.py").write_text(src + "\n\nK = smem(None, 'toy', 1)\n")
    free, _ = analyze_paths([tmp_path / "free.py"])
    bound, _ = analyze_paths([tmp_path / "bound.py"])
    assert free == []
    assert [f.rule for f in bound] == ["launch-undeclared-ctypes"]
    assert "lib.toy_smem_bytes" in bound[0].message


@pytest.mark.parametrize("module", ["spmm_accel.py", "grouped_matmul.py",
                                    "build.py"])
def test_port_kernel_wrappers_are_launch_clean(module):
    path = PORT / "kernels" / module
    assert "import ctypes" in path.read_text()
    findings, _ = analyze_paths([path], rules=set(RULE_FAMILIES["launch"]))
    assert findings == [], [f.format() for f in findings]


def test_launch_rules_read_the_kernels_launches():
    """The wrappers really are in the family's scope: with their guards,
    stream and status checks stripped they trip the rules."""
    src = (PORT / "kernels" / "grouped_matmul.py").read_text()
    broken = (src.replace("if n_ctas > _MAX_GRID:", "if False:")
              .replace("if err != 0:", "if False:"))
    assert broken != src
    import ast
    from repro_torch.statics import launch_rules
    rules = {f.rule for f in launch_rules.check("g.py", ast.parse(broken))}
    assert rules == {"launch-unguarded-grid", "launch-unchecked-status"}


# --------------------------------------------------------------------- CLI
def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.statics", *args],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=120)


def test_cli_clean_on_defaults():
    r = _cli()
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 findings" in r.stderr


def test_cli_fails_on_corpus(corpus):
    r = _cli(str(corpus))
    assert r.returncode == 1, r.stdout + r.stderr
    for rule in RULE_FAMILIES["launch"]:
        assert rule in r.stdout


def test_cli_lists_four_families():
    r = _cli("--list-rules")
    assert r.returncode == 0
    families = [ln.rstrip(":") for ln in r.stdout.splitlines()
                if not ln.startswith(" ")]
    assert families == ["lock", "launch", "future", "meta"]
    for rule in ALL_RULES:
        assert f"  {rule}" in r.stdout
