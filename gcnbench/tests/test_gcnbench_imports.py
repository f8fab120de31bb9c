"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either. Names are compared by
their top-level part, whole: ``repro_torch`` is not ``repro``."""
import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def modules():
    return sorted(BENCH.rglob("*.py"))


def test_there_are_modules_to_check():
    names = {p.name for p in modules()}
    assert {"run.py", "model.py", "graphs.py", "train.py"} <= names


def test_no_module_imports_jax_or_the_jax_package():
    found = {(str(p.relative_to(BENCH)), n) for p in modules()
             for n in top_level_imports(p) if n in FORBIDDEN}
    assert not found


def test_reference_imports_nothing_of_the_program():
    ref = sorted((BENCH / "reference").rglob("*.py"))
    assert ref
    found = {(p.name, n) for p in ref for n in top_level_imports(p)
             if n in FORBIDDEN | {"repro_torch", "gcnbench"}}
    assert not found


def test_the_check_compares_whole_top_level_names():
    from gcnbench.run import forbidden_modules
    assert forbidden_modules(["repro_torch", "repro_torch.models.gcn",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["repro.core", "jax.numpy", "flax"]) == [
        "flax", "jax", "repro"]
