"""Drives the statics rules over a file set.

Two passes: pass 1 builds the cross-file class -> bases map (so guarded
attributes follow inheritance: ``MultihostGraphEngine`` ->
``FleetGraphEngine`` -> ``GraphServeEngine``); pass 2 runs every rule
module per file and filters findings through the per-line suppressions.
The families are the reference's but one: the port launches hand-written
kernels through ``ctypes``, so the ``launch`` family takes the place of
the ``pallas`` one.
"""

from __future__ import annotations

import ast
from pathlib import Path

from . import future_rules, launch_rules, lock_rules
from .findings import Finding, apply_suppressions, parse_suppressions

ALL_RULES: tuple[str, ...] = (
    "locked-call-outside-lock",
    "guarded-attr-outside-lock",
    "blocking-call-under-lock",
    "launch-unchecked-status",
    "launch-off-stream",
    "launch-unguarded-grid",
    "launch-undeclared-ctypes",
    "future-leak",
    "future-double-settle",
    "bad-suppression",
)

RULE_FAMILIES: dict[str, tuple[str, ...]] = {
    "lock": (
        "locked-call-outside-lock",
        "guarded-attr-outside-lock",
        "blocking-call-under-lock",
    ),
    "launch": (
        "launch-unchecked-status",
        "launch-off-stream",
        "launch-unguarded-grid",
        "launch-undeclared-ctypes",
    ),
    "future": ("future-leak", "future-double-settle"),
    "meta": ("bad-suppression",),
}


def collect_py_files(paths: list[str | Path]) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            files.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            files.append(path)
    # dedupe, keep order
    seen: set[Path] = set()
    out = []
    for f in files:
        r = f.resolve()
        if r not in seen and "__pycache__" not in f.parts:
            seen.add(r)
            out.append(f)
    return out


def _class_bases(trees: dict[Path, ast.Module]) -> dict[str, list[str]]:
    bases: dict[str, list[str]] = {}
    for tree in trees.values():
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                names = []
                for b in node.bases:
                    if isinstance(b, ast.Name):
                        names.append(b.id)
                    elif isinstance(b, ast.Attribute):
                        names.append(b.attr)
                bases[node.name] = names
    return bases


def analyze_paths(
    paths: list[str | Path],
    rules: set[str] | None = None,
    guarded_attrs: dict[str, dict[str, str]] | None = None,
) -> tuple[list[Finding], int]:
    """Run the analyzer. Returns (findings, files_checked).

    ``rules`` restricts output to a subset of ALL_RULES (None = all).
    ``guarded_attrs`` overrides lock_rules.DEFAULT_GUARDED_ATTRS.
    """
    files = collect_py_files(paths)
    sources: dict[Path, str] = {}
    trees: dict[Path, ast.Module] = {}
    findings: list[Finding] = []
    for f in files:
        try:
            src = f.read_text()
            trees[f] = ast.parse(src, filename=str(f))
            sources[f] = src
        except SyntaxError as e:
            findings.append(
                Finding(
                    rule="syntax-error",
                    path=str(f),
                    line=e.lineno or 0,
                    message=f"file does not parse: {e.msg}",
                )
            )

    registry = lock_rules.GuardedRegistry(
        guarded_attrs if guarded_attrs is not None else lock_rules.DEFAULT_GUARDED_ATTRS,
        _class_bases(trees),
    )

    for f, tree in trees.items():
        path = str(f)
        raw: list[Finding] = []
        raw.extend(lock_rules.check(path, tree, registry))
        raw.extend(launch_rules.check(path, tree))
        raw.extend(future_rules.check(path, tree))
        raw = apply_suppressions(raw, parse_suppressions(sources[f]), path)
        findings.extend(raw)

    if rules is not None:
        findings = [f for f in findings if f.rule in rules or f.rule == "syntax-error"]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, len(files)
