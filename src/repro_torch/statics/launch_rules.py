"""Launch rules for the ctypes wrappers of the hand-written kernels.

Applied only to files that import ``ctypes``, as the reference package's
Pallas rules apply only to files that import Pallas.  Each turns a failure
on the card into a lint error:

* ``launch-unchecked-status`` — a direct launch is either the function
  handed to ``launch_on_stream`` (which checks it), or its result is bound
  to a name that the same function compares with 0 (``err != 0``, or
  ``if err:``) and raises on.  A bare call, or a status nobody reads,
  lets a launch the card refused pass as a result.
* ``launch-off-stream`` — a direct launch sits lexically inside
  ``with torch.cuda.device(...)`` and passes a name bound in that block
  from ``torch.cuda.current_stream(...).cuda_stream``.  A launch on stream
  0 races the work queued on the caller's stream (the fleet's per-slot
  streams, the tuner's shadow stream).
* ``launch-unguarded-grid`` — a function that launches, directly or
  through ``launch_on_stream``, first calls ``check_launch(...)`` or
  compares a CTA count with ``_MAX_GRID``: a launch the card would refuse
  becomes a ``ValueError`` that names the kernel instead of an error code.
* ``launch-undeclared-ctypes`` — every ``lib.<symbol>`` that the module
  calls, or hands to ``launch_on_stream``, has both ``.argtypes`` and
  ``.restype`` assigned in the module: ctypes' default C-int ``restype``
  truncates a 64-bit result such as a CTA count or a shared-memory size.

A direct launch is a call of an attribute named ``*_launch`` (or of
``getattr(lib, "..._launch")``), or, inside ``launch_on_stream`` itself,
the call of its ``fn`` parameter.  A receiver is a library when its name is
``lib`` or ends in ``_lib``.  A symbol named as
``getattr(lib, f"{prefix}_...")`` is resolved where ``prefix`` is a
literal in the module (bound at module level, or passed for a parameter
named ``prefix`` of a function the module defines) and skipped otherwise.
"""

from __future__ import annotations

import ast
import itertools
import re

from .findings import Finding

_HELPER = "launch_on_stream"       # checks and counts a launch it is handed
_HELPER_FN = "fn"                  # the helper's launch-function parameter
_GUARD_CALL = "check_launch"
_GRID_LIMIT = "_MAX_GRID"
_LIB_RE = re.compile(r"(^|_)lib$")


def _imports_ctypes(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] == "ctypes" for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == "ctypes":
                return True
    return False


def _dotted_tail(expr: ast.expr) -> tuple[str, ...]:
    """``torch.cuda.device`` -> ("torch", "cuda", "device"); () otherwise."""
    parts: list[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return tuple(reversed(parts))
    return ()


def _ends_with(expr: ast.expr, *tail: str) -> bool:
    return _dotted_tail(expr)[-len(tail):] == tail


def _call_name(call: ast.Call) -> str | None:
    if isinstance(call.func, ast.Name):
        return call.func.id
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return None


def _is_lib(expr: ast.expr) -> bool:
    return isinstance(expr, ast.Name) and bool(_LIB_RE.search(expr.id))


def _is_getattr_on_lib(expr: ast.expr) -> bool:
    return (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name)
            and expr.func.id == "getattr" and len(expr.args) == 2
            and _is_lib(expr.args[0]))


def _is_launch_ref(expr: ast.expr) -> bool:
    """``x.<name>_launch`` or ``getattr(lib, "<...>_launch")``."""
    if isinstance(expr, ast.Attribute):
        return expr.attr.endswith("_launch")
    if _is_getattr_on_lib(expr):
        name = expr.args[1]
        if isinstance(name, ast.Constant) and isinstance(name.value, str):
            return name.value.endswith("_launch")
        if isinstance(name, ast.JoinedStr) and name.values:
            last = name.values[-1]
            return (isinstance(last, ast.Constant)
                    and isinstance(last.value, str)
                    and last.value.endswith("_launch"))
    return False


_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)


def _own_nodes(scope: ast.Module | ast.FunctionDef | ast.AsyncFunctionDef):
    """Every node of ``scope``'s body outside nested functions, lambdas and
    classes (each function is checked as a scope of its own)."""
    stack = [n for n in scope.body if not isinstance(n, _SCOPES)]
    while stack:
        node = stack.pop()
        yield node
        stack.extend(c for c in ast.iter_child_nodes(node)
                     if not isinstance(c, _SCOPES))


def _parents(func: ast.AST) -> dict[ast.AST, ast.AST]:
    out: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(func):
        for child in ast.iter_child_nodes(node):
            out[child] = node
    return out


def _direct_launches(func) -> list[ast.Call]:
    out = []
    for node in _own_nodes(func):
        if not isinstance(node, ast.Call):
            continue
        if _is_launch_ref(node.func):
            out.append(node)
        elif (func.name == _HELPER and isinstance(node.func, ast.Name)
              and node.func.id == _HELPER_FN):
            out.append(node)
    return out


# -- launch-unchecked-status --------------------------------------------------

def _raises(body: list[ast.stmt]) -> bool:
    return any(isinstance(n, ast.Raise) for stmt in body for n in ast.walk(stmt))


def _is_zero(expr: ast.expr) -> bool:
    return isinstance(expr, ast.Constant) and expr.value == 0 \
        and not isinstance(expr.value, bool)


def _checks_status(func, name: str, after: int) -> bool:
    """An ``if`` after line ``after`` that raises when ``name`` != 0."""
    for node in _own_nodes(func):
        if not isinstance(node, ast.If) or node.lineno <= after:
            continue
        test = node.test
        if isinstance(test, ast.Name) and test.id == name:
            if _raises(node.body):
                return True
            continue
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
            continue
        left, right = test.left, test.comparators[0]
        named = [e for e in (left, right)
                 if isinstance(e, ast.Name) and e.id == name]
        if not named or not (_is_zero(left) or _is_zero(right)):
            continue
        if isinstance(test.ops[0], ast.NotEq) and _raises(node.body):
            return True
        if isinstance(test.ops[0], ast.Eq) and _raises(node.orelse):
            return True
    return False


def _check_status(path, func, launches, parents) -> list[Finding]:
    out = []
    for call in launches:
        parent = parents.get(call)
        if (isinstance(parent, ast.Assign) and parent.value is call
                and len(parent.targets) == 1
                and isinstance(parent.targets[0], ast.Name)
                and _checks_status(func, parent.targets[0].id, call.lineno)):
            continue
        out.append(Finding(
            rule="launch-unchecked-status", path=path, line=call.lineno,
            message=(
                f"the status of {ast.unparse(call.func)}() is never checked: "
                "bind it and raise when it is not 0, or hand the launch "
                f"function to {_HELPER}()"),
        ))
    return out


# -- launch-off-stream --------------------------------------------------------

def _stream_names(with_node: ast.With) -> set[str]:
    names: set[str] = set()
    for stmt in with_node.body:
        for node in ast.walk(stmt):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            v = node.value
            if (isinstance(v, ast.Attribute) and v.attr == "cuda_stream"
                    and isinstance(v.value, ast.Call)
                    and _ends_with(v.value.func, "cuda", "current_stream")):
                names.add(node.targets[0].id)
    return names


def _check_stream(path, launches, parents) -> list[Finding]:
    out = []
    for call in launches:
        streams: set[str] = set()
        node = parents.get(call)
        while node is not None:
            if isinstance(node, ast.With) and any(
                    isinstance(i.context_expr, ast.Call)
                    and _ends_with(i.context_expr.func, "cuda", "device")
                    for i in node.items):
                streams |= _stream_names(node)
            node = parents.get(node)
        args = list(call.args) + [kw.value for kw in call.keywords]
        if any(isinstance(a, ast.Name) and a.id in streams for a in args):
            continue
        out.append(Finding(
            rule="launch-off-stream", path=path, line=call.lineno,
            message=(
                f"{ast.unparse(call.func)}() does not pass the caller's stream: "
                "launch inside 'with torch.cuda.device(...)' with a name "
                "bound there from torch.cuda.current_stream(...).cuda_stream"),
        ))
    return out


# -- launch-unguarded-grid ----------------------------------------------------

def _check_grid(path, func, launches) -> list[Finding]:
    if func.name == _HELPER:
        return []           # its callers guard what they hand it
    sites = list(launches) + [
        n for n in _own_nodes(func)
        if isinstance(n, ast.Call) and _call_name(n) == _HELPER]
    if not sites:
        return []
    first = min(sites, key=lambda n: (n.lineno, n.col_offset))
    for node in _own_nodes(func):
        if getattr(node, "lineno", first.lineno) >= first.lineno:
            continue
        if isinstance(node, ast.Call) and _call_name(node) == _GUARD_CALL:
            return []
        if isinstance(node, ast.Compare) and any(
                (isinstance(e, ast.Name) and e.id == _GRID_LIMIT)
                or (isinstance(e, ast.Attribute) and e.attr == _GRID_LIMIT)
                for e in [node.left, *node.comparators]):
            return []
    return [Finding(
        rule="launch-unguarded-grid", path=path, line=first.lineno,
        message=(
            f"{func.name}() launches without calling {_GUARD_CALL}(...) or "
            f"comparing its CTA count with {_GRID_LIMIT} first; a launch "
            "the card refuses should be a ValueError that names the kernel"),
    )]


# -- launch-undeclared-ctypes -------------------------------------------------

def _literals(tree: ast.Module) -> dict[str, set[str]]:
    """name -> string literals it takes: module-level ``NAME = "..."`` and
    arguments passed for parameters of functions defined in the module."""
    out: dict[str, set[str]] = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, set()).add(node.value.value)
    params: dict[str, list[str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            params[node.name] = [a.arg for a in node.args.posonlyargs
                                 + node.args.args]
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in params):
            continue
        names = params[node.func.id]
        pairs = list(zip(names, node.args)) + [
            (kw.arg, kw.value) for kw in node.keywords if kw.arg]
        for name, value in pairs:
            if isinstance(value, ast.Constant) and isinstance(value.value, str):
                out.setdefault(name, set()).add(value.value)
    return out


def _resolve(expr: ast.expr, literals: dict[str, set[str]]) -> set[str]:
    """The strings ``expr`` can name; empty when it cannot be resolved."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return {expr.value}
    if not isinstance(expr, ast.JoinedStr):
        return set()
    choices: list[set[str]] = []
    for part in expr.values:
        if isinstance(part, ast.Constant) and isinstance(part.value, str):
            choices.append({part.value})
        elif (isinstance(part, ast.FormattedValue) and part.conversion == -1
              and part.format_spec is None and isinstance(part.value, ast.Name)
              and literals.get(part.value.id)):
            choices.append(literals[part.value.id])
        else:
            return set()
    return {"".join(p) for p in itertools.product(*choices)}


def _symbols(expr: ast.expr, literals) -> set[str] | None:
    """The library symbols ``expr`` names, or None when it names none."""
    if isinstance(expr, ast.Attribute) and _is_lib(expr.value):
        return None if expr.attr.startswith("_") else {expr.attr}
    if _is_getattr_on_lib(expr):
        return _resolve(expr.args[1], literals)
    return None


def _check_declared(path: str, tree: ast.Module) -> list[Finding]:
    literals = _literals(tree)
    declared: dict[str, set[str]] = {"argtypes": set(), "restype": set()}
    used: dict[str, int] = {}
    funcs = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for scope in [tree, *funcs]:
        nodes = list(_own_nodes(scope))
        aliases: dict[str, set[str]] = {}
        for node in nodes:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                syms = _symbols(node.value, literals)
                if syms is not None:
                    aliases[node.targets[0].id] = syms
        for node in nodes:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if not (isinstance(t, ast.Attribute)
                            and t.attr in declared):
                        continue
                    syms = _symbols(t.value, literals)
                    if syms is None and isinstance(t.value, ast.Name):
                        syms = aliases.get(t.value.id)
                    declared[t.attr] |= syms or set()
            elif isinstance(node, ast.Call):
                refs = [node.func]
                if _call_name(node) == _HELPER:
                    refs += list(node.args)
                for ref in refs:
                    for sym in _symbols(ref, literals) or ():
                        used.setdefault(sym, node.lineno)
    out = []
    for sym, line in sorted(used.items(), key=lambda kv: (kv[1], kv[0])):
        missing = [a for a in ("argtypes", "restype") if sym not in declared[a]]
        if missing:
            out.append(Finding(
                rule="launch-undeclared-ctypes", path=path, line=line,
                message=(
                    f"lib.{sym} is called but its {' and '.join(missing)} "
                    "is never assigned in this module; ctypes' default C-int "
                    "restype truncates a 64-bit result"),
            ))
    return out


def check(path: str, tree: ast.Module) -> list[Finding]:
    if not _imports_ctypes(tree):
        return []
    findings: list[Finding] = []
    for func in ast.walk(tree):
        if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        launches = _direct_launches(func)
        parents = _parents(func)
        findings.extend(_check_status(path, func, launches, parents))
        findings.extend(_check_stream(path, launches, parents))
        findings.extend(_check_grid(path, func, launches))
    findings.extend(_check_declared(path, tree))
    return findings
