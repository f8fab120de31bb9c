"""Future/WorkItem settlement rule.

A ``WorkItem`` (or bare ``concurrent.futures.Future``) constructed and
*fully owned* by one function must reach exactly one settle call —
``complete`` / ``fail`` / ``cancel`` / ``set_result`` / ``set_exception``
— on every path out of that function.  Futures that escape (returned,
stored into an attribute/container, passed to another call, or captured
by a nested function) are someone else's responsibility and are skipped.

The path arithmetic is a conservative (min, max) settle count over the
statement tree: ``min == 0`` means some path leaks the future
(``future-leak``); ``max >= 2`` means some path can settle twice — the
mid-flush ``InvalidStateError`` class (``future-double-settle``).
"""

from __future__ import annotations

import ast

from .findings import Finding

_CONSTRUCTORS = {"WorkItem", "Future"}
_SETTLE_METHODS = {"complete", "fail", "cancel", "set_result", "set_exception"}


def _constructed_names(func: ast.FunctionDef) -> dict[str, int]:
    """local name -> lineno for `name = WorkItem(...)` / `name = Future()`."""
    out: dict[str, int] = {}
    for node in ast.walk(func):
        if not isinstance(node, ast.Assign) or not isinstance(node.value, ast.Call):
            continue
        f = node.value.func
        ctor = None
        if isinstance(f, ast.Name) and f.id in _CONSTRUCTORS:
            ctor = f.id
        elif isinstance(f, ast.Attribute) and f.attr in _CONSTRUCTORS:
            ctor = f.attr
        if ctor is None:
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                out[t.id] = node.lineno
    return out


def _escapes(func: ast.FunctionDef, name: str) -> bool:
    for node in ast.walk(func):
        # returned / yielded
        if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)) and node.value:
            if any(
                isinstance(n, ast.Name) and n.id == name for n in ast.walk(node.value)
            ):
                return True
        # stored somewhere that outlives the frame, or aliased
        if isinstance(node, ast.Assign):
            if any(
                isinstance(n, ast.Name) and n.id == name
                for n in ast.walk(node.value)
            ) and not (
                isinstance(node.value, ast.Call)
                and any(
                    isinstance(t, ast.Name) and t.id == name for t in node.targets
                )
            ):
                # e.g. self._items[k] = item, other = item, lst = [item]
                if not all(
                    isinstance(t, ast.Name) and t.id == name for t in node.targets
                ):
                    return True
        # passed as an argument (incl. queue.append(item), fn(item))
        if isinstance(node, ast.Call):
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                for n in ast.walk(arg):
                    if isinstance(n, ast.Name) and n.id == name:
                        # item.complete(x) has `item` as receiver, not arg
                        return True
        # captured by a nested function / lambda
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            if node is not func:
                body = node.body if isinstance(node.body, list) else [node.body]
                for stmt in body:
                    for n in ast.walk(stmt):
                        if isinstance(n, ast.Name) and n.id == name:
                            return True
    return False


def _stmt_settles(stmt: ast.stmt, name: str) -> int:
    """Settle calls on `name` directly inside this statement (not in nested
    compound bodies — those are handled by _count)."""
    count = 0
    for node in ast.walk(stmt):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            f = node.func
            if (
                f.attr in _SETTLE_METHODS
                and isinstance(f.value, ast.Name)
                and f.value.id == name
            ):
                count += 1
    return count


def _count(body: list[ast.stmt], name: str) -> tuple[int, int]:
    """(min, max) settle count along paths through `body`.

    Approximations: loops count as 0-or-double their body; try-bodies may
    be interrupted anywhere, so their settle count is 0..max; a return /
    raise ends the path.
    """
    lo, hi = 0, 0
    for stmt in body:
        if isinstance(stmt, ast.If):
            blo, bhi = _count(stmt.body, name)
            olo, ohi = _count(stmt.orelse, name)
            lo += min(blo, olo)
            hi += max(bhi, ohi)
        elif isinstance(stmt, (ast.For, ast.While, ast.AsyncFor)):
            _, bhi = _count(stmt.body, name)
            olo, ohi = _count(stmt.orelse, name)
            lo += olo
            hi += (2 * bhi if bhi else 0) + ohi
        elif isinstance(stmt, ast.Try):
            blo, bhi = _count(stmt.body + stmt.orelse, name)
            hlos = [_count(h.body, name) for h in stmt.handlers]
            flo, fhi = _count(stmt.finalbody, name)
            if hlos:
                lo += min([blo] + [0 + h[0] for h in hlos]) + flo
                hi += max([bhi] + [bhi + h[1] for h in hlos]) + fhi
            else:
                lo += blo + flo
                hi += bhi + fhi
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            blo, bhi = _count(stmt.body, name)
            lo += blo
            hi += bhi
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        else:
            n = _stmt_settles(stmt, name)
            lo += n
            hi += n
        if isinstance(stmt, (ast.Return, ast.Raise)):
            break
    return lo, hi


def check(path: str, tree: ast.Module) -> list[Finding]:
    findings: list[Finding] = []
    for func in ast.walk(tree):
        if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for name, line in _constructed_names(func).items():
            if _escapes(func, name):
                continue
            lo, hi = _count(func.body, name)
            if lo == 0:
                findings.append(
                    Finding(
                        rule="future-leak",
                        path=path,
                        line=line,
                        message=(
                            f"'{name}' is constructed here but some path through "
                            f"{func.name}() never settles it (complete/fail/"
                            "cancel); waiters would hang forever"
                        ),
                    )
                )
            if hi >= 2:
                findings.append(
                    Finding(
                        rule="future-double-settle",
                        path=path,
                        line=line,
                        message=(
                            f"'{name}' can be settled more than once on some path "
                            f"through {func.name}(); the second settle raises "
                            "InvalidStateError mid-flush"
                        ),
                    )
                )
    return findings
