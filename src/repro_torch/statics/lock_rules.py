"""Lock-discipline rules (the port's copy of the reference package's).

The codebase-wide convention: a method named ``*_locked`` assumes its
caller already holds the owning lock, so

* ``locked-call-outside-lock`` — every call to a ``*_locked`` method must
  be lexically inside a ``with self._lock:`` / ``with self._cond:`` block
  (any attribute or name matching the lock-name pattern counts), unless
  the enclosing function is itself ``*_locked``.
* ``guarded-attr-outside-lock`` — attributes registered in the guarded
  registry (e.g. ``BatchScheduler._queues`` -> ``_cond``) may only be
  touched while lexically holding the registered lock, inside a
  ``*_locked`` method, or inside ``__init__`` (no concurrent readers can
  exist before ``__init__`` returns).
* ``blocking-call-under-lock`` — no blocking call (``time.sleep``,
  ``Future.result`` without ``timeout=0``, foreign ``.wait()``, socket
  and peer I/O, ``scheduler.submit``) inside a ``with <lock>:`` body or a
  ``*_locked`` method.  This is the mutual-forwarding deadlock class:
  two hosts each holding a lock while waiting on the other's answer.

All checks are lexical: holding a lock inside a helper the caller
invoked is invisible, which is exactly why the ``*_locked`` naming
convention exists.
"""

from __future__ import annotations

import ast
import re

from .findings import Finding

# matches _lock, _bind_lock, _cond, _cv, lock, prep_lock, mutex, ...
LOCK_NAME_RE = re.compile(r"(^|_)(lock|locks|cv|cond|mutex)($|_)")

# methods whose *receiver* makes the call blocking under a lock
_SOCKET_METHODS = {
    "recv",
    "recv_into",
    "accept",
    "connect",
    "create_connection",
    "sendall",
    "makefile",
    "request",
    "handshake",
}
_SCHEDULER_SUBMIT = {"submit", "submit_many"}


def _is_lock_expr(expr: ast.expr) -> bool:
    if isinstance(expr, ast.Attribute):
        return bool(LOCK_NAME_RE.search(expr.attr))
    if isinstance(expr, ast.Name):
        return bool(LOCK_NAME_RE.search(expr.id))
    return False


def _expr_key(expr: ast.expr) -> str:
    return ast.dump(expr)


def _receiver_text(expr: ast.expr) -> str:
    """Best-effort dotted-source rendering of a call receiver."""
    try:
        return ast.unparse(expr)
    except Exception:
        return ""


class GuardedRegistry:
    """class name -> {attr name -> owning lock attr}, closed over bases.

    ``class_bases`` maps every class seen across the analyzed tree to its
    base-class names, so subclasses (FleetGraphEngine, MultihostGraphEngine)
    inherit their parents' guarded attributes.
    """

    def __init__(self, guarded: dict[str, dict[str, str]], class_bases: dict[str, list[str]]):
        self._guarded = guarded
        self._bases = class_bases
        self._cache: dict[str, dict[str, str]] = {}

    def for_class(self, name: str) -> dict[str, str]:
        if name in self._cache:
            return self._cache[name]
        merged: dict[str, str] = {}
        seen: set[str] = set()
        stack = [name]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            for attr, lock in self._guarded.get(cur, {}).items():
                merged.setdefault(attr, lock)
            stack.extend(self._bases.get(cur, []))
        self._cache[name] = merged
        return merged


# The default registry: state that has bitten before (non-atomic stats
# snapshots, torn bindings).  Keys are attribute names on ``self``; values
# are the lock attribute that owns them.  The port's classes carry the
# reference's names and guarded attributes (serve/scheduler.py,
# core/plan_cache.py, serve/graph_engine.py).
DEFAULT_GUARDED_ATTRS: dict[str, dict[str, str]] = {
    "BatchScheduler": {
        "_queues": "_cond",
        "_credits": "_cond",
        "_latencies": "_cond",
        "_class_latencies": "_cond",
    },
    "PlanCache": {
        "_plans": "_lock",
        "_pins": "_lock",
        "_retired": "_lock",
        "_inflight": "_lock",
    },
    "GraphServeEngine": {
        "_graphs": "_bind_lock",
        "_keys": "_bind_lock",
        "_versions": "_bind_lock",
    },
}


class _FunctionLockChecker:
    """Walks one function body tracking the lexical stack of held locks."""

    def __init__(
        self,
        path: str,
        func: ast.FunctionDef | ast.AsyncFunctionDef,
        class_name: str | None,
        guarded: dict[str, str],
    ):
        self.path = path
        self.func = func
        self.class_name = class_name
        self.guarded = guarded
        self.in_locked_fn = func.name.endswith("_locked")
        self.is_init = func.name == "__init__"
        self.findings: list[Finding] = []
        # stack of ast.dump() keys of held lock expressions
        self.held: list[str] = []

    def run(self) -> list[Finding]:
        for stmt in self.func.body:
            self._walk(stmt)
        return self.findings

    # -- statement walking -------------------------------------------------

    def _walk(self, node: ast.stmt) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def runs later, possibly on another thread: check it
            # as its own scope with a fresh (empty) held-lock stack
            sub = _FunctionLockChecker(self.path, node, self.class_name, self.guarded)
            self.findings.extend(sub.run())
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in node.items:
                self._visit_expr(item.context_expr)
                if _is_lock_expr(item.context_expr):
                    self.held.append(_expr_key(item.context_expr))
                    pushed += 1
            for child in node.body:
                self._walk(child)
            for _ in range(pushed):
                self.held.pop()
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                self._walk(child)
            elif isinstance(child, ast.expr):
                self._visit_expr(child)
            elif isinstance(child, (ast.excepthandler, ast.withitem)):
                for sub in ast.iter_child_nodes(child):
                    if isinstance(sub, ast.stmt):
                        self._walk(sub)
                    elif isinstance(sub, ast.expr):
                        self._visit_expr(sub)

    def _visit_expr(self, node: ast.expr) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._check_call(sub)
            elif isinstance(sub, ast.Attribute):
                self._check_guarded_attr(sub)

    # -- rule bodies -------------------------------------------------------

    def _under_lock(self) -> bool:
        return bool(self.held) or self.in_locked_fn

    def _check_call(self, call: ast.Call) -> None:
        func = call.func
        name = None
        if isinstance(func, ast.Attribute):
            name = func.attr
        elif isinstance(func, ast.Name):
            name = func.id
        if name is None:
            return

        # locked-call-outside-lock
        if name.endswith("_locked") and not self._under_lock():
            self.findings.append(
                Finding(
                    rule="locked-call-outside-lock",
                    path=self.path,
                    line=call.lineno,
                    message=(
                        f"call to {name}() outside any 'with <lock>:' block; "
                        "*_locked methods require the caller to hold the lock"
                    ),
                )
            )

        # blocking-call-under-lock
        if self._under_lock():
            self._check_blocking(call, func, name)

    def _check_blocking(self, call: ast.Call, func: ast.expr, name: str) -> None:
        def flag(what: str) -> None:
            self.findings.append(
                Finding(
                    rule="blocking-call-under-lock",
                    path=self.path,
                    line=call.lineno,
                    message=(
                        f"{what} while holding a lock can deadlock or stall every "
                        "other thread contending for it; move it outside the "
                        "'with' block"
                    ),
                )
            )

        if not isinstance(func, ast.Attribute):
            if isinstance(func, ast.Name) and func.id == "sleep":
                flag("sleep()")
            return

        recv = func.value
        if name == "sleep":
            if isinstance(recv, ast.Name) and recv.id == "time":
                flag("time.sleep()")
            return
        if name == "result":
            if not self._is_zero_timeout(call):
                flag("Future.result() without timeout=0")
            return
        if name == "wait":
            # cond.wait() on a lock we are lexically holding releases it —
            # that is the one legitimate blocking wait under a lock
            if _expr_key(recv) in self.held:
                return
            flag(f"{_receiver_text(recv)}.wait()")
            return
        if name == "join":
            if isinstance(recv, ast.Constant) and isinstance(recv.value, str):
                return  # "sep".join(...) is string join, not thread join
            if _receiver_text(recv).endswith(("path", "os.path")):
                return
            flag(f"{_receiver_text(recv)}.join()")
            return
        if name in _SOCKET_METHODS:
            flag(f"socket/peer I/O ({_receiver_text(recv)}.{name}())")
            return
        if name in _SCHEDULER_SUBMIT:
            text = _receiver_text(recv).lower()
            if "sched" in text:
                flag(f"{_receiver_text(recv)}.{name}()")
            return

    @staticmethod
    def _is_zero_timeout(call: ast.Call) -> bool:
        for kw in call.keywords:
            if kw.arg == "timeout":
                return isinstance(kw.value, ast.Constant) and kw.value.value == 0
        if call.args:
            a = call.args[0]
            return isinstance(a, ast.Constant) and a.value == 0
        return False

    def _check_guarded_attr(self, node: ast.Attribute) -> None:
        if not self.guarded or self.is_init or self.in_locked_fn:
            return
        if not (isinstance(node.value, ast.Name) and node.value.id == "self"):
            return
        lock_attr = self.guarded.get(node.attr)
        if lock_attr is None:
            return
        want = _expr_key(ast.parse(f"self.{lock_attr}", mode="eval").body)
        if want in self.held:
            return
        self.findings.append(
            Finding(
                rule="guarded-attr-outside-lock",
                path=self.path,
                line=node.lineno,
                message=(
                    f"self.{node.attr} is guarded by self.{lock_attr}; access it "
                    f"inside 'with self.{lock_attr}:' or from a *_locked method"
                ),
            )
        )


def check(
    path: str,
    tree: ast.Module,
    registry: GuardedRegistry,
) -> list[Finding]:
    findings: list[Finding] = []

    def visit_scope(body: list[ast.stmt], class_name: str | None) -> None:
        for node in body:
            if isinstance(node, ast.ClassDef):
                visit_scope(node.body, node.name)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                guarded = registry.for_class(class_name) if class_name else {}
                findings.extend(
                    _FunctionLockChecker(path, node, class_name, guarded).run()
                )
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                visit_scope(
                    [n for n in ast.iter_child_nodes(node) if isinstance(n, ast.stmt)],
                    class_name,
                )
    visit_scope(tree.body, None)
    return findings
