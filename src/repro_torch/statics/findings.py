"""Finding + suppression machinery shared by every statics rule.

A finding is one (rule, file, line, message) tuple.  Suppressions are
per-line comments of the form::

    # statics: ignore[rule-a,rule-b] -- reason the violation is intentional

The reason string after ``--`` is mandatory: a suppression without one
does not suppress anything and instead raises a ``bad-suppression``
finding, so "shut it up and move on" leaves a visible trail.
"""

from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass(frozen=True)
class Suppression:
    line: int
    rules: tuple[str, ...]
    reason: str | None


_SUPPRESS_RE = re.compile(
    r"#\s*statics:\s*ignore\[(?P<rules>[A-Za-z0-9_,\- ]*)\]"
    r"(?:\s*--\s*(?P<reason>\S.*))?"
)


def parse_suppressions(source: str) -> list[Suppression]:
    out: list[Suppression] = []
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if m is None:
            continue
        rules = tuple(r.strip() for r in m.group("rules").split(",") if r.strip())
        reason = m.group("reason")
        out.append(Suppression(line=lineno, rules=rules, reason=reason))
    return out


def apply_suppressions(
    findings: list[Finding], suppressions: list[Suppression], path: str
) -> list[Finding]:
    """Drop findings covered by a well-formed same-line suppression.

    Malformed suppressions (no rule list, or no ``-- reason``) never
    suppress and each contribute one ``bad-suppression`` finding.
    """
    valid_by_line: dict[int, set[str]] = {}
    kept: list[Finding] = []
    for s in suppressions:
        if s.rules and s.reason:
            valid_by_line.setdefault(s.line, set()).update(s.rules)
        else:
            kept.append(
                Finding(
                    rule="bad-suppression",
                    path=path,
                    line=s.line,
                    message=(
                        "suppression needs both a rule list and a reason: "
                        "'# statics: ignore[rule] -- why this is safe'"
                    ),
                )
            )
    for f in findings:
        if f.rule in valid_by_line.get(f.line, ()):
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.rule))
    return kept
