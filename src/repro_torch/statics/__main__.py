"""Run the port's invariant analyzer over the tree.

Exit 0 when no unsuppressed findings; exit 1 otherwise.

Usage:
    python -m repro_torch.statics                     # default paths
    python -m repro_torch.statics src/repro_torch/serve
    python -m repro_torch.statics --rules lock,launch # families or rules
    python -m repro_torch.statics --list-rules
    python -m repro_torch.statics --json

The default paths are the package itself and, where it sits beside the
package's ``src`` directory, the repository's ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import ALL_RULES, RULE_FAMILIES, analyze_paths

PACKAGE = Path(__file__).resolve().parent.parent


def default_paths() -> list[str]:
    paths = [str(PACKAGE)]
    smoke = PACKAGE.parent.parent / "chip_smoke.py"
    if smoke.is_file():
        paths.append(str(smoke))
    return paths


def _resolve_rules(spec: str | None) -> set[str] | None:
    if spec is None:
        return None
    out: set[str] = set()
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        if token in RULE_FAMILIES:
            out.update(RULE_FAMILIES[token])
        elif token in ALL_RULES:
            out.add(token)
        else:
            sys.exit(f"unknown rule or family: {token!r} (see --list-rules)")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.statics",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to check (default: src/repro_torch "
                         "and chip_smoke.py)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule names or families "
                         f"({', '.join(RULE_FAMILIES)})")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    args = ap.parse_args(argv)

    if args.list_rules:
        for family, rules in RULE_FAMILIES.items():
            print(f"{family}:")
            for r in rules:
                print(f"  {r}")
        return 0

    paths = args.paths or default_paths()
    findings, n_files = analyze_paths(paths, rules=_resolve_rules(args.rules))

    if args.as_json:
        print(json.dumps(
            [{"rule": f.rule, "path": f.path, "line": f.line, "message": f.message}
             for f in findings],
            indent=2,
        ))
    else:
        for f in findings:
            print(f.format())
        label = "finding" if len(findings) == 1 else "findings"
        print(f"checked {n_files} files: {len(findings)} {label}", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
