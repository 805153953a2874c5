#!/usr/bin/env python
"""kube-vet CLI for the port — the project's govet analog (ref:
hack/test-go.sh gating every change through govet/golint).

Runs the invariant rule set in kubernetes_tpu_torch/analysis over the
port's tree (the package and chip_smoke.py) and exits non-zero on any
active (unwaived) violation. The rules and the waiver grammar are
documented in analysis/rules.py and analysis/engine.py.

Usage::

    python kubernetes_tpu_torch/tools/vet.py              # the port, all rules
    python kubernetes_tpu_torch/tools/vet.py path/to/file.py ...
    python kubernetes_tpu_torch/tools/vet.py --rules unused,py310-compat
    python kubernetes_tpu_torch/tools/vet.py --list-rules
    python kubernetes_tpu_torch/tools/vet.py --show-waived  # every waiver
    python kubernetes_tpu_torch/tools/vet.py --json         # machine-readable

Exit codes: 0 clean, 1 violations found, 2 usage/internal error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, _REPO)

from kubernetes_tpu_torch.analysis import (  # noqa: E402
    all_rules, default_paths, format_violation, run_vet)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="vet", description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="files to vet (default: the whole tree)")
    ap.add_argument("--rules", default="",
                    help="comma-separated rule ids (default: all)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--show-waived", action="store_true",
                    help="also print waived findings with their reasons")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for rid in sorted(rules):
            print(f"{rid:18s} {rules[rid].doc}")
        return 0
    rule_ids = None
    if args.rules:
        rule_ids = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rule_ids if r not in rules]
        if unknown:
            print(f"vet: unknown rule(s): {', '.join(unknown)} "
                  f"(--list-rules)", file=sys.stderr)
            return 2
    paths = [os.path.abspath(p) for p in args.paths] or None
    try:
        active, waived = run_vet(paths=paths, rule_ids=rule_ids, root=_REPO)
    except (OSError, ValueError) as e:
        print(f"vet: {e}", file=sys.stderr)
        return 2

    if args.as_json:
        print(json.dumps({
            "violations": [vars(v) for v in active],
            "waived": [vars(v) for v in waived]}, indent=1, default=str))
        return 1 if active else 0

    for v in active:
        print(format_violation(v))
    if args.show_waived:
        for v in waived:
            print(format_violation(v))
    n_files = len(paths) if paths else len(default_paths(_REPO))
    print(f"[vet] {n_files} files, "
          f"{len(rule_ids) if rule_ids else len(rules)} rules: "
          f"{len(active)} violations, {len(waived)} waived", file=sys.stderr)
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
