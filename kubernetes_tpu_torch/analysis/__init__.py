"""kube-vet — invariant-enforcing static analysis for the control plane.

The reference tree gates every change through govet/golint
(ref: hack/test-go.sh); this package is the project-specific analog. It
does NOT re-implement a general linter: every rule encodes one
hard-won, machine-checkable invariant of THIS codebase, each motivated
by a real incident (the r11 donation heap corruption, the PR 1
f-string that silently muted 13 test modules) or a documented contract
(the read-only-store-objects invariant, the bounded-queue discipline).

Each rule's docstring (analysis/rules.py) states its invariant; the
waiver grammar is in analysis/engine.py. This is the port's vet: its
default tree is ``kubernetes_tpu_torch/`` and ``chip_smoke.py``, and the
rules scoped to the package read the port's paths. CLI: ``python
kubernetes_tpu_torch/tools/vet.py``.
"""

from kubernetes_tpu_torch.analysis.engine import (  # noqa: F401
    FileContext, Rule, Violation, Waiver, all_rules, default_paths,
    format_violation, load_context, run_vet)
from kubernetes_tpu_torch.analysis import rules  # noqa: F401  (registers rules)

__all__ = ["FileContext", "Rule", "Violation", "Waiver", "all_rules",
           "default_paths", "format_violation", "load_context", "run_vet",
           "rules"]
