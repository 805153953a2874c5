"""Field selectors (ref: pkg/fields/).

Port of ``kubernetes_tpu/api/fields.py``.

Select objects by field values, e.g. ``spec.host=`` selects unscheduled pods
(used by the scheduler's unassigned-pod reflector, ref:
plugin/pkg/scheduler/factory/factory.go:177). Only equality / inequality are
supported, mirroring the reference (pkg/fields/selector.go ParseSelector).
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["FieldSelector", "parse_field_selector", "everything"]


class FieldSelector:
    __slots__ = ("requirements",)

    def __init__(self, requirements=None):
        # list of (field, op, value) with op in {"=", "!="}
        self.requirements = list(requirements or [])

    def matches(self, fields: Dict[str, str]) -> bool:
        for field, op, value in self.requirements:
            has = field in fields
            if op == "=":
                if not has or fields[field] != value:
                    return False
            elif op == "!=":
                if has and fields[field] == value:
                    return False
            else:
                raise ValueError(f"invalid operator {op!r}")
        return True

    def empty(self) -> bool:
        return not self.requirements

    def __str__(self) -> str:
        return ",".join(f"{f}{'=' if op == '=' else '!='}{v}" for f, op, v in self.requirements)

    def __eq__(self, other):
        return isinstance(other, FieldSelector) and sorted(self.requirements) == sorted(
            other.requirements
        )


def everything() -> FieldSelector:
    return FieldSelector()


def parse_field_selector(s: Optional[str]) -> FieldSelector:
    """ref: pkg/fields/selector.go ParseSelector — terms split on ','."""
    if not s:
        return everything()
    reqs = []
    for part in s.split(","):
        if not part:
            continue
        if "!=" in part:
            f, v = part.split("!=", 1)
            reqs.append((f.strip(), "!=", v.strip()))
        elif "==" in part:
            f, v = part.split("==", 1)
            reqs.append((f.strip(), "=", v.strip()))
        elif "=" in part:
            f, v = part.split("=", 1)
            reqs.append((f.strip(), "=", v.strip()))
        else:
            raise ValueError(f"invalid field selector {part!r}")
    return FieldSelector(reqs)
