"""Label selectors — what the listers and the service lister match with.

Port of the part of ``kubernetes_tpu/api/labels.py`` (ref: pkg/labels/
labels.go, selector.go) that the client cache calls: equality
``Requirement``s, their conjunction ``Selector`` and
``selector_from_set``. The string parser is not ported: the port's
callers build selectors from label sets.
"""

from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["Requirement", "Selector", "selector_from_set"]


class Requirement:
    """``key = value`` (ref: selector.go Requirement, the equality ops)."""

    __slots__ = ("key", "value")

    def __init__(self, key: str, value: str):
        self.key = key
        self.value = value

    def matches(self, labels: Dict[str, str]) -> bool:
        return labels.get(self.key) == self.value


class Selector:
    """A conjunction of Requirements (ref: selector.go internalSelector)."""

    __slots__ = ("requirements",)

    def __init__(self, requirements: Optional[List[Requirement]] = None):
        self.requirements = list(requirements or [])

    def matches(self, labels: Optional[Dict[str, str]]) -> bool:
        labels = labels or {}
        return all(r.matches(labels) for r in self.requirements)


def selector_from_set(labels: Optional[Dict[str, str]]) -> Selector:
    """ref: labels.go SelectorFromSet — nil/empty set selects everything."""
    return Selector([Requirement(k, v)
                     for k, v in sorted((labels or {}).items())])
