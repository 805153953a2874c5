"""ABAC authorization: one JSON policy object per line.

Port of ``kubernetes_tpu/auth/abac.py``.

Rebuild of ``pkg/auth/authorizer/abac/abac.go``: the policy file is JSONL,
each line ``{"user": ..., "group": ..., "readonly": bool, "resource": ...,
"namespace": ...}``; empty/missing fields match everything. A request is
allowed iff some policy line matches; otherwise Forbidden.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, List

from kubernetes_tpu_torch.api import errors

__all__ = ["Policy", "ABACAuthorizer", "AlwaysAllowAuthorizer",
           "AlwaysDenyAuthorizer", "parse_policy_lines"]

READONLY_VERBS = frozenset({"get", "list", "watch"})


@dataclass
class Policy:
    """One policy line (ref: abac.go policy struct)."""

    user: str = ""
    group: str = ""
    readonly: bool = False
    resource: str = ""
    namespace: str = ""

    def matches(self, user: Any, attrs: Any) -> bool:
        if self.user:
            if user is None or self.user != getattr(user, "name", ""):
                return False
        if self.group:
            if user is None or self.group not in getattr(user, "groups", ()):
                return False
        if self.readonly:
            # attrs.operation is "" for get/list/watch (only mutations set it)
            if getattr(attrs, "operation", "") not in ("", *READONLY_VERBS):
                return False
        if self.resource and self.resource != getattr(attrs, "resource", ""):
            return False
        if self.namespace and self.namespace != getattr(attrs, "namespace", ""):
            return False
        return True


def parse_policy_lines(text: str) -> List[Policy]:
    """ref: abac.go NewFromFile — skip blank lines and # comments."""
    policies = []
    for i, line in enumerate(text.splitlines()):
        line = line.strip()
        if not line or line.startswith("#") or line.startswith("//"):
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(f"policy line {i + 1}: {e}") from e
        policies.append(Policy(
            user=obj.get("user", ""), group=obj.get("group", ""),
            readonly=bool(obj.get("readonly", False)),
            resource=obj.get("resource", ""), namespace=obj.get("namespace", "")))
    return policies


class ABACAuthorizer:
    """``authorize(user, attrs)`` raises Forbidden unless a policy matches
    (ref: abac.go Authorize)."""

    def __init__(self, policies: List[Policy]):
        self.policies = policies

    @classmethod
    def from_text(cls, text: str) -> "ABACAuthorizer":
        return cls(parse_policy_lines(text))

    def authorize(self, user: Any, attrs: Any) -> None:
        for p in self.policies:
            if p.matches(user, attrs):
                return
        name = getattr(user, "name", "") if user is not None else "<anonymous>"
        raise errors.new_forbidden(
            getattr(attrs, "resource", ""), getattr(attrs, "name", ""),
            f"user {name!r} cannot {getattr(attrs, 'operation', 'access') or 'access'} "
            f"{getattr(attrs, 'resource', '')}")


class AlwaysAllowAuthorizer:
    def authorize(self, user: Any, attrs: Any) -> None:
        return


class AlwaysDenyAuthorizer:
    def authorize(self, user: Any, attrs: Any) -> None:
        raise errors.new_forbidden(
            getattr(attrs, "resource", ""), getattr(attrs, "name", ""), "always deny")
