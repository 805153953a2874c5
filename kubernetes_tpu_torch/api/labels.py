"""Labels and selectors — the universal grouping mechanism.

Port of ``kubernetes_tpu/api/labels.py``.

Rebuild of the reference's `pkg/labels/` (labels.go, selector.go): a label set
is a str->str map; a Selector matches label sets. Two selector families are
supported, mirroring the reference:

- equality/set-based expression selectors parsed from strings like
  ``"env in (a,b), tier notin (db), partition, !legacy, k=v, k!=v"``
  (ref: pkg/labels/selector.go:626 Parse, grammar at :430-470).
- ``SelectorFromSet`` / plain dict match-labels (ref: labels.go Set.AsSelector).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional

__all__ = [
    "Selector",
    "Requirement",
    "parse_selector",
    "selector_from_set",
    "everything",
    "nothing",
    "format_labels",
    "parse_labels",
]

# Operators (ref: pkg/labels/selector.go:117-124).
IN = "in"
NOT_IN = "notin"
EQUALS = "="
DOUBLE_EQUALS = "=="
NOT_EQUALS = "!="
EXISTS = "exists"
DOES_NOT_EXIST = "!"

_LABEL_VALUE_RE = re.compile(r"^(?:[A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9]$|^$")
_QUALIFIED_NAME_RE = re.compile(
    r"^(?:[a-z0-9](?:[-a-z0-9.]*[a-z0-9])?/)?[A-Za-z0-9](?:[-A-Za-z0-9_.]*[A-Za-z0-9])?$"
)


def validate_label_key(k: str) -> bool:
    """Qualified name: optional DNS-subdomain prefix (<=253) + '/' + name (<=63)
    (ref: pkg/util/validation IsQualifiedName)."""
    if not k:
        return False
    prefix, _, name = k.rpartition("/")
    if prefix and len(prefix) > 253:
        return False
    if not name or len(name) > 63:
        return False
    return bool(_QUALIFIED_NAME_RE.match(k))


def validate_label_value(v: str) -> bool:
    return len(v) <= 63 and bool(_LABEL_VALUE_RE.match(v))


class Requirement:
    """One term of a selector: key op [values] (ref: selector.go:104-259)."""

    __slots__ = ("key", "op", "values")

    def __init__(self, key: str, op: str, values: Iterable[str] = ()):
        self.key = key
        self.op = op
        self.values = sorted(set(values))
        if op in (IN, NOT_IN) and not self.values:
            raise ValueError(f"for {op!r} operator, values set can't be empty")
        if op in (EQUALS, DOUBLE_EQUALS, NOT_EQUALS) and len(self.values) != 1:
            raise ValueError(f"exact-match requires exactly one value, got {self.values}")
        if op in (EXISTS, DOES_NOT_EXIST) and self.values:
            raise ValueError(f"values set must be empty for {op!r}")

    def matches(self, labels: Dict[str, str]) -> bool:
        # ref: selector.go Requirement.Matches (:152-176)
        if self.op in (IN, EQUALS, DOUBLE_EQUALS):
            return self.key in labels and labels[self.key] in self.values
        if self.op in (NOT_IN, NOT_EQUALS):
            return self.key not in labels or labels[self.key] not in self.values
        if self.op == EXISTS:
            return self.key in labels
        if self.op == DOES_NOT_EXIST:
            return self.key not in labels
        raise ValueError(f"unknown operator {self.op!r}")

    def __str__(self) -> str:
        if self.op == EXISTS:
            return self.key
        if self.op == DOES_NOT_EXIST:
            return "!" + self.key
        if self.op in (EQUALS, DOUBLE_EQUALS, NOT_EQUALS):
            return f"{self.key}{self.op}{self.values[0]}"
        return f"{self.key} {self.op} ({','.join(self.values)})"

    def __eq__(self, other):
        return (
            isinstance(other, Requirement)
            and (self.key, self.op, self.values) == (other.key, other.op, other.values)
        )


class Selector:
    """A conjunction of Requirements (ref: selector.go internalSelector)."""

    __slots__ = ("requirements", "_nothing")

    def __init__(self, requirements: Optional[List[Requirement]] = None, nothing: bool = False):
        self.requirements = list(requirements or [])
        self._nothing = nothing

    def matches(self, labels: Optional[Dict[str, str]]) -> bool:
        if self._nothing:
            return False
        labels = labels or {}
        return all(r.matches(labels) for r in self.requirements)

    def empty(self) -> bool:
        return not self._nothing and not self.requirements

    def add(self, *reqs: Requirement) -> "Selector":
        return Selector(self.requirements + list(reqs), self._nothing)

    def exact_match_labels(self) -> Optional[Dict[str, str]]:
        """If the selector is purely conjunctive equality, return the map."""
        out = {}
        for r in self.requirements:
            if r.op in (EQUALS, DOUBLE_EQUALS) or (r.op == IN and len(r.values) == 1):
                out[r.key] = r.values[0]
            else:
                return None
        return out

    def __str__(self) -> str:
        if self._nothing:
            return "<nothing>"
        return ",".join(str(r) for r in sorted(self.requirements, key=lambda r: r.key))

    def __eq__(self, other):
        return (
            isinstance(other, Selector)
            and self._nothing == other._nothing
            and sorted(map(str, self.requirements)) == sorted(map(str, other.requirements))
        )

    def __repr__(self):
        return f"Selector({str(self)!r})"


def everything() -> Selector:
    return Selector()


def nothing() -> Selector:
    return Selector(nothing=True)


def selector_from_set(labels: Optional[Dict[str, str]]) -> Selector:
    """ref: labels.go SelectorFromSet — nil/empty set selects everything."""
    if not labels:
        return everything()
    return Selector([Requirement(k, EQUALS, [v]) for k, v in sorted(labels.items())])


# ---------------------------------------------------------------------------
# Parser (ref: pkg/labels/selector.go lexer/parser :262-626)
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<comma>,) |
        (?P<lparen>\() |
        (?P<rparen>\)) |
        (?P<op>==|=|!=) |
        (?P<bang>!) |
        (?P<ident>[A-Za-z0-9_][A-Za-z0-9_./\-]*)
    )""",
    re.VERBOSE,
)


def _tokenize(s: str):
    pos, out = 0, []
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m or m.end() == pos:
            if s[pos:].strip() == "":
                break
            raise ValueError(f"unable to parse selector at {s[pos:]!r}")
        kind = m.lastgroup
        out.append((kind, m.group(kind)))
        pos = m.end()
    return out


def parse_selector(s: Optional[str]) -> Selector:
    """Parse a set-based selector string (ref: selector.go:626 Parse)."""
    if s is None or s.strip() == "":
        return everything()
    toks = _tokenize(s)
    reqs: List[Requirement] = []
    i = 0
    need_sep = False  # a requirement just ended; only ',' (or end) may follow

    def peek(j=0):
        return toks[i + j] if i + j < len(toks) else (None, None)

    while i < len(toks):
        kind, val = toks[i]
        if kind == "comma":
            need_sep = False
            i += 1
            continue
        if need_sep:
            raise ValueError(f"expected ',' before {val!r} in selector {s!r}")
        if kind == "bang":
            nkind, nval = peek(1)
            if nkind != "ident":
                raise ValueError(f"expected identifier after '!' in {s!r}")
            reqs.append(Requirement(nval, DOES_NOT_EXIST))
            i += 2
            need_sep = True
            continue
        if kind != "ident":
            raise ValueError(f"unexpected token {val!r} in selector {s!r}")
        key = val
        nkind, nval = peek(1)
        if nkind in (None, "comma"):
            reqs.append(Requirement(key, EXISTS))
            i += 1
            need_sep = True
            continue
        if nkind == "op":
            vkind, vval = peek(2)
            if vkind == "ident":
                value = vval
                i += 3
            elif vkind in (None, "comma"):  # empty value, e.g. "k="
                value = ""
                i += 2
            else:
                raise ValueError(f"expected value after {nval!r} in {s!r}")
            op = NOT_EQUALS if nval == "!=" else EQUALS
            reqs.append(Requirement(key, op, [value]))
            need_sep = True
            continue
        if nkind == "ident" and nval in ("in", "notin"):
            op = IN if nval == "in" else NOT_IN
            if peek(2)[0] != "lparen":
                raise ValueError(f"expected '(' after {nval!r} in {s!r}")
            j = i + 3
            values = []
            expect_value = True
            while j < len(toks):
                tkind, tval = toks[j]
                if tkind == "rparen":
                    break
                if tkind == "comma":
                    if expect_value:
                        values.append("")
                    expect_value = True
                elif tkind == "ident":
                    values.append(tval)
                    expect_value = False
                else:
                    raise ValueError(f"unexpected {tval!r} inside () in {s!r}")
                j += 1
            else:
                raise ValueError(f"missing ')' in {s!r}")
            reqs.append(Requirement(key, op, values))
            i = j + 1
            need_sep = True
            continue
        raise ValueError(f"unexpected token {nval!r} after key {key!r} in {s!r}")
    return Selector(reqs)


def format_labels(labels: Dict[str, str]) -> str:
    """ref: labels.go Set.String — k1=v1,k2=v2 sorted."""
    return ",".join(f"{k}={v}" for k, v in sorted((labels or {}).items()))


def parse_labels(s: str) -> Dict[str, str]:
    """Parse "k1=v1,k2=v2" into a map (strict equality only)."""
    out: Dict[str, str] = {}
    if not s:
        return out
    for part in s.split(","):
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"invalid label spec {part!r}")
        k, v = part.split("=", 1)
        out[k] = v
    return out
