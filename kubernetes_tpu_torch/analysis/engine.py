"""kube-vet engine: file loading, rule registry, waiver resolution.

Port of ``kubernetes_tpu/analysis/engine.py``; the default tree is the
port's (``kubernetes_tpu_torch/`` and ``chip_smoke.py``).

A rule reports :class:`Violation`\\ s anchored to AST nodes. A violation
is silenced only by an explicit, reason-carrying waiver comment on the
flagged statement (or the line directly above it)::

    self._q = deque()  # ktpu-vet: ok thread-discipline — bounded by BUSY check

Waiver grammar: ``# ktpu-vet: ok <rule>[,<rule>...] — <reason>`` (the
separator may be an em-dash, ``--``, or a spaced ``-``). The reason is
REQUIRED: a bare waiver is itself a violation, and so is a waiver
naming a rule that does not exist — silencing must stay reviewable.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Violation", "Waiver", "FileContext", "Rule", "register",
           "all_rules", "default_paths", "load_context", "run_vet",
           "format_violation"]

_WAIVER_RE = re.compile(
    r"#\s*ktpu-vet:\s*ok\s+(?P<rules>[a-z0-9_.,\- ]*?)"
    r"(?:\s+(?:—|--|-)\s+(?P<reason>.*))?$")


@dataclass
class Violation:
    rule: str
    path: str                  # repo-relative
    line: int
    col: int
    message: str
    span: Tuple[int, int] = (0, 0)   # (first, last) line of the statement
    waived: bool = False
    waiver_reason: str = ""

    def key(self) -> Tuple[str, str, int, str]:
        return (self.rule, self.path, self.line, self.message)


@dataclass
class Waiver:
    rules: Tuple[str, ...]
    reason: str
    line: int
    used: bool = False


@dataclass
class FileContext:
    """One parsed source file plus its waivers, shared by every rule."""

    path: str                  # absolute
    rel: str                   # repo-relative (the reporting name)
    source: str
    lines: List[str]
    tree: Optional[ast.AST]
    syntax_error: Optional[SyntaxError] = None
    waivers: List[Waiver] = field(default_factory=list)
    waiver_errors: List[Violation] = field(default_factory=list)

    def violation(self, rule: str, node, message: str) -> Violation:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        end = getattr(node, "end_lineno", None) or line
        return Violation(rule=rule, path=self.rel, line=line, col=col,
                         message=message, span=(line, end))


class Rule:
    """One named invariant. Subclasses set ``id``/``doc`` and implement
    either per-file ``check`` or whole-tree ``check_tree``."""

    id: str = ""
    doc: str = ""

    def applies_to(self, rel: str) -> bool:
        return not rel.startswith("tests/")

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        return ()

    def check_tree(self, ctxs: Sequence[FileContext]) -> Iterable[Violation]:
        for ctx in ctxs:
            if self.applies_to(ctx.rel):
                yield from self.check(ctx)


_RULES: Dict[str, Rule] = {}


def register(cls):
    """Class decorator adding a rule to the registry (id must be unique)."""
    inst = cls()
    if not inst.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if inst.id in _RULES:
        raise ValueError(f"duplicate rule id {inst.id!r}")
    _RULES[inst.id] = inst
    return cls


def all_rules() -> Dict[str, Rule]:
    return dict(_RULES)


def _comment_tokens(source: str):
    """(line, comment text) for every real COMMENT token — docstrings
    and string literals that merely mention the waiver syntax (this
    engine's own documentation, for one) must not parse as waivers."""
    import io
    import tokenize
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return


def _parse_waivers(ctx: FileContext) -> None:
    for i, line in _comment_tokens(ctx.source):
        if "ktpu-vet" not in line:
            continue
        m = _WAIVER_RE.search(line)
        if m is None:
            ctx.waiver_errors.append(Violation(
                rule="waiver", path=ctx.rel, line=i, col=0,
                message="malformed ktpu-vet comment (expected "
                        "'# ktpu-vet: ok <rule> — <reason>')",
                span=(i, i)))
            continue
        rules = tuple(r for r in re.split(r"[\s,]+", m.group("rules"))
                      if r)
        reason = (m.group("reason") or "").strip()
        if not rules or not reason:
            ctx.waiver_errors.append(Violation(
                rule="waiver", path=ctx.rel, line=i, col=0,
                message="waiver must name a rule AND carry a reason: "
                        "'# ktpu-vet: ok <rule> — <reason>'",
                span=(i, i)))
            continue
        unknown = [r for r in rules if r not in _RULES]
        if unknown:
            ctx.waiver_errors.append(Violation(
                rule="waiver", path=ctx.rel, line=i, col=0,
                message=f"waiver names unknown rule(s) "
                        f"{', '.join(sorted(unknown))} (known: "
                        f"{', '.join(sorted(_RULES))})",
                span=(i, i)))
            continue
        ctx.waivers.append(Waiver(rules=rules, reason=reason, line=i))


def load_context(path: str, root: str) -> FileContext:
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    tree = None
    err: Optional[SyntaxError] = None
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        err = e
    ctx = FileContext(path=path, rel=rel, source=source,
                      lines=source.splitlines(), tree=tree,
                      syntax_error=err)
    _parse_waivers(ctx)
    return ctx


_SKIP_DIRS = {"__pycache__", ".git", ".ktpu_cache", "www", "node_modules"}
_DEFAULT_TOPS = ("kubernetes_tpu_torch",)
_DEFAULT_FILES = ("chip_smoke.py",)


def default_paths(root: str) -> List[str]:
    """Every Python file the vet pass owns (the committed tree minus
    generated/vendored assets)."""
    out: List[str] = []
    for top in _DEFAULT_TOPS:
        base = os.path.join(root, top)
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    for fn in _DEFAULT_FILES:
        p = os.path.join(root, fn)
        if os.path.isfile(p):
            out.append(p)
    return out


def _covers(ctx: FileContext, w: Waiver, first: int, last: int) -> bool:
    """A waiver covers a statement when it sits on one of its lines, or
    in the contiguous comment block directly above it (a multi-line
    reason reads naturally; a blank line breaks the attachment)."""
    if first <= w.line <= last:
        return True
    if w.line < first:
        between = ctx.lines[w.line:first - 1]
        return all(s.strip().startswith("#") for s in between)
    return False


def _apply_waivers(ctx: FileContext,
                   violations: List[Violation]) -> List[Violation]:
    for v in violations:
        first, last = v.span if v.span != (0, 0) else (v.line, v.line)
        for w in ctx.waivers:
            if v.rule in w.rules and _covers(ctx, w, first, last):
                v.waived = True
                v.waiver_reason = w.reason
                w.used = True
                break
    return violations


def run_vet(paths: Optional[Sequence[str]] = None,
            rule_ids: Optional[Sequence[str]] = None,
            root: Optional[str] = None,
            ) -> Tuple[List[Violation], List[Violation]]:
    """Run the rule set -> (active violations, waived violations).

    ``paths`` defaults to the whole tree under ``root`` (defaults to the
    repo root containing this package).
    """
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    if paths is None:
        paths = default_paths(root)
    # "waiver" is the engine's own hygiene pseudo-rule, not in _RULES
    rules = [_RULES[r] for r in rule_ids if r in _RULES] if rule_ids \
        else list(_RULES.values())
    ctxs = [load_context(p, root) for p in paths]

    active: List[Violation] = []
    waived: List[Violation] = []
    per_file: Dict[str, List[Violation]] = {c.rel: [] for c in ctxs}
    for rule in rules:
        scoped = [c for c in ctxs if rule.applies_to(c.rel)]
        for v in rule.check_tree(scoped):
            per_file.setdefault(v.path, []).append(v)
    by_rel = {c.rel: c for c in ctxs}
    for rel, vs in per_file.items():
        ctx = by_rel.get(rel)
        if ctx is not None:
            _apply_waivers(ctx, vs)
        for v in vs:
            (waived if v.waived else active).append(v)
    # waiver hygiene is unconditional (a broken waiver can't waive itself)
    if rule_ids is None or "waiver" in rule_ids:
        for ctx in ctxs:
            active.extend(ctx.waiver_errors)
    if rule_ids is None:
        # stale-waiver check only when EVERY rule ran: under a rule
        # subset, a waiver for an unselected rule is legitimately idle
        for ctx in ctxs:
            for w in ctx.waivers:
                if not w.used:
                    active.append(Violation(
                        rule="waiver", path=ctx.rel, line=w.line, col=0,
                        message=f"waiver for {', '.join(w.rules)} "
                                f"matches no violation — the finding "
                                f"was fixed or moved; remove the stale "
                                f"waiver", span=(w.line, w.line)))
    active.sort(key=lambda v: (v.path, v.line, v.rule))
    waived.sort(key=lambda v: (v.path, v.line, v.rule))
    return active, waived


def format_violation(v: Violation) -> str:
    tag = f" (waived: {v.waiver_reason})" if v.waived else ""
    return f"{v.path}:{v.line}:{v.col}: [{v.rule}] {v.message}{tag}"
