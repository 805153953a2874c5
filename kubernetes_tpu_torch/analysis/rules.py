"""The kube-vet rule set. Every rule encodes one invariant this repo
already paid for at runtime; docs/design/invariants.md carries the full
table (rule id, invariant, motivating incident, waiver policy).

Port of ``kubernetes_tpu/analysis/rules.py``: the rules scoped to the
package (``clone-mutation``, ``metrics-sync``) read the port's paths
(``kubernetes_tpu_torch/runtime/clone.py``, ``util/metrics.py``,
``addons/monitoring.py``).

Rules report against the statement span, so a waiver comment on any
line of the flagged statement (or the line above it) silences exactly
that finding — see engine.py for the waiver grammar.
"""

from __future__ import annotations

import ast
import io
import re
import sys
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from kubernetes_tpu_torch.analysis.engine import (FileContext, Rule, Violation,
                                            register)

__all__ = ["DonationSafetyRule", "CloneMutationRule", "ThreadDisciplineRule",
           "Py310CompatRule", "MetricsSyncRule", "UnusedNamesRule"]


def _parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def _enclosing_stmt(node: ast.AST, parents: Dict[ast.AST, ast.AST]):
    cur: Optional[ast.AST] = node
    while cur is not None and not isinstance(cur, ast.stmt):
        cur = parents.get(cur)
    return cur


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _import_map(tree: ast.AST) -> Dict[str, str]:
    """Local name -> fully dotted origin ('Popen' -> 'subprocess.Popen')."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                if a.name != "*":
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _resolve(node: ast.AST, imports: Dict[str, str]) -> Optional[str]:
    """Fully qualified dotted path of a Name/Attribute, through imports."""
    d = _dotted(node)
    if d is None:
        return None
    head, _, rest = d.partition(".")
    origin = imports.get(head, head)
    return f"{origin}.{rest}" if rest else origin


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


# ---------------------------------------------------------------------------
# donation-safety — the r11 heap-corruption class
# ---------------------------------------------------------------------------

_OWNED_PAT = re.compile(r"donat|owned", re.IGNORECASE)


def _is_empty_donation(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and node.value in (False, None):
        return True
    return isinstance(node, (ast.Tuple, ast.List)) and not node.elts


def _guarded_by_provenance(node: ast.AST) -> bool:
    """True for 'X if <owned-flag> else ()'-shaped donation values and
    for plain references to an ownership-named flag: the decision to
    donate must visibly flow from buffer provenance."""
    if isinstance(node, ast.IfExp):
        safe_else = _is_empty_donation(node.orelse)
        guard_named = any(_OWNED_PAT.search(n) for n in _names_in(node.test))
        return safe_else and guard_named
    d = _dotted(node)
    if d is not None and _OWNED_PAT.search(d):
        return True
    return False


@register
class DonationSafetyRule(Rule):
    """Any ``donate_argnums=``/``donate=`` site that can donate must be
    gated on an ownership flag (``xla_owned``-style provenance).

    Motivating incident: PR 7's ride-along fix — solver/mesh_exec.py
    donated device buffers that on the CPU backend ALIASED host numpy
    (zero-copy ``jax.device_put``); XLA freed memory numpy still owned
    and the daemon died mid-churn with ``malloc(): unsorted double
    linked list corrupted``. An unconditional donation is statically
    indistinguishable from that bug, so it must either be guarded by a
    provenance-named flag or carry a waiver explaining why the buffer
    can never alias host memory.
    """

    id = "donation-safety"
    doc = "donation must be gated on buffer-ownership provenance"

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        if ctx.tree is None:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            for kw in node.keywords:
                if kw.arg not in ("donate_argnums", "donate_argnames",
                                  "donate"):
                    continue
                if _is_empty_donation(kw.value) \
                        or _guarded_by_provenance(kw.value):
                    continue
                yield ctx.violation(
                    self.id, node,
                    f"{kw.arg}={ast.unparse(kw.value)}: donation is not "
                    f"provably gated on buffer ownership — a device_put "
                    f"of host numpy may alias it on the CPU backend "
                    f"(the r11 malloc-corruption class); gate on an "
                    f"xla_owned-style flag ('(0,) if xla_owned else ()') "
                    f"or waive with the provenance argument")


# ---------------------------------------------------------------------------
# clone-mutation — the read-only-store-objects invariant
# ---------------------------------------------------------------------------

_MUTATORS = frozenset({"append", "extend", "insert", "remove", "pop",
                       "popitem", "clear", "update", "setdefault", "add",
                       "discard", "sort", "reverse"})
_CTOR_METHODS = frozenset({"__init__", "__new__", "__setstate__",
                           "__deepcopy__", "__copy__", "__post_init__",
                           "__init_subclass__"})
_CLONE_FILE = "kubernetes_tpu_torch/runtime/clone.py"


@register
class CloneMutationRule(Rule):
    """No in-place mutation of objects on ``runtime/clone.py``
    shared-clone paths.

    ``deep_clone`` shares leaves of the ``_ATOMIC`` classes verbatim
    between original and clone, and the codebase-wide invariant says
    store/reflector objects are read-only (mutations go through
    ``deep_clone``; models/snapshot.py keys its ``_ktpu_rows`` cache on
    that promise). Three statically checkable facets:

    1. every repo-local class in ``_ATOMIC`` must be immutable — no
       method outside construction assigns ``self.<attr>``;
    2. after ``x = deep_clone(y)``, the SOURCE ``y`` must not be
       mutated in that function (you cloned because ``y`` is shared;
       mutate the clone);
    3. inside ``deep_clone`` itself, no wholesale ``__dict__`` copy —
       declared fields only, or derived caches ride onto mutable clones.
    """

    id = "clone-mutation"
    doc = "clone-shared objects are read-only; mutate the clone"

    def applies_to(self, rel: str) -> bool:
        return rel.startswith("kubernetes_tpu_torch/")

    def check_tree(self, ctxs: Sequence[FileContext]) -> Iterable[Violation]:
        by_rel = {c.rel: c for c in ctxs}
        clone_ctx = by_rel.get(_CLONE_FILE)
        if clone_ctx is not None and clone_ctx.tree is not None:
            yield from self._check_clone_module(clone_ctx)
            for cls_name in self._atomic_local_classes(clone_ctx):
                yield from self._check_immutable(cls_name, ctxs)
        for ctx in ctxs:
            yield from self._check_source_mutation(ctx)

    # facet 1 ---------------------------------------------------------------
    @staticmethod
    def _atomic_local_classes(clone_ctx: FileContext) -> List[str]:
        """Plain-Name entries of the _ATOMIC frozenset — repo-local
        classes shared verbatim between clone and original (builtins and
        stdlib attributes like datetime.datetime are Attribute/Call
        nodes or well-known immutables, skipped)."""
        out: List[str] = []
        skip = {"str", "int", "float", "bool", "bytes", "complex",
                "frozenset", "tuple", "type"}
        for node in ast.walk(clone_ctx.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == "_ATOMIC":
                for call in ast.walk(node.value):
                    if isinstance(call, (ast.Set, ast.Tuple, ast.List)):
                        for elt in call.elts:
                            if isinstance(elt, ast.Name) \
                                    and elt.id not in skip:
                                out.append(elt.id)
        return out

    def _check_immutable(self, cls_name: str,
                         ctxs: Sequence[FileContext]) -> Iterable[Violation]:
        for ctx in ctxs:
            if ctx.tree is None:
                continue
            for node in ast.walk(ctx.tree):
                if not (isinstance(node, ast.ClassDef)
                        and node.name == cls_name):
                    continue
                for meth in node.body:
                    if not isinstance(meth, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)) \
                            or meth.name in _CTOR_METHODS:
                        continue
                    for sub in ast.walk(meth):
                        tgt = None
                        if isinstance(sub, (ast.Assign, ast.AugAssign)):
                            tgts = sub.targets if isinstance(
                                sub, ast.Assign) else [sub.target]
                            for t in tgts:
                                if isinstance(t, (ast.Attribute,
                                                  ast.Subscript)) \
                                        and isinstance(
                                            getattr(t, "value", None),
                                            ast.Name) \
                                        and t.value.id == "self":
                                    tgt = t
                        if tgt is not None:
                            yield ctx.violation(
                                self.id, sub,
                                f"{cls_name}.{meth.name} mutates self — "
                                f"{cls_name} is in runtime/clone.py "
                                f"_ATOMIC (shared verbatim between clone "
                                f"and original) and must stay immutable "
                                f"outside construction")
                            break

    # facet 2 ---------------------------------------------------------------
    def _check_source_mutation(self, ctx: FileContext) -> Iterable[Violation]:
        if ctx.tree is None or "deep_clone" not in ctx.source:
            return
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            sources: List[Tuple[str, int]] = []   # (unparsed expr, line)
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) \
                        and isinstance(node.value, ast.Call):
                    f = node.value.func
                    fname = f.id if isinstance(f, ast.Name) else \
                        (f.attr if isinstance(f, ast.Attribute) else "")
                    if fname == "deep_clone" and node.value.args \
                            and _dotted(node.value.args[0]) is not None:
                        sources.append((ast.unparse(node.value.args[0]),
                                        node.lineno))
            if not sources:
                continue
            for node in ast.walk(fn):
                mutated = self._mutated_expr(node)
                if mutated is None:
                    continue
                for src, line in sources:
                    if node.lineno <= line:
                        continue
                    if mutated == src or mutated.startswith(src + ".") \
                            or mutated.startswith(src + "["):
                        yield ctx.violation(
                            self.id, node,
                            f"in-place mutation of {mutated!r} after "
                            f"deep_clone({src}) at line {line} — the "
                            f"source is the SHARED object (that's why it "
                            f"was cloned); mutate the clone instead")
                        break

    @staticmethod
    def _mutated_expr(node: ast.AST) -> Optional[str]:
        """Unparsed object expression a statement mutates in place."""
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            tgts = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in tgts:
                if isinstance(t, (ast.Attribute, ast.Subscript)):
                    return ast.unparse(t.value)
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS:
            return ast.unparse(node.func.value)
        return None

    # facet 3 ---------------------------------------------------------------
    def _check_clone_module(self, ctx: FileContext) -> Iterable[Violation]:
        for node in ast.walk(ctx.tree):
            bad = False
            if isinstance(node, ast.Call):
                # dict(obj.__dict__) — wholesale copy
                if isinstance(node.func, ast.Name) \
                        and node.func.id == "dict" and node.args \
                        and isinstance(node.args[0], ast.Attribute) \
                        and node.args[0].attr == "__dict__":
                    bad = True
                # new.__dict__.update(...)
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "update" \
                        and isinstance(node.func.value, ast.Attribute) \
                        and node.func.value.attr == "__dict__":
                    bad = True
            if bad:
                yield ctx.violation(
                    self.id, node,
                    "wholesale __dict__ copy in runtime/clone.py — "
                    "deep_clone must copy DECLARED dataclass fields only "
                    "(undeclared attrs are derived caches keyed to the "
                    "original's contents, e.g. PodSpec._ktpu_rows)")


# ---------------------------------------------------------------------------
# thread-discipline — threads stoppable, cross-thread queues bounded
# ---------------------------------------------------------------------------

_UNBOUNDED_QUEUES = {
    "queue.Queue": ("maxsize", 0),
    "queue.LifoQueue": ("maxsize", 0),
    "queue.PriorityQueue": ("maxsize", 0),
    "collections.deque": ("maxlen", 1),
}


@register
class ThreadDisciplineRule(Rule):
    """Every ``threading.Thread`` must be daemonized or joined in a
    reachable stop path; every queue/deque in a threaded module must be
    bounded.

    Motivating incidents: the PR 2 backoff-requeue leak (non-daemon
    requeue threads waiting out their backoff past test teardown,
    killing runs with ConnectionRefusedError tracebacks), and the first
    cut of the PR 4 watch fan-out, where per-watcher unbounded queues
    let one stuck watcher buffer unbounded history. A thread nobody can
    stop and a queue nobody bounded are the same bug at different
    speeds.
    """

    id = "thread-discipline"
    doc = "threads daemonized-or-joined; cross-thread queues bounded"

    def applies_to(self, rel: str) -> bool:
        return not rel.startswith("tests/")

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        if ctx.tree is None:
            return
        imports = _import_map(ctx.tree)
        parents = _parent_map(ctx.tree)
        threaded = any(v == "threading" or v.startswith("threading.")
                       or v == "queue" or v.startswith("queue.")
                       for v in imports.values())
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            target = _resolve(node.func, imports)
            if target == "threading.Thread":
                yield from self._check_thread(ctx, node, parents)
            elif target == "queue.SimpleQueue" and threaded:
                yield ctx.violation(
                    self.id, node,
                    "queue.SimpleQueue is unbounded by construction — "
                    "use queue.Queue(maxsize=N) so a stalled consumer "
                    "backpressures instead of buffering without limit")
            elif target in _UNBOUNDED_QUEUES and threaded:
                yield from self._check_queue(ctx, node, target)

    def _check_thread(self, ctx, node: ast.Call,
                      parents) -> Iterable[Violation]:
        for kw in node.keywords:
            if kw.arg == "daemon":
                if isinstance(kw.value, ast.Constant):
                    if kw.value.value is True:
                        return
                else:
                    return          # dynamic daemon flag: deliberate
        name = self._binding_name(node, parents)
        if name is not None and self._joined_or_daemonized(ctx, name):
            return
        hint = f" (bound to {name!r})" if name else ""
        yield ctx.violation(
            self.id, node,
            f"thread is neither daemon=True nor joined in a reachable "
            f"stop path{hint} — a non-daemon thread nobody joins "
            f"outlives its owner (the PR 2 backoff-requeue leak class)")

    @staticmethod
    def _binding_name(node: ast.Call, parents) -> Optional[str]:
        stmt = _enclosing_stmt(node, parents)
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            t = stmt.targets[0]
            if isinstance(t, ast.Name):
                return t.id
            if isinstance(t, ast.Attribute):
                return t.attr
        if isinstance(stmt, ast.AnnAssign):
            t = stmt.target
            if isinstance(t, ast.Name):
                return t.id
            if isinstance(t, ast.Attribute):
                return t.attr
        return None

    @staticmethod
    def _joined_or_daemonized(ctx: FileContext, name: str) -> bool:
        # `<name>.join(` anywhere in the module counts as a reachable
        # stop path; so does a post-construction `<name>.daemon = True`
        esc = re.escape(name)
        if re.search(rf"\b{esc}\s*\.\s*join\s*\(", ctx.source):
            return True
        if re.search(rf"\b{esc}\s*\.\s*daemon\s*=\s*True", ctx.source):
            return True
        # collection binding: `for t in <name>: t.join()` joins them all
        for m in re.finditer(rf"\bfor\s+(\w+)\s+in\s+{esc}\b", ctx.source):
            if re.search(rf"\b{re.escape(m.group(1))}\s*\.\s*join\s*\(",
                         ctx.source):
                return True
        return False

    def _check_queue(self, ctx, node: ast.Call,
                     target: str) -> Iterable[Violation]:
        kw_name, pos = _UNBOUNDED_QUEUES[target]
        bound = None
        if len(node.args) > pos:
            bound = node.args[pos]
        for kw in node.keywords:
            if kw.arg == kw_name:
                bound = kw.value
        unbounded = bound is None or (
            isinstance(bound, ast.Constant) and bound.value in (None, 0))
        if unbounded:
            yield ctx.violation(
                self.id, node,
                f"{target.rsplit('.', 1)[-1]} without {kw_name}= in a "
                f"threaded module — an unbounded cross-thread queue "
                f"turns a stalled consumer into unbounded memory growth "
                f"(PR 4 sized every watcher queue for exactly this); "
                f"bound it or waive with the reason the producer is "
                f"bounded elsewhere")


# ---------------------------------------------------------------------------
# py310-compat — the PR 1 muted-test-modules class
# ---------------------------------------------------------------------------

# APIs that import/attribute-resolve fine on 3.11+ but crash (or do not
# exist) on the 3.10 interpreter this repo pins. Names are fully dotted
# post-import-resolution.
_PY311_APIS: Dict[str, str] = {
    "datetime.UTC": "3.11 (use datetime.timezone.utc)",
    "enum.StrEnum": "3.11 (use str + Enum mixin)",
    "enum.ReprEnum": "3.11",
    "asyncio.TaskGroup": "3.11",
    "asyncio.Runner": "3.11",
    "asyncio.timeout": "3.11 (use asyncio.wait_for)",
    "asyncio.timeout_at": "3.11",
    "asyncio.Barrier": "3.11",
    "contextlib.chdir": "3.11",
    "typing.Self": "3.11",
    "typing.LiteralString": "3.11",
    "typing.Never": "3.11",
    "typing.assert_never": "3.11",
    "typing.assert_type": "3.11",
    "typing.dataclass_transform": "3.11",
    "typing.Required": "3.11",
    "typing.NotRequired": "3.11",
    "math.cbrt": "3.11",
    "math.exp2": "3.11",
    "operator.call": "3.11",
    "hashlib.file_digest": "3.11",
    "inspect.getmembers_static": "3.11",
    "sys.exception": "3.11",
    "itertools.batched": "3.12",
}
_PY311_MODULES: Dict[str, str] = {"tomllib": "3.11"}
_PY311_BUILTINS: Dict[str, str] = {"ExceptionGroup": "3.11",
                                   "BaseExceptionGroup": "3.11"}
# keyword-only: valid call shape on 3.11+, TypeError on 3.10 — the
# kubelet process-runtime hit exactly this with Popen(process_group=)
_PY311_KWARGS: Dict[str, Tuple[str, ...]] = {
    "process_group": ("subprocess.Popen", "subprocess.run",
                      "subprocess.call", "subprocess.check_call",
                      "subprocess.check_output"),
}


def _quote_of(token: str) -> str:
    """The opening quote of a string or f-string-start token: one quote
    character, or three for a triple-quoted string."""
    body = token.lstrip("rRbBuUfF")
    q = body[:1]
    return q * 3 if body.startswith(q * 3) else q


def _pep701_quote(source: str) -> Optional[Tuple[int, int]]:
    """Where a string or f-string inside an f-string's replacement field
    opens with a quote that would close an enclosing f-string on python
    3.10, as ``(line, col)``; None if there is none. Python >= 3.12
    tokenizes f-strings (PEP 701), and ``ast.parse(feature_version=
    (3, 10))`` accepts the nested form there, so the tokens are the
    check. Before 3.12 the parse already refuses it."""
    if sys.version_info < (3, 12):
        return None
    enclosing: List[str] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.FSTRING_END:
                if enclosing:
                    enclosing.pop()
                continue
            if tok.type not in (tokenize.FSTRING_START, tokenize.STRING):
                continue
            quote = _quote_of(tok.string)
            if any(quote.startswith(outer) for outer in enclosing):
                return tok.start
            if tok.type == tokenize.FSTRING_START:
                enclosing.append(quote)
    except (tokenize.TokenError, SyntaxError):
        return None
    return None


@register
class Py310CompatRule(Rule):
    """The whole tree must parse and run on Python 3.10.

    Motivating incident: PR 1 found (and fixed) an f-string nested-quote
    SyntaxError in util/metrics.py that silently killed COLLECTION of 13
    test modules on py3.10 — the suite went green by not running. A
    second instance of the class: ``Popen(process_group=...)`` is a
    py3.11 keyword that fails only when the spawn path executes.
    ``ast.parse(feature_version=(3, 10))`` catches the syntax half at
    vet time; a denylist of py3.11+-only stdlib APIs catches the
    runtime half.
    """

    id = "py310-compat"
    doc = "tree parses and runs on python 3.10"

    def applies_to(self, rel: str) -> bool:   # tests too: muted test
        return True                           # modules WERE the incident

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        try:
            ast.parse(ctx.source, filename=ctx.rel,
                      feature_version=(3, 10))
        except SyntaxError as e:
            v = Violation(rule=self.id, path=ctx.rel, line=e.lineno or 1,
                          col=(e.offset or 1) - 1,
                          message=f"does not parse as python 3.10: "
                                  f"{e.msg} (the PR 1 class: one "
                                  f"SyntaxError silently mutes every "
                                  f"importer)",
                          span=(e.lineno or 1, e.lineno or 1))
            yield v
            return
        nested = _pep701_quote(ctx.source)
        if nested is not None:
            line, col = nested
            yield Violation(rule=self.id, path=ctx.rel, line=line, col=col,
                            message="does not parse as python 3.10: a "
                                    "string inside an f-string reuses its "
                                    "quote (PEP 701, python >= 3.12; the "
                                    "PR 1 class: one SyntaxError silently "
                                    "mutes every importer)",
                            span=(line, line))
            return
        if ctx.tree is None:
            return
        imports = _import_map(ctx.tree)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mod = a.name.split(".")[0]
                    if mod in _PY311_MODULES:
                        yield ctx.violation(
                            self.id, node,
                            f"import {a.name}: module requires python "
                            f">= {_PY311_MODULES[mod]}")
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    dotted = f"{node.module}.{a.name}"
                    if dotted in _PY311_APIS:
                        yield ctx.violation(
                            self.id, node,
                            f"from {node.module} import {a.name}: "
                            f"requires python >= {_PY311_APIS[dotted]}")
            elif isinstance(node, ast.Attribute):
                full = _resolve(node, imports)
                ver = _PY311_APIS.get(full or "")
                # flag only when the chain head is a real module (it was
                # imported here, or is a known stdlib module name) — a
                # local variable named `math` must not trip the rule
                head = (full or "").split(".")[0]
                if ver and (head in imports or head in _STDLIB_HEADS):
                    yield ctx.violation(
                        self.id, node,
                        f"{full}: requires python >= {ver}")
            elif isinstance(node, ast.Name) and isinstance(node.ctx,
                                                           ast.Load):
                if node.id in _PY311_BUILTINS and node.id not in imports:
                    yield ctx.violation(
                        self.id, node,
                        f"{node.id}: builtin requires python >= "
                        f"{_PY311_BUILTINS[node.id]}")
                else:
                    full = imports.get(node.id)
                    ver = _PY311_APIS.get(full or "")
                    if ver:
                        yield ctx.violation(
                            self.id, node,
                            f"{full}: requires python >= {ver}")
            elif isinstance(node, ast.Call):
                callee = _resolve(node.func, imports) or ""
                for kw in node.keywords:
                    funcs = _PY311_KWARGS.get(kw.arg or "")
                    if funcs and callee in funcs:
                        yield ctx.violation(
                            self.id, node,
                            f"{callee}({kw.arg}=...): keyword requires "
                            f"python >= 3.11 (use a preexec_fn shim — "
                            f"kubelet/process_runtime._spawn is the "
                            f"in-tree pattern)")


# `math.cbrt` in a file that (unusually) lacks the `import math` line —
# e.g. the module object was passed in — still deserves a flag when the
# chain head is a known stdlib module name.
_STDLIB_HEADS = {d.split(".")[0] for d in _PY311_APIS}


# ---------------------------------------------------------------------------
# metrics-sync — gates must never point at renamed series
# ---------------------------------------------------------------------------

# file -> restrict-to-function (None = whole file). monitoring.py also
# scrapes kubelet cAdvisor-style stats dicts whose keys look like
# series; only its SLO rule set binds to flightrec series names.
_METRIC_REF_FILES: Dict[str, Optional[str]] = {
    "hack/churn_mp.py": None,
    "hack/perfgate.py": None,
    "kubernetes_tpu_torch/addons/monitoring.py": "default_churn_rules",
}
_METRIC_SUFFIXES = ("_total", "_seconds", "_bytes", "_depth", "_entries")
_METRIC_BUILTIN_REFS = {"process_resident_bytes",
                        "process_cpu_seconds_total",
                        "tracing_spans_dropped"}
_METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")


@register
class MetricsSyncRule(Rule):
    """Every metric series name the gates reference — the churn
    harness's record scrape (hack/churn_mp.py), the SLO rule set
    (addons/monitoring.py default_churn_rules), the perfgate bands —
    must exist in the util/metrics registry universe.

    Motivating invariant: an instrumentation rename must never silently
    turn a gate into "no data". The SLO watchdog treats a missing
    series as neither-fire-nor-resolve and the scrape defaults absent
    counters to 0 — both by design tolerant at runtime, which is
    exactly why the name binding must be checked statically.
    """

    id = "metrics-sync"
    doc = "scraped/SLO/gated series names exist in the metric registry"

    def applies_to(self, rel: str) -> bool:
        return rel.startswith("kubernetes_tpu_torch/") or rel.startswith("hack/")

    def check_tree(self, ctxs: Sequence[FileContext]) -> Iterable[Violation]:
        universe = self._registry_universe(ctxs)
        if not universe:
            return
        for ctx in ctxs:
            if ctx.rel not in _METRIC_REF_FILES or ctx.tree is None:
                continue
            scope: ast.AST = ctx.tree
            fn_name = _METRIC_REF_FILES[ctx.rel]
            if fn_name is not None:
                scope = next(
                    (n for n in ast.walk(ctx.tree)
                     if isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                     and n.name == fn_name), ast.Module(body=[],
                                                        type_ignores=[]))
            for node in ast.walk(scope):
                if not (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)):
                    continue
                name = node.value.strip().rstrip("{")
                if not self._looks_like_series(name):
                    continue
                if name in universe:
                    continue
                yield ctx.violation(
                    self.id, node,
                    f"series {name!r} is scraped/gated here but not "
                    f"registered anywhere in the metric registry — a "
                    f"rename on the instrumentation side would turn "
                    f"this gate into 'no data' silently")

    @staticmethod
    def _looks_like_series(name: str) -> bool:
        if name in _METRIC_BUILTIN_REFS:
            return True
        if not _METRIC_NAME_RE.match(name):
            return False
        # series names are multi-segment AND carry a unit/kind suffix;
        # record keys ('transfer_bytes', 'solve_p50_ms') miss one or both
        return name.count("_") >= 2 and name.endswith(_METRIC_SUFFIXES)

    @staticmethod
    def _registry_universe(ctxs: Sequence[FileContext]) -> Set[str]:
        """Names registered via Registry.counter/gauge/histogram (or the
        metric classes directly) anywhere in the tree, plus histogram
        derived series, counter :rate series, and the flight recorder's
        per-process built-ins."""
        out: Set[str] = set()
        for ctx in ctxs:
            if ctx.tree is None \
                    or not ctx.rel.startswith("kubernetes_tpu_torch/"):
                continue
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                first = node.args[0]
                if not (isinstance(first, ast.Constant)
                        and isinstance(first.value, str)):
                    continue
                kind = None
                if isinstance(node.func, ast.Attribute):
                    if node.func.attr in ("counter", "gauge", "histogram"):
                        kind = node.func.attr
                elif isinstance(node.func, ast.Name):
                    if node.func.id in ("Counter", "Gauge", "Histogram"):
                        kind = node.func.id.lower()
                if kind is None:
                    continue
                name = first.value
                out.add(name)
                if kind == "counter":
                    out.add(name + ":rate")
                if kind == "histogram":
                    out.update((name + "_bucket", name + "_sum",
                                name + "_count", name + "_sum:rate",
                                name + "_count:rate"))
            # flight-recorder built-ins: the (name, type, value) tuples
            # _process_samples appends are registrations in spirit
            if ctx.rel == "kubernetes_tpu_torch/util/metrics.py":
                for node in ast.walk(ctx.tree):
                    if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)) \
                            and node.name == "_process_samples":
                        for tup in ast.walk(node):
                            if isinstance(tup, ast.Tuple) \
                                    and len(tup.elts) >= 2 \
                                    and isinstance(tup.elts[0],
                                                   ast.Constant) \
                                    and isinstance(tup.elts[0].value, str):
                                bname = tup.elts[0].value
                                out.add(bname)
                                if isinstance(tup.elts[1], ast.Constant) \
                                        and tup.elts[1].value == "counter":
                                    out.add(bname + ":rate")
        return out


# ---------------------------------------------------------------------------
# unused — pyflakes-equivalent hygiene, tree kept at zero
# ---------------------------------------------------------------------------

@register
class UnusedNamesRule(Rule):
    """Unused imports and unreferenced private module-level names.

    Dead imports are where stale dependencies and copy-paste rot hide;
    the PR 1 incident proved this tree cannot afford import-time
    surprises. Public module-level names are API surface (left alone);
    private (``_``-prefixed) ones with no reference in their own file,
    no cross-module import, and no attribute access anywhere are dead
    code. ``__init__.py`` imports are re-exports and exempt.
    """

    id = "unused"
    doc = "no unused imports or dead private module-level names"

    def applies_to(self, rel: str) -> bool:
        return True

    def check_tree(self, ctxs: Sequence[FileContext]) -> Iterable[Violation]:
        # names referenced cross-module anywhere in the tree: imported
        # by name, or accessed as an attribute (module._private)
        externally_used: Set[str] = set()
        # (module dotted path, name) imported elsewhere: an import that
        # other modules re-import FROM here is a deliberate re-export
        imported_from: Set[Tuple[str, str]] = set()
        for ctx in ctxs:
            if ctx.tree is None:
                continue
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.ImportFrom):
                    externally_used.update(
                        a.asname or a.name for a in node.names)
                    if node.module and node.level == 0:
                        imported_from.update(
                            (node.module, a.name) for a in node.names)
                elif isinstance(node, ast.Attribute):
                    externally_used.add(node.attr)
        for ctx in ctxs:
            yield from self._check_file(ctx, externally_used,
                                        imported_from)

    @staticmethod
    def _module_of(rel: str) -> str:
        mod = rel[:-3] if rel.endswith(".py") else rel
        if mod.endswith("/__init__"):
            mod = mod[:-len("/__init__")]
        return mod.replace("/", ".")

    def _check_file(self, ctx: FileContext, externally_used: Set[str],
                    imported_from: Set[Tuple[str, str]]) -> Iterable[Violation]:
        if ctx.tree is None:
            return
        loads: Dict[str, int] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                loads[node.id] = loads.get(node.id, 0) + 1
        strings = [node.value for node in ast.walk(ctx.tree)
                   if isinstance(node, ast.Constant)
                   and isinstance(node.value, str)]

        def referenced(name: str) -> bool:
            if loads.get(name):
                return True
            # string annotations, __all__, doctests
            pat = re.compile(rf"\b{re.escape(name)}\b")
            return any(pat.search(s) for s in strings)

        if not ctx.rel.endswith("__init__.py"):
            yield from self._unused_imports(ctx, referenced, imported_from)
        yield from self._dead_privates(ctx, referenced, loads,
                                       externally_used)

    def _unused_imports(self, ctx, referenced,
                        imported_from) -> Iterable[Violation]:
        this_mod = self._module_of(ctx.rel)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    name = a.asname or a.name.split(".")[0]
                    if not referenced(name) \
                            and (this_mod, name) not in imported_from:
                        yield ctx.violation(
                            self.id, node,
                            f"import {a.name!r} is never used (waive "
                            f"with the side effect it exists for, if "
                            f"any)")
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for a in node.names:
                    if a.name == "*":
                        continue
                    name = a.asname or a.name
                    if not referenced(name) \
                            and (this_mod, name) not in imported_from:
                        yield ctx.violation(
                            self.id, node,
                            f"'from {node.module or '.'} import "
                            f"{a.name}' is never used")

    def _dead_privates(self, ctx, referenced, loads,
                       externally_used) -> Iterable[Violation]:
        if ctx.rel.startswith("tests/"):
            return       # pytest discovers helpers reflectively
        body = getattr(ctx.tree, "body", [])
        for node in body:
            name = None
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                name = node.name
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
            if name is None or not name.startswith("_") \
                    or name.startswith("__"):
                continue
            if referenced(name) or name in externally_used:
                continue
            yield ctx.violation(
                self.id, node,
                f"private module-level name {name!r} is never "
                f"referenced (in this file or by any importer) — dead "
                f"code")
