"""Output printers (ref: pkg/kubectl/resource_printer.go).

Port of ``kubernetes_tpu/kubectl/printers.py``.

- ``HumanReadablePrinter`` — per-kind column tables (columns mirror
  resource_printer.go:231-240)
- ``JSONPrinter`` / ``YAMLPrinter`` — codec round-trip to wire form
- ``TemplatePrinter`` — Python format-string over the wire dict (the
  reference uses Go templates; str.format over the same wire data is the
  idiomatic equivalent)
- ``JSONPathPrinter`` — minimal jsonpath: dotted paths, [idx], .items[*]
  (ref: resource_printer.go jsonpath support)
"""

from __future__ import annotations

import datetime
import json
import re
from typing import Any, Dict, List

import yaml

from kubernetes_tpu_torch.api import types as api

__all__ = ["HumanReadablePrinter", "JSONPrinter", "YAMLPrinter",
           "TemplatePrinter", "JSONPathPrinter", "printer_for"]


def _join_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return "<none>"
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


def _age(meta: api.ObjectMeta) -> str:
    ts = meta.creation_timestamp
    if not ts:
        return "<unknown>"
    now = datetime.datetime.now(datetime.timezone.utc)
    if ts.tzinfo is None:
        ts = ts.replace(tzinfo=datetime.timezone.utc)
    delta = now - ts
    secs = int(delta.total_seconds())
    if secs < 120:
        return f"{secs}s"
    if secs < 2 * 3600:
        return f"{secs // 60}m"
    if secs < 2 * 86400:
        return f"{secs // 3600}h"
    return f"{secs // 86400}d"


# -- per-kind column definitions (ref: resource_printer.go:231-240) --------

def _pod_rows(pod: api.Pod):
    containers = pod.spec.containers
    first = containers[0] if containers else None
    rows = [[pod.metadata.name, pod.status.pod_ip or "",
             first.name if first else "", first.image if first else "",
             pod.spec.host or pod.status.host or "",
             _join_labels(pod.metadata.labels),
             pod.status.phase or "Pending", _age(pod.metadata)]]
    for c in containers[1:]:
        rows.append(["", "", c.name, c.image, "", "", "", ""])
    return rows


def _rc_rows(rc: api.ReplicationController):
    tmpl = rc.spec.template
    containers = tmpl.spec.containers if tmpl else []
    first = containers[0] if containers else None
    rows = [[rc.metadata.name,
             first.name if first else "", first.image if first else "",
             _join_labels(rc.spec.selector), str(rc.spec.replicas)]]
    for c in containers[1:]:
        rows.append(["", c.name, c.image, "", ""])
    return rows


def _svc_rows(svc: api.Service):
    return [[svc.metadata.name, _join_labels(svc.metadata.labels),
             _join_labels(svc.spec.selector), svc.spec.portal_ip or "",
             str(svc.spec.port)]]


def _endpoints_rows(ep: api.Endpoints):
    eps = ",".join(f"{e.ip}:{e.port}" for e in ep.endpoints) or "<none>"
    return [[ep.metadata.name, eps]]


def _node_status(node: api.Node) -> str:
    conds = [c for c in node.status.conditions if c.status == api.ConditionTrue]
    names = [c.type for c in conds]
    status = ",".join(names) if names else "Unknown"
    if node.spec.unschedulable:
        # cordoned (ref: printers.go appends SchedulingDisabled)
        status += ",SchedulingDisabled"
    return status


def _node_rows(node: api.Node):
    return [[node.metadata.name, _join_labels(node.metadata.labels),
             _node_status(node)]]


def _event_rows(ev: api.Event):
    fmt = "%Y-%m-%d %H:%M:%S"
    first = ev.first_timestamp.strftime(fmt) if ev.first_timestamp else ""
    last = ev.last_timestamp.strftime(fmt) if ev.last_timestamp else ""
    ref = ev.involved_object
    src = ev.source.component + (f" {ev.source.host}" if ev.source.host else "")
    return [[first, last, str(ev.count or 1), ref.name, ref.kind,
             ref.field_path, ev.reason, src, ev.message]]


def _ns_rows(ns: api.Namespace):
    return [[ns.metadata.name, _join_labels(ns.metadata.labels),
             ns.status.phase or "Active"]]


def _secret_rows(s: api.Secret):
    return [[s.metadata.name, s.type, str(len(s.data))]]


def _limitrange_rows(lr: api.LimitRange):
    return [[lr.metadata.name]]


def _quota_rows(q: api.ResourceQuota):
    return [[q.metadata.name]]


def _status_rows(st: api.Status):
    return [[st.status]]


def _priorityclass_rows(pc: api.PriorityClass):
    return [[pc.metadata.name, str(pc.value),
             "true" if pc.global_default else "false",
             pc.preemption_policy or api.PreemptLowerPriority,
             _age(pc.metadata)]]


_HANDLERS: Dict[str, tuple] = {
    # kind -> (columns, row fn)   columns ref: resource_printer.go:231-240
    "Pod": (["POD", "IP", "CONTAINER(S)", "IMAGE(S)", "HOST", "LABELS",
             "STATUS", "CREATED"], _pod_rows),
    "ReplicationController": (["CONTROLLER", "CONTAINER(S)", "IMAGE(S)",
                               "SELECTOR", "REPLICAS"], _rc_rows),
    "Service": (["NAME", "LABELS", "SELECTOR", "IP", "PORT"], _svc_rows),
    "Endpoints": (["NAME", "ENDPOINTS"], _endpoints_rows),
    "Node": (["NAME", "LABELS", "STATUS"], _node_rows),
    "Event": (["FIRSTSEEN", "LASTSEEN", "COUNT", "NAME", "KIND", "SUBOBJECT",
               "REASON", "SOURCE", "MESSAGE"], _event_rows),
    "Namespace": (["NAME", "LABELS", "STATUS"], _ns_rows),
    "Secret": (["NAME", "TYPE", "DATA"], _secret_rows),
    "LimitRange": (["NAME"], _limitrange_rows),
    "ResourceQuota": (["NAME"], _quota_rows),
    "PriorityClass": (["NAME", "VALUE", "GLOBAL-DEFAULT",
                       "PREEMPTIONPOLICY", "AGE"], _priorityclass_rows),
    "Status": (["STATUS"], _status_rows),
}


class HumanReadablePrinter:
    """Tab-aligned tables, one handler per kind
    (ref: resource_printer.go HumanReadablePrinter)."""

    def __init__(self, no_headers: bool = False):
        self.no_headers = no_headers

    def print_obj(self, obj: Any, out) -> None:
        kind = getattr(obj, "kind", type(obj).__name__) or type(obj).__name__
        if kind.endswith("List") and hasattr(obj, "items"):
            item_kind = kind[:-4]
            self._print_table(item_kind, list(obj.items), out)
            return
        self._print_table(kind, [obj], out)

    def _print_table(self, kind: str, items: List[Any], out) -> None:
        spec = _HANDLERS.get(kind)
        if spec is None:
            raise ValueError(f"no printer handler for kind {kind!r}")
        columns, row_fn = spec
        rows: List[List[str]] = []
        for item in items:
            rows.extend(row_fn(item))
        widths = [len(c) for c in columns]
        for row in rows:
            for i, cell in enumerate(row):
                widths[i] = max(widths[i], len(str(cell)))
        def emit(cells):
            out.write("   ".join(str(c).ljust(widths[i])
                                 for i, c in enumerate(cells)).rstrip() + "\n")
        if not self.no_headers:
            emit(columns)
        for row in rows:
            emit(row)


class JSONPrinter:
    def __init__(self, scheme, version: str = ""):
        self.scheme = scheme
        self.version = version or None

    def print_obj(self, obj: Any, out) -> None:
        wire = self.scheme.encode_to_wire(obj, self.version)
        json.dump(wire, out, indent=4, sort_keys=True)
        out.write("\n")


class YAMLPrinter(JSONPrinter):
    def print_obj(self, obj: Any, out) -> None:
        wire = self.scheme.encode_to_wire(obj, self.version)
        yaml.safe_dump(wire, out, default_flow_style=False, sort_keys=True)


class TemplatePrinter:
    """Python .format template over the wire dict. ``{.x.y}``-style access is
    spelled ``{x[y]}``; bare ``{field}`` works for top-level fields."""

    def __init__(self, scheme, template: str, version: str = ""):
        self.scheme = scheme
        self.template = template
        self.version = version or None

    def print_obj(self, obj: Any, out) -> None:
        wire = self.scheme.encode_to_wire(obj, self.version)
        out.write(self.template.format(**wire))
        if not self.template.endswith("\n"):
            out.write("\n")


_JSONPATH_TOKEN = re.compile(r"\.([A-Za-z_][A-Za-z0-9_\-]*)|\[(\*|\d+|'[^']*')\]")


class JSONPathPrinter:
    """Minimal jsonpath: ``{.a.b[0].c}``, ``[*]`` fan-out, quoted keys."""

    def __init__(self, scheme, path: str, version: str = ""):
        self.scheme = scheme
        self.version = version or None
        self.exprs = re.findall(r"\{([^}]*)\}", path)
        self.literal_parts = re.split(r"\{[^}]*\}", path)

    def _eval(self, expr: str, data: Any) -> List[Any]:
        expr = expr.strip()
        if expr.startswith("$"):
            expr = expr[1:]
        current = [data]
        for m in _JSONPATH_TOKEN.finditer(expr):
            name, idx = m.group(1), m.group(2)
            nxt: List[Any] = []
            for c in current:
                if name is not None:
                    if isinstance(c, dict) and name in c:
                        nxt.append(c[name])
                elif idx == "*":
                    if isinstance(c, list):
                        nxt.extend(c)
                    elif isinstance(c, dict):
                        nxt.extend(c.values())
                elif idx.startswith("'"):
                    if isinstance(c, dict) and idx[1:-1] in c:
                        nxt.append(c[idx[1:-1]])
                else:
                    i = int(idx)
                    if isinstance(c, list) and i < len(c):
                        nxt.append(c[i])
            current = nxt
        return current

    def print_obj(self, obj: Any, out) -> None:
        wire = self.scheme.encode_to_wire(obj, self.version)
        pieces = [self.literal_parts[0]]
        for i, expr in enumerate(self.exprs):
            vals = self._eval(expr, wire)
            pieces.append(" ".join(
                v if isinstance(v, str) else json.dumps(v) for v in vals))
            pieces.append(self.literal_parts[i + 1])
        out.write("".join(pieces))
        out.write("\n")


def printer_for(output: str, scheme, template: str = "",
                no_headers: bool = False, version: str = ""):
    """ref: resource_printer.go GetPrinter."""
    if output in ("", "wide"):
        return HumanReadablePrinter(no_headers=no_headers)
    if output == "json":
        return JSONPrinter(scheme, version)
    if output == "yaml":
        return YAMLPrinter(scheme, version)
    if output == "template":
        if not template:
            raise ValueError("template format specified but no template given")
        return TemplatePrinter(scheme, template, version)
    if output == "jsonpath":
        if not template:
            raise ValueError("jsonpath format specified but no expression given")
        return JSONPathPrinter(scheme, template, version)
    raise ValueError(f"unknown output format {output!r}")
