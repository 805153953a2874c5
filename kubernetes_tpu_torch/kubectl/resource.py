"""Generic resource Builder -> Info -> Visitor pipeline.

Port of ``kubernetes_tpu/kubectl/resource.py``.

ref: pkg/kubectl/resource/builder.go:36 (Builder), visitor.go (Info,
Visitor chain). The Builder turns CLI inputs — filenames (JSON/YAML, multi
-document, directories, "-" for stdin), resource/name arguments
("pods", "pods/web", "pod web x y"), label selectors — into a stream of
``Info`` objects that commands visit uniformly. This is the seam that lets
get/create/update/delete/label share one input grammar.
"""

from __future__ import annotations

import glob
import io
import json
import os
import sys
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import yaml

from kubernetes_tpu_torch.api.meta import default_rest_mapper

__all__ = ["Info", "Builder", "ResourceError", "RESOURCE_ALIASES"]


class ResourceError(Exception):
    pass


# Short names + singular forms accepted on the CLI
# (ref: pkg/kubectl/kubectl.go expandResourceShortcut + alias table).
RESOURCE_ALIASES = {
    "po": "pods", "pod": "pods",
    "rc": "replicationcontrollers", "replicationcontroller": "replicationcontrollers",
    "controllers": "replicationcontrollers", "controller": "replicationcontrollers",
    "svc": "services", "service": "services",
    "ep": "endpoints", "endpoint": "endpoints",
    "no": "nodes", "node": "nodes", "minion": "nodes", "minions": "nodes",
    "ev": "events", "event": "events",
    "ns": "namespaces", "namespace": "namespaces",
    "secret": "secrets",
    "limit": "limitranges", "limitrange": "limitranges", "limits": "limitranges",
    "quota": "resourcequotas", "resourcequota": "resourcequotas",
    "pc": "priorityclasses", "priorityclass": "priorityclasses",
}


def resolve_resource(arg: str, mapper=None) -> str:
    mapper = mapper or default_rest_mapper()
    r = arg.lower()
    r = RESOURCE_ALIASES.get(r, r)
    if not mapper.has_resource(r):
        raise ResourceError(f"unknown resource type {arg!r}")
    return r


@dataclass
class Info:
    """One visitable object (ref: resource/visitor.go Info)."""

    resource: str = ""
    namespace: str = ""
    name: str = ""
    obj: Any = None
    source: str = ""          # filename or "arg"

    def refresh(self, client) -> "Info":
        """Re-fetch from the server (ref: Info.Get)."""
        self.obj = client.resource(self.resource, self.namespace).get(self.name)
        return self


class Builder:
    """ref: resource/builder.go Builder — chainable input collector."""

    def __init__(self, scheme, mapper=None, default_namespace: str = "default"):
        self.scheme = scheme
        self.mapper = mapper or default_rest_mapper()
        self.default_namespace = default_namespace
        self._filenames: List[str] = []
        self._stdin: Optional[io.TextIOBase] = None
        self._resource_args: List[str] = []
        self._selector: str = ""
        self._namespace: str = ""
        self._all_namespaces = False

    # -- chainable configuration ------------------------------------------
    def filename(self, *names: str) -> "Builder":
        self._filenames.extend(names)
        return self

    def stdin(self, stream=None) -> "Builder":
        self._stdin = stream or sys.stdin
        return self

    def namespace(self, ns: str) -> "Builder":
        self._namespace = ns
        return self

    def all_namespaces(self, flag: bool = True) -> "Builder":
        self._all_namespaces = flag
        return self

    def selector(self, sel: str) -> "Builder":
        self._selector = sel
        return self

    def resource_type_or_name(self, *args: str) -> "Builder":
        self._resource_args.extend(args)
        return self

    # -- file parsing ------------------------------------------------------
    def _decode_doc(self, doc: Any, source: str) -> Info:
        if not isinstance(doc, dict):
            raise ResourceError(f"{source}: expected an object, got {type(doc).__name__}")
        kind = doc.get("kind", "")
        if not kind:
            raise ResourceError(f"{source}: object has no kind")
        obj = self.scheme.decode_from_wire(
            doc, default_version=doc.get("apiVersion", ""))
        # the decoded object's kind, not the wire's: a legacy version may
        # spell it otherwise (v1beta1 "Minion" is a Node)
        resource = self.mapper.resource_for(self.scheme.object_kind(obj))
        meta = getattr(obj, "metadata", None)
        ns = ""
        if self.mapper.is_namespaced(resource):
            ns = (meta.namespace if meta and meta.namespace else
                  self._namespace or self.default_namespace)
            if meta is not None:
                meta.namespace = ns
        return Info(resource=resource, namespace=ns,
                    name=meta.name if meta else "", obj=obj, source=source)

    def _parse_stream(self, text: str, source: str) -> List[Info]:
        infos = []
        stripped = text.lstrip()
        if stripped.startswith("{") or stripped.startswith("["):
            docs = json.loads(text)
            docs = docs if isinstance(docs, list) else [docs]
        else:
            docs = [d for d in yaml.safe_load_all(text) if d is not None]
        for doc in docs:
            # v1beta3-style List objects flatten into their items
            if isinstance(doc, dict) and doc.get("kind", "").endswith("List") \
                    and "items" in doc:
                for item in doc["items"]:
                    infos.append(self._decode_doc(item, source))
            else:
                infos.append(self._decode_doc(doc, source))
        return infos

    def _expand_paths(self) -> List[str]:
        out = []
        for name in self._filenames:
            if name == "-":
                out.append(name)
                continue
            if os.path.isdir(name):
                for ext in ("*.json", "*.yaml", "*.yml"):
                    out.extend(sorted(glob.glob(os.path.join(name, ext))))
            elif os.path.exists(name):
                out.append(name)
            else:
                matches = sorted(glob.glob(name))
                if not matches:
                    raise ResourceError(f"the path {name!r} does not exist")
                out.extend(matches)
        return out

    # -- resource/name argument grammar -----------------------------------
    def _parse_resource_args(self, client) -> List[Info]:
        """Grammar (ref: builder.go ResourceTypeOrNameArgs):
        <resource>                     -> list (with selector)
        <resource>/<name> ...          -> those objects
        <resource> <name1> <name2> ... -> those objects
        """
        args = self._resource_args
        if not args:
            return []
        infos: List[Info] = []
        pairs: List[tuple] = []
        if all("/" in a for a in args):
            for a in args:
                r, _, n = a.partition("/")
                pairs.append((resolve_resource(r, self.mapper), n))
        else:
            if any("/" in a for a in args):
                raise ResourceError(
                    "there is no need to specify a resource type as a separate "
                    "argument when passing arguments in resource/name form "
                    "(e.g. 'get resource/<resource_name>' instead of "
                    "'get resource resource/<resource_name>')")
            resource = resolve_resource(args[0], self.mapper)
            names = args[1:]
            if not names:
                pairs.append((resource, ""))
            else:
                pairs.extend((resource, n) for n in names)

        for resource, name in pairs:
            namespaced = self.mapper.is_namespaced(resource)
            ns = "" if (not namespaced or self._all_namespaces) else \
                (self._namespace or self.default_namespace)
            if name:
                obj = client.resource(resource, ns).get(name)
                infos.append(Info(resource=resource, namespace=ns, name=name,
                                  obj=obj, source="arg"))
            else:
                lst = client.resource(resource, ns).list(
                    label_selector=self._selector)
                for item in lst.items:
                    m = item.metadata
                    infos.append(Info(resource=resource,
                                      namespace=m.namespace, name=m.name,
                                      obj=item, source="arg"))
        return infos

    # -- execution ---------------------------------------------------------
    def infos(self, client=None) -> List[Info]:
        """Materialize all inputs. ``client`` is only needed for
        resource/name args (file inputs never hit the server)."""
        infos: List[Info] = []
        for path in self._expand_paths():
            if path == "-":
                stream = self._stdin or sys.stdin
                infos.extend(self._parse_stream(stream.read(), "stdin"))
            else:
                with open(path, "r", encoding="utf-8") as f:
                    infos.extend(self._parse_stream(f.read(), path))
        if self._resource_args:
            if client is None:
                raise ResourceError("resource arguments require a client")
            infos.extend(self._parse_resource_args(client))
        if not infos and not self._filenames and not self._resource_args:
            raise ResourceError("no resources specified")
        return infos

    def visit(self, fn: Callable[[Info], None], client=None) -> int:
        """Apply ``fn`` to each Info; returns the count visited
        (ref: visitor.go Visit). Errors from individual items propagate."""
        infos = self.infos(client)
        for info in infos:
            fn(info)
        return len(infos)
