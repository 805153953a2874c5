"""v1beta1 — the legacy wire API, structurally divergent from v1.

Port of ``kubernetes_tpu/api/v1beta1.py``.

ref: pkg/api/v1beta1/{types,conversion,defaults}.go. The reference shipped
v1beta1/v1beta2 (flat metadata, desiredState/currentState envelopes,
manifest-nested pod specs, object-shaped restart policies, "Minion" for
Node, "podID" on bindings, "ip:port" endpoint strings) side by side with
the nested-metadata v1beta3 that became v1. This module gives our "v1"
internal model that same genuinely-restructured sibling so the conversion
engine is proven against a REAL divergent format, not a field-rename toy:

- metadata flattens to the top level with ``name`` spelled ``id``;
- Pod/PodTemplate specs nest under ``desiredState.manifest`` with the
  restart policy as a one-of object (``{"always": {}}``), status under
  ``currentState`` with phase spelled ``status`` and container statuses
  as ``info``;
- ReplicationController uses ``desiredState.{replicas,replicaSelector,
  podTemplate}``;
- Service flattens its spec to the top level;
- Node rides the wire as kind ``Minion`` with capacity under
  ``resources.capacity``;
- Endpoints carry ``"ip:port"`` strings plus a parallel ``targetRefs``;
- Binding names its pod ``podID``;
- Namespace/ResourceQuota/LimitRange hoist their specs.

Every transform is exactly invertible (fuzz: tests/test_serialization.py
asserts internal -> v1beta1 wire -> internal identity over randomized
objects of every kind), decode applies the era's defaulting pass, and
field labels convert per version (``DesiredState.Host`` <->
``spec.host``, ref: pkg/api/v1beta1/conversion.go field-label funcs).

v1beta1 additionally carries the era's *deprecated wire aliases*, which
are exactly what distinguishes it from its v1beta2 sibling in the
reference (v1beta2 is the same envelope shape minus the aliases):

- ``EnvVar.key`` — deprecated duplicate of ``name``; encode writes both,
  decode prefers ``name`` and falls back to ``key``
  (ref: pkg/api/v1beta1/conversion.go:114-129, absent from v1beta2);
- ``VolumeMount.path``/``mountType`` — deprecated aliases of
  ``mountPath``; decode falls back to ``path``
  (ref: pkg/api/v1beta1/conversion.go:131-149);
- ``MinionList.minions`` — duplicate of ``items`` on the wire; decode
  prefers ``items`` (ref: pkg/api/v1beta1/conversion.go:151-196
  "MinionList.Items had a wrong name in v1beta1").

The transform registry is built by :func:`make_kind_transforms` so the
v1beta2 module can instantiate the shared envelope with
``legacy_aliases=False`` and its own manifest version stamp.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

__all__ = ["KIND_TRANSFORMS", "KIND_ALIASES", "DEFAULTERS",
           "FIELD_LABELS", "encode_for", "decode_for",
           "make_kind_transforms"]


# -- metadata flattening (name is spelled "id") ------------------------------

_META_FLAT = (
    ("name", "id"),
    ("namespace", "namespace"),
    ("uid", "uid"),
    ("resourceVersion", "resourceVersion"),
    ("creationTimestamp", "creationTimestamp"),
    ("deletionTimestamp", "deletionTimestamp"),
    ("selfLink", "selfLink"),
    ("labels", "labels"),
    ("annotations", "annotations"),
    ("generateName", "generateName"),
)


def _meta_out(wire: dict) -> dict:
    wire = dict(wire)
    meta = wire.pop("metadata", None)
    if isinstance(meta, dict):
        for internal_name, beta_name in _META_FLAT:
            if internal_name in meta:
                wire[beta_name] = meta[internal_name]
    return wire


def _meta_in(wire: dict) -> dict:
    wire = dict(wire)
    meta = {}
    for internal_name, beta_name in _META_FLAT:
        if beta_name in wire:
            meta[internal_name] = wire.pop(beta_name)
    if meta:
        wire["metadata"] = meta
    return wire


def _move(d: dict, src: str, dst: dict, dst_key: str) -> None:
    if src in d:
        dst[dst_key] = d.pop(src)


# -- pod spec <-> desiredState.manifest --------------------------------------

# restartPolicy: string <-> one-of object (ref: v1beta1 RestartPolicy
# {Always *RestartPolicyAlways, ...})
_POLICY_OUT = {"Always": "always", "OnFailure": "onFailure", "Never": "never"}
_POLICY_IN = {v: k for k, v in _POLICY_OUT.items()}


def _containers_alias_out(containers: list) -> list:
    """Write the v1beta1-only deprecated duplicates: EnvVar.key mirrors
    name, VolumeMount.path mirrors mountPath (ref: v1beta1/conversion.go
    EnvVar/VolumeMount funcs; v1beta2 dropped both fields)."""
    out = []
    for c in containers:
        if not isinstance(c, dict):
            out.append(c)
            continue
        c = dict(c)
        env = c.get("env")
        if isinstance(env, list):
            c["env"] = [dict(e, key=e["name"])
                        if isinstance(e, dict) and e.get("name") else e
                        for e in env]
        vms = c.get("volumeMounts")
        if isinstance(vms, list):
            c["volumeMounts"] = [dict(v, path=v["mountPath"])
                                 if isinstance(v, dict) and v.get("mountPath")
                                 else v for v in vms]
        out.append(c)
    return out


def _containers_alias_in(containers: list) -> list:
    """Accept the deprecated aliases: key -> name, path -> mountPath;
    mountType is ignored (ref: v1beta1/conversion.go "MountType is
    ignored")."""
    out = []
    for c in containers:
        if not isinstance(c, dict):
            out.append(c)
            continue
        c = dict(c)
        env = c.get("env")
        if isinstance(env, list):
            fixed = []
            for e in env:
                if isinstance(e, dict):
                    e = dict(e)
                    key = e.pop("key", None)
                    if not e.get("name") and key:
                        e["name"] = key
                fixed.append(e)
            c["env"] = fixed
        vms = c.get("volumeMounts")
        if isinstance(vms, list):
            fixed = []
            for v in vms:
                if isinstance(v, dict):
                    v = dict(v)
                    path = v.pop("path", None)
                    v.pop("mountType", None)
                    if not v.get("mountPath") and path:
                        v["mountPath"] = path
                fixed.append(v)
            c["volumeMounts"] = fixed
        out.append(c)
    return out


def _podspec_out(spec: dict, version: str = "v1beta1",
                 legacy: bool = True) -> dict:
    spec = dict(spec)
    manifest: dict = {"version": version}
    for k, mk in (("containers", "containers"), ("volumes", "volumes"),
                  ("dnsPolicy", "dnsPolicy"), ("hostNetwork", "hostNetwork"),
                  ("terminationGracePeriodSeconds",
                   "terminationGracePeriodSeconds")):
        _move(spec, k, manifest, mk)
    if legacy and isinstance(manifest.get("containers"), list):
        manifest["containers"] = _containers_alias_out(manifest["containers"])
    rp = spec.pop("restartPolicy", None)
    if rp is not None:
        manifest["restartPolicy"] = {_POLICY_OUT.get(rp, "always"): {}}
    out: dict = {"manifest": manifest}
    _move(spec, "host", out, "host")
    _move(spec, "nodeSelector", out, "nodeSelector")
    out.update(spec)  # forward-compat: unknown spec fields ride along
    return out


def _podspec_in(ds: dict, legacy: bool = True) -> dict:
    ds = dict(ds)
    spec: dict = {}
    manifest = dict(ds.pop("manifest", {}) or {})
    manifest.pop("version", None)
    manifest.pop("id", None)
    if legacy and isinstance(manifest.get("containers"), list):
        manifest["containers"] = _containers_alias_in(manifest["containers"])
    rp = manifest.pop("restartPolicy", None)
    if isinstance(rp, dict) and rp:
        spec["restartPolicy"] = _POLICY_IN.get(next(iter(rp)), "Always")
    spec.update(manifest)
    _move(ds, "host", spec, "host")
    _move(ds, "nodeSelector", spec, "nodeSelector")
    spec.update(ds)
    return spec


def _podstatus_out(status: dict) -> dict:
    cs = dict(status)
    out: dict = {}
    _move(cs, "phase", out, "status")          # phase is spelled "status"
    _move(cs, "containerStatuses", out, "info")
    out.update(cs)
    return out


def _podstatus_in(cs: dict) -> dict:
    cs = dict(cs)
    status: dict = {}
    _move(cs, "status", status, "phase")
    _move(cs, "info", status, "containerStatuses")
    status.update(cs)
    return status


def _pod_out(wire: dict, version: str = "v1beta1",
             legacy: bool = True) -> dict:
    wire = _meta_out(wire)
    if "spec" in wire:
        wire["desiredState"] = _podspec_out(wire.pop("spec"), version, legacy)
    if "status" in wire:
        wire["currentState"] = _podstatus_out(wire.pop("status"))
    return wire


def _pod_in(wire: dict, legacy: bool = True) -> dict:
    wire = _meta_in(wire)
    if "desiredState" in wire:
        wire["spec"] = _podspec_in(wire.pop("desiredState"), legacy)
    if "currentState" in wire:
        wire["status"] = _podstatus_in(wire.pop("currentState"))
    return wire


# -- replication controller --------------------------------------------------

def _template_out(t: dict, version: str = "v1beta1",
                  legacy: bool = True) -> dict:
    t = _meta_out(t)  # template metadata flattens like any object's
    if "spec" in t:
        t["desiredState"] = _podspec_out(t.pop("spec"), version, legacy)
    return t


def _template_in(t: dict, legacy: bool = True) -> dict:
    t = _meta_in(t)
    if "desiredState" in t:
        t["spec"] = _podspec_in(t.pop("desiredState"), legacy)
    return t


def _rc_out(wire: dict, version: str = "v1beta1",
            legacy: bool = True) -> dict:
    wire = _meta_out(wire)
    spec = dict(wire.pop("spec", {}) or {})
    ds: dict = {}
    _move(spec, "replicas", ds, "replicas")
    _move(spec, "selector", ds, "replicaSelector")
    if "template" in spec:
        ds["podTemplate"] = _template_out(spec.pop("template"), version,
                                          legacy)
    ds.update(spec)
    wire["desiredState"] = ds
    if "status" in wire:
        wire["currentState"] = wire.pop("status")
    return wire


def _rc_in(wire: dict, legacy: bool = True) -> dict:
    wire = _meta_in(wire)
    ds = dict(wire.pop("desiredState", {}) or {})
    spec: dict = {}
    _move(ds, "replicas", spec, "replicas")
    _move(ds, "replicaSelector", spec, "selector")
    if "podTemplate" in ds:
        spec["template"] = _template_in(ds.pop("podTemplate"), legacy)
    spec.update(ds)
    wire["spec"] = spec
    if "currentState" in wire:
        wire["status"] = wire.pop("currentState")
    return wire


# -- service: spec flattened to the top level --------------------------------

_SVC_FLAT = ("port", "protocol", "selector", "portalIp",
             "createExternalLoadBalancer", "publicIps", "containerPort",
             "sessionAffinity")


def _service_out(wire: dict) -> dict:
    wire = _meta_out(wire)
    spec = dict(wire.pop("spec", {}) or {})
    # only the shared _SVC_FLAT keys move — both directions are driven by
    # the one table, so a new ServiceSpec field fails loudly in round-trip
    # fuzz instead of silently flattening out but never restoring
    for k in _SVC_FLAT:
        _move(spec, k, wire, k)
    if spec:
        wire["spec"] = spec  # unmapped spec fields stay nested (lossless)
    wire.pop("status", None)  # ServiceStatus is empty in this era
    return wire


def _service_in(wire: dict) -> dict:
    wire = _meta_in(wire)
    spec = dict(wire.pop("spec", {}) or {})
    for k in _SVC_FLAT:
        if k in wire:
            spec[k] = wire.pop(k)
    wire["spec"] = spec
    return wire


# -- node (wire kind "Minion"): resources envelope ---------------------------

_NODE_FLAT = ("podCidr", "externalId", "unschedulable")


def _node_out(wire: dict) -> dict:
    wire = _meta_out(wire)
    spec = dict(wire.pop("spec", {}) or {})
    if "capacity" in spec:
        wire["resources"] = {"capacity": spec.pop("capacity")}
    for k in _NODE_FLAT:
        _move(spec, k, wire, k)
    if spec:
        wire["spec"] = spec  # unmapped spec fields stay nested (lossless)
    return wire


def _node_in(wire: dict) -> dict:
    wire = _meta_in(wire)
    spec = dict(wire.pop("spec", {}) or {})
    res = wire.pop("resources", None)
    if isinstance(res, dict) and "capacity" in res:
        spec["capacity"] = res["capacity"]
    for k in _NODE_FLAT:
        if k in wire:
            spec[k] = wire.pop(k)
    wire["spec"] = spec
    return wire


# -- endpoints: "ip:port" strings + parallel targetRefs ----------------------

def _endpoints_out(wire: dict) -> dict:
    wire = _meta_out(wire)
    eps = wire.pop("endpoints", None)
    if isinstance(eps, list):
        flat, refs = [], []
        for i, e in enumerate(eps):
            addr = f"{e.get('ip', '')}:{e.get('port', 0)}"
            flat.append(addr)
            if e.get("targetRef") is not None:
                # positional pairing: several endpoints may share ip:port
                # (distinct target pods behind one address), so refs keyed
                # by address would collide and corrupt on decode
                refs.append({"endpoint": addr, "i": i,
                             "target": e["targetRef"]})
        wire["endpoints"] = flat
        if refs:
            wire["targetRefs"] = refs
    return wire


def _endpoints_in(wire: dict) -> dict:
    wire = _meta_in(wire)
    eps = wire.pop("endpoints", None)
    refs = {r["i"]: r.get("target")
            for r in wire.pop("targetRefs", []) or [] if "i" in r}
    if isinstance(eps, list):
        out = []
        for i, addr in enumerate(eps):
            ip, _, port = str(addr).rpartition(":")
            e = {"ip": ip, "port": int(port or 0)}
            if i in refs:
                e["targetRef"] = refs[i]
            out.append(e)
        wire["endpoints"] = out
    return wire


# -- binding: podID ----------------------------------------------------------

def _binding_out(wire: dict) -> dict:
    wire = _meta_out(wire)
    _move(wire, "podName", wire, "podID")
    return wire


def _binding_in(wire: dict) -> dict:
    wire = _meta_in(wire)
    _move(wire, "podID", wire, "podName")
    return wire


# -- namespace / quota / limitrange: hoisted specs ---------------------------

def _namespace_out(wire: dict) -> dict:
    wire = _meta_out(wire)
    spec = dict(wire.pop("spec", {}) or {})
    _move(spec, "finalizers", wire, "finalizers")
    status = dict(wire.pop("status", {}) or {})
    _move(status, "phase", wire, "phase")
    return wire


def _namespace_in(wire: dict) -> dict:
    wire = _meta_in(wire)
    if "finalizers" in wire:
        wire["spec"] = {"finalizers": wire.pop("finalizers")}
    if "phase" in wire:
        wire["status"] = {"phase": wire.pop("phase")}
    return wire


def _quota_out(wire: dict) -> dict:
    wire = _meta_out(wire)
    spec = dict(wire.pop("spec", {}) or {})
    _move(spec, "hard", wire, "hard")
    if "status" in wire:
        wire["currentStatus"] = wire.pop("status")
    return wire


def _quota_in(wire: dict) -> dict:
    wire = _meta_in(wire)
    if "hard" in wire:
        wire["spec"] = {"hard": wire.pop("hard")}
    if "currentStatus" in wire:
        wire["status"] = wire.pop("currentStatus")
    return wire


def _limitrange_out(wire: dict) -> dict:
    wire = _meta_out(wire)
    spec = dict(wire.pop("spec", {}) or {})
    _move(spec, "limits", wire, "limits")
    return wire


def _limitrange_in(wire: dict) -> dict:
    wire = _meta_in(wire)
    if "limits" in wire:
        wire["spec"] = {"limits": wire.pop("limits")}
    return wire


# -- registry ----------------------------------------------------------------

WireFn = Callable[[dict], dict]


def make_kind_transforms(manifest_version: str = "v1beta1",
                         legacy_aliases: bool = True,
                         ) -> Dict[str, Tuple[WireFn, WireFn]]:
    """Build the kind -> (encode, decode) registry for one legacy wire
    version. v1beta1 = ("v1beta1", True); the v1beta2 sibling shares the
    whole envelope shape but stamps its own manifest version and drops
    the deprecated aliases (ref: pkg/api/v1beta2/ is v1beta1 minus
    EnvVar.Key / VolumeMount.Path / MinionList.Minions)."""
    v, leg = manifest_version, legacy_aliases
    reg: Dict[str, Tuple[WireFn, WireFn]] = {
        "Pod": (lambda w: _pod_out(w, v, leg),
                lambda w: _pod_in(w, leg)),
        "ReplicationController": (lambda w: _rc_out(w, v, leg),
                                  lambda w: _rc_in(w, leg)),
        "Service": (_service_out, _service_in),
        "Node": (_node_out, _node_in),
        "Endpoints": (_endpoints_out, _endpoints_in),
        "Binding": (_binding_out, _binding_in),
        "Namespace": (_namespace_out, _namespace_in),
        "ResourceQuota": (_quota_out, _quota_in),
        "LimitRange": (_limitrange_out, _limitrange_in),
        # flat-metadata-only kinds
        "Event": (_meta_out, _meta_in),
        "Secret": (_meta_out, _meta_in),
        "Status": (lambda w: w, lambda w: w),
        "DeleteOptions": (lambda w: w, lambda w: w),
    }
    if legacy_aliases:
        # MinionList carries a duplicate "minions" field on the wire;
        # decode prefers "items" and falls back to "minions"
        # (ref: v1beta1/conversion.go "MinionList.Items had a wrong name")
        node_out, node_in = reg["Node"]

        def _nodelist_out(wire: dict) -> dict:
            wire = _list_out(node_out, wire)
            if isinstance(wire.get("items"), list):
                wire["minions"] = wire["items"]
            return wire

        def _nodelist_in(wire: dict) -> dict:
            wire = dict(wire)
            minions = wire.pop("minions", None)
            if "items" not in wire and isinstance(minions, list):
                wire["items"] = minions
            return _list_in(node_in, wire)

        reg["NodeList"] = (_nodelist_out, _nodelist_in)
    return reg


def _list_out(item: WireFn, wire: dict) -> dict:
    wire = _meta_out(wire)
    items = wire.get("items")
    if isinstance(items, list):
        wire["items"] = [item(i) if isinstance(i, dict) else i
                         for i in items]
    return wire


def _list_in(item: WireFn, wire: dict) -> dict:
    wire = _meta_in(wire)
    items = wire.get("items")
    if isinstance(items, list):
        wire["items"] = [item(i) if isinstance(i, dict) else i
                         for i in items]
    return wire


# kind -> (encode internal-wire -> v1beta1-wire, decode back)
KIND_TRANSFORMS: Dict[str, Tuple[WireFn, WireFn]] = make_kind_transforms()

# v1beta1 wire kind -> internal kind (ref: Node was "Minion" on the wire)
KIND_ALIASES: Dict[str, str] = {"Minion": "Node", "MinionList": "NodeList"}


def encode_for(kind: str, registry: Dict[str, Tuple[WireFn, WireFn]]
               = KIND_TRANSFORMS) -> WireFn:
    """Encoder for a kind, deriving List transforms from the item kind."""
    if kind in registry:
        return registry[kind][0]
    if kind.endswith("List") and kind[:-4] in registry:
        item = registry[kind[:-4]][0]
        return lambda wire: _list_out(item, wire)
    return _meta_out


def decode_for(kind: str, registry: Dict[str, Tuple[WireFn, WireFn]]
               = KIND_TRANSFORMS) -> WireFn:
    if kind in registry:
        return registry[kind][1]
    if kind.endswith("List") and kind[:-4] in registry:
        item = registry[kind[:-4]][1]
        return lambda wire: _list_in(item, wire)
    return _meta_in


# -- defaulting (ref: pkg/api/v1beta1/defaults.go) ---------------------------

def _default_pod(pod) -> None:
    if not pod.spec.restart_policy:
        pod.spec.restart_policy = "Always"
    if not pod.spec.dns_policy:
        pod.spec.dns_policy = "ClusterFirst"
    for c in pod.spec.containers:
        for p in c.ports:
            if not p.protocol:
                p.protocol = "TCP"
            # with host networking, unset host ports default to the
            # container port (ref: v1beta1/defaults.go:112-121
            # defaultHostNetworkPorts; v1beta2/defaults.go:114-123 is
            # code-identical — only its comment claims the reverse)
            if pod.spec.host_network and not p.host_port:
                p.host_port = p.container_port


def _default_service(svc) -> None:
    if not svc.spec.protocol:
        svc.spec.protocol = "TCP"
    if not svc.spec.session_affinity:
        svc.spec.session_affinity = "None"


def _default_endpoints(eps) -> None:
    if not eps.protocol:
        eps.protocol = "TCP"


# kind -> defaulter(obj); applied on decode of that version's wire
DEFAULTERS: Dict[str, Callable] = {
    "Pod": _default_pod,
    "Service": _default_service,
    "Endpoints": _default_endpoints,
}


# -- field-label conversion (ref: v1beta1/conversion.go field-label funcs) ---

_POD_FIELDS = {
    "DesiredState.Host": "spec.host",
    "DesiredState.Status": "status.phase",
    "Status.Phase": "status.phase",
    "id": "metadata.name",
}
_NODE_FIELDS = {"id": "metadata.name", "unschedulable": "spec.unschedulable"}
_GENERIC_FIELDS = {"id": "metadata.name"}


def _label_fn(mapping):
    def convert(label: str, value: str) -> Tuple[str, str]:
        return mapping.get(label, label), value
    return convert


# kind -> fn(label, value) -> (internal label, value)
FIELD_LABELS: Dict[str, Callable[[str, str], Tuple[str, str]]] = {
    "Pod": _label_fn(_POD_FIELDS),
    "Node": _label_fn(_NODE_FIELDS),
    "Service": _label_fn(_GENERIC_FIELDS),
    "ReplicationController": _label_fn(_GENERIC_FIELDS),
    "Event": _label_fn(_GENERIC_FIELDS),
}
