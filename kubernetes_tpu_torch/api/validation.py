"""API object validation (ref: pkg/api/validation/validation.go).

Port of ``kubernetes_tpu/api/validation.py``.

Pure functions returning a list of ValidationError; empty list = valid.
Key entry points mirror the reference: validate_pod, validate_service,
validate_replication_controller, validate_node, validate_namespace.
``accumulate_unique_host_ports`` is shared with the kubelet's on-node
admission (ref: pkg/kubelet/kubelet.go:1706).
"""

from __future__ import annotations

import re
from typing import List, Optional, Set, Tuple

from kubernetes_tpu_torch import capabilities
from kubernetes_tpu_torch.api import labels as labels_pkg
from kubernetes_tpu_torch.api import types as api

__all__ = [
    "ValidationError",
    "validate_object_meta",
    "validate_pod",
    "validate_pod_update",
    "validate_service",
    "validate_replication_controller",
    "validate_node",
    "validate_namespace",
    "validate_event",
    "validate_priority_class",
    "accumulate_unique_host_ports",
    "is_dns1123_label",
    "is_dns1123_subdomain",
]

_DNS1123_LABEL = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")
_DNS1123_SUBDOMAIN = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*$")
_C_IDENTIFIER = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


class ValidationError(Exception):
    def __init__(self, etype: str, field: str, value=None, detail: str = ""):
        self.type = etype
        self.field = field
        self.value = value
        self.detail = detail
        msg = f"{field}: {etype}"
        if value not in (None, ""):
            msg += f" {value!r}"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


def _required(field):
    return ValidationError("required value", field)


def _invalid(field, value, detail=""):
    return ValidationError("invalid value", field, value, detail)


def _duplicate(field, value):
    return ValidationError("duplicate value", field, value)


def _unsupported(field, value, detail=""):
    return ValidationError("unsupported value", field, value, detail)


def is_dns1123_label(s: str) -> bool:
    return len(s) <= 63 and bool(_DNS1123_LABEL.match(s))


def is_dns1123_subdomain(s: str) -> bool:
    return len(s) <= 253 and bool(_DNS1123_SUBDOMAIN.match(s))


def validate_labels(lbls, field) -> List[ValidationError]:
    errs = []
    for k, v in (lbls or {}).items():
        if not labels_pkg.validate_label_key(k):
            errs.append(_invalid(f"{field}.{k}", k, "invalid label key"))
        if not labels_pkg.validate_label_value(v):
            errs.append(_invalid(f"{field}.{k}", v, "invalid label value"))
    return errs


def validate_object_meta(meta: api.ObjectMeta, namespaced: bool, name_fn=None,
                         field: str = "metadata") -> List[ValidationError]:
    """ref: validation.go ValidateObjectMeta."""
    errs: List[ValidationError] = []
    if not meta.name and not meta.generate_name:
        errs.append(_required(f"{field}.name"))
    elif meta.name and not is_dns1123_subdomain(meta.name):
        errs.append(_invalid(f"{field}.name", meta.name, "must be a DNS subdomain"))
    if name_fn and meta.name:
        errs.extend(name_fn(meta.name, f"{field}.name"))
    if namespaced:
        if not meta.namespace:
            errs.append(_required(f"{field}.namespace"))
        elif not is_dns1123_label(meta.namespace):
            errs.append(_invalid(f"{field}.namespace", meta.namespace, "must be a DNS label"))
    elif meta.namespace:
        errs.append(_invalid(f"{field}.namespace", meta.namespace,
                             "namespace is not allowed on this type"))
    errs.extend(validate_labels(meta.labels, f"{field}.labels"))
    return errs


def accumulate_unique_host_ports(containers: List[api.Container],
                                 accumulator: Optional[Set[Tuple[int, str]]] = None
                                 ) -> List[ValidationError]:
    """ref: validation.go AccumulateUniquePorts / checkHostPortConflicts —
    also reused by the scheduler predicate (pkg/scheduler/predicates.go:326)
    and the kubelet (pkg/kubelet/kubelet.go:1706)."""
    errs: List[ValidationError] = []
    ports = accumulator if accumulator is not None else set()
    for ci, c in enumerate(containers):
        for pi, p in enumerate(c.ports):
            if not p.host_port:
                continue
            key = (p.host_port, p.protocol or api.ProtocolTCP)
            if key in ports:
                errs.append(_duplicate(f"spec.containers[{ci}].ports[{pi}].hostPort", p.host_port))
            ports.add(key)
    return errs


def _validate_volumes(volumes: List[api.Volume]) -> Tuple[Set[str], List[ValidationError]]:
    errs: List[ValidationError] = []
    names: Set[str] = set()
    for i, v in enumerate(volumes or []):
        fld = f"spec.volumes[{i}]"
        if not v.name:
            errs.append(_required(f"{fld}.name"))
        elif not is_dns1123_label(v.name):
            errs.append(_invalid(f"{fld}.name", v.name, "must be a DNS label"))
        elif v.name in names:
            errs.append(_duplicate(f"{fld}.name", v.name))
        names.add(v.name)
        src = v.source
        set_sources = [s for s in (src.empty_dir, src.host_path, src.gce_persistent_disk,
                                   src.git_repo, src.secret, src.nfs) if s is not None]
        if len(set_sources) > 1:
            errs.append(_invalid(f"{fld}.source", None, "exactly one volume source may be set"))
    return names, errs


def _validate_containers(containers: List[api.Container], volume_names: Set[str]
                         ) -> List[ValidationError]:
    errs: List[ValidationError] = []
    if not containers:
        return [_required("spec.containers")]
    names: Set[str] = set()
    for i, c in enumerate(containers):
        fld = f"spec.containers[{i}]"
        if not c.name:
            errs.append(_required(f"{fld}.name"))
        elif not is_dns1123_label(c.name):
            errs.append(_invalid(f"{fld}.name", c.name, "must be a DNS label"))
        elif c.name in names:
            errs.append(_duplicate(f"{fld}.name", c.name))
        names.add(c.name)
        if not c.image:
            errs.append(_required(f"{fld}.image"))
        if c.privileged and not capabilities.get().allow_privileged:
            # ref: validation.go:612-613 — privileged mode is a per-binary
            # capability (--allow_privileged), off by default
            errs.append(ValidationError(
                "forbidden", f"{fld}.privileged", True,
                "privileged mode is disallowed (start with --allow-privileged)"))
        port_names: Set[str] = set()
        for pi, p in enumerate(c.ports):
            pfld = f"{fld}.ports[{pi}]"
            if p.name:
                if not is_dns1123_label(p.name):
                    errs.append(_invalid(f"{pfld}.name", p.name))
                elif p.name in port_names:
                    errs.append(_duplicate(f"{pfld}.name", p.name))
                port_names.add(p.name)
            if not (0 < p.container_port < 65536):
                errs.append(_invalid(f"{pfld}.containerPort", p.container_port))
            if p.host_port and not (0 < p.host_port < 65536):
                errs.append(_invalid(f"{pfld}.hostPort", p.host_port))
            if p.protocol and p.protocol not in (api.ProtocolTCP, api.ProtocolUDP):
                errs.append(_unsupported(f"{pfld}.protocol", p.protocol))
        for ei, e in enumerate(c.env):
            if not e.name:
                errs.append(_required(f"{fld}.env[{ei}].name"))
            elif not _C_IDENTIFIER.match(e.name):
                errs.append(_invalid(f"{fld}.env[{ei}].name", e.name))
        for mi, m in enumerate(c.volume_mounts):
            mfld = f"{fld}.volumeMounts[{mi}]"
            if not m.name:
                errs.append(_required(f"{mfld}.name"))
            elif m.name not in volume_names:
                errs.append(ValidationError("not found", f"{mfld}.name", m.name))
            if not m.mount_path:
                errs.append(_required(f"{mfld}.mountPath"))
    errs.extend(accumulate_unique_host_ports(containers))
    return errs


def validate_pod_spec(spec: api.PodSpec) -> List[ValidationError]:
    volume_names, errs = _validate_volumes(spec.volumes)
    errs.extend(_validate_containers(spec.containers, volume_names))
    if spec.restart_policy not in (api.RestartPolicyAlways, api.RestartPolicyOnFailure,
                                   api.RestartPolicyNever):
        errs.append(_unsupported("spec.restartPolicy", spec.restart_policy))
    if spec.dns_policy not in (api.DNSClusterFirst, api.DNSDefault):
        errs.append(_unsupported("spec.dnsPolicy", spec.dns_policy))
    errs.extend(validate_labels(spec.node_selector, "spec.nodeSelector"))
    if spec.priority_class_name and \
            not is_dns1123_subdomain(spec.priority_class_name):
        errs.append(_invalid("spec.priorityClassName",
                             spec.priority_class_name,
                             "must be a DNS subdomain"))
    if spec.priority is not None and \
            spec.priority > api.HighestUserDefinablePriority:
        errs.append(_invalid("spec.priority", spec.priority,
                             "must not exceed the highest user-definable "
                             f"priority ({api.HighestUserDefinablePriority})"))
    if spec.preemption_policy not in ("", api.PreemptLowerPriority,
                                      api.PreemptNever):
        errs.append(_unsupported("spec.preemptionPolicy",
                                 spec.preemption_policy))
    return errs


def validate_pod(pod: api.Pod) -> List[ValidationError]:
    """ref: validation.go ValidatePod."""
    errs = validate_object_meta(pod.metadata, namespaced=True)
    errs.extend(validate_pod_spec(pod.spec))
    return errs


def validate_pod_update(new: api.Pod, old: api.Pod) -> List[ValidationError]:
    """ref: validation.go ValidatePodUpdate — spec is mostly immutable; only
    container image updates are allowed in the reference."""
    errs: List[ValidationError] = []
    if new.metadata.name != old.metadata.name or new.metadata.namespace != old.metadata.namespace:
        errs.append(_invalid("metadata.name", new.metadata.name, "may not be changed"))
    ns, os_ = new.spec, old.spec
    if len(ns.containers) != len(os_.containers):
        errs.append(_invalid("spec.containers", None, "may not add or remove containers"))
        return errs
    # Whole-container equality with image masked out: everything except the
    # image is immutable (ref: validation.go ValidatePodUpdate copies
    # containers and overwrites Image before DeepEqual).
    import dataclasses as _dc

    for nc, oc in zip(ns.containers, os_.containers):
        if _dc.replace(nc, image=oc.image) != oc:
            errs.append(_invalid("spec.containers", nc.name,
                                 "only container image updates are allowed"))
            break
    if ns.host != os_.host and os_.host:
        errs.append(_invalid("spec.host", ns.host, "may not be changed once set"))
    return errs


def validate_service(svc: api.Service) -> List[ValidationError]:
    """ref: validation.go ValidateService."""
    def name_fn(name, field):
        return [] if is_dns1123_label(name) else [_invalid(field, name, "must be a DNS label")]

    errs = validate_object_meta(svc.metadata, namespaced=True, name_fn=name_fn)
    if not (0 < svc.spec.port < 65536):
        errs.append(_invalid("spec.port", svc.spec.port))
    if svc.spec.protocol and svc.spec.protocol not in (api.ProtocolTCP, api.ProtocolUDP):
        errs.append(_unsupported("spec.protocol", svc.spec.protocol))
    if svc.spec.session_affinity not in (api.AffinityNone, api.AffinityClientIP):
        errs.append(_unsupported("spec.sessionAffinity", svc.spec.session_affinity))
    errs.extend(validate_labels(svc.spec.selector, "spec.selector"))
    return errs


def validate_replication_controller(rc: api.ReplicationController) -> List[ValidationError]:
    """ref: validation.go ValidateReplicationController."""
    errs = validate_object_meta(rc.metadata, namespaced=True)
    if rc.spec.replicas < 0:
        errs.append(_invalid("spec.replicas", rc.spec.replicas, "must be non-negative"))
    if not rc.spec.selector:
        errs.append(_required("spec.selector"))
    tmpl = rc.spec.template
    if tmpl is None:
        if rc.spec.replicas > 0:
            errs.append(_required("spec.template"))
    else:
        sel = rc.spec.selector or {}
        tl = tmpl.metadata.labels or {}
        if any(tl.get(k) != v for k, v in sel.items()):
            errs.append(_invalid("spec.template.metadata.labels", tl,
                                 "selector does not match template labels"))
        errs.extend(validate_pod_spec(tmpl.spec))
        if tmpl.spec.restart_policy != api.RestartPolicyAlways:
            errs.append(_unsupported("spec.template.spec.restartPolicy",
                                     tmpl.spec.restart_policy,
                                     "replicated pods must have RestartPolicy=Always"))
    return errs


def validate_node(node: api.Node) -> List[ValidationError]:
    errs = validate_object_meta(node.metadata, namespaced=False)
    for k, q in (node.spec.capacity or {}).items():
        if q.value < 0:
            errs.append(_invalid(f"spec.capacity.{k}", str(q), "must be non-negative"))
    return errs


def validate_namespace(ns: api.Namespace) -> List[ValidationError]:
    def name_fn(name, field):
        return [] if is_dns1123_label(name) else [_invalid(field, name, "must be a DNS label")]

    return validate_object_meta(ns.metadata, namespaced=False, name_fn=name_fn)


def validate_priority_class(pc: api.PriorityClass) -> List[ValidationError]:
    """kube-preempt: PriorityClass is cluster-scoped; value is a bounded
    int32 (the upstream user-definable ceiling), the preemption policy an
    enum. The at-most-one-globalDefault invariant is enforced by the
    registry (it needs the stored set)."""
    def name_fn(name, field):
        return [] if is_dns1123_subdomain(name) else \
            [_invalid(field, name, "must be a DNS subdomain")]

    errs = validate_object_meta(pc.metadata, namespaced=False,
                                name_fn=name_fn)
    if not isinstance(pc.value, int) or isinstance(pc.value, bool):
        errs.append(_invalid("value", pc.value, "must be an integer"))
    elif not (-(1 << 31) <= pc.value <= api.HighestUserDefinablePriority):
        errs.append(_invalid(
            "value", pc.value,
            "must be an int32 no greater than the highest user-definable "
            f"priority ({api.HighestUserDefinablePriority})"))
    if pc.preemption_policy not in (api.PreemptLowerPriority,
                                    api.PreemptNever):
        errs.append(_unsupported("preemptionPolicy", pc.preemption_policy))
    return errs


def validate_event(ev: api.Event) -> List[ValidationError]:
    """ref: validation.go ValidateEvent — event namespace must match the
    involved object's namespace."""
    errs: List[ValidationError] = []
    if ev.involved_object.namespace and ev.metadata.namespace != ev.involved_object.namespace:
        errs.append(_invalid("involvedObject.namespace", ev.involved_object.namespace,
                             "does not match event namespace"))
    return errs
