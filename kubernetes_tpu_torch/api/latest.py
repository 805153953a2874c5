"""Default scheme wiring — registered versions, conversions, defaults.

Port of ``kubernetes_tpu/api/latest.py``.

ref: pkg/api/latest/latest.go — declares the supported external versions
("v1" current, "v1beta1"/"v1beta2" legacy) and registers every kind plus
conversion functions, defaulting, kind aliases, and field-label
conversions. The legacy wire format lives in kubernetes_tpu_torch.api.v1beta1:
a genuinely restructured sibling (flat metadata with ``id``,
desiredState/currentState envelopes, manifest-nested pod specs,
one-of-object restart policies, "Minion", "podID", "ip:port" endpoints)
exercising the same seam the reference used for its hand-written
v1beta1/v1beta2 conversions (ref: pkg/api/v1beta1/conversion.go).
v1beta2 (kubernetes_tpu_torch.api.v1beta2) shares that envelope but drops the
era's deprecated aliases (EnvVar.key, VolumeMount.path,
MinionList.minions) and stamps its own manifest version — the same
delta separating the reference's two betas (ref: pkg/api/v1beta2/
types.go vs v1beta1/conversion.go:114-196); v1beta3 introduced the
nested metadata that became v1, which is our "v1" here.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api import v1beta1, v1beta2
from kubernetes_tpu_torch.runtime.scheme import Scheme

__all__ = ["scheme", "VERSIONS", "LATEST_VERSION", "new_scheme"]

LATEST_VERSION = "v1"
OLDEST_VERSION = "v1beta1"
VERSIONS = ("v1", "v1beta1", "v1beta2")
# each legacy version registers from its own wire module
_LEGACY = {"v1beta1": v1beta1, "v1beta2": v1beta2}

_ALL_KINDS = (
    api.Pod, api.PodList,
    api.ReplicationController, api.ReplicationControllerList,
    api.Service, api.ServiceList,
    api.Endpoints, api.EndpointsList,
    api.Node, api.NodeList,
    api.Namespace, api.NamespaceList,
    api.Binding, api.BindingList, api.BindingResultList,
    api.Event, api.EventList,
    api.Secret, api.SecretList,
    api.LimitRange, api.LimitRangeList,
    api.ResourceQuota, api.ResourceQuotaList,
    api.PriorityClass, api.PriorityClassList,
    api.Status,
    api.DeleteOptions,
)


def new_scheme() -> Scheme:
    s = Scheme(default_version=LATEST_VERSION)
    for v in VERSIONS:
        s.add_known_types(v, *_ALL_KINDS)
    for t in _ALL_KINDS:
        kind = getattr(t, "kind", t.__name__) or t.__name__
        for v, mod in _LEGACY.items():
            s.add_conversion(v, kind, mod.encode_for(kind),
                             mod.decode_for(kind))
    for v, mod in _LEGACY.items():
        for wire_kind, kind in mod.KIND_ALIASES.items():
            s.add_kind_alias(v, wire_kind, kind)
        for kind, fn in mod.DEFAULTERS.items():
            s.add_defaulter(v, kind, fn)
        for kind, fn in mod.FIELD_LABELS.items():
            s.add_field_label_conversion(v, kind, fn)
    # v1 applies the same era defaults on decode (ref: v1beta3/defaults.go)
    for kind, fn in v1beta1.DEFAULTERS.items():
        s.add_defaulter("v1", kind, fn)
    return s


# The shared default scheme (ref: api.Scheme package variable).
scheme = new_scheme()
