"""Standard admission plugins (ref: plugin/pkg/admission/).

Port of ``kubernetes_tpu/admission/plugins.py``.

- AlwaysAdmit / AlwaysDeny (admit/, deny/)
- NamespaceExists / NamespaceAutoProvision / NamespaceLifecycle (namespace/)
- ResourceDefaults (resourcedefaults/) — default cpu/memory limits
- LimitRanger (limitranger/) — enforce LimitRange min/max, apply defaults
- ResourceQuota (resourcequota/) — live usage accounting via CAS on
  ResourceQuota.Status (the reference's optimistic quota decrement)

Factories take the master's registries via keyword args and are registered in
the shared plugin map so servers select them by name
(ref: cmd/kube-apiserver --admission_control flag).
"""

from __future__ import annotations

from typing import Dict, Optional

from kubernetes_tpu_torch.admission import (
    CREATE,
    UPDATE,
    Attributes,
    Interface,
    register_plugin,
)
from kubernetes_tpu_torch.api import errors
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.quantity import Quantity
from kubernetes_tpu_torch.registry.generic import Context

__all__ = ["AlwaysAdmit", "AlwaysDeny", "NamespaceExists", "NamespaceAutoProvision",
           "NamespaceLifecycle", "ResourceDefaults", "LimitRanger", "ResourceQuota",
           "PriorityDefault"]


class AlwaysAdmit(Interface):
    def __init__(self, **_):
        pass

    def admit(self, attrs: Attributes) -> None:
        return None


class AlwaysDeny(Interface):
    def __init__(self, **_):
        pass

    def admit(self, attrs: Attributes) -> None:
        raise errors.new_forbidden(attrs.resource, attrs.name, "admission is denying all requests")


class _NamespacedBase(Interface):
    # Namespace phase changes are rare; every pod create paying a registry
    # get (decode included) for them dominates the admission cost at 1k
    # pods/s churn. The reference's lifecycle plugin reads from an informer
    # cache for the same reason (plugin/pkg/admission/namespace/lifecycle
    # uses a cache.Store); a short TTL bounds the staleness identically.
    _NS_CACHE_TTL = 0.5

    def __init__(self, namespaces=None, **_):
        self.namespaces = namespaces  # NamespaceRegistry
        self._ns_cache: dict = {}     # name -> (deadline, Namespace | None)

    def _get_ns(self, name: str) -> Optional[api.Namespace]:
        import time as _time

        hit = self._ns_cache.get(name)
        now = _time.monotonic()
        if hit is not None and hit[0] > now:
            return hit[1]
        try:
            ns = self.namespaces.get(Context(), name)
        except errors.StatusError as e:
            if errors.is_not_found(e):
                ns = None
            else:
                raise
        if len(self._ns_cache) >= 1024:
            # bounded: drop expired entries, then fall back to a reset —
            # unbounded growth from churning/bogus namespace names would
            # be a slow leak in the admission hot path
            self._ns_cache = {k: v for k, v in self._ns_cache.items()
                              if v[0] > now}
            if len(self._ns_cache) >= 1024:
                self._ns_cache.clear()
        self._ns_cache[name] = (now + self._NS_CACHE_TTL, ns)
        return ns

    def _invalidate_ns(self, name: str) -> None:
        self._ns_cache.pop(name, None)


class NamespaceExists(_NamespacedBase):
    """Reject writes into namespaces that do not exist."""

    def admit(self, attrs: Attributes) -> None:
        if not attrs.namespace or attrs.resource == "namespaces":
            return
        if self._get_ns(attrs.namespace) is None:
            raise errors.new_forbidden("Namespace", attrs.namespace,
                                       f"namespace {attrs.namespace} does not exist")


class NamespaceAutoProvision(_NamespacedBase):
    """Create namespaces on first use (ref: namespace/autoprovision —
    CREATE only, admission.go:50: a typo'd namespace in a delete must not
    materialize a namespace)."""

    def admit(self, attrs: Attributes) -> None:
        if attrs.operation != CREATE or not attrs.namespace or attrs.resource == "namespaces":
            return
        if self._get_ns(attrs.namespace) is None:
            try:
                self.namespaces.create(
                    Context(), api.Namespace(metadata=api.ObjectMeta(name=attrs.namespace)))
            except errors.StatusError as e:
                if not errors.is_already_exists(e):
                    raise
            self._invalidate_ns(attrs.namespace)  # cached None is now stale


class NamespaceLifecycle(_NamespacedBase):
    """Reject creates in Terminating namespaces (ref: namespace/lifecycle)."""

    def admit(self, attrs: Attributes) -> None:
        if not attrs.namespace or attrs.resource == "namespaces" or attrs.operation != CREATE:
            return
        ns = self._get_ns(attrs.namespace)
        if ns is not None and ns.status.phase == api.NamespaceTerminating:
            raise errors.new_forbidden(
                "Namespace", attrs.namespace,
                f"cannot create new content in namespace {attrs.namespace} "
                "because it is being terminated")


class ResourceDefaults(Interface):
    """Apply default cpu/memory limits to containers that set none
    (ref: resourcedefaults/admission.go: 100m CPU / 512Mi memory)."""

    DEFAULT_CPU = "100m"
    DEFAULT_MEMORY = "512Mi"

    def __init__(self, **_):
        pass

    def admit(self, attrs: Attributes) -> None:
        if attrs.resource != "pods" or attrs.operation not in (CREATE, UPDATE) \
                or attrs.subresource:
            return
        pod = attrs.obj
        for c in pod.spec.containers:
            limits = c.resources.limits
            if api.ResourceCPU not in limits:
                limits[api.ResourceCPU] = Quantity(self.DEFAULT_CPU)
            if api.ResourceMemory not in limits:
                limits[api.ResourceMemory] = Quantity(self.DEFAULT_MEMORY)


class PriorityDefault(Interface):
    """kube-preempt admission-defaulting: resolve a pod's
    spec.priorityClassName into the integer spec.priority (and inherit the
    class's preemptionPolicy when the pod sets none) — the analog of the
    upstream Priority admission plugin. Rules:

    - a named class must exist (unknown name -> 400-class Invalid);
    - an explicitly pre-set spec.priority must MATCH the named class's
      value (only the admission chain may invent priorities);
    - with no class named, the globalDefault class (if any) applies,
      else priority resolves to 0 (DefaultPodPriority).

    Class lookups ride a short-TTL cache like the namespace plugins:
    priority classes change rarely, pod creates at churn rate should not
    pay a registry decode each.
    """

    _PC_CACHE_TTL = 1.0

    def __init__(self, priorityclasses=None, **_):
        self.priorityclasses = priorityclasses
        self._cache: dict = {}   # name ("" = globalDefault) -> (deadline, pc)

    def _get_class(self, name: str) -> Optional[api.PriorityClass]:
        import time as _time

        now = _time.monotonic()
        hit = self._cache.get(name)
        if hit is not None and hit[0] > now:
            return hit[1]
        pc: Optional[api.PriorityClass] = None
        if name:
            try:
                pc = self.priorityclasses.get(Context(), name)
            except errors.StatusError as e:
                if not errors.is_not_found(e):
                    raise
        else:
            pc = next((c for c in
                       self.priorityclasses.list(Context()).items
                       if c.global_default), None)
        if len(self._cache) >= 1024:
            self._cache = {k: v for k, v in self._cache.items()
                           if v[0] > now}
            if len(self._cache) >= 1024:
                self._cache.clear()
        self._cache[name] = (now + self._PC_CACHE_TTL, pc)
        return pc

    def admit(self, attrs: Attributes) -> None:
        if attrs.resource != "pods" or attrs.operation != CREATE \
                or attrs.subresource:
            return
        if self.priorityclasses is None:
            return
        pod = attrs.obj
        spec = pod.spec
        pc = self._get_class(spec.priority_class_name)
        if spec.priority_class_name and pc is None:
            raise errors.new_invalid(
                "Pod", pod.metadata.name,
                [ValueError(f"spec.priorityClassName: no PriorityClass "
                            f"named {spec.priority_class_name!r}")])
        value = pc.value if pc is not None else api.DefaultPodPriority
        if spec.priority is not None and spec.priority != value:
            raise errors.new_invalid(
                "Pod", pod.metadata.name,
                [ValueError(f"spec.priority: {spec.priority} conflicts "
                            f"with the resolved class value {value}")])
        spec.priority = value
        if pc is not None and not spec.preemption_policy:
            spec.preemption_policy = pc.preemption_policy


class LimitRanger(Interface):
    """Enforce LimitRange min/max per container (ref: limitranger/admission.go)."""

    def __init__(self, limitranges=None, **_):
        self.limitranges = limitranges

    def admit(self, attrs: Attributes) -> None:
        if attrs.resource != "pods" or attrs.operation not in (CREATE, UPDATE) \
                or attrs.subresource:
            return
        lst = self.limitranges.list(Context(namespace=attrs.namespace))
        pod = attrs.obj
        for lr in lst.items:
            for item in lr.spec.limits:
                if item.type == "Container":
                    self._admit_containers(pod, item)
                elif item.type == "Pod":
                    self._admit_pod(pod, item)

    @staticmethod
    def _container_value(c: api.Container, resource: str) -> Quantity:
        return c.resources.limits.get(resource) or Quantity("0")

    def _admit_containers(self, pod: api.Pod, item: api.LimitRangeItem) -> None:
        for c in pod.spec.containers:
            for resource, q in (item.default or {}).items():
                if resource not in c.resources.limits:
                    c.resources.limits[resource] = q.copy()
            for resource, mx in (item.max or {}).items():
                v = self._container_value(c, resource)
                if v > mx:
                    raise errors.new_forbidden(
                        "Pod", pod.metadata.name,
                        f"container {c.name} {resource} limit {v} exceeds maximum {mx}")
            for resource, mn in (item.min or {}).items():
                v = self._container_value(c, resource)
                if v < mn:
                    raise errors.new_forbidden(
                        "Pod", pod.metadata.name,
                        f"container {c.name} {resource} limit {v} below minimum {mn}")

    def _admit_pod(self, pod: api.Pod, item: api.LimitRangeItem) -> None:
        for resource, mx in (item.max or {}).items():
            total = Quantity("0")
            for c in pod.spec.containers:
                total = total + self._container_value(c, resource)
            if total > mx:
                raise errors.new_forbidden(
                    "Pod", pod.metadata.name,
                    f"pod total {resource} {total} exceeds maximum {mx}")


def _object_count_resource(resource: str) -> Optional[str]:
    return {
        "pods": api.ResourcePods,
        "services": api.ResourceServices,
        "replicationcontrollers": api.ResourceReplicationControllers,
        "secrets": api.ResourceSecrets,
        "resourcequotas": api.ResourceQuotas,
    }.get(resource)


class ResourceQuota(Interface):
    """Live quota accounting: CAS-increment ResourceQuota.Status.Used on
    create, reject when over hard limits (ref: resourcequota/admission.go)."""

    def __init__(self, resourcequotas=None, **_):
        self.quotas = resourcequotas

    def admit(self, attrs: Attributes) -> None:
        # Sub-resource writes (bindings, status) never change quota usage;
        # DELETE is uncounted here — usage is recomputed by the quota
        # controller, matching the reference (resourcequota/admission.go:70).
        if attrs.operation != CREATE or not attrs.namespace or attrs.subresource:
            return
        counted = _object_count_resource(attrs.resource)
        if counted is None:
            return
        ctx = Context(namespace=attrs.namespace)
        for quota in self.quotas.list(ctx).items:
            self._charge(ctx, quota, counted, attrs)

    def _charge(self, ctx: Context, quota: api.ResourceQuota, counted: str,
                attrs: Attributes) -> None:
        # Skip the CAS write entirely when this quota tracks nothing relevant
        # to the request — avoids spurious MODIFIED events and contention.
        hard_now = quota.spec.hard or {}
        relevant = counted in hard_now or (
            attrs.resource == "pods"
            and any(r in hard_now for r in (api.ResourceCPU, api.ResourceMemory)))
        if not relevant:
            return
        # NOTE: a charge is not rolled back if the registry write later fails;
        # the quota controller recomputes usage periodically, exactly like the
        # reference (admission charges, resource_quota_controller.go reconciles).
        key = self.quotas.key(ctx, quota.metadata.name)

        def bump(cur: api.ResourceQuota) -> api.ResourceQuota:
            hard = cur.spec.hard or {}
            used = dict(cur.status.used or {})
            deltas: Dict[str, Quantity] = {}
            if counted in hard:
                deltas[counted] = Quantity("1")
            if attrs.resource == "pods" and attrs.obj is not None:
                for rname in (api.ResourceCPU, api.ResourceMemory):
                    if rname in hard:
                        total = Quantity("0")
                        for c in attrs.obj.spec.containers:
                            q = c.resources.limits.get(rname)
                            if q:
                                total = total + q
                        deltas[rname] = total
            for rname, delta in deltas.items():
                new_used = used.get(rname, Quantity("0")) + delta
                if new_used > hard[rname]:
                    raise errors.new_forbidden(
                        attrs.resource, attrs.name,
                        f"{rname} quota exceeded in namespace {attrs.namespace}: "
                        f"used {used.get(rname, Quantity('0'))} + {delta} > hard {hard[rname]}")
                used[rname] = new_used
            cur.status.hard = dict(hard)
            cur.status.used = used
            return cur

        self.quotas.helper.atomic_update(key, api.ResourceQuota, bump)


register_plugin("AlwaysAdmit", AlwaysAdmit)
register_plugin("AlwaysDeny", AlwaysDeny)
register_plugin("NamespaceExists", NamespaceExists)
register_plugin("NamespaceAutoProvision", NamespaceAutoProvision)
register_plugin("NamespaceLifecycle", NamespaceLifecycle)
register_plugin("ResourceDefaults", ResourceDefaults)
register_plugin("LimitRanger", LimitRanger)
register_plugin("ResourceQuota", ResourceQuota)
register_plugin("PriorityDefault", PriorityDefault)
