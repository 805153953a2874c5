"""Per-resource registries: strategies + resource-specific REST extras.

Port of ``kubernetes_tpu/registry/resources.py``.

Rebuild of ``pkg/registry/{pod,controller,service,endpoint,minion,event,
namespace,secret,limitrange,resourcequota}/``. Each resource is a Strategy
over the GenericRegistry plus, where the reference has them, special verbs:

- pods: **BindingREST** — the scheduler's write path: Create(Binding) performs
  an atomic CAS setting spec.host iff currently empty
  (ref: pkg/registry/pod/etcd/etcd.go:98-152 assignPod), plus a status
  sub-resource update.
- services: portal IP allocation from a bitmap allocator
  (ref: pkg/registry/service/ip_allocator.go:29-241).
- events: TTL'd storage.
- namespaces: deletion flips status.phase to Terminating; the finalize
  sub-resource removes finalizers; actual deletion requires empty finalizers
  (ref: pkg/registry/namespace/etcd/etcd.go + namespace lifecycle design).
"""

from __future__ import annotations

import threading
from typing import List, Optional

from kubernetes_tpu_torch.api import errors
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api import validation
from kubernetes_tpu_torch.api.meta import accessor
from kubernetes_tpu_torch.registry.generic import Context, GenericRegistry, Strategy
from kubernetes_tpu_torch.storage.helper import StoreHelper
from kubernetes_tpu_torch.util import tracing

__all__ = [
    "make_pod_registry", "BindingREST", "PodStatusREST",
    "make_rc_registry", "make_service_registry", "make_endpoints_registry",
    "make_node_registry", "make_event_registry", "make_namespace_registry",
    "NamespaceFinalizeREST", "make_secret_registry", "make_limitrange_registry",
    "make_resourcequota_registry", "ResourceQuotaStatusREST", "IPAllocator",
    "make_priorityclass_registry",
]


# ---------------------------------------------------------------------------
# Pods
# ---------------------------------------------------------------------------


class PodStrategy(Strategy):
    kind = "Pod"
    namespaced = True

    def prepare_for_create(self, ctx, pod: api.Pod) -> None:
        pod.status = api.PodStatus(phase=api.PodPending)

    def validate(self, ctx, pod: api.Pod) -> List[Exception]:
        return validation.validate_pod(pod)

    def prepare_for_update(self, ctx, new: api.Pod, old: api.Pod) -> None:
        pass

    def validate_update(self, ctx, new: api.Pod, old: api.Pod) -> List[Exception]:
        return validation.validate_pod_update(new, old)


def pod_attr_func(pod: api.Pod):
    """Pod label/field attributes (ref: pkg/registry/pod/rest.go
    PodToSelectableFields — the scheduler selects on spec.host='')."""
    return accessor.labels(pod), {
        "metadata.name": pod.metadata.name,
        "spec.host": pod.spec.host,
        "status.phase": pod.status.phase,
    }


def make_pod_registry(helper: StoreHelper) -> GenericRegistry:
    return GenericRegistry(helper, "/registry/pods", api.Pod, api.PodList,
                           PodStrategy(), attr_func=pod_attr_func)


class BindingREST:
    """POST /bindings (ref: pkg/registry/pod/etcd/etcd.go:98-152).

    The bind is an AtomicUpdate that sets spec.host iff it is empty — the
    CAS guard that makes concurrent schedulers safe.
    """

    kind = "Binding"

    def __init__(self, pod_registry: GenericRegistry):
        self.pods = pod_registry

    @staticmethod
    def _assign_fn(name: str, host: str):
        def assign(pod: api.Pod) -> api.Pod:
            if pod.spec.host:
                raise errors.new_conflict(
                    "Pod", name,
                    f"pod {name} is already assigned to host {pod.spec.host!r}")
            pod.spec.host = host
            pod.status.host = host
            return pod
        return assign

    @staticmethod
    def _migrate_fn(name: str, host: str, from_host: str, pod_uid: str):
        """kube-defrag: the migration bind — evict-here + bind-there as one
        atomic host swap on the pod object. Guards: the pod must still be
        on ``from_host`` (a concurrent scheduler/preemption bind loses the
        race 409) and, when given, still carry ``pod_uid`` (deletion +
        name-reuse between proposal and commit 409s instead of moving a
        stranger). Either the swap commits whole or nothing is applied."""
        def migrate(pod: api.Pod) -> api.Pod:
            if pod_uid and pod.metadata.uid != pod_uid:
                raise errors.new_conflict(
                    "Pod", name,
                    f"pod {name} uid changed since the defrag proposal "
                    f"(re-solve required)")
            if pod.spec.host != from_host:
                raise errors.new_conflict(
                    "Pod", name,
                    f"pod {name} is on host {pod.spec.host!r}, not "
                    f"{from_host!r} (re-solve required)")
            pod.spec.host = host
            pod.status.host = host
            return pod
        return migrate

    def create(self, ctx: Context, binding: api.Binding) -> api.Status:
        if isinstance(binding, api.BindingList):
            return self.create_many(ctx, binding)
        name = binding.pod_name or binding.metadata.name
        if not name:
            raise errors.new_bad_request("binding must name a pod")
        if not binding.host:
            raise errors.new_bad_request("binding must name a host")
        if binding.victims or binding.from_host:
            # the single-binding form of the evict+bind item: one-element
            # batch, same all-or-nothing transaction
            res = self.create_many(ctx.with_namespace(
                ctx.namespace or binding.metadata.namespace),
                api.BindingList(items=[binding]))
            r = res.items[0]
            if r.error:
                raise errors.StatusError(api.Status(
                    status=api.StatusFailure, message=r.error, code=r.code,
                    reason=api.ReasonConflict if r.code == 409 else ""))
            return api.Status(status=api.StatusSuccess)
        key = self.pods.key(ctx, name)
        self.pods.helper.atomic_update(key, api.Pod,
                                       self._assign_fn(name, binding.host))
        return api.Status(status=api.StatusSuccess)

    def create_many(self, ctx: Context, bindings: api.BindingList,
                    on_bound=None) -> api.BindingResultList:
        """One transactional store pass for a whole wave's bindings (the
        batched form of the CAS bind; see api.BindingList). Every item is
        scoped to the REQUEST namespace — authorization and admission ran
        against that namespace only, so an item naming another namespace
        is rejected per-item rather than silently escaping the checks
        (callers batch per namespace; the scheduler does).

        ``on_bound`` (optional) is called with each successfully bound
        pod (its committed post-bind revision) — the apiserver's
        encode-once seam: the HTTP layer serializes the revision here,
        at commit, so fanning its watch event out is a byte copy.

        kube-preempt: an item carrying ``victims`` commits as ONE
        all-or-nothing transaction — every victim pod deleted (its
        watch DELETE event drives the normal kubelet teardown) AND the
        pod bound, or a per-item 409 and nothing applied. Victims are
        namespace-pinned to the request exactly like the binding;
        victim uids guard against name reuse; an already-gone victim
        counts as evicted (the eviction's goal state)."""
        updates = []
        results = [api.BindingResult() for _ in bindings.items]
        slot_map = []
        evict_items = []     # (pod_key, assign_fn, [(victim_key, uid)])
        evict_slots = []
        for i, b in enumerate(bindings.items):
            name = b.pod_name or b.metadata.name
            results[i].pod_name = name
            if not name or not b.host:
                results[i].error = "binding must name a pod and a host"
                results[i].code = 400
                continue
            if b.metadata.namespace and b.metadata.namespace != ctx.namespace:
                results[i].error = (
                    f"binding namespace {b.metadata.namespace!r} does not "
                    f"match request namespace {ctx.namespace!r}")
                results[i].code = 403
                continue
            if b.victims or b.from_host:
                if any(not v.name for v in b.victims):
                    results[i].error = "every victim must name a pod"
                    results[i].code = 400
                    continue
                # victims may live in other namespaces (the node is a
                # shared resource); Master.bind_batch authorized DELETE
                # against every victim namespace the wave touches.
                # kube-defrag migrations (from_host set) ride the same
                # transactional lane: the guarded host swap and any victim
                # deletes commit whole or 409 with nothing applied.
                fn = (self._migrate_fn(name, b.host, b.from_host, b.pod_uid)
                      if b.from_host else self._assign_fn(name, b.host))
                evict_items.append((
                    self.pods.key(ctx, name),
                    fn,
                    [(self.pods.key(
                        ctx.with_namespace(v.namespace or ctx.namespace),
                        v.name), v.uid)
                     for v in b.victims]))
                evict_slots.append(i)
                continue
            updates.append((self.pods.key(ctx, name),
                            self._assign_fn(name, b.host)))
            slot_map.append(i)
        with tracing.child_span("store.bind_batch", bindings=len(updates),
                                evict_binds=len(evict_items)):
            outcomes = self.pods.helper.atomic_update_many(api.Pod, updates)
            evict_outcomes = self.pods.helper.atomic_bind_evict_many(
                api.Pod, evict_items) if evict_items else []
        for i, oc in zip(slot_map + evict_slots,
                         list(outcomes) + list(evict_outcomes)):
            if isinstance(oc, errors.StatusError):
                results[i].error = oc.status.message
                results[i].code = oc.status.code
            elif on_bound is not None:
                try:
                    on_bound(oc)
                except Exception:
                    pass  # seeding is best-effort, never fails a bind
        return api.BindingResultList(items=results)

    # only create is implemented; the storage map exposure must answer the
    # other verbs with 405 like every resource, not AttributeError 500s
    def get(self, ctx, name):
        raise errors.new_method_not_supported("bindings", "get")

    def list(self, ctx, *a, **kw):
        raise errors.new_method_not_supported("bindings", "list")

    def watch(self, ctx, *a, **kw):
        raise errors.new_method_not_supported("bindings", "watch")

    def update(self, ctx, obj):
        raise errors.new_method_not_supported("bindings", "update")

    def delete(self, ctx, name):
        raise errors.new_method_not_supported("bindings", "delete")


class PodStatusREST:
    """PUT pods/{name}/status — status-only update sub-resource.

    A status that names a host other than the one the pod is bound to is
    refused (409), in the same transaction as the write: a kubelet whose
    sync of a pod was under way when the descheduler migrated the pod
    away would otherwise write its own host back into ``status.host``
    after the new node's kubelet wrote its status, and the pod would stay
    bound to one node with the status of another."""

    def __init__(self, pod_registry: GenericRegistry):
        self.pods = pod_registry

    def update(self, ctx: Context, pod: api.Pod) -> api.Pod:
        key = self.pods.key(ctx, pod.metadata.name)

        def set_status(current: api.Pod) -> api.Pod:
            host = current.spec.host
            if pod.status.host and host and pod.status.host != host:
                raise errors.new_conflict(
                    "Pod", pod.metadata.name,
                    f"pod {pod.metadata.name} is bound to host {host!r}, "
                    f"not {pod.status.host!r}")
            current.status = pod.status
            return current

        return self.pods.helper.atomic_update(key, api.Pod, set_status)


# ---------------------------------------------------------------------------
# ReplicationControllers
# ---------------------------------------------------------------------------


class RCStrategy(Strategy):
    kind = "ReplicationController"

    def prepare_for_create(self, ctx, rc: api.ReplicationController) -> None:
        rc.status = api.ReplicationControllerStatus()

    def validate(self, ctx, rc) -> List[Exception]:
        return validation.validate_replication_controller(rc)

    def validate_update(self, ctx, new, old) -> List[Exception]:
        return validation.validate_replication_controller(new)


def make_rc_registry(helper: StoreHelper) -> GenericRegistry:
    return GenericRegistry(helper, "/registry/controllers", api.ReplicationController,
                           api.ReplicationControllerList, RCStrategy())


# ---------------------------------------------------------------------------
# Services + portal IP allocation
# ---------------------------------------------------------------------------


class IPAllocator:
    """Bitmap allocator over a /24-ish CIDR
    (ref: pkg/registry/service/ip_allocator.go:29-241)."""

    def __init__(self, cidr: str = "10.0.0.0/24"):
        import ipaddress

        self.network = ipaddress.ip_network(cidr)
        self._lock = threading.Lock()
        self._used = set()
        # network and broadcast addresses are never handed out
        self._reserved = {self.network.network_address, self.network.broadcast_address}

    def allocate(self, ip: Optional[str] = None) -> str:
        import ipaddress

        with self._lock:
            if ip:
                addr = ipaddress.ip_address(ip)
                if addr not in self.network or addr in self._reserved:
                    raise errors.new_invalid("Service", ip,
                                             [ValueError(f"{ip} not usable in portal net {self.network}")])
                if addr in self._used:
                    raise errors.new_conflict("Service", ip, f"portal IP {ip} already allocated")
                self._used.add(addr)
                return str(addr)
            for addr in self.network.hosts():
                if addr not in self._used and addr not in self._reserved:
                    self._used.add(addr)
                    return str(addr)
            raise errors.new_internal_error("portal IP range exhausted")

    def release(self, ip: str) -> None:
        import ipaddress

        with self._lock:
            self._used.discard(ipaddress.ip_address(ip))


class ServiceStrategy(Strategy):
    kind = "Service"

    def validate(self, ctx, svc) -> List[Exception]:
        return validation.validate_service(svc)

    def validate_update(self, ctx, new, old) -> List[Exception]:
        errs = validation.validate_service(new)
        if old.spec.portal_ip and new.spec.portal_ip != old.spec.portal_ip:
            errs.append(ValueError("spec.portalIP: may not be changed"))
        return errs


class ServiceRegistry(GenericRegistry):
    """Service storage owning portal-IP lifecycle
    (ref: pkg/registry/service/rest.go Create/Delete)."""

    def __init__(self, helper: StoreHelper, allocator: Optional[IPAllocator] = None,
                 cloud=None, node_lister=None):
        super().__init__(helper, "/registry/services", api.Service, api.ServiceList,
                         ServiceStrategy())
        self.allocator = allocator or IPAllocator()
        # cloud external load balancers (ref: pkg/registry/service/rest.go
        # Create/Delete cloud hooks); node_lister() -> [hostnames]
        self.cloud = cloud
        self.node_lister = node_lister
        # Rebuild the allocation bitmap from pre-existing services, like the
        # reference does on startup (ip_allocator.go) — a Master over an
        # existing store must not hand out IPs already in use.
        for svc in self.helper.extract_to_list(self.prefix, api.ServiceList).items:
            if svc.spec.portal_ip:
                try:
                    self.allocator.allocate(svc.spec.portal_ip)
                except errors.StatusError:
                    pass  # duplicate/bad legacy data: leave as-is

    def _lb(self):
        return self.cloud.tcp_load_balancer() if self.cloud else None

    def _region(self) -> str:
        zones = self.cloud.zones() if self.cloud else None
        return zones.get_zone().region if zones else ""

    def create(self, ctx: Context, svc: api.Service) -> api.Service:
        ip = self.allocator.allocate(svc.spec.portal_ip or None)
        svc.spec.portal_ip = ip
        try:
            created = super().create(ctx, svc)
        except Exception:
            self.allocator.release(ip)
            raise
        lb = self._lb()
        if lb is not None and svc.spec.create_external_load_balancer:
            # ref: service/rest.go Create — build the cloud balancer over
            # the current node set; ANY failure here (node list, zone
            # lookup, the LB call) rolls the service back
            try:
                hosts = list(self.node_lister()) if self.node_lister else []
                lb.create_tcp_load_balancer(
                    svc.metadata.name, self._region(),
                    svc.spec.public_ips[0] if svc.spec.public_ips else "",
                    svc.spec.port, hosts)
            except Exception as e:
                super().delete(ctx, svc.metadata.name)
                self.allocator.release(ip)
                raise errors.new_internal_error(
                    f"failed to create external load balancer: {e}")
        return created

    def delete(self, ctx: Context, name: str) -> api.Status:
        svc = self.get(ctx, name)
        status = super().delete(ctx, name)
        if svc.spec.portal_ip:
            self.allocator.release(svc.spec.portal_ip)
        lb = self._lb()
        if lb is not None and svc.spec.create_external_load_balancer:
            try:
                lb.delete_tcp_load_balancer(name, self._region())
            except Exception:
                pass  # ref: rest.go logs and continues
        return status


def make_service_registry(helper: StoreHelper,
                          allocator: Optional[IPAllocator] = None,
                          cloud=None, node_lister=None) -> ServiceRegistry:
    return ServiceRegistry(helper, allocator, cloud=cloud,
                           node_lister=node_lister)


class EndpointsStrategy(Strategy):
    kind = "Endpoints"
    allow_create_on_update = True


def make_endpoints_registry(helper: StoreHelper) -> GenericRegistry:
    return GenericRegistry(helper, "/registry/endpoints", api.Endpoints,
                           api.EndpointsList, EndpointsStrategy())


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------


class NodeStrategy(Strategy):
    kind = "Node"
    namespaced = False

    def validate(self, ctx, node) -> List[Exception]:
        return validation.validate_node(node)


def node_attr_func(node: api.Node):
    return accessor.labels(node), {
        "metadata.name": node.metadata.name,
        "spec.unschedulable": str(node.spec.unschedulable).lower(),
    }


def make_node_registry(helper: StoreHelper) -> GenericRegistry:
    return GenericRegistry(helper, "/registry/minions", api.Node, api.NodeList,
                           NodeStrategy(), attr_func=node_attr_func)


# ---------------------------------------------------------------------------
# Events (TTL'd)
# ---------------------------------------------------------------------------


class EventStrategy(Strategy):
    kind = "Event"
    allow_create_on_update = True

    def validate(self, ctx, ev) -> List[Exception]:
        return validation.validate_event(ev)

    def validate_update(self, ctx, new, old) -> List[Exception]:
        return validation.validate_event(new)


def event_attr_func(ev: api.Event):
    """Event selectable fields (ref: pkg/registry/event getAttrs /
    EventToSelectableFields): kubectl describe lists a pod's events with
    ``involvedObject.name=...,involvedObject.kind=...`` — without these
    the describe events table silently matched nothing, so the
    kube-explain FailedScheduling breakdown (and every other event) was
    invisible to ``kubectl describe pod``."""
    ref = ev.involved_object
    return accessor.labels(ev), {
        "metadata.name": ev.metadata.name,
        "involvedObject.kind": ref.kind,
        "involvedObject.namespace": ref.namespace,
        "involvedObject.name": ref.name,
        "involvedObject.uid": ref.uid,
        "reason": ev.reason,
        "source": ev.source.component,
    }


def make_event_registry(helper: StoreHelper, ttl_seconds: float = 3600.0) -> GenericRegistry:
    """ref: pkg/registry/event/registry.go — events carry an etcd TTL."""
    return GenericRegistry(helper, "/registry/events", api.Event, api.EventList,
                           EventStrategy(), ttl_func=lambda ev: ttl_seconds,
                           attr_func=event_attr_func)


# ---------------------------------------------------------------------------
# Namespaces (finalizer-driven termination)
# ---------------------------------------------------------------------------


class NamespaceStrategy(Strategy):
    kind = "Namespace"
    namespaced = False

    def prepare_for_create(self, ctx, ns: api.Namespace) -> None:
        ns.status = api.NamespaceStatus(phase=api.NamespaceActive)
        if api.FinalizerKubernetes not in ns.spec.finalizers:
            ns.spec.finalizers.append(api.FinalizerKubernetes)

    def validate(self, ctx, ns) -> List[Exception]:
        return validation.validate_namespace(ns)


class NamespaceRegistry(GenericRegistry):
    """DELETE marks Terminating while finalizers remain; the namespace
    controller drains content, finalizes, and re-deletes
    (ref: namespace lifecycle, pkg/registry/namespace/)."""

    def __init__(self, helper: StoreHelper):
        super().__init__(helper, "/registry/namespaces", api.Namespace,
                         api.NamespaceList, NamespaceStrategy())

    def delete(self, ctx: Context, name: str) -> api.Status:
        ns = self.get(ctx, name)
        if ns.spec.finalizers:
            def terminate(cur: api.Namespace) -> api.Namespace:
                cur.status.phase = api.NamespaceTerminating
                return cur

            self.helper.atomic_update(self.key(ctx, name), api.Namespace, terminate)
            return api.Status(status=api.StatusSuccess,
                              reason="Terminating",
                              message=f"namespace {name} is terminating; "
                                      "content is being drained")
        return super().delete(ctx, name)


class NamespaceFinalizeREST:
    """PUT namespaces/{name}/finalize — replace spec.finalizers."""

    def __init__(self, registry: NamespaceRegistry):
        self.registry = registry

    def update(self, ctx: Context, ns: api.Namespace) -> api.Namespace:
        key = self.registry.key(ctx, ns.metadata.name)

        def fin(cur: api.Namespace) -> api.Namespace:
            cur.spec.finalizers = list(ns.spec.finalizers)
            return cur

        return self.registry.helper.atomic_update(key, api.Namespace, fin)


def make_namespace_registry(helper: StoreHelper) -> NamespaceRegistry:
    return NamespaceRegistry(helper)


# ---------------------------------------------------------------------------
# Secrets, LimitRanges, ResourceQuotas
# ---------------------------------------------------------------------------


class SecretStrategy(Strategy):
    kind = "Secret"

    def validate(self, ctx, s) -> List[Exception]:
        import base64

        errs = validation.validate_object_meta(s.metadata, namespaced=True)
        total = 0
        for k, v in (s.data or {}).items():
            # each key becomes a filename in the secret volume — it must be a
            # DNS-1123 subdomain (ref: pkg/api/validation/validation.go
            # ValidateSecret:1010), which also forbids path separators / '..'
            if not validation.is_dns1123_subdomain(k):
                errs.append(ValueError(
                    f"data[{k}]: key must be a DNS-1123 subdomain"))
                continue
            try:
                total += len(base64.b64decode(v, validate=True))
            except Exception:
                errs.append(ValueError(f"data[{k}]: not valid base64"))
        if total > 1024 * 1024:
            errs.append(ValueError("secret data exceeds 1MB"))
        return errs


def make_secret_registry(helper: StoreHelper) -> GenericRegistry:
    return GenericRegistry(helper, "/registry/secrets", api.Secret, api.SecretList,
                           SecretStrategy())


class LimitRangeStrategy(Strategy):
    kind = "LimitRange"


def make_limitrange_registry(helper: StoreHelper) -> GenericRegistry:
    return GenericRegistry(helper, "/registry/limitranges", api.LimitRange,
                           api.LimitRangeList, LimitRangeStrategy())


class ResourceQuotaStrategy(Strategy):
    kind = "ResourceQuota"

    def prepare_for_create(self, ctx, q: api.ResourceQuota) -> None:
        q.status = api.ResourceQuotaStatus(hard=dict(q.spec.hard))


def make_resourcequota_registry(helper: StoreHelper) -> GenericRegistry:
    return GenericRegistry(helper, "/registry/resourcequotas", api.ResourceQuota,
                           api.ResourceQuotaList, ResourceQuotaStrategy())


class PriorityClassStrategy(Strategy):
    """kube-preempt: cluster-scoped PriorityClass storage. Beyond field
    validation, create/update check the at-most-one-globalDefault
    invariant against the stored set. The check is list-then-write (no
    cross-key transaction spans it), so two concurrent globalDefault
    creates racing through separate apiserver workers can still both
    land — the same window the upstream apiserver has; PriorityDefault
    admission tolerates that state (it resolves to SOME globalDefault
    deterministically per process) and the serial case is rejected."""

    kind = "PriorityClass"
    namespaced = False

    def __init__(self, registry_ref):
        # late-bound reference: the strategy needs the registry's list()
        # for the globalDefault check, and the registry needs the strategy
        self._registry = registry_ref

    def _global_default_conflict(self, pc: api.PriorityClass):
        if not pc.global_default:
            return None
        for other in self._registry[0].list(Context()).items:
            if other.global_default and other.metadata.name != pc.metadata.name:
                return other.metadata.name
        return None

    def validate(self, ctx, pc: api.PriorityClass) -> List[Exception]:
        errs = list(validation.validate_priority_class(pc))
        clash = self._global_default_conflict(pc)
        if clash:
            errs.append(ValueError(
                f"globalDefault: PriorityClass {clash!r} is already the "
                "global default"))
        return errs

    def validate_update(self, ctx, new, old) -> List[Exception]:
        errs = list(validation.validate_priority_class(new))
        if new.value != old.value:
            # upstream parity: the value is immutable post-creation (the
            # scheduler caches resolved priorities on pods)
            errs.append(ValueError("value: may not be changed"))
        clash = self._global_default_conflict(new)
        if clash:
            errs.append(ValueError(
                f"globalDefault: PriorityClass {clash!r} is already the "
                "global default"))
        return errs


def make_priorityclass_registry(helper: StoreHelper) -> GenericRegistry:
    ref: list = []
    reg = GenericRegistry(helper, "/registry/priorityclasses",
                          api.PriorityClass, api.PriorityClassList,
                          PriorityClassStrategy(ref))
    ref.append(reg)
    return reg


class ResourceQuotaStatusREST:
    """PUT resourcequotas/{name}/status — used by the quota admission plugin's
    CAS-based usage decrement (ref: plugin/pkg/admission/resourcequota)."""

    def __init__(self, registry: GenericRegistry):
        self.registry = registry

    def update(self, ctx: Context, quota: api.ResourceQuota) -> api.ResourceQuota:
        key = self.registry.key(ctx, quota.metadata.name)
        expect_rv = quota.metadata.resource_version

        def set_status(cur: api.ResourceQuota) -> api.ResourceQuota:
            if expect_rv and cur.metadata.resource_version != expect_rv:
                raise errors.new_conflict("ResourceQuota", quota.metadata.name)
            cur.status = quota.status
            return cur

        return self.registry.helper.atomic_update(key, api.ResourceQuota, set_status)
