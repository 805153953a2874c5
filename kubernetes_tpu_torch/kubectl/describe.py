"""Per-kind describers (ref: pkg/kubectl/describe.go).

Port of ``kubernetes_tpu/kubectl/describe.py``.

Each describer renders one object plus related state (a pod's events, an
RC's pod statuses, a service's endpoints) the way ``kubectl describe``
does: Name/Labels/key-fields blocks followed by an events table.
"""

from __future__ import annotations

import io
from typing import Optional

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.kubectl.printers import HumanReadablePrinter, _join_labels

__all__ = ["describe", "PodDescriber", "ReplicationControllerDescriber",
           "ServiceDescriber", "NodeDescriber", "NamespaceDescriber",
           "SecretDescriber", "LimitRangeDescriber", "ResourceQuotaDescriber",
           "PriorityClassDescriber"]


def _events_for(client, obj, namespace: str) -> Optional[api.EventList]:
    try:
        name = obj.metadata.name
        kind = getattr(obj, "kind", "")
        evs = client.resource("events", namespace).list(
            field_selector=f"involvedObject.name={name},involvedObject.kind={kind}")
        return evs
    except Exception:
        return None


def _write_events(out, events: Optional[api.EventList]) -> None:
    if not events or not events.items:
        out.write("No events.\n")
        return
    out.write("Events:\n")
    HumanReadablePrinter().print_obj(events, out)


class PodDescriber:
    def describe(self, client, namespace: str, name: str) -> str:
        pod = client.resource("pods", namespace).get(name)
        out = io.StringIO()
        out.write(f"Name:\t{pod.metadata.name}\n")
        out.write(f"Namespace:\t{pod.metadata.namespace}\n")
        out.write(f"Image(s):\t{', '.join(c.image for c in pod.spec.containers)}\n")
        out.write(f"Host:\t{pod.spec.host or pod.status.host or '<unscheduled>'}\n")
        out.write(f"Labels:\t{_join_labels(pod.metadata.labels)}\n")
        prio = pod.spec.priority
        if prio is not None or pod.spec.priority_class_name:
            out.write(f"Priority:\t{0 if prio is None else prio}\n")
            if pod.spec.priority_class_name:
                out.write(f"Priority Class Name:\t"
                          f"{pod.spec.priority_class_name}\n")
        out.write(f"Status:\t{pod.status.phase or 'Pending'}\n")
        if pod.status.pod_ip:
            out.write(f"IP:\t{pod.status.pod_ip}\n")
        if pod.status.message:
            out.write(f"Message:\t{pod.status.message}\n")
        for cs in pod.status.container_statuses:
            state = "unknown"
            if cs.state.running:
                state = "Running"
            elif cs.state.waiting:
                state = f"Waiting ({cs.state.waiting.reason})"
            elif cs.state.termination:
                state = f"Terminated (exit {cs.state.termination.exit_code})"
            out.write(f"Container:\t{cs.name}\t{state}\trestarts={cs.restart_count}\n")
        _write_events(out, _events_for(client, pod, namespace))
        return out.getvalue()


class ReplicationControllerDescriber:
    def describe(self, client, namespace: str, name: str) -> str:
        rc = client.resource("replicationcontrollers", namespace).get(name)
        out = io.StringIO()
        out.write(f"Name:\t{rc.metadata.name}\n")
        out.write(f"Namespace:\t{rc.metadata.namespace}\n")
        tmpl = rc.spec.template
        images = [c.image for c in tmpl.spec.containers] if tmpl else []
        out.write(f"Image(s):\t{', '.join(images)}\n")
        out.write(f"Selector:\t{_join_labels(rc.spec.selector)}\n")
        out.write(f"Labels:\t{_join_labels(rc.metadata.labels)}\n")
        out.write(f"Replicas:\t{rc.status.replicas} current / "
                  f"{rc.spec.replicas} desired\n")
        # pod status tally (ref: describe.go getPodStatusForController)
        running = waiting = succeeded = failed = 0
        try:
            sel = ",".join(f"{k}={v}" for k, v in sorted(rc.spec.selector.items()))
            pods = client.resource("pods", namespace).list(label_selector=sel)
            for p in pods.items:
                phase = p.status.phase
                if phase == api.PodRunning:
                    running += 1
                elif phase == api.PodSucceeded:
                    succeeded += 1
                elif phase == api.PodFailed:
                    failed += 1
                else:
                    waiting += 1
        except Exception:
            pass
        out.write(f"Pods Status:\t{running} Running / {waiting} Waiting / "
                  f"{succeeded} Succeeded / {failed} Failed\n")
        _write_events(out, _events_for(client, rc, namespace))
        return out.getvalue()


class ServiceDescriber:
    def describe(self, client, namespace: str, name: str) -> str:
        svc = client.resource("services", namespace).get(name)
        out = io.StringIO()
        out.write(f"Name:\t{svc.metadata.name}\n")
        out.write(f"Namespace:\t{svc.metadata.namespace}\n")
        out.write(f"Labels:\t{_join_labels(svc.metadata.labels)}\n")
        out.write(f"Selector:\t{_join_labels(svc.spec.selector)}\n")
        out.write(f"IP:\t{svc.spec.portal_ip}\n")
        out.write(f"Port:\t{svc.spec.port}\n")
        try:
            ep = client.resource("endpoints", namespace).get(name)
            eps = ",".join(f"{e.ip}:{e.port}" for e in ep.endpoints) or "<none>"
        except Exception:
            eps = "<none>"
        out.write(f"Endpoints:\t{eps}\n")
        out.write(f"Session Affinity:\t{svc.spec.session_affinity or 'None'}\n")
        _write_events(out, _events_for(client, svc, namespace))
        return out.getvalue()


class NodeDescriber:
    def describe(self, client, namespace: str, name: str) -> str:
        node = client.resource("nodes", "").get(name)
        out = io.StringIO()
        out.write(f"Name:\t{node.metadata.name}\n")
        out.write(f"Labels:\t{_join_labels(node.metadata.labels)}\n")
        out.write(f"Unschedulable:\t{'true' if node.spec.unschedulable else 'false'}\n")
        out.write("Conditions:\n")
        for c in node.status.conditions:
            out.write(f"  {c.type}\t{c.status}\t{c.reason}\n")
        if node.spec.capacity:
            out.write("Capacity:\n")
            for k, v in sorted(node.spec.capacity.items()):
                out.write(f"  {k}:\t{v}\n")
        # pods on this node (ref: describe.go describeNode)
        try:
            pods = client.resource("pods", "").list(
                field_selector=f"spec.host={name}")
            out.write(f"Pods:\t({len(pods.items)} in total)\n")
            for p in pods.items:
                out.write(f"  {p.metadata.namespace}/{p.metadata.name}\n")
        except Exception:
            pass
        _write_events(out, _events_for(client, node, ""))
        return out.getvalue()


class NamespaceDescriber:
    def describe(self, client, namespace: str, name: str) -> str:
        ns = client.resource("namespaces", "").get(name)
        out = io.StringIO()
        out.write(f"Name:\t{ns.metadata.name}\n")
        out.write(f"Labels:\t{_join_labels(ns.metadata.labels)}\n")
        out.write(f"Status:\t{ns.status.phase or 'Active'}\n")
        return out.getvalue()


class PriorityClassDescriber:
    def describe(self, client, namespace: str, name: str) -> str:
        pc = client.resource("priorityclasses", "").get(name)
        out = io.StringIO()
        out.write(f"Name:\t{pc.metadata.name}\n")
        out.write(f"Value:\t{pc.value}\n")
        out.write(f"GlobalDefault:\t{pc.global_default}\n")
        out.write(f"PreemptionPolicy:\t"
                  f"{pc.preemption_policy or api.PreemptLowerPriority}\n")
        if pc.description:
            out.write(f"Description:\t{pc.description}\n")
        _write_events(out, _events_for(client, pc, ""))
        return out.getvalue()


class SecretDescriber:
    def describe(self, client, namespace: str, name: str) -> str:
        s = client.resource("secrets", namespace).get(name)
        out = io.StringIO()
        out.write(f"Name:\t{s.metadata.name}\n")
        out.write(f"Type:\t{s.type}\n")
        out.write("Data:\n")
        for k, v in sorted(s.data.items()):
            out.write(f"  {k}:\t{len(v)} bytes\n")
        return out.getvalue()


class LimitRangeDescriber:
    def describe(self, client, namespace: str, name: str) -> str:
        lr = client.resource("limitranges", namespace).get(name)
        out = io.StringIO()
        out.write(f"Name:\t{lr.metadata.name}\n")
        out.write("Type\tResource\tMin\tMax\n")
        for item in lr.spec.limits:
            resources = set(item.min) | set(item.max)
            for r in sorted(resources):
                out.write(f"{item.type}\t{r}\t{item.min.get(r, '-')}\t"
                          f"{item.max.get(r, '-')}\n")
        return out.getvalue()


class ResourceQuotaDescriber:
    def describe(self, client, namespace: str, name: str) -> str:
        q = client.resource("resourcequotas", namespace).get(name)
        out = io.StringIO()
        out.write(f"Name:\t{q.metadata.name}\n")
        out.write("Resource\tUsed\tHard\n")
        hard = q.status.hard or q.spec.hard
        for r in sorted(hard):
            out.write(f"{r}\t{q.status.used.get(r, '0')}\t{hard[r]}\n")
        return out.getvalue()


_DESCRIBERS = {
    "pods": PodDescriber,
    "replicationcontrollers": ReplicationControllerDescriber,
    "services": ServiceDescriber,
    "nodes": NodeDescriber,
    "namespaces": NamespaceDescriber,
    "secrets": SecretDescriber,
    "limitranges": LimitRangeDescriber,
    "resourcequotas": ResourceQuotaDescriber,
    "priorityclasses": PriorityClassDescriber,
}


def describe(client, resource: str, namespace: str, name: str) -> str:
    """ref: describe.go DescriberFor."""
    cls = _DESCRIBERS.get(resource)
    if cls is None:
        raise ValueError(f"no describer for resource {resource!r}")
    return cls().describe(client, namespace, name)
