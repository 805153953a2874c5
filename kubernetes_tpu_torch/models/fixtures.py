"""Synthetic clusters at the benchmark's published shapes.

Port of ``bench.py:build_cluster`` (:518-571), ``affinity_policy``
(:489-502) and ``build_priority_cluster`` (:763-821): nodes with 16 cpu
and 64Gi memory (plus 256Gi ephemeral storage for the three-resource
shape), labelled by zone and disk; eight services; two existing pods per
node; a pending batch whose requests, service labels and host ports cycle
deterministically, or gangs of ``gang_size`` members; and the preemption
cluster, every node filled to capacity by pods of two low priorities
before a storm of high-priority pods. ``FULL_SHAPES`` mirrors
``bench.py:507-515`` for the shapes the port drives (``mesh``, the
device-mesh shape, is the node-sharded solve's), plus
``north_star_dec``: north_star with every pending pod's memory written in
decimal units (``M``), as many manifests do, which makes the memory
column's gcd 2^8 and the wave's resource planes int64; and two shapes
past the narrow kernel's limits, which its large-cluster instances take:
``planet``, the JAX package's largest record (``CHURN_MP_r18_planetshape
.json``: 40,000 nodes) with two services, so its 80,000 residents give
each 40,000 peers (counts past 2^15), and ``services64``, north_star with
64 services (64 service groups in the wave). ``build_shape`` builds any
of them.
"""

from __future__ import annotations

import json

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.quantity import Quantity
from kubernetes_tpu_torch.models import gang as gang_mod
from kubernetes_tpu_torch.scheduler.plugins import (Policy, PolicyPredicate,
                                                    PolicyPriority)

__all__ = ["AFFINITY_POLICY_JSON", "FULL_SHAPES", "affinity_policy",
           "build_cluster", "build_priority_cluster", "build_shape"]

# affinity_policy() as the JSON Policy file a scheduler operator writes
AFFINITY_POLICY_JSON = json.dumps({
    "predicates": [{"name": n} for n in (
        "PodFitsPorts", "PodFitsResources", "NoDiskConflict",
        "MatchNodeSelector", "HostName")],
    "priorities": [
        {"name": "LeastRequestedPriority", "weight": 1},
        {"name": "zoneSpread", "weight": 2,
         "argument": {"serviceAntiAffinity": {"label": "zone"}}}],
})

# (nodes, pending pods, build_cluster kwargs, the JSON Policy the wave runs
# under or None for the default provider)
FULL_SHAPES = {
    "north_star": (5_000, 10_000, {}, None),
    "basic": (500, 1_000, {}, None),
    "affinity": (5_000, 5_000, {}, AFFINITY_POLICY_JSON),
    "binpack3": (5_000, 10_000, {"three_resources": True}, None),
    "gang": (2_000, 0, {"gang_groups": 1_000, "gang_size": 8}, None),
    "mesh": (10_000, 2_048, {}, None),
    "north_star_dec": (5_000, 10_000, {"decimal_memory": True}, None),
    "priority": (2_000, 1_000, {"fill_per_node": 4}, None),
    "planet": (40_000, 10_000, {"n_services": 2}, None),
    "services64": (5_000, 10_000, {"n_services": 64}, None),
}

def affinity_policy() -> Policy:
    """The anti-affinity benchmark policy: the full default predicate set
    and LeastRequested plus ServiceAntiAffinity on ``zone`` (weight 2)."""
    return Policy(
        predicates=[PolicyPredicate(name=n) for n in
                    ("PodFitsPorts", "PodFitsResources", "NoDiskConflict",
                     "MatchNodeSelector", "HostName")],
        priorities=[PolicyPriority(name="LeastRequestedPriority", weight=1),
                    PolicyPriority(name="zoneSpread", weight=2,
                                   service_anti_affinity_label="zone")])


def build_cluster(n_nodes: int, n_pods: int, n_services: int = 8,
                  existing_per_node: int = 2, three_resources: bool = False,
                  gang_groups: int = 0, gang_size: int = 8,
                  decimal_memory: bool = False):
    caps = {"cpu": Quantity("16"), "memory": Quantity("64Gi")}
    if three_resources:
        caps["ephemeral-storage"] = Quantity("256Gi")
    nodes = [api.Node(
        metadata=api.ObjectMeta(name=f"node-{i:05d}",
                                labels={"zone": f"z{i % 16}",
                                        "disk": "ssd" if i % 4 else "hdd"}),
        spec=api.NodeSpec(capacity=dict(caps)))
        for i in range(n_nodes)]
    services = [api.Service(
        metadata=api.ObjectMeta(name=f"svc-{s}", namespace="default"),
        spec=api.ServiceSpec(port=80, selector={"app": f"app-{s}"}))
        for s in range(n_services)]

    def pod(name, i, host="", group=None):
        # decimal memory: 100M..1100M, odd multiples of 10^8, against
        # binary capacities
        mem = (f"{100 + (i % 6) * 200}M" if decimal_memory and not host
               else f"{128 + (i % 6) * 256}Mi")
        limits = {"cpu": Quantity(f"{100 + (i % 8) * 100}m"),
                  "memory": Quantity(mem)}
        if three_resources:
            limits["ephemeral-storage"] = Quantity(f"{1 + (i % 4)}Gi")
        ann = {}
        if group is not None:
            ann[gang_mod.GANG_NAME_ANNOTATION] = group
            ann[gang_mod.GANG_MIN_MEMBERS_ANNOTATION] = str(gang_size)
        return api.Pod(
            metadata=api.ObjectMeta(
                name=name, namespace="default", uid=f"uid-{name}",
                labels={"app": f"app-{i % n_services}"}, annotations=ann),
            spec=api.PodSpec(
                host=host,
                containers=[api.Container(
                    name="c", image="img",
                    ports=[api.ContainerPort(container_port=80,
                                             host_port=7000 + (i % 50))]
                    if i % 10 == 0 else [],
                    resources=api.ResourceRequirements(limits=limits))]),
            status=api.PodStatus(host=host))

    existing = [pod(f"old-{n}-{j}", n * existing_per_node + j,
                    host=nodes[n].metadata.name)
                for n in range(n_nodes) for j in range(existing_per_node)]
    if gang_groups:
        pending = [pod(f"g{g:04d}-m{m}", g * gang_size + m,
                       group=f"group-{g:04d}")
                   for g in range(gang_groups) for m in range(gang_size)]
    else:
        pending = [pod(f"new-{i:05d}", i) for i in range(n_pods)]
    return nodes, existing, pending, services


def build_priority_cluster(n_nodes: int, n_pending: int,
                           fill_per_node: int = 4):
    """The preemption cluster: every node filled exactly to capacity by
    low-priority pods in two bands (100 and 200, so the lowest sufficient
    threshold is a real choice), then a pending storm that can place only
    by evicting, with PreemptionPolicy=Never pods (every 10th) and pods at
    the top resident priority (every 10th) that must stay pending. Returns
    (nodes, existing, pending, services), services empty."""
    unit_m = 500
    nodes = [api.Node(
        metadata=api.ObjectMeta(name=f"node-{i:05d}"),
        spec=api.NodeSpec(capacity={
            "cpu": Quantity(f"{fill_per_node * unit_m}m"),
            "memory": Quantity("32Gi")}))
        for i in range(n_nodes)]

    def pod(name, prio, host="", policy_never=False, units=1):
        return api.Pod(
            metadata=api.ObjectMeta(name=name, namespace="default",
                                    uid=f"uid-{name}"),
            spec=api.PodSpec(
                host=host,
                containers=[api.Container(
                    name="c", image="img",
                    resources=api.ResourceRequirements(limits={
                        "cpu": Quantity(f"{units * unit_m}m"),
                        "memory": Quantity(f"{units * 256}Mi")}))],
                priority=prio,
                preemption_policy=(api.PreemptNever if policy_never
                                   else "")),
            status=api.PodStatus(host=host))

    existing = [pod(f"low-{i:05d}-{j}", 100 if j % 2 == 0 else 200,
                    host=f"node-{i:05d}")
                for i in range(n_nodes) for j in range(fill_per_node)]
    pending = []
    for k in range(n_pending):
        if k % 10 == 9:
            pending.append(pod(f"storm-never-{k:05d}", 1000,
                               policy_never=True))
        elif k % 10 == 8:
            pending.append(pod(f"storm-equal-{k:05d}", 200))
        else:
            # single- and double-unit high-priority pods
            pending.append(pod(f"storm-{k:05d}", 1000,
                               units=1 + (k % 3 == 0)))
    return nodes, existing, pending, []


def build_shape(name: str):
    """The cluster of ``FULL_SHAPES[name]``: (nodes, existing, pending,
    services)."""
    n_nodes, n_pods, kw, _policy = FULL_SHAPES[name]
    if name == "priority":
        return build_priority_cluster(n_nodes, n_pods, **kw)
    return build_cluster(n_nodes, n_pods, **kw)
