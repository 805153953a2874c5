"""Synthetic clusters at the benchmark's published shapes.

Port of ``bench.py:build_cluster`` (:518-571): nodes with 16 cpu and 64Gi
memory (plus 256Gi ephemeral storage for the three-resource shape),
labelled by zone and disk; eight services; two existing pods per node; a
pending batch whose requests, service labels and host ports cycle
deterministically (the gang variant is left for the gang slice).
``FULL_SHAPES`` mirrors ``bench.py:507-515`` for the
shapes this slice solves.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.quantity import Quantity

__all__ = ["FULL_SHAPES", "build_cluster"]

# (nodes, pending pods, build_cluster kwargs)
FULL_SHAPES = {
    "north_star": (5_000, 10_000, {}),
    "basic": (500, 1_000, {}),
    "binpack3": (5_000, 10_000, {"three_resources": True}),
}


def build_cluster(n_nodes: int, n_pods: int, n_services: int = 8,
                  existing_per_node: int = 2, three_resources: bool = False):
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

    def pod(name, i, host=""):
        limits = {"cpu": Quantity(f"{100 + (i % 8) * 100}m"),
                  "memory": Quantity(f"{128 + (i % 6) * 256}Mi")}
        if three_resources:
            limits["ephemeral-storage"] = Quantity(f"{1 + (i % 4)}Gi")
        return api.Pod(
            metadata=api.ObjectMeta(
                name=name, namespace="default", uid=f"uid-{name}",
                labels={"app": f"app-{i % n_services}"}),
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
    pending = [pod(f"new-{i:05d}", i) for i in range(n_pods)]
    return nodes, existing, pending, services
