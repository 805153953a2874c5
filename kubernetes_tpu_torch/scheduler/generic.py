"""The deterministic tie-break of the generic scheduler, and FitError.

Port of ``kubernetes_tpu/scheduler/generic.py:29-55``: the reference's
``rand.Int() % len(bestHosts)`` (generic_scheduler.go:84-96) becomes an
FNV-1a-64 hash of the pod's identity modulo the best-host count, over the
best hosts in node-list order; ``FitError`` is the error a pod that fits
no node is requeued with. The serial ``GenericScheduler`` is not ported.
"""

from __future__ import annotations

from typing import Dict, Set

from kubernetes_tpu_torch.api import types as api

__all__ = ["FNV64_OFFSET", "FNV64_PRIME", "fnv1a64", "pod_tie_break_key",
           "FitError"]

FNV64_OFFSET = 0xCBF29CE484222325
FNV64_PRIME = 0x100000001B3


def fnv1a64(data: str) -> int:
    h = FNV64_OFFSET
    for b in data.encode("utf-8"):
        h ^= b
        h = (h * FNV64_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def pod_tie_break_key(pod: api.Pod) -> str:
    return pod.metadata.uid or f"{pod.metadata.namespace}/{pod.metadata.name}"


class FitError(Exception):
    """ref: generic_scheduler.go:31-44 FitError."""

    def __init__(self, pod: api.Pod, failed_predicates: Dict[str, Set[str]]):
        self.pod = pod
        self.failed_predicates = failed_predicates
        detail = "".join(
            f" Node {node}: {','.join(sorted(names))}."
            for node, names in sorted(failed_predicates.items()))
        super().__init__(
            f"failed to find fit for pod "
            f"{pod.metadata.namespace}/{pod.metadata.name}:{detail}")
