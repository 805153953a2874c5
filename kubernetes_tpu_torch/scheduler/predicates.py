"""Resource accounting shared by the serial predicates and the encoder.

Port of the part of ``kubernetes_tpu/scheduler/predicates.py`` that
``encode_snapshot`` calls (:36-39, :61-76; ref: pkg/scheduler/
predicates.go:93-101).
"""

from __future__ import annotations

from typing import List

from kubernetes_tpu_torch.api import types as api

__all__ = ["resource_value", "resource_universe"]


def resource_value(name: str, q) -> int:
    """Canonical integer for one resource dimension: CPU counts milli-units
    (predicates.go:96 ``MilliValue``), everything else whole units."""
    return q.milli_value() if name == api.ResourceCPU else q.int_value()


def resource_universe(nodes) -> List[str]:
    """The wave's scored resource dimensions: cpu and memory always, plus
    every other resource any node advertises, sorted. LeastRequested
    averages over exactly this set."""
    extras = set()
    for n in nodes:
        for name in (n.spec.capacity or {}):
            if name not in (api.ResourceCPU, api.ResourceMemory):
                extras.add(name)
    return [api.ResourceCPU, api.ResourceMemory] + sorted(extras)
