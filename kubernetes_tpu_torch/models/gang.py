"""Gang (PodGroup) run ids — the numpy half of all-or-nothing placement.

Port of the part of ``kubernetes_tpu/models/gang.py`` the encoder calls:
it tags each pod with its run (a maximal stretch of consecutive pods of
one gang). Solving gang waves, and the all-or-nothing post-pass, is
ROADMAP work; the run ids let a gang wave be recognised and refused.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.api import types as api

__all__ = ["GANG_NAME_ANNOTATION", "gang_key", "pod_run_ids"]

GANG_NAME_ANNOTATION = "scheduler.kubernetes.io/group-name"


def gang_key(pod: api.Pod) -> Optional[Tuple[str, str]]:
    """(namespace, group-name) for gang members, None for singletons."""
    name = (pod.metadata.annotations or {}).get(GANG_NAME_ANNOTATION)
    if not name:
        return None
    return (pod.metadata.namespace, name)


def pod_run_ids(pods: Sequence[api.Pod]) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pod (run_id, run_start): run_id is -1 for singletons and a dense
    index per maximal run of consecutive same-gang pods otherwise;
    run_start marks the first pod of every scheduling unit."""
    P = len(pods)
    rid = np.full(P, -1, np.int32)
    start = np.ones(P, bool)
    prev_key = object()
    next_rid = 0
    for j, p in enumerate(pods):
        key = gang_key(p)
        if key is not None and key == prev_key:
            rid[j] = rid[j - 1]
            start[j] = False
        elif key is not None:
            rid[j] = next_rid
            next_rid += 1
        prev_key = key
    return rid, start
