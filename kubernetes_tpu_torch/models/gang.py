"""Gang (PodGroup) scheduling — all-or-nothing placement within a wave.

Port of ``kubernetes_tpu/models/gang.py``. A pod group either places fully
within the wave or not at all; the solver rolls its sequential-commit state
back to the group's checkpoint when a member fails, so later pods schedule
as if the failed group never existed.

Pods declare membership through annotations: ``group-name`` (the gang key
is (namespace, group-name)) and an optional ``group-min-members`` quorum.
Semantics are defined over *runs*, maximal stretches of consecutive wave
pods sharing a gang key; ``order_wave`` makes each group one run.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.api import types as api

__all__ = ["GANG_NAME_ANNOTATION", "GANG_MIN_MEMBERS_ANNOTATION",
           "gang_key", "gang_min_members", "order_wave", "pod_run_ids",
           "apply_all_or_nothing"]

GANG_NAME_ANNOTATION = "scheduler.kubernetes.io/group-name"
GANG_MIN_MEMBERS_ANNOTATION = "scheduler.kubernetes.io/group-min-members"


def gang_key(pod: api.Pod) -> Optional[Tuple[str, str]]:
    """(namespace, group-name) for gang members, None for singletons."""
    name = (pod.metadata.annotations or {}).get(GANG_NAME_ANNOTATION)
    if not name:
        return None
    return (pod.metadata.namespace, name)


def gang_min_members(pod: api.Pod) -> int:
    """The group quorum a member declares (0 = no quorum)."""
    raw = (pod.metadata.annotations or {}).get(GANG_MIN_MEMBERS_ANNOTATION)
    try:
        return int(raw) if raw else 0
    except ValueError:
        return 0


def order_wave(pods: Sequence[api.Pod]) -> List[api.Pod]:
    """Reorder a wave so each gang's members are contiguous, keeping the
    first-appearance order of scheduling units (singletons and gangs) and
    the order of members within a gang."""
    units: Dict[object, List[api.Pod]] = {}
    order: List[object] = []
    for i, p in enumerate(pods):
        key = gang_key(p) or ("", f"\x00singleton-{i}")
        if key not in units:
            units[key] = []
            order.append(key)
        units[key].append(p)
    return [p for key in order for p in units[key]]


def pod_run_ids(pods: Sequence[api.Pod]) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pod (run_id, run_start): run_id is -1 for singletons and a dense
    index per maximal run of consecutive same-gang pods otherwise;
    run_start marks the first pod of every scheduling unit, where the
    solver checkpoints its rollback state."""
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


def apply_all_or_nothing(rid: np.ndarray, chosen: np.ndarray) -> np.ndarray:
    """Host post-pass: drop every member of a run that has a failed member.
    The solver already rolled its state back; this drops the earlier
    members' tentative hosts from the output too."""
    chosen = np.asarray(chosen).copy()
    in_gang = rid >= 0
    failed_runs = np.unique(rid[in_gang & (chosen < 0)])
    if failed_runs.size:
        chosen[np.isin(rid, failed_runs) & in_gang] = -1
    return chosen
