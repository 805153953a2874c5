"""Priority bands, victim replay and the preemption score channel.

Port of ``kubernetes_tpu/models/preempt.py``. The solve models preemption
as one extra pair of resident planes: per node and per **priority band**
(one band per distinct priority among the node-resident pods) the summed
evictable capacity ``evict_cap [N, B, R]`` and pod count ``evict_cnt
[N, B]``, beside the band values ``band_prio [B]`` (``BAND_EMPTY`` pads
unused slots and never sits below a pod's priority).

The eviction rule, which the kernel, its plain version and the serial
oracle all implement:

- a pod tries normal placement first; preemption is considered only when
  no node is normally feasible and its preemptionPolicy allows it;
- on each node the candidate victim sets are the priority prefixes: every
  resident pod with priority <= t, for a threshold t among the node's
  band values strictly below the pod's priority (equal-or-higher pods are
  never candidates);
- a (node, t) pair fits when every non-resource filter of the pod's
  normal placement passes (victims keep their ports, PDs and service
  membership for the rest of the wave) and ``free + freed(t) >= request``
  on every resource dimension (pre-exceeded nodes are excluded);
- per node the smallest fitting threshold wins; across nodes the fewest
  victims win, with the usual FNV-1a tie-break over those nodes;
- the chosen prefix is evicted in the solve's state, so later pods of the
  wave see the cluster after the eviction. Pods placed earlier in the
  same wave are never victims.

The solve holds aggregates and cannot name victims, so a preempting
placement reports its threshold's band SLOT through the score channel
(``preempt_score``), and ``assign_victims`` replays (node, threshold) into
the concrete victim pods on the host.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

import numpy as np

from kubernetes_tpu_torch.api import types as api

__all__ = ["BAND_EMPTY", "PREEMPT_SCORE_BASE", "is_preempt_score",
           "ceiling_slot", "preempt_score", "Victim", "ResidentPod",
           "resident_from_pods", "assign_victims", "derive_evict_planes",
           "band_values_of", "preemption_possible"]

# Empty/padded band slots: above every legal pod priority, so a padded
# slot is never "strictly lower" than any pod.
BAND_EMPTY = np.int32(2**31 - 1)

# A placed pod's score at or below this value placed by preemption; the
# band slot is recovered by ceiling_slot. Normal scores are >= 0 and the
# unschedulable sentinel is -1, so the ranges do not meet.
PREEMPT_SCORE_BASE = -2


def preempt_score(slot) -> int:
    """Encode a threshold band slot into the score channel."""
    return PREEMPT_SCORE_BASE - slot


def is_preempt_score(score: int) -> bool:
    return score <= PREEMPT_SCORE_BASE


def ceiling_slot(score: int) -> int:
    """Inverse of preempt_score."""
    return PREEMPT_SCORE_BASE - int(score)


class Victim(NamedTuple):
    """One evicted pod, as the commit needs it."""

    uid: str
    name: str
    namespace: str
    priority: int


class ResidentPod(NamedTuple):
    """A node-resident pod as the victim replay sees it: from the
    IncrementalEncoder's registry, or derived from an existing-pod list."""

    uid: str
    name: str
    namespace: str
    host_idx: int
    priority: int


def resident_from_pods(pods: Sequence[api.Pod],
                       node_index: Dict[str, int]) -> List[ResidentPod]:
    """Existing-pod list -> ResidentPod rows (pods on no listed node are
    dropped: they occupy no node and are never victims)."""
    out: List[ResidentPod] = []
    for p in pods:
        i = node_index.get(p.status.host)
        if i is None:
            continue
        m = p.metadata
        out.append(ResidentPod(m.uid, m.name, m.namespace, i,
                               api.pod_priority(p)))
    return out


def assign_victims(chosen: np.ndarray, scores: np.ndarray,
                   band_prio: np.ndarray,
                   resident: Optional[Iterable[ResidentPod]] = None,
                   n_pods: Optional[int] = None,
                   node_pods=None) -> List[Optional[List[Victim]]]:
    """Expand the solve's (node, threshold) preemption decisions into
    victim sets, one entry per pod in wave order: None for a pod that did
    not preempt, else its victims sorted by (priority, uid).

    The victims of a preempting pod are the still-resident pods on its
    node with priority <= its threshold; each pod's victims leave every
    later pod's candidates, as the solve zeroed those bands. ``n_pods``
    cuts the pod-axis padding off. ``node_pods(i)``, when given, replaces
    the flat ``resident`` iterable with a per-node lookup (the encoder's
    registry), so a wave costs the pods of the touched nodes only."""
    n = len(chosen) if n_pods is None else n_pods
    if node_pods is None:
        by_node: Dict[int, List[ResidentPod]] = {}
        for r in (resident or ()):
            by_node.setdefault(r.host_idx, []).append(r)
        node_pods = lambda i: by_node.get(i, ())  # noqa: E731
    evicted: set = set()
    out: List[Optional[List[Victim]]] = []
    for j in range(n):
        node = int(chosen[j])
        score = int(scores[j])
        if node < 0 or not is_preempt_score(score):
            out.append(None)
            continue
        ceiling = int(band_prio[ceiling_slot(score)])
        victims = [Victim(r.uid, r.name, r.namespace, r.priority)
                   for r in node_pods(node)
                   if r.uid not in evicted and r.priority <= ceiling]
        victims.sort(key=lambda v: (v.priority, v.uid))
        evicted.update(v.uid for v in victims)
        out.append(victims)
    return out


def band_values_of(existing_pods: Sequence[api.Pod],
                   node_index: Dict[str, int]) -> List[int]:
    """Sorted distinct priorities of the node-resident existing pods: the
    full encoder's band vocabulary (the incremental encoder's sticky
    vocabulary holds the same values, in other slots)."""
    seen = set()
    for p in existing_pods:
        if p.status.host in node_index:
            seen.add(api.pod_priority(p))
    return sorted(seen)


def preemption_possible(band_values: Sequence[int],
                        pending_pods: Sequence[api.Pod]) -> bool:
    """The emit gate: band planes ship only when some pending pod's
    priority sits strictly above some resident band; otherwise no
    eviction can happen."""
    if not band_values or not pending_pods:
        return False
    floor = min(band_values)
    return any(api.pod_priority(p) > floor for p in pending_pods)


def derive_evict_planes(e_host: np.ndarray, e_prio: np.ndarray,
                        e_req: np.ndarray, band_prio: np.ndarray,
                        n_nodes: int):
    """``evict_cap[n, b, :]`` = summed request vectors of pods resident on
    node ``n`` whose priority equals ``band_prio[b]``; ``evict_cnt`` the
    matching pod counts. ``e_host >= n_nodes`` marks off-list pods."""
    B = len(band_prio)
    R = e_req.shape[1] if e_req.ndim == 2 else 0
    cap = np.zeros((n_nodes, B, R), np.int64)
    cnt = np.zeros((n_nodes, B), np.int32)
    slot_of = {int(v): b for b, v in enumerate(band_prio)
               if int(v) != int(BAND_EMPTY)}
    for k in range(len(e_host)):
        i = int(e_host[k])
        if i >= n_nodes:
            continue
        b = slot_of.get(int(e_prio[k]))
        if b is None:
            continue
        cap[i, b] += e_req[k]
        cnt[i, b] += 1
    return cap, cnt
