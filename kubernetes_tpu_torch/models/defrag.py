"""kube-defrag — dense consolidation waves over the resident planes.

Port of ``kubernetes_tpu/models/defrag.py``, whole (numpy; the
descheduler loop that drives it is ``descheduler/controller.py``).

The descheduler's solve: score cluster fragmentation from the same
per-node free vectors the batch solver already encodes, select movable
pods, and plan a migration wave as a dense (candidates x nodes) pass
that reuses the preemption scan's carry rules (sequential commit,
conservative retention). The controller (descheduler/controller.py)
commits accepted moves atomically as evict-here + bind-there items
through the Binding migration path; this module never touches the store.

**The fragmentation score** (the single definition the dense path, the
serial oracle, the ``defrag_fragmentation_score`` gauge, and the churn
record's ``fragmentation`` section all share): over nodes with at least
one resident pod, the summed free-capacity permille of the core
dimensions —

    score = sum over nodes n, cnt[n] > 0
            sum over r in {cpu, memory}, cap[n, r] > 0
            max(cap[n, r] - used[n, r], 0) * 1000 // cap[n, r]

Empty nodes contribute zero, so the score falls exactly when a wave
empties a node — consolidation IS the objective, and "reclaimable empty
nodes" is what the autoscaler economics read off it. Lower is better.

**Candidate selection** (never the hot path's business — the controller
runs this off-thread): a pod is *movable* unless it is system flow
(protected namespace), a gang member (models/gang.py annotation — a
gang's co-placement predates us and moving one member breaks it), at or
above the priority ceiling, opted out via the do-not-disrupt annotation
(the PDB analog of this API era), or not cleanly bound (spec.host !=
status.host, or host off-list). Mandatory candidates are the movable
pods of cordoned (``spec.unschedulable``) nodes — cordon-drain.
Voluntary candidates come from *source* nodes: non-cordoned, non-
overcommitted, non-empty nodes whose residents are ALL movable (a node
that cannot fully empty never improves the score), taken emptiest-first
(ascending used-permille, node order on ties) whole-node at a time
within the move budget.

**The wave rule** (sequential carry, preemption's conservative
retention): candidates run mandatory-first, then voluntary grouped by
source node; for each candidate every node is tested densely — not the
source, not a source node, ``node_extra_ok`` (which folds cordon),
not pre-exceeded, no port/PD conflict against the carry, node-selector
subset, per-dim resource fit — and the tightest feasible target wins
(min free-permille after placement, FNV-1a tie-break in node order).
A committed move frees the source's *resources only* (its ports/PDs
are conservatively retained for the rest of the wave, exactly the
preemption carry) and the target gains usage, ports, and PDs. A
voluntary source that cannot fully place rolls its whole group back.
Voluntary targets must already hold a pod (packing, not spreading).

**The acceptance gate**: after the wave, the voluntary proposals are
kept only if they STRICTLY improve the score over the mandatory-only
outcome — so an already-packed cluster provably yields zero proposals,
and the ``fragmentation_score_monotone_under_defrag`` SLO holds by
construction. Mandatory (drain) moves are never dropped.

Bit-identity: ``oracle.defrag_serial`` implements the same rule
pod-by-pod from the object graph; tests/test_defrag.py pins fixtures
and fuzzes both encoders against it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.models import gang as gang_mod
from kubernetes_tpu_torch.models.snapshot import ClusterSnapshot, encode_snapshot
from kubernetes_tpu_torch.scheduler import predicates as _preds

__all__ = [
    "DO_NOT_DISRUPT_ANNOTATION", "DefragConfig", "CandidateSet",
    "DefragPlan", "Move", "is_movable", "select_candidates",
    "fragmentation_score", "resident_counts", "plan_defrag", "defrag_wave",
]

# The opt-out annotation — this era has no PodDisruptionBudget objects,
# so the budget is binary and pod-declared (the karpenter.sh/descheduler
# convention): an annotated pod is never a defrag candidate.
DO_NOT_DISRUPT_ANNOTATION = "scheduler.kubernetes.io/do-not-disrupt"

_CORE = (api.ResourceCPU, api.ResourceMemory)


@dataclass(frozen=True)
class DefragConfig:
    """The wave knobs (cmd/descheduler.py flags map 1:1)."""

    # voluntary moves per wave ride this budget (whole source nodes at a
    # time); mandatory drain moves are never budget-limited — cordon is
    # an operator order, pacing belongs to the wave rate limit
    max_moves: int = 50
    # pods at or above this priority are never moved (system-critical
    # band; upstream's HighestUserDefinablePriority split)
    priority_ceiling: int = api.HighestUserDefinablePriority
    protected_namespaces: Tuple[str, ...] = ("kube-system",)
    # only nodes STRICTLY below this summed core-dim used-permille
    # (0..~2000) may be voluntary sources — the k8s-descheduler
    # HighNodeUtilization split: empty the under-utilized tail into the
    # well-utilized head, never the reverse (without this, a generous
    # budget turns every movable node into a source and the only legal
    # targets left are empty nodes — anti-consolidation)
    source_max_permille: int = 700


class CandidateSet(NamedTuple):
    """select_candidates output: wave-ordered candidate pods (mandatory
    first, then voluntary grouped by source node), the mandatory mask,
    and the voluntary source node indices (excluded as targets)."""

    pods: List[api.Pod]
    mandatory: np.ndarray        # [C] bool
    source_idx: np.ndarray       # voluntary source node indices, ascending
    # movable=False residents of cordoned nodes — the drain's blind spot,
    # surfaced so the controller can report an incomplete drain honestly
    undrainable: List[api.Pod]


class Move(NamedTuple):
    """One accepted migration, as the commit path needs it."""

    uid: str
    name: str
    namespace: str
    source: str
    target: str
    mandatory: bool


@dataclass
class DefragPlan:
    """plan_defrag output. ``target[j]`` is the chosen node index for
    candidate j (-1 = not moved this wave); scores are the shared
    fragmentation metric before the wave, after mandatory-only, and
    after the accepted wave."""

    target: np.ndarray           # [C] i32
    score_before: int
    score_mandatory: int
    score_after: int
    voluntary_dropped: bool      # acceptance gate rejected the voluntary set


def is_movable(pod: api.Pod, cfg: DefragConfig) -> bool:
    if pod.metadata.namespace in cfg.protected_namespaces:
        return False
    if gang_mod.gang_key(pod) is not None:
        return False
    if api.pod_priority(pod) >= cfg.priority_ceiling:
        return False
    ann = pod.metadata.annotations or {}
    if ann.get(DO_NOT_DISRUPT_ANNOTATION, "false") != "false":
        return False
    return True


def _pod_order_key(pod: api.Pod):
    return (api.pod_priority(pod), pod.metadata.uid)


def _req_of(pod: api.Pod) -> Dict[str, int]:
    return _preds.get_resource_request(pod)


def _node_used_permille(node: api.Node, pods: Sequence[api.Pod]) -> int:
    """Source-ordering key: summed core-dim used-permille (object-graph
    side twin of the plane arithmetic; sums, not greedy — ordering only
    ever consults non-overcommitted nodes where the two agree)."""
    caps = _preds.capacity_values(node.spec.capacity)
    used: Dict[str, int] = {}
    for p in pods:
        for name, amt in _req_of(p).items():
            used[name] = used.get(name, 0) + amt
    out = 0
    for name in _CORE:
        cap = caps.get(name, 0)
        if cap > 0:
            out += used.get(name, 0) * 1000 // cap
    return out


def select_candidates(nodes: Sequence[api.Node],
                      existing_pods: Sequence[api.Pod],
                      cfg: Optional[DefragConfig] = None) -> CandidateSet:
    """The deterministic candidate feed (module docstring rule)."""
    cfg = cfg or DefragConfig()
    node_index = {n.metadata.name: i for i, n in enumerate(nodes)}
    by_host: Dict[str, List[api.Pod]] = {}
    for p in existing_pods:
        if p.status.host in node_index:
            by_host.setdefault(p.status.host, []).append(p)

    pods: List[api.Pod] = []
    mandatory_flags: List[bool] = []
    undrainable: List[api.Pod] = []

    def clean(p: api.Pod) -> bool:
        return p.spec.host == p.status.host

    # mandatory: cordon-drain, node order then (priority, uid)
    for n in nodes:
        if not n.spec.unschedulable:
            continue
        resident = by_host.get(n.metadata.name, ())
        if _node_exceeded_obj(n, resident):
            undrainable.extend(resident)
            continue
        for p in sorted(resident, key=_pod_order_key):
            if is_movable(p, cfg) and clean(p):
                pods.append(p)
                mandatory_flags.append(True)
            else:
                undrainable.append(p)

    # voluntary: emptiest-first fully-movable source nodes, whole nodes
    # within the budget
    budget = max(0, cfg.max_moves - len(pods))
    n_targets = sum(
        1 for n in nodes
        if not n.spec.unschedulable
        and not _node_exceeded_obj(n, by_host.get(n.metadata.name, ())))
    ranked: List[Tuple[int, int, api.Node, List[api.Pod]]] = []
    for i, n in enumerate(nodes):
        if n.spec.unschedulable:
            continue
        resident = by_host.get(n.metadata.name, ())
        if not resident or _node_exceeded_obj(n, resident):
            continue
        if not all(is_movable(p, cfg) and clean(p) for p in resident):
            continue
        permille = _node_used_permille(n, resident)
        if permille >= cfg.source_max_permille:
            continue
        ranked.append((permille, i, n,
                       sorted(resident, key=_pod_order_key)))
    ranked.sort(key=lambda t: (t[0], t[1]))
    source_idx: List[int] = []
    for _permille, i, _n, resident in ranked:
        # a source is excluded as a target, so never consume the last
        # schedulable non-source node — an all-sources wave has nowhere
        # to move anything (drains included) and dies as a silent no-op
        if n_targets - len(source_idx) < 2:
            break
        if len(resident) > budget:
            break
        budget -= len(resident)
        source_idx.append(i)
        pods.extend(resident)
        mandatory_flags.extend([False] * len(resident))

    return CandidateSet(pods,
                        np.asarray(mandatory_flags, bool),
                        np.asarray(sorted(source_idx), np.int64),
                        undrainable)


def _node_exceeded_obj(node: api.Node, pods: Sequence[api.Pod]) -> bool:
    """Greedy order-exact pre-exceeded rule over the object graph
    (snapshot.greedy_fit_accumulators semantics) — overcommitted nodes
    are neither sources nor targets: their accumulators are not sums, so
    freeing a pod there proves nothing."""
    caps = _preds.capacity_values(node.spec.capacity)
    used: Dict[str, int] = {}
    for p in pods:
        req = _req_of(p)
        if not all(_preds.dim_fits(name, caps.get(name, 0),
                                   caps.get(name, 0) - used.get(name, 0),
                                   amt)
                   for name, amt in req.items()):
            return True
        for name, amt in req.items():
            used[name] = used.get(name, 0) + amt
    return False


def resident_counts(node_names: Sequence[str],
                    existing_pods: Sequence[api.Pod]) -> np.ndarray:
    """[N] resident-pod counts (status.host), the score's emptiness axis."""
    index = {nm: i for i, nm in enumerate(node_names)}
    cnt = np.zeros(len(node_names), np.int64)
    for p in existing_pods:
        i = index.get(p.status.host)
        if i is not None:
            cnt[i] += 1
    return cnt


def fragmentation_score(cap: np.ndarray, used: np.ndarray,
                        cnt: np.ndarray) -> int:
    """The shared score (module docstring): core-dim free-permille summed
    over non-empty nodes. All-integer, so both paths agree bit-for-bit."""
    core = cap[:, :2]
    free = np.maximum(core - used[:, :2], 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        permille = np.where(core > 0, free * 1000 // np.maximum(core, 1), 0)
    return int(permille[cnt > 0].sum())


def plan_defrag(snap: ClusterSnapshot, mandatory: np.ndarray,
                source_idx: np.ndarray,
                resident_cnt: np.ndarray) -> DefragPlan:
    """The dense migration wave: snap's pending pods ARE the candidates
    (either encoder, ``pad_pods=False`` on the incremental one), wave
    order = list order = mandatory first then voluntary grouped by
    source. Pure plane arithmetic; no object graph."""
    N = snap.n_nodes
    C = len(snap.pod_names)
    target = np.full(C, -1, np.int32)
    if C == 0 or N == 0:
        s = fragmentation_score(snap.cap, snap.fit_used, resident_cnt)
        return DefragPlan(target, s, s, s, False)

    cap = snap.cap
    R = cap.shape[1]
    unconstrained = (cap == 0) & (np.arange(R) < 2)[None, :]
    is_source = np.zeros(N, bool)
    if len(source_idx):
        is_source[source_idx] = True
    base_ok = snap.node_extra_ok & ~snap.fit_exceeded & ~is_source
    node_ids = np.arange(N)

    used = snap.fit_used.astype(np.int64).copy()
    ports = snap.node_ports.copy()
    pds = snap.node_pds.copy()
    cnt = resident_cnt.astype(np.int64).copy()
    score_before = fragmentation_score(cap, used, cnt)
    ties = ((snap.tie_hi.astype(np.uint64) << np.uint64(32))
            | snap.tie_lo.astype(np.uint64))

    def try_place(j: int, voluntary: bool) -> bool:
        src = int(snap.pod_host_idx[j])
        req = snap.req[j]
        free = cap - used
        ok = base_ok & (node_ids != src) \
            & (unconstrained | (free >= req[None, :])).all(axis=1) \
            & ~(ports & snap.pod_ports[j][None, :]).any(axis=1) \
            & ~(pds & snap.pod_pds[j][None, :]).any(axis=1) \
            & ~(~snap.node_sel & snap.pod_sel[j][None, :]).any(axis=1)
        if voluntary:
            ok &= cnt > 0
        if not ok.any():
            return False
        # best fit: tightest target after placement, FNV tie-break
        core = cap[:, :2]
        free_after = np.maximum(core - used[:, :2] - req[None, :2], 0)
        fit_score = np.where(core > 0,
                             free_after * 1000 // np.maximum(core, 1),
                             0).sum(axis=1)
        fit_score = np.where(ok, fit_score, np.int64(2**62))
        best = int(fit_score.min())
        tied = np.nonzero(fit_score == best)[0]
        t = int(tied[int(ties[j] % np.uint64(len(tied)))])
        # commit to the carry: resources leave the source (its ports/PDs
        # are conservatively retained — the preemption rule); the target
        # gains everything
        used[src] -= req
        used[t] += req
        ports[t] |= snap.pod_ports[j]
        pds[t] |= snap.pod_pds[j]
        cnt[src] -= 1
        cnt[t] += 1
        target[j] = t
        return True

    # mandatory phase: independent moves; a failure leaves the pod put
    for j in range(C):
        if mandatory[j]:
            try_place(j, voluntary=False)
    score_mandatory = fragmentation_score(cap, used, cnt)
    mand_state = (used.copy(), ports.copy(), pds.copy(), cnt.copy(),
                  target.copy())

    # voluntary phase: per-source groups, all-or-nothing per group
    j = 0
    while j < C:
        if mandatory[j]:
            j += 1
            continue
        src = int(snap.pod_host_idx[j])
        group = [j]
        while j + len(group) < C and not mandatory[j + len(group)] \
                and int(snap.pod_host_idx[j + len(group)]) == src:
            group.append(j + len(group))
        mark = (used.copy(), ports.copy(), pds.copy(), cnt.copy())
        ok = True
        for k in group:
            if not try_place(k, voluntary=True):
                ok = False
                break
        if not ok:
            used[:], ports[:], pds[:], cnt[:] = mark
            for k in group:
                target[k] = -1
        j = group[-1] + 1

    score_after = fragmentation_score(cap, used, cnt)
    dropped = False
    if score_after >= score_mandatory and \
            bool((target[~np.asarray(mandatory, bool)] >= 0).any()):
        # acceptance gate: the voluntary set must STRICTLY improve the
        # score or the whole set is dropped — zero proposals on an
        # already-packed cluster, monotone under the SLO by construction
        used, ports, pds, cnt, target = \
            mand_state[0], mand_state[1], mand_state[2], mand_state[3], \
            mand_state[4]
        score_after = score_mandatory
        dropped = True
    return DefragPlan(target, score_before, score_mandatory, score_after,
                      dropped)


def defrag_wave(nodes: Sequence[api.Node],
                existing_pods: Sequence[api.Pod],
                services: Sequence[api.Service] = (),
                cfg: Optional[DefragConfig] = None,
                encoder=None) -> Tuple[DefragPlan, CandidateSet, List[Move]]:
    """One full wave: select -> encode (full encoder, or a caller-owned
    IncrementalEncoder via ``encoder``) -> dense plan -> Move list."""
    cfg = cfg or DefragConfig()
    cand = select_candidates(nodes, existing_pods, cfg)
    if encoder is not None:
        snap = encoder.encode(nodes, existing_pods, cand.pods, services,
                              pad_pods=False)
    else:
        snap = encode_snapshot(nodes, existing_pods, cand.pods, services)
    plan = plan_defrag(snap, cand.mandatory, cand.source_idx,
                       resident_counts(snap.node_names, existing_pods))
    moves: List[Move] = []
    for j, p in enumerate(cand.pods):
        t = int(plan.target[j])
        if t < 0:
            continue
        moves.append(Move(p.metadata.uid, p.metadata.name,
                          p.metadata.namespace, p.status.host,
                          snap.node_names[t], bool(cand.mandatory[j])))
    return plan, cand, moves
