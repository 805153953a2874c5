"""Serial wave oracle — the reference path run over a whole pending batch.

Port of ``kubernetes_tpu/models/oracle.py``, whole.

Runs the unmodified serial GenericScheduler (kubernetes_tpu_torch.scheduler.generic)
pod-by-pod over the same inputs the TPU batch solver sees, committing each
decision before the next — exactly the reference driver's behavior
(scheduleOne + Modeler.AssumePod, plugin/pkg/scheduler/scheduler.go:90-119).
The equivalence contract: ``solve_serial(...) == decisions_to_names(solve(...))``
for every input; tests/test_batch_solver.py fuzzes it, and bench.py re-checks
it on every benchmark run.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.models import gang as gang_mod
from kubernetes_tpu_torch.models.preempt import Victim
from kubernetes_tpu_torch.scheduler import plugins as schedplugins
from kubernetes_tpu_torch.scheduler import predicates as _preds
from kubernetes_tpu_torch.scheduler.generic import (
    FitError,
    GenericScheduler,
    fnv1a64,
    pod_tie_break_key,
)
from kubernetes_tpu_torch.scheduler.listers import (
    FakeMinionLister,
    FakeNodeInfo,
    FakePodLister,
    FakeServiceLister,
)

__all__ = ["solve_serial", "preempt_serial", "explain_serial",
           "defrag_serial"]


def solve_serial(nodes: Sequence[api.Node], existing_pods: Sequence[api.Pod],
                 pending_pods: Sequence[api.Pod],
                 services: Sequence[api.Service] = (),
                 provider: str = schedplugins.DEFAULT_PROVIDER,
                 policy: Optional[schedplugins.Policy] = None,
                 gangs: bool = False) -> List[Optional[str]]:
    """Serial reference decisions for a wave. A ``policy`` replaces the
    provider's plugin sets entirely (CreateFromConfig, factory.go:88-104).

    With ``gangs=True``, PodGroup runs (models/gang.py) are all-or-nothing:
    members commit one by one exactly as above, but a member failing rolls
    the whole run's commits back, fails every member of the run, and the
    walk resumes after it — the semantics the in-scan checkpoint/rollback
    path must reproduce bit-for-bit."""
    node_list = api.NodeList(items=list(nodes))
    committed: List[api.Pod] = list(existing_pods)
    pod_lister = FakePodLister(committed)  # shared, mutated via committed
    args = schedplugins.PluginFactoryArgs(
        pod_lister=pod_lister,
        service_lister=FakeServiceLister(list(services)),
        node_lister=FakeMinionLister(node_list),
        node_info=FakeNodeInfo(node_list))
    if policy is not None:
        predicates = schedplugins.predicates_from_policy(policy, args)
        priorities = schedplugins.priorities_from_policy(policy, args)
    else:
        keys = schedplugins.get_algorithm_provider(provider)
        predicates = schedplugins.get_predicates(keys["predicates"], args)
        priorities = schedplugins.get_priorities(keys["priorities"], args)
    scheduler = GenericScheduler(predicates, priorities, pod_lister)
    minion_lister = FakeMinionLister(node_list)

    def schedule_one(pod) -> Optional[str]:
        try:
            host = scheduler.schedule(pod, minion_lister)
        except FitError:
            return None
        bound = copy.deepcopy(pod)
        bound.spec.host = host
        bound.status.host = host
        committed.append(bound)  # visible to the next decision via pod_lister
        return host

    pending = list(pending_pods)
    if not gangs:
        return [schedule_one(p) for p in pending]

    rid, _start = gang_mod.pod_run_ids(pending)
    decisions: List[Optional[str]] = [None] * len(pending)
    j = 0
    while j < len(pending):
        if rid[j] < 0:                      # singleton
            decisions[j] = schedule_one(pending[j])
            j += 1
            continue
        run = [j]
        while j + len(run) < len(pending) and rid[j + len(run)] == rid[j]:
            run.append(j + len(run))
        mark = len(committed)
        ok = True
        for k in run:
            host = schedule_one(pending[k])
            decisions[k] = host
            if host is None:
                ok = False
                break
        if not ok:                          # rollback the whole run
            del committed[mark:]
            for k in run:
                decisions[k] = None
        j = run[-1] + 1
    return decisions


# ---------------------------------------------------------------------------
# kube-preempt serial oracle
# ---------------------------------------------------------------------------

def _req_vec(pod: api.Pod) -> Dict[str, int]:
    """Summed container limits per resource name (the same accounting the
    encoder's request planes use — limits double as requests in this era)."""
    out: Dict[str, int] = {}
    for c in pod.spec.containers:
        for name, q in c.resources.limits.items():
            out[name] = out.get(name, 0) + _preds.resource_value(name, q)
    return out


def _node_exceeded(cap: Dict[str, int], pods: Sequence[api.Pod]) -> bool:
    """The greedy order-exact pre-exceeded rule (snapshot
    .greedy_fit_accumulators semantics): walking the node's pods in list
    order, did any pod fail to fit? Preemption never targets such nodes —
    their accumulators are not plain sums."""
    used: Dict[str, int] = {}
    for p in pods:
        req = _req_vec(p)
        ok = all(_preds.dim_fits(name, cap.get(name, 0),
                                 cap.get(name, 0) - used.get(name, 0), amt)
                 for name, amt in req.items())
        if not ok:
            return True
        for name, amt in req.items():
            used[name] = used.get(name, 0) + amt
    return False


def preempt_serial(nodes: Sequence[api.Node],
                   existing_pods: Sequence[api.Pod],
                   pending_pods: Sequence[api.Pod],
                   services: Sequence[api.Service] = (),
                   provider: str = schedplugins.DEFAULT_PROVIDER,
                   policy: Optional[schedplugins.Policy] = None
                   ) -> Tuple[List[Optional[str]],
                              List[Optional[List[Victim]]]]:
    """Serial reference for priority preemption: the lowest-sufficient-
    victim-set rule of models/preempt.py run pod by pod over the object
    graph. Returns ``(decisions, victims)`` — ``victims[j]`` is None when
    pod j placed normally (or not at all), else the evicted pods sorted by
    (priority, uid). The batched path (solve + preempt.assign_victims over
    the same wave) must match BOTH lists bit-for-bit; tests/test_preempt.py
    and the ``priority`` bench config gate it.

    Per pod, in wave order:

    1. normal placement through the unmodified GenericScheduler — identical
       to solve_serial (preemption never perturbs a schedulable wave);
    2. on FitError, if the pod's preemptionPolicy allows: per node, over
       thresholds t drawn from the remaining evictable pods' priorities
       strictly below the pod's, the minimal t whose prefix set
       {priority <= t} frees enough capacity (same per-dim rule as the
       resource predicate; victims' ports/PDs/service membership are
       conservatively retained — only resources free up); across nodes the
       minimal victim count wins, FNV tie-break in node-list order;
    3. the whole chosen prefix evicts: victims leave the evictable pool
       and their resources leave the accounting, but ghost entries keep
       their ports/PDs/labels visible to every later pod's predicates —
       exactly the batched scan's conservative-retention carry.
    """
    node_list = api.NodeList(items=list(nodes))
    node_order = [n.metadata.name for n in nodes]
    caps = {n.metadata.name: _preds.capacity_values(n.spec.capacity)
            for n in nodes}
    committed: List[api.Pod] = list(existing_pods)
    pod_lister = FakePodLister(committed)
    args = schedplugins.PluginFactoryArgs(
        pod_lister=pod_lister,
        service_lister=FakeServiceLister(list(services)),
        node_lister=FakeMinionLister(node_list),
        node_info=FakeNodeInfo(node_list))
    if policy is not None:
        predicates = schedplugins.predicates_from_policy(policy, args)
        priorities = schedplugins.priorities_from_policy(policy, args)
    else:
        keys = schedplugins.get_algorithm_provider(provider)
        predicates = schedplugins.get_predicates(keys["predicates"], args)
        priorities = schedplugins.get_priorities(keys["priorities"], args)
    scheduler = GenericScheduler(predicates, priorities, pod_lister)
    minion_lister = FakeMinionLister(node_list)
    nores_predicates = {name: fn for name, fn in predicates.items()
                        if name != "PodFitsResources"}

    # static pre-exceeded set + the evictable pool (wave-start residents;
    # within-wave placements are never added, so they can never be victims)
    by_host: Dict[str, List[api.Pod]] = {}
    for p in existing_pods:
        if p.status.host in caps:
            by_host.setdefault(p.status.host, []).append(p)
    exceeded = {name: _node_exceeded(caps[name], by_host.get(name, ()))
                for name in node_order}
    evictable: Dict[str, List[api.Pod]] = {
        name: list(by_host.get(name, ())) for name in node_order}

    # maintained per-host usage (same values a committed-list scan would
    # produce; kept incrementally so the per-candidate-node check is O(1))
    used_by_host: Dict[str, Dict[str, int]] = {name: {}
                                               for name in node_order}

    def account(host: str, req: Dict[str, int], sign: int) -> None:
        used = used_by_host[host]
        for name, amt in req.items():
            used[name] = used.get(name, 0) + sign * amt

    for p in existing_pods:
        if p.status.host in caps:
            account(p.status.host, _req_vec(p), +1)

    def commit(pod: api.Pod, host: str) -> None:
        bound = copy.deepcopy(pod)
        bound.spec.host = host
        bound.status.host = host
        committed.append(bound)
        account(host, _req_vec(bound), +1)

    def try_preempt(pod: api.Pod):
        """-> (host, victims) or None. The serial form of the scan's
        preemption sub-program."""
        p_prio = api.pod_priority(pod)
        req = _req_vec(pod)
        machine_to_pods = _preds.map_pods_to_machines(pod_lister)
        best: List[Tuple[str, int, List[api.Pod]]] = []  # (host, cost, set)
        for host in node_order:
            if exceeded[host]:
                continue
            if not all(fn(pod, machine_to_pods.get(host, []), host)
                       for fn in nores_predicates.values()):
                continue
            pool = [v for v in evictable[host]
                    if api.pod_priority(v) < p_prio]
            if not pool:
                continue
            cap = caps[host]
            used = used_by_host[host]
            free = {name: cap.get(name, 0) - used.get(name, 0)
                    for name in set(cap) | set(used) | set(req)}
            # thresholds ascending; freed is monotone, so the first
            # sufficient prefix is the lowest-sufficient victim set
            chosen_t = None
            for t in sorted({api.pod_priority(v) for v in pool}):
                prefix = [v for v in pool if api.pod_priority(v) <= t]
                freed: Dict[str, int] = {}
                for v in prefix:
                    for name, amt in _req_vec(v).items():
                        freed[name] = freed.get(name, 0) + amt
                fits = all(_preds.dim_fits(
                    name, cap.get(name, 0),
                    free.get(name, 0) + freed.get(name, 0), amt)
                    for name, amt in req.items())
                if fits:
                    chosen_t = t
                    break
            if chosen_t is None:
                continue
            victims = [v for v in pool
                       if api.pod_priority(v) <= chosen_t]
            best.append((host, len(victims), victims))
        if not best:
            return None
        min_cost = min(cost for _h, cost, _v in best)
        tied = [(h, v) for h, cost, v in best if cost == min_cost]
        host, victims = tied[fnv1a64(pod_tie_break_key(pod)) % len(tied)]
        return host, victims

    decisions: List[Optional[str]] = []
    victim_out: List[Optional[List[Victim]]] = []
    for pod in pending_pods:
        try:
            host = scheduler.schedule(pod, minion_lister)
            commit(pod, host)
            decisions.append(host)
            victim_out.append(None)
            continue
        except FitError:
            pass
        hit = try_preempt(pod) if api.pod_can_preempt(pod) else None
        if hit is None:
            decisions.append(None)
            victim_out.append(None)
            continue
        host, victims = hit
        gone = {id(v) for v in victims}
        evictable[host] = [v for v in evictable[host]
                           if id(v) not in gone]
        for v in victims:
            account(host, _req_vec(v), -1)
        # ghost the victims: resources leave the accounting, but ports /
        # PDs / labels stay visible for the rest of the wave (the scan's
        # conservative-retention rule)
        for k, p in enumerate(committed):
            if id(p) in gone:
                ghost = copy.deepcopy(p)
                for c in ghost.spec.containers:
                    c.resources.limits = {}
                    c.resources.requests = {}
                ghost.spec.__dict__.pop("_ktpu_rows", None)
                committed[k] = ghost
        commit(pod, host)
        decisions.append(host)
        victim_out.append(sorted(
            (Victim(v.metadata.uid, v.metadata.name,
                    v.metadata.namespace, api.pod_priority(v))
             for v in victims), key=lambda v: (v.priority, v.uid)))
    return decisions, victim_out


# ---------------------------------------------------------------------------
# kube-explain serial oracle
# ---------------------------------------------------------------------------

def _rank_key(name: str):
    """Canonical resource-attribution rank (models/explain.canonical_rank
    twin): cpu, memory, then lexicographic."""
    if name == api.ResourceCPU:
        return (0, "")
    if name == api.ResourceMemory:
        return (1, "")
    return (2, name)


def explain_serial(nodes: Sequence[api.Node],
                   existing_pods: Sequence[api.Pod],
                   pending_pods: Sequence[api.Pod],
                   services: Sequence[api.Service] = (),
                   provider: str = schedplugins.DEFAULT_PROVIDER,
                   policy: Optional[schedplugins.Policy] = None):
    """Serial twin of models/explain.explain_wave: decisions via the
    proven serial rule (:func:`preempt_serial` — normal placement first,
    lowest-sufficient-prefix preemption when possible), then each
    unschedulable pod's per-reason node-elimination counts re-derived in
    plain Python from the object graph against the state its own turn
    saw. Returns ``(decisions, diags)`` — ``diags[j]`` is None for
    placed pods, else a ``models.explain.PodDiagnosis``. The batched
    path (solve + explain_wave over the same wave) must match both
    bit-for-bit; tests/test_explain.py gates it.

    The attribution contract (one reason per eliminated node, serial
    short-circuit order; Insufficient-<dim> by canonical rank;
    overcommitted when only the greedy pre-exceeded flag fails;
    conservative victim retention for ports/PDs) is defined in
    models/explain.py — this is its independent implementation.
    """
    from kubernetes_tpu_torch.models.explain import (
        PodDiagnosis,
        REASON_HOST,
        REASON_LABEL,
        REASON_OVERCOMMIT,
        REASON_PD,
        REASON_PORT,
        REASON_SELECTOR,
        insufficient_reason,
    )
    from kubernetes_tpu_torch.models.policy import batch_policy_from
    from kubernetes_tpu_torch.models.preempt import (
        band_values_of,
        preemption_possible,
    )

    pol = batch_policy_from(provider, policy)
    decisions, victims = preempt_serial(nodes, existing_pods, pending_pods,
                                        services, provider, policy)
    node_order = [n.metadata.name for n in nodes]
    node_index = {nm: i for i, nm in enumerate(node_order)}
    caps = {n.metadata.name: _preds.capacity_values(n.spec.capacity)
            for n in nodes}
    labels = {n.metadata.name: dict(n.metadata.labels or {}) for n in nodes}
    # cordon folds into extra_ok unconditionally, like the planes do: a
    # cordoned node's eliminations attribute to REASON_LABEL (the
    # extra_ok bucket — documented coarseness, docs/design/descheduler.md)
    extra_ok = {n.metadata.name: not n.spec.unschedulable for n in nodes}
    for name in node_order:
        for lbls, presence in pol.label_presence:
            if any((l in labels[name]) != presence for l in lbls):
                extra_ok[name] = False
                break

    # wave-start diagnostic state, greedy-walked in existing-list order
    # (snapshot.greedy_fit_accumulators semantics)
    fit_used: Dict[str, Dict[str, int]] = {n: {} for n in node_order}
    exceeded: Dict[str, bool] = {n: False for n in node_order}
    ports: Dict[str, set] = {n: set() for n in node_order}
    pds: Dict[str, set] = {n: set() for n in node_order}
    by_uid: Dict[str, api.Pod] = {}
    for p in existing_pods:
        by_uid[p.metadata.uid] = p
        host = p.status.host
        if host not in caps:
            continue
        cap = caps[host]
        used = fit_used[host]
        req = _req_vec(p)
        if all(_preds.dim_fits(k, cap.get(k, 0),
                               cap.get(k, 0) - used.get(k, 0), v)
               for k, v in req.items()):
            for k, v in req.items():
                used[k] = used.get(k, 0) + v
        else:
            exceeded[host] = True
        for c in p.spec.containers:
            for cp in c.ports:
                if cp.host_port:
                    ports[host].add(cp.host_port)
        for v in p.spec.volumes:
            if v.source.gce_persistent_disk is not None:
                pds[host].add(v.source.gce_persistent_disk.pd_name)

    gate = preemption_possible(
        band_values_of(existing_pods, node_index), pending_pods)

    def pod_ports_of(pod: api.Pod) -> set:
        return {cp.host_port for c in pod.spec.containers
                for cp in c.ports if cp.host_port}

    def pod_pds_of(pod: api.Pod) -> set:
        return {v.source.gce_persistent_disk.pd_name
                for v in pod.spec.volumes
                if v.source.gce_persistent_disk is not None}

    def diagnose(pod: api.Pod) -> PodDiagnosis:
        req = _req_vec(pod)
        zero_req = not any(req.values())
        p_ports = pod_ports_of(pod)
        p_pds = pod_pds_of(pod)
        counts: Dict[str, int] = {}

        def hit(reason: str) -> None:
            counts[reason] = counts.get(reason, 0) + 1

        for name in node_order:
            cap = caps[name]
            used = fit_used[name]
            if pol.use_ports and p_ports & ports[name]:
                hit(REASON_PORT)
                continue
            if pol.use_resources and not zero_req:
                bad = [k for k, v in req.items()
                       if not _preds.dim_fits(
                           k, cap.get(k, 0),
                           cap.get(k, 0) - used.get(k, 0), v)]
                if bad:
                    hit(insufficient_reason(min(bad, key=_rank_key)))
                    continue
                if exceeded[name]:
                    hit(REASON_OVERCOMMIT)
                    continue
            if pol.use_disk and p_pds & pds[name]:
                hit(REASON_PD)
                continue
            if pol.use_selector and pod.spec.node_selector and \
                    any(labels[name].get(k) != v
                        for k, v in pod.spec.node_selector.items()):
                hit(REASON_SELECTOR)
                continue
            if pol.use_host and pod.spec.host and pod.spec.host != name:
                hit(REASON_HOST)
                continue
            if not extra_ok[name]:
                hit(REASON_LABEL)
        pstate = ""
        if gate:
            pstate = "no_prefix" if api.pod_can_preempt(pod) else "Never"
        return PodDiagnosis(len(node_order), counts, pstate)

    diags: List[Optional[PodDiagnosis]] = []
    for j, pod in enumerate(pending_pods):
        host = decisions[j]
        if host is None:
            diags.append(diagnose(pod))
            continue
        diags.append(None)
        used = fit_used[host]
        for v in victims[j] or ():
            # eviction frees resources only; the victim's ports/PDs are
            # conservatively retained for the rest of the wave
            for k, amt in _req_vec(by_uid[v.uid]).items():
                used[k] = used.get(k, 0) - amt
        for k, amt in _req_vec(pod).items():
            used[k] = used.get(k, 0) + amt
        ports[host] |= pod_ports_of(pod)
        pds[host] |= pod_pds_of(pod)
    return decisions, diags


# ---------------------------------------------------------------------------
# kube-defrag serial oracle
# ---------------------------------------------------------------------------

def defrag_serial(nodes: Sequence[api.Node],
                  existing_pods: Sequence[api.Pod],
                  services: Sequence[api.Service] = (),
                  cfg=None,
                  provider: str = schedplugins.DEFAULT_PROVIDER,
                  policy: Optional[schedplugins.Policy] = None):
    """Serial twin of models/defrag (select_candidates + plan_defrag) —
    the whole consolidation rule walked pod-by-pod over the object
    graph, nothing dense. Returns ``(moves, score_before,
    score_mandatory, score_after)`` with ``moves`` a list of
    models.defrag.Move; the planes path must match all four bit-for-bit
    (tests/test_defrag.py fixtures + fuzz over both encoders).

    The rule (models/defrag.py module docstring is the definition):
    mandatory cordon-drain candidates first (node order, then
    (priority, uid)), voluntary candidates from fully-movable
    emptiest-first source nodes within the budget; per candidate the
    tightest feasible non-source target wins (free-permille after
    placement, FNV-1a tie-break in node order); a committed move frees
    the source's resources but conservatively retains its ports/PDs
    (the preemption carry); voluntary groups are all-or-nothing per
    source; the voluntary set is dropped wholesale unless it strictly
    improves the score over the mandatory-only outcome."""
    from kubernetes_tpu_torch.models.defrag import (
        DO_NOT_DISRUPT_ANNOTATION,
        DefragConfig,
        Move,
    )
    from kubernetes_tpu_torch.models.gang import gang_key
    from kubernetes_tpu_torch.models.policy import batch_policy_from

    cfg = cfg or DefragConfig()
    pol = batch_policy_from(provider, policy)
    node_order = [n.metadata.name for n in nodes]
    node_of = {n.metadata.name: n for n in nodes}
    caps = {nm: _preds.capacity_values(node_of[nm].spec.capacity)
            for nm in node_order}
    labels = {nm: dict(node_of[nm].metadata.labels or {})
              for nm in node_order}
    cordoned = {nm for nm in node_order if node_of[nm].spec.unschedulable}
    extra_ok = {nm: nm not in cordoned for nm in node_order}
    for nm in node_order:
        for lbls, presence in pol.label_presence:
            if any((l in labels[nm]) != presence for l in lbls):
                extra_ok[nm] = False
                break

    by_host: Dict[str, List[api.Pod]] = {}
    for p in existing_pods:
        if p.status.host in caps:
            by_host.setdefault(p.status.host, []).append(p)

    # wave-start greedy state, existing-list order (the shared
    # pre-exceeded rule), plus ports/PDs and resident counts
    used: Dict[str, Dict[str, int]] = {nm: {} for nm in node_order}
    exceeded: Dict[str, bool] = {nm: False for nm in node_order}
    ports: Dict[str, set] = {nm: set() for nm in node_order}
    pds: Dict[str, set] = {nm: set() for nm in node_order}
    cnt: Dict[str, int] = {nm: 0 for nm in node_order}
    for p in existing_pods:
        host = p.status.host
        if host not in caps:
            continue
        cnt[host] += 1
        cap = caps[host]
        u = used[host]
        req = _req_vec(p)
        if all(_preds.dim_fits(k, cap.get(k, 0),
                               cap.get(k, 0) - u.get(k, 0), v)
               for k, v in req.items()):
            for k, v in req.items():
                u[k] = u.get(k, 0) + v
        else:
            exceeded[host] = True
        for c in p.spec.containers:
            for cp in c.ports:
                if cp.host_port:
                    ports[host].add(cp.host_port)
        for v in p.spec.volumes:
            if v.source.gce_persistent_disk is not None:
                pds[host].add(v.source.gce_persistent_disk.pd_name)

    def movable(p: api.Pod) -> bool:
        if p.metadata.namespace in cfg.protected_namespaces:
            return False
        if gang_key(p) is not None:
            return False
        if api.pod_priority(p) >= cfg.priority_ceiling:
            return False
        ann = p.metadata.annotations or {}
        if ann.get(DO_NOT_DISRUPT_ANNOTATION, "false") != "false":
            return False
        return p.spec.host == p.status.host

    def order_key(p: api.Pod):
        return (api.pod_priority(p), p.metadata.uid)

    def score() -> int:
        total = 0
        for nm in node_order:
            if cnt[nm] <= 0:
                continue
            cap = caps[nm]
            u = used[nm]
            for name in (api.ResourceCPU, api.ResourceMemory):
                c = cap.get(name, 0)
                if c > 0:
                    total += max(c - u.get(name, 0), 0) * 1000 // c
        return total

    # -- candidate selection (defrag.select_candidates twin) ---------------
    mandatory: List[api.Pod] = []
    for nm in node_order:
        if nm not in cordoned or exceeded[nm]:
            continue
        for p in sorted(by_host.get(nm, ()), key=order_key):
            if movable(p):
                mandatory.append(p)
    budget = max(0, cfg.max_moves - len(mandatory))
    ranked = []
    for i, nm in enumerate(node_order):
        resident = by_host.get(nm, ())
        if nm in cordoned or not resident or exceeded[nm]:
            continue
        if not all(movable(p) for p in resident):
            continue
        permille = 0
        cap = caps[nm]
        total: Dict[str, int] = {}
        for p in resident:
            for k, v in _req_vec(p).items():
                total[k] = total.get(k, 0) + v
        for name in (api.ResourceCPU, api.ResourceMemory):
            c = cap.get(name, 0)
            if c > 0:
                permille += total.get(name, 0) * 1000 // c
        if permille >= cfg.source_max_permille:
            continue
        ranked.append((permille, i, nm, sorted(resident, key=order_key)))
    ranked.sort(key=lambda t: (t[0], t[1]))
    n_targets = sum(1 for nm in node_order
                    if nm not in cordoned and not exceeded[nm])
    groups: List[Tuple[str, List[api.Pod]]] = []
    sources: set = set()
    for _permille, _i, nm, resident in ranked:
        # target-floor twin: never consume the last schedulable
        # non-source node
        if n_targets - len(sources) < 2:
            break
        if len(resident) > budget:
            break
        budget -= len(resident)
        sources.add(nm)
        groups.append((nm, resident))

    # -- the wave ----------------------------------------------------------
    def try_place(p: api.Pod, voluntary: bool) -> Optional[str]:
        src = p.status.host
        req = _req_vec(p)
        p_ports = {cp.host_port for c in p.spec.containers
                   for cp in c.ports if cp.host_port}
        p_pds = {v.source.gce_persistent_disk.pd_name
                 for v in p.spec.volumes
                 if v.source.gce_persistent_disk is not None}
        feasible: List[Tuple[str, int]] = []
        for nm in node_order:
            if nm == src or nm in sources or exceeded[nm] \
                    or not extra_ok[nm]:
                continue
            if voluntary and cnt[nm] <= 0:
                continue
            cap = caps[nm]
            u = used[nm]
            if not all(_preds.dim_fits(k, cap.get(k, 0),
                                       cap.get(k, 0) - u.get(k, 0), v)
                       for k, v in req.items()):
                continue
            if p_ports & ports[nm] or p_pds & pds[nm]:
                continue
            if p.spec.node_selector and \
                    any(labels[nm].get(k) != v
                        for k, v in p.spec.node_selector.items()):
                continue
            fit = 0
            for name in (api.ResourceCPU, api.ResourceMemory):
                c = cap.get(name, 0)
                if c > 0:
                    fit += max(c - u.get(name, 0) - req.get(name, 0), 0) \
                        * 1000 // c
            feasible.append((nm, fit))
        if not feasible:
            return None
        best = min(f for _nm, f in feasible)
        tied = [nm for nm, f in feasible if f == best]
        t = tied[fnv1a64(pod_tie_break_key(p)) % len(tied)]
        # commit: resources leave the source, ports/PDs conservatively
        # retained there; the target gains everything
        u_src = used[src]
        for k, v in req.items():
            u_src[k] = u_src.get(k, 0) - v
        u_t = used[t]
        for k, v in req.items():
            u_t[k] = u_t.get(k, 0) + v
        ports[t] |= p_ports
        pds[t] |= p_pds
        cnt[src] -= 1
        cnt[t] += 1
        return t

    score_before = score()
    moves: List[Move] = []
    for p in mandatory:
        t = try_place(p, voluntary=False)
        if t is not None:
            moves.append(Move(p.metadata.uid, p.metadata.name,
                              p.metadata.namespace, p.status.host, t, True))
    score_mandatory = score()

    vol_moves: List[Move] = []
    for nm, resident in groups:
        mark = (copy.deepcopy(used), {k: set(v) for k, v in ports.items()},
                {k: set(v) for k, v in pds.items()}, dict(cnt))
        placed: List[Move] = []
        ok = True
        for p in resident:
            t = try_place(p, voluntary=True)
            if t is None:
                ok = False
                break
            placed.append(Move(p.metadata.uid, p.metadata.name,
                               p.metadata.namespace, p.status.host, t,
                               False))
        if ok:
            vol_moves.extend(placed)
        else:
            used.clear(); used.update(mark[0])
            ports.clear(); ports.update(mark[1])
            pds.clear(); pds.update(mark[2])
            cnt.clear(); cnt.update(mark[3])
    score_after = score()
    if vol_moves and score_after >= score_mandatory:
        # the acceptance gate: no strict improvement -> the voluntary
        # set is dropped wholesale (mandatory drain moves stay)
        vol_moves = []
        score_after = score_mandatory
    return moves + vol_moves, score_before, score_mandatory, score_after
