"""ClusterSnapshot — dense-array encoding of one scheduling wave.

Port of ``kubernetes_tpu/models/snapshot.py`` (the analog of the
reference's per-cycle ``MapPodsToMachines`` pivot, pkg/scheduler/
predicates.go:354-375): one host-side numpy pass encodes nodes, existing
pods and the pending batch into fixed-shape arrays the batch solver
consumes. Label selectors, host ports and GCE PD names are interned into
small per-wave vocabularies, so every check is exact.

Resource state mirrors predicates.go: a greedy-fitting usage plus an
exceeded flag per node (CheckPodsExceedingCapacity :104-124) for the
Filter, and the sum over ALL pods for LeastRequested scoring
(priorities.go:41-75). Service spreading: per (namespace, first matching
service) group counts by host, plus one overflow slot for unassigned or
unknown hosts (spreading.go:62-68); the group axis pads to a power of two.

The policy extensions are encoded too: CheckNodeLabelPresence folds into
the static node mask, NodeLabelPriority is a static score plane,
CheckServiceAffinity carries per-label value codes and per-group anchors,
and ServiceAntiAffinity per-label zone codes. Gang run ids and the
preemption bands are encoded for the solver.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from itertools import chain
from operator import itemgetter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.models import gang
from kubernetes_tpu_torch.models import preempt as _preempt
from kubernetes_tpu_torch.models.policy import (BatchPolicy,
                                                DEFAULT_BATCH_POLICY)
from kubernetes_tpu_torch.scheduler import predicates as _preds
from kubernetes_tpu_torch.scheduler.generic import (
    FNV64_OFFSET,
    FNV64_PRIME,
    pod_tie_break_key,
)
from kubernetes_tpu_torch.util import tracing

__all__ = ["ClusterSnapshot", "encode_snapshot", "greedy_fit_accumulators"]

# KTPU_DEBUG=1: recompute every _ktpu_rows cache hit from the object graph
# and assert it matches — catches an in-place PodSpec mutation, which the
# cache's correctness forbids (see container_rows and runtime/clone.py)
_DEBUG_VERIFY_ROWS = os.environ.get("KTPU_DEBUG", "") not in ("", "0")


def _fnv1a64_batch(keys: List[str]) -> np.ndarray:
    """Vectorized FNV-1a-64 over a batch of strings (same results as
    scheduler.generic.fnv1a64): the per-byte chain runs over the longest
    key, a dozen numpy passes over [P] instead of P Python loops."""
    if not keys:
        return np.zeros(0, np.uint64)
    bs = [k.encode("utf-8") for k in keys]
    maxlen = max(len(b) for b in bs)
    if maxlen == 0:
        return np.full(len(bs), FNV64_OFFSET, np.uint64)
    buf = np.frombuffer(b"".join(b.ljust(maxlen, b"\0") for b in bs),
                        np.uint8).reshape(len(bs), maxlen)
    lens = np.array([len(b) for b in bs])
    h = np.full(len(bs), FNV64_OFFSET, np.uint64)
    prime = np.uint64(FNV64_PRIME)
    for c in range(maxlen):
        nh = (h ^ buf[:, c].astype(np.uint64)) * prime  # wraps mod 2^64
        h = np.where(c < lens, nh, h)
    return h


def greedy_fit_accumulators(cap: np.ndarray, score_used: np.ndarray,
                            pods_in_order) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy Filter accumulators (CheckPodsExceedingCapacity :104-124):
    when a node's total existing usage fits its capacity every prefix fit
    too, so only the overflowing nodes walk ``pods_in_order`` — an
    iterable of (host_idx, req_vec[R]) in existing-list order. cpu and
    memory are unconstrained at zero capacity; other dims are strict."""
    N, R = cap.shape
    fit_used = score_used.copy()
    fit_exceeded = np.zeros(N, bool)
    is_core = np.arange(R) < 2
    unconstrained = (cap == 0) & is_core[None, :]
    all_fit = (unconstrained | (score_used <= cap)).all(axis=1)
    if not all_fit.all():
        slow = set(np.nonzero(~all_fit)[0].tolist())
        per_host: Dict[int, np.ndarray] = {
            i: np.zeros(R, np.int64) for i in slow}
        for i, e_req in pods_in_order:
            i = int(i)
            if i not in per_host:
                continue
            used = per_host[i]
            if bool((unconstrained[i] | (cap[i] - used >= e_req)).all()):
                per_host[i] = used + e_req
            else:
                fit_exceeded[i] = True
        for i, used in per_host.items():
            fit_used[i] = used
    return fit_used, fit_exceeded


def _pow2_pad(n: int, minimum: int = 8) -> int:
    """Next power of two >= max(n, minimum)."""
    out = minimum
    while out < n:
        out *= 2
    return out


@dataclass
class ClusterSnapshot:
    """All arrays are numpy; the solver moves them to the device."""

    node_names: List[str]
    # [N, R] planes; resource_names[0:2] is [cpu, memory], then the
    # node-advertised extras, then request-only dims. ``advertised`` is
    # capacity-key PRESENCE (a zero-quantity advertisement still widens
    # the LeastRequested divisor).
    resource_names: List[str]
    cap: np.ndarray              # [N, R] i64 (cpu in milli-units)
    advertised: np.ndarray       # [N, R] bool
    fit_used: np.ndarray         # [N, R] i64 greedy-fitting usage (Filter)
    fit_exceeded: np.ndarray     # [N] bool — an existing pod didn't fit
    score_used: np.ndarray       # [N, R] i64 all-pods usage (Score)
    node_ports: np.ndarray       # [N, K] bool
    node_sel: np.ndarray         # [N, K2] bool — node has (key,value) label
    node_pds: np.ndarray         # [N, K3] bool
    node_extra_ok: np.ndarray    # [N] bool — cordon + caller mask
    pod_names: List[str]
    req: np.ndarray              # [P, R] i64
    pod_ports: np.ndarray        # [P, K] bool
    pod_sel: np.ndarray          # [P, K2] bool — required (key,value) pairs
    pod_pds: np.ndarray          # [P, K3] bool
    pod_host_idx: np.ndarray     # [P] i32: -1 unset, -2 host not in list
    tie_hi: np.ndarray           # [P] i64 — fnv1a64(pod key) >> 32
    tie_lo: np.ndarray           # [P] i64 — fnv1a64(pod key) & 0xffffffff
    pod_gid: np.ndarray          # [P] i32, -1 = no service
    pod_group_member: np.ndarray  # [P, G] bool
    group_counts: np.ndarray     # [G, N+1] i32 (slot N: unassigned hosts)
    pod_rid: np.ndarray = None        # [P] i32 gang run id, -1 singleton
    pod_run_start: np.ndarray = None  # [P] bool — checkpoint marker
    # policy extensions (minimal shapes when the policy does not use them)
    score_static: np.ndarray = None    # [N] i32 NodeLabelPriority terms
    node_aff_vals: np.ndarray = None   # [N, L] i32 value codes, -1 absent
    pod_aff_static: np.ndarray = None  # [P, L] i32 codes, -2 unpinned
    anchor_vals0: np.ndarray = None    # [G, L] i32 initial anchor values
    has_anchor0: np.ndarray = None     # [G] bool
    node_zone: np.ndarray = None       # [A, N] i32 zone codes, -1 unlabeled
    # [A, G, V] per-group per-zone initial peers; None = derive from
    # node_zone x group_counts (batch_solver.derive_zone_counts)
    zone_counts0: np.ndarray = None
    pod_prio: np.ndarray = None       # [P] i32 resolved priorities
    pod_can_preempt: np.ndarray = None  # [P] bool
    band_prio: np.ndarray = None      # [B] i32, BAND_EMPTY padded
    evict_cap: np.ndarray = None      # [N, B, R] i64
    evict_cnt: np.ndarray = None      # [N, B] i32
    policy: BatchPolicy = field(default_factory=lambda: DEFAULT_BATCH_POLICY)

    @property
    def n_nodes(self) -> int:
        return len(self.node_names)

    @property
    def n_pods(self) -> int:
        return len(self.pod_names)

    @property
    def has_gangs(self) -> bool:
        return self.pod_rid is not None and bool((self.pod_rid >= 0).any())


def encode_snapshot(nodes: Sequence[api.Node],
                    existing_pods: Sequence[api.Pod],
                    pending_pods: Sequence[api.Pod],
                    services: Sequence[api.Service] = (),
                    node_extra_ok: Optional[np.ndarray] = None,
                    policy: Optional[BatchPolicy] = None) -> ClusterSnapshot:
    """Encode one scheduling wave. Node order defines the tie-break order
    and must match what the serial oracle sees."""
    policy = policy or DEFAULT_BATCH_POLICY
    N, P, E = len(nodes), len(pending_pods), len(existing_pods)

    # -- capacities: R-dimensional planes -----------------------------------
    # scored dims (cpu, memory, node-advertised extras) first; dims only
    # requested by pods are appended: they constrain but never score
    with tracing.span("encode.nodes", nodes=N):
        node_index = {n.metadata.name: i for i, n in enumerate(nodes)}
        scored = _preds.resource_universe(nodes)
    seen = set(scored)
    request_only: List[str] = []
    CPU = api.ResourceCPU

    # one traversal a pod LIFETIME extracts its (resource, value) rows and
    # host ports, cached on the spec object: a stored PodSpec's containers
    # are never mutated in place (a change goes through
    # runtime.clone.deep_clone, which drops undeclared attributes), and a
    # live scheduler re-encodes the same reflector-store objects every
    # wave. The request-only dims are wave-local and collected over the
    # cached rows.
    def derive(spec):
        lr, pr = [], []
        for c in spec.containers:
            for name, q in c.resources.limits.items():
                lr.append((name, q.milli_value() if name == CPU
                           else q.int_value()))
            for cp in c.ports:
                if cp.host_port:
                    pr.append(cp.host_port)
        return (lr, pr)

    def rows_of(p):
        spec = p.spec
        cached = spec.__dict__.get("_ktpu_rows")
        if cached is None:
            cached = derive(spec)
            spec.__dict__["_ktpu_rows"] = cached
        elif _DEBUG_VERIFY_ROWS:
            fresh = derive(spec)
            assert fresh == cached, (
                f"_ktpu_rows cache stale for pod "
                f"{p.metadata.namespace}/{p.metadata.name}: cached "
                f"{cached!r} != recomputed {fresh!r} — a PodSpec was "
                f"mutated in place after encoding (mutations must go "
                f"through runtime.clone.deep_clone, which drops the "
                f"cache)")
        return cached

    def container_rows(pods):
        limits, ports = [], []
        for p in pods:
            lr, pr = rows_of(p)
            for name, _v in lr:
                if name not in seen:
                    seen.add(name)
                    request_only.append(name)
            limits.append(lr)
            ports.append(pr)
        return limits, ports

    with tracing.span("encode.pending", pods=P):
        pend_limits, pend_ports = container_rows(pending_pods)

    # -- service selector vocabulary ----------------------------------------
    services = list(services)
    S = len(services)
    svc_vocab: Dict[Tuple[str, str], int] = {}
    ns_codes: Dict[str, int] = {}

    def intern(vocab, key):
        if key not in vocab:
            vocab[key] = len(vocab)
        return vocab[key]

    sv_ij: List[Tuple[int, int]] = []
    for si, s in enumerate(services):
        for kv in (s.spec.selector or {}).items():
            sv_ij.append((si, intern(svc_vocab, kv)))

    # -- existing pods: one gathering pass into flat lists; the arrays are
    # built in bulk once the pending pass has closed the vocabularies. A
    # sub-walk whose vocabulary is empty can match nothing and is skipped;
    # namespaces matter only to service membership, so they go with labels
    walk_labels = bool(svc_vocab)
    with tracing.span("encode.residents", pods=E):
        e_rows: List[tuple] = []              # each resident's cached rows
        e_hosts: List[int] = []               # node index, -1 off the list
        e_prios: List[int] = []
        e_nsl: List[int] = []                 # codes into ns_seen
        ns_seen: Dict[str, int] = {}
        ef_ij: List[Tuple[int, int]] = []     # (pod, service-selector-vocab)
        add_rows, add_host = e_rows.append, e_hosts.append
        add_prio, add_ns = e_prios.append, e_nsl.append
        host_of, pod_priority = node_index.get, api.pod_priority
        for e, p in enumerate(existing_pods):
            rows = p.spec.__dict__.get("_ktpu_rows")
            if rows is None or _DEBUG_VERIFY_ROWS:
                rows = rows_of(p)
            add_rows(rows)
            add_host(host_of(p.status.host, -1))
            add_prio(pod_priority(p))
            if walk_labels:
                meta = p.metadata
                add_ns(ns_seen.setdefault(meta.namespace, len(ns_seen)))
                for kv in (meta.labels or {}).items():
                    t = svc_vocab.get(kv)
                    if t is not None:
                        ef_ij.append((e, t))
        # name, value, name, value, ... over every resident's rows
        e_flat = list(chain.from_iterable(chain.from_iterable(
            map(itemgetter(0), e_rows))))
        e_names = e_flat[0::2]
        for name in set(e_names) - seen:
            seen.add(name)
            request_only.append(name)
    resource_names = scored + sorted(request_only)
    R = len(resource_names)
    rindex = {name: r for r, name in enumerate(resource_names)}
    with tracing.span("encode.nodes", nodes=N):
        cap = np.zeros((N, R), np.int64)
        advertised = np.zeros((N, R), bool)
        for i, n in enumerate(nodes):
            for name, q in (n.spec.capacity or {}).items():
                r = rindex.get(name)
                if r is not None:
                    cap[i, r] = _preds.resource_value(name, q)
                    advertised[i, r] = True

    # -- pending pods: one Python pass pulls every field --------------------
    with tracing.span("encode.pending", pods=P):
        port_vocab: Dict[int, int] = {}
        sel_vocab: Dict[Tuple[str, str], int] = {}
        pd_vocab: Dict[str, int] = {}

        req = np.zeros((P, R), np.int64)
        pod_host_idx = np.full(P, -1, np.int32)
        pod_prio = np.zeros(P, np.int32)
        pod_can_preempt = np.ones(P, bool)
        pod_names: List[str] = []
        pp_ij: List[Tuple[int, int]] = []   # (pod, port-vocab)
        ps_ij: List[Tuple[int, int]] = []   # (pod, selector-vocab)
        pg_ij: List[Tuple[int, int]] = []   # (pod, pd-vocab)
        pf_ij: List[Tuple[int, int]] = []   # (pod, service-selector-vocab)
        pod_ns = np.zeros(P, np.int32)
        for j, p in enumerate(pending_pods):
            meta, spec = p.metadata, p.spec
            pod_names.append(f"{meta.namespace}/{meta.name}")
            pod_ns[j] = intern(ns_codes, meta.namespace)
            for kv in (meta.labels or {}).items():
                t = svc_vocab.get(kv)
                if t is not None:
                    pf_ij.append((j, t))
            for name, val in pend_limits[j]:
                req[j, rindex[name]] += val
            for hp in pend_ports[j]:
                pp_ij.append((j, intern(port_vocab, hp)))
            for kv in (spec.node_selector or {}).items():
                ps_ij.append((j, intern(sel_vocab, kv)))
            for v in spec.volumes:
                if v.source.gce_persistent_disk is not None:
                    pg_ij.append((j, intern(
                        pd_vocab, v.source.gce_persistent_disk.pd_name)))
            if spec.host:
                pod_host_idx[j] = node_index.get(spec.host, -2)
            pod_prio[j] = api.pod_priority(p)
            pod_can_preempt[j] = api.pod_can_preempt(p)
        pod_rid, pod_run_start = gang.pod_run_ids(pending_pods)
        tie = _fnv1a64_batch([pod_tie_break_key(p) for p in pending_pods])
        tie_hi = (tie >> np.uint64(32)).astype(np.int64)
        tie_lo = (tie & np.uint64(0xFFFFFFFF)).astype(np.int64)

        # pow-2 buckets on every vocabulary axis
        K = _pow2_pad(len(port_vocab))
        K2 = _pow2_pad(len(sel_vocab))
        K3 = _pow2_pad(len(pd_vocab))

        def scatter_true(pairs, rows, cols) -> np.ndarray:
            out = np.zeros((rows, cols), bool)
            if pairs:
                idx = np.asarray(pairs, np.int64)
                out[idx[:, 0], idx[:, 1]] = True
            return out

        pod_ports = scatter_true(pp_ij, P, K)
        pod_sel = scatter_true(ps_ij, P, K2)
        pod_pds = scatter_true(pg_ij, P, K3)

    with tracing.span("encode.nodes", nodes=N):
        node_sel = np.zeros((N, K2), bool)
        for i, n in enumerate(nodes):
            for kv in (n.metadata.labels or {}).items():
                k = sel_vocab.get(kv)
                if k is not None:
                    node_sel[i, k] = True

    with tracing.span("encode.residents", pods=E) as sp:
        e_host = np.array(e_hosts, np.int64)
        e_host[e_host < 0] = N                # N = unknown/unassigned slot
        e_prio = np.array(e_prios, np.int32)
        # unseen namespaces can't match
        e_ns = (np.array([ns_codes.get(ns, -9) for ns in ns_seen],
                         np.int32)[np.array(e_nsl, np.intp)]
                if walk_labels else None)
        # one scatter of every row; duplicate names in one pod add up, as
        # a scalar += would
        owners = np.repeat(np.arange(E, dtype=np.int64), np.fromiter(
            map(len, map(itemgetter(0), e_rows)), np.int64, E))
        cols = np.fromiter(map(rindex.__getitem__, e_names), np.int64,
                           len(e_names))
        e_req = np.zeros((E, R), np.int64)
        np.add.at(e_req.reshape(-1), owners * R + cols,
                  np.array(e_flat[1::2], np.int64))
        np_ij: List[Tuple[int, int]] = []     # (node, port-vocab)
        nd_ij: List[Tuple[int, int]] = []     # (node, pd-vocab)
        if port_vocab:
            for i, (_lr, pr) in zip(e_hosts, e_rows):
                if i >= 0:
                    for hp in pr:
                        k = port_vocab.get(hp)
                        if k is not None:
                            np_ij.append((i, k))
        if pd_vocab:
            for i, p in zip(e_hosts, existing_pods):
                if i >= 0:
                    for v in p.spec.volumes:
                        if v.source.gce_persistent_disk is not None:
                            k = pd_vocab.get(
                                v.source.gce_persistent_disk.pd_name)
                            if k is not None:
                                nd_ij.append((i, k))
        sp.set(labels=int(walk_labels), services=S,
               ports=int(bool(port_vocab)), volumes=int(bool(pd_vocab)),
               rows=len(e_names))

        node_ports = scatter_true(np_ij, N, K)
        node_pds = scatter_true(nd_ij, N, K3)

        on_node = e_host < N
        score_used = np.zeros((N, R), np.int64)
        np.add.at(score_used, e_host[on_node], e_req[on_node])

        fit_used, fit_exceeded = greedy_fit_accumulators(
            cap, score_used, zip(e_host.tolist(), e_req))

        # -- preemption emit gate: bands ship only when some pending pod sits
        # strictly above some resident priority
        band_vals = np.unique(e_prio[on_node])
        if band_vals.size and P and \
                int(pod_prio.max(initial=-(2**31))) > band_vals[0]:
            B = _pow2_pad(len(band_vals), minimum=2)
            band_prio = np.full(B, _preempt.BAND_EMPTY, np.int32)
            band_prio[:len(band_vals)] = band_vals
            evict_cap, evict_cnt = _preempt.derive_evict_planes(
                e_host, e_prio, e_req, band_prio, N)
        else:
            band_prio = np.zeros(0, np.int32)
            evict_cap = np.zeros((N, 0, R), np.int64)
            evict_cnt = np.zeros((N, 0), np.int32)

    # -- service groups ----------------------------------------------------
    # group = (namespace, FIRST service whose selector matches the pod),
    # ServiceSpread's "just use the first service" (spreading.go:44);
    # membership of any pod is same namespace + selector match
    T = max(1, len(svc_vocab))
    svc_req = (scatter_true(sv_ij, max(1, S), T)[:S] if S
               else np.zeros((0, T), bool))
    req_cnt = svc_req.sum(axis=1).astype(np.int32)            # [S]
    svc_ns = np.array([(intern(ns_codes, s.metadata.namespace)
                        if s.metadata.namespace else -1) for s in services],
                      np.int32) if S else np.zeros(0, np.int32)

    def feat_matrix(pairs, rows) -> np.ndarray:
        out = np.zeros((max(1, rows), T), np.float32)
        if pairs:
            idx = np.asarray(pairs, np.int64)
            out[idx[:, 0], idx[:, 1]] = 1.0
        return out[:rows]

    group_ids: Dict[Tuple[int, int], int] = {}   # (ns_code, svc_idx) -> gid
    pod_gid = np.full(P, -1, np.int32)
    if S and P:
        with tracing.span("encode.pending", pods=P):
            hits = (feat_matrix(pf_ij, P)
                    @ svc_req.astype(np.float32).T)             # [P, S]
            subset_pending = hits == req_cnt[None, :]
            eligible = subset_pending & (req_cnt[None, :] > 0) & \
                ((svc_ns[None, :] == -1)
                 | (svc_ns[None, :] == pod_ns[:, None]))
            has_svc = eligible.any(axis=1)
            first_svc = np.argmax(eligible, axis=1)
            for j in np.nonzero(has_svc)[0]:
                key = (int(pod_ns[j]), int(first_svc[j]))
                if key not in group_ids:
                    group_ids[key] = len(group_ids)
                pod_gid[j] = group_ids[key]

    G_real = len(group_ids)
    G = _pow2_pad(max(1, G_real))
    group_counts = np.zeros((G, N + 1), np.int32)
    pod_group_member = np.zeros((P, G), bool)
    anchor_node = np.full(G, -1, np.int64)       # node of the initial anchor
    anchor_unknown = np.zeros(G, bool)           # the anchor is off-list
    if group_ids:
        g_ns = np.array([k[0] for k in group_ids], np.int32)     # [G_real]
        g_si = np.array([k[1] for k in group_ids], np.int64)
        pod_group_member[:, :G_real] = subset_pending[:, g_si] & \
            (pod_ns[:, None] == g_ns[None, :])
        if E:
            with tracing.span("encode.residents", pods=E):
                e_hits = feat_matrix(ef_ij, E) @ svc_req.astype(np.float32).T
                member_exist = (e_hits == req_cnt[None, :])[:, g_si] & \
                    (e_ns[:, None] == g_ns[None, :])             # [E, G_real]
                for g in range(G_real):
                    mask = member_exist[:, g]
                    if mask.any():
                        group_counts[g, :] = np.bincount(
                            e_host[mask], minlength=N + 1).astype(np.int32)
                        # the anchor is the first existing peer in list order
                        a = int(e_host[int(np.argmax(mask))])
                        if a < N:
                            anchor_node[g] = a
                        else:
                            anchor_unknown[g] = True

    # cordon: spec.unschedulable is structural (the always-on Schedulable
    # predicate), folded into the static node mask before the policy's
    # CheckNodeLabelPresence
    with tracing.span("encode.nodes", nodes=N):
        extra_ok = (node_extra_ok.copy() if node_extra_ok is not None
                    else np.ones(N, bool))
        for i, n in enumerate(nodes):
            if n.spec.unschedulable:
                extra_ok[i] = False
        if policy.label_presence:
            for i, n in enumerate(nodes):
                lbls = n.metadata.labels or {}
                for labels, presence in policy.label_presence:
                    if any((label in lbls) != presence for label in labels):
                        extra_ok[i] = False
                        break

        # NodeLabelPriority: a static additive score per node
        score_static = np.zeros(N, np.int32)
        if policy.label_prefs:
            for i, n in enumerate(nodes):
                lbls = n.metadata.labels or {}
                score_static[i] = sum(
                    10 * weight
                    for label, presence, weight in policy.label_prefs
                    if (label in lbls) == presence)

        # ServiceAffinity: per-label value codes and each group's anchor
        L = len(policy.affinity_labels)
        node_aff_vals = np.full((N, L), -1, np.int32)
        pod_aff_static = np.full((P, L), -2, np.int32)
        anchor_vals0 = np.full((G, L), -3, np.int32)
        has_anchor0 = np.zeros(G, bool)
        if L:
            for li, label in enumerate(policy.affinity_labels):
                vocab: Dict[str, int] = {}
                for i, n in enumerate(nodes):
                    v = (n.metadata.labels or {}).get(label)
                    if v is not None:
                        node_aff_vals[i, li] = intern(vocab, v)
                for j, p in enumerate(pending_pods):
                    v = (p.spec.node_selector or {}).get(label)
                    if v is not None:
                        pod_aff_static[j, li] = intern(vocab, v)
            has_anchor0[:] = (anchor_node >= 0) | anchor_unknown
            ok = anchor_node >= 0
            anchor_vals0[ok] = node_aff_vals[anchor_node[ok]]
            # a pod that consults an anchor on an unknown host fails its
            # schedule() serially (predicates.go:238-324) and is requeued: an
            # impossible pinned code makes exactly those pods infeasible
            if anchor_unknown.any():
                needs_anchor = ((pod_gid >= 0)
                                & (pod_aff_static == -2).any(axis=1))
                for j in np.nonzero(needs_anchor)[0]:
                    if anchor_unknown[pod_gid[j]]:
                        pod_aff_static[j, 0] = -100

        # ServiceAntiAffinity: per-label zone codes
        A = len(policy.anti_affinity)
        node_zone = np.full((A, N), -1, np.int32)
        for a, (label, _w) in enumerate(policy.anti_affinity):
            vocab = {}
            for i, n in enumerate(nodes):
                v = (n.metadata.labels or {}).get(label)
                if v is not None:
                    node_zone[a, i] = intern(vocab, v)
        node_names = [n.metadata.name for n in nodes]

    return ClusterSnapshot(
        node_names=node_names,
        resource_names=resource_names,
        cap=cap, advertised=advertised,
        fit_used=fit_used, fit_exceeded=fit_exceeded,
        score_used=score_used,
        node_ports=node_ports, node_sel=node_sel, node_pds=node_pds,
        node_extra_ok=extra_ok,
        pod_names=pod_names,
        req=req,
        pod_ports=pod_ports, pod_sel=pod_sel, pod_pds=pod_pds,
        pod_host_idx=pod_host_idx, tie_hi=tie_hi, tie_lo=tie_lo,
        pod_gid=pod_gid, pod_group_member=pod_group_member,
        group_counts=group_counts,
        pod_rid=pod_rid, pod_run_start=pod_run_start,
        score_static=score_static,
        node_aff_vals=node_aff_vals, pod_aff_static=pod_aff_static,
        anchor_vals0=anchor_vals0, has_anchor0=has_anchor0,
        node_zone=node_zone,
        pod_prio=pod_prio, pod_can_preempt=pod_can_preempt,
        band_prio=band_prio, evict_cap=evict_cap, evict_cnt=evict_cnt,
        policy=policy,
    )
