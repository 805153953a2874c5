"""kube-explain — batched unschedulability diagnosis from the dense planes.

Port of ``kubernetes_tpu/models/explain.py``, whole. The solve reports an
unschedulable pod as ``chosen == -1``; this module decomposes that
decision against the SAME planes the solve consumed — per-pod,
per-filter node-elimination counts — and renders the k8s-idiom event
line::

    0/10000 nodes available: 9988 Insufficient cpu, 12 Port conflict

**Attribution contract** (shared with the JAX package's ``explain_wave``
and its serial twin ``oracle.explain_serial``; count-identity between
them is the proof):

- a pod's diagnosis is evaluated against the cluster state *its own scan
  step saw*: the wave-start planes plus every EARLIER pod's committed
  placement (unschedulable pods change nothing; preempting placements
  subtract the evicted bands' capacity, and victims conservatively
  RETAIN their ports/PDs — the scan's conservative-retention carry);
- each eliminated node is attributed to exactly ONE reason, the first
  failing filter in the serial scheduler's short-circuit order:
  **Port conflict** -> **resources** -> **PD conflict** ->
  **Node selector mismatch** -> **Host mismatch** ->
  **Node label presence** (policy mask, checked last) — so per-pod
  counts are disjoint and sum to the node count;
- within resources, attribution goes to the first insufficient dimension
  in CANONICAL rank order (cpu, memory, then remaining resource names
  lexicographically — rank, not column index, so the full and
  incremental encoders' differing column orders cannot change a count),
  rendered ``Insufficient <resource>``; a greedy-pre-exceeded node whose
  headroom would otherwise fit reports **Node overcommitted**;
- when the wave shipped preemption bands (B > 0) the pod-level preempt
  state rides along: ``Never`` (preemptionPolicy forbids eviction) vs
  ``no_prefix`` (the pod may preempt, but the scan proved no
  lower-priority victim prefix frees enough anywhere).

**Where it runs**: strictly off the hot path — only for unschedulable
pods, on the planes the encoder already holds, as torch ops on the
wave's device (``cuda`` unless the caller passes another; the binary
passes its ``--device``). The pod axis goes in batches of at most
``_EXPLAIN_MAX_BATCH`` rows, which bounds the ``Q x N x R`` temporaries.
The three set-overlap products (selector, PD, port) are float64 matrix
products of 0/1 planes: exact, and never TF32 (TF32 applies to float32
products only), so the process-wide TF32 switch is left alone. The
:class:`Explainer` adds a token-bucket rate limit and refuses to run on
the pipelined loop's solve/commit threads; a declined wave keeps the
generic event message and is counted in ``scheduler_explain_skipped_total``.

Unsupported waves (diagnosis declines, never guesses): gang waves (the
checkpoint/rollback carry would need replaying), CheckServiceAffinity
policies (anchor state is arrival-order dependent), and all-infeasible
policies (no prioritizers: the serial path fails every pod before filters
run).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from kubernetes_tpu_torch.models import preempt as preempt_mod
from kubernetes_tpu_torch.models.batch_solver import resolve_device
from kubernetes_tpu_torch.models.snapshot import ClusterSnapshot
from kubernetes_tpu_torch.util import metrics

__all__ = ["PodDiagnosis", "ExplainUnsupported", "Explainer",
           "explain_wave", "format_message", "dominant_reason",
           "canonical_rank", "REASON_PORT", "REASON_OVERCOMMIT",
           "REASON_PD", "REASON_SELECTOR", "REASON_HOST", "REASON_LABEL",
           "REASON_UNEXPLAINED", "insufficient_reason"]

# The reason vocabulary (kubectl-visible strings; the metric's reason
# label values). Insufficient-<resource> is generated per dimension.
REASON_PORT = "Port conflict"
REASON_OVERCOMMIT = "Node overcommitted"
REASON_PD = "PD conflict"
REASON_SELECTOR = "Node selector mismatch"
REASON_HOST = "Host mismatch"
REASON_LABEL = "Node label presence"
# metrics-only bucket: unschedulable pods whose wave was not explained
# (rate-limited / unsupported / hot-path refusal) — the by-reason counter
# always sums to the pods counter
REASON_UNEXPLAINED = "unexplained"

# preempt-state rendering (PodDiagnosis.preempt -> event suffix)
_PREEMPT_SUFFIX = {
    "Never": "; preemption not attempted (preemptionPolicy: Never)",
    "no_prefix": "; preemption would not help (no lower-priority victim "
                 "set frees enough)",
}

# reason codes (precedence is applied by overwrite order in
# _diag_counts, NOT by code value): 0 = feasible, fixed codes below, and
# _CODE_RES + canonical-rank for Insufficient-<dim>
_CODE_PORT = 1
_CODE_OVERCOMMIT = 2
_CODE_PD = 3
_CODE_SELECTOR = 4
_CODE_HOST = 5
_CODE_LABEL = 6
_CODE_RES = 8

_FIXED_REASONS = ((_CODE_PORT, REASON_PORT),
                  (_CODE_OVERCOMMIT, REASON_OVERCOMMIT),
                  (_CODE_PD, REASON_PD),
                  (_CODE_SELECTOR, REASON_SELECTOR),
                  (_CODE_HOST, REASON_HOST),
                  (_CODE_LABEL, REASON_LABEL))

# pod rows per diagnosis batch: bounds the [Q, N, R] temporaries
_EXPLAIN_MAX_BATCH = 32


def insufficient_reason(resource: str) -> str:
    return f"Insufficient {resource}"


_log = logging.getLogger("kubernetes_tpu_torch.models.explain")


class ExplainUnsupported(Exception):
    """The wave's configuration is outside the diagnosis vocabulary;
    callers fall back to the generic FitError message."""


class PodDiagnosis(NamedTuple):
    """One unschedulable pod's decomposition: disjoint per-reason node
    counts (summing to ``n_nodes``) plus the preempt state (empty when
    the wave carried no bands)."""

    n_nodes: int
    counts: Dict[str, int]
    preempt: str = ""       # "" | "Never" | "no_prefix"


def canonical_rank(resource_names: Sequence[str]) -> np.ndarray:
    """[R] canonical attribution rank per snapshot column: cpu 0, memory
    1, everything else by name — column order (which differs between the
    full and incremental encoders' vocabularies) can never change which
    dimension a node's elimination is attributed to."""
    rest = sorted(n for n in resource_names[2:])
    order = {name: 2 + k for k, name in enumerate(rest)}
    return np.array([0 if r == 0 else 1 if r == 1
                     else order[name]
                     for r, name in enumerate(resource_names)], np.int32)


def format_message(diag: PodDiagnosis, top_k: int = 4) -> str:
    """The k8s-idiom FailedScheduling line: ``0/N nodes available:``
    plus the top-k reasons by count (ties broken by reason name), a
    summed ``other`` bucket for the tail, and the preempt-state suffix."""
    items = sorted(diag.counts.items(), key=lambda kv: (-kv[1], kv[0]))
    msg = f"0/{diag.n_nodes} nodes available"
    if items:
        parts = [f"{n} {reason}" for reason, n in items[:top_k]]
        rest = sum(n for _, n in items[top_k:])
        if rest:
            parts.append(f"{rest} other")
        msg += ": " + ", ".join(parts)
    return msg + _PREEMPT_SUFFIX.get(diag.preempt, "")


def dominant_reason(diag: PodDiagnosis) -> str:
    """The reason eliminating the most nodes (ties by name) — the
    ``scheduler_unschedulable_total{reason=...}`` bucket this pod lands
    in."""
    if not diag.counts:
        return REASON_UNEXPLAINED
    return min(diag.counts.items(), key=lambda kv: (-kv[1], kv[0]))[0]


def _overlap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[Q, N] count of shared set bits between bool rows a [Q, K] and
    b [N, K]: a float64 product of 0/1 planes, exact for any K < 2^53."""
    return a.to(torch.float64) @ b.to(torch.float64).T


def _diag_counts(cap, fit_used, fit_exceeded, node_ports, node_pds,
                 node_sel, extra_ok, rank, req, p_ports, p_pds, p_sel,
                 p_host, pol) -> torch.Tensor:
    """One diagnosis batch: [Q] pod rows against one carry state ->
    per-pod per-reason node counts [Q, 8 + R] (int64), on the tensors'
    device. The reference's ``_diag_kernel`` (a jitted program there)."""
    N, R = cap.shape
    Q = req.shape[0]
    dev = cap.device
    code = torch.zeros((Q, N), dtype=torch.int64, device=dev)

    # lowest-precedence first; each later filter overwrites, so the final
    # code per node is the FIRST failing filter in serial short-circuit
    # order (ports, resources, disk, selector, host, label-presence)
    code = torch.where(~extra_ok[None, :], _CODE_LABEL, code)
    if pol.use_host:
        host = p_host[:, None]
        host_ok = (host == -1) | (host == torch.arange(N, device=dev))
        code = torch.where(~host_ok, _CODE_HOST, code)
    if pol.use_selector:
        code = torch.where(_overlap(p_sel, ~node_sel) != 0, _CODE_SELECTOR,
                           code)
    if pol.use_disk:
        code = torch.where(_overlap(p_pds, node_pds) != 0, _CODE_PD, code)
    if pol.use_resources:
        unconstrained = (cap == 0) & (torch.arange(R, device=dev) < 2)
        insuf = ~(unconstrained[None, :, :]
                  | ((cap - fit_used)[None, :, :] >= req[:, None, :]))
        any_insuf = insuf.any(dim=2)
        first_rank = torch.where(insuf, rank, 2**30).amin(dim=2)
        zero_req = (req == 0).all(dim=1)
        res_fail = (~zero_req[:, None]) & (fit_exceeded[None, :] | any_insuf)
        code = torch.where(res_fail, torch.where(
            any_insuf, _CODE_RES + first_rank, _CODE_OVERCOMMIT), code)
    if pol.use_ports:
        code = torch.where(_overlap(p_ports, node_ports) != 0, _CODE_PORT,
                           code)

    C = _CODE_RES + R
    counts = torch.zeros((Q, C), dtype=torch.int64, device=dev)
    return counts.scatter_add_(1, code, torch.ones_like(code))


def explain_wave(snap: ClusterSnapshot, chosen, scores, device=None
                 ) -> Dict[int, PodDiagnosis]:
    """Diagnose every unschedulable pod of one solved wave.

    ``chosen``/``scores`` are the raw solve outputs (wave row order;
    pod-axis padding rows are ignored). Returns {row: PodDiagnosis} for
    rows with ``chosen < 0``. The carry is replayed host-side: walking
    the wave in order, unschedulable runs are diagnosed in one batch
    against the current planes on ``device`` (``cuda`` unless the caller
    names another), then each placed pod's commit (including
    preemption's freed capacity) is applied — so every pod is judged
    against exactly the state its own scan step saw.

    Raises :class:`ExplainUnsupported` for gang waves, affinity
    policies, and all-infeasible policies (see module docstring).
    """
    pol = snap.policy
    if pol.has_affinity:
        raise ExplainUnsupported(
            "CheckServiceAffinity policies are arrival-order dependent")
    if pol.all_infeasible:
        raise ExplainUnsupported(
            "no prioritizers configured: every pod fails before filters")
    if snap.has_gangs:
        raise ExplainUnsupported(
            "gang waves roll back through the checkpoint carry")

    P = len(snap.pod_names)
    chosen = np.asarray(chosen)[:P]
    scores = np.asarray(scores)[:P]
    unsched = np.nonzero(chosen < 0)[0]
    if unsched.size == 0:
        return {}
    N = len(snap.node_names)
    if N == 0:
        # the serial scheduler fails the whole wave before any predicate
        # runs (schedule() raises on an empty minion list)
        return {int(j): PodDiagnosis(0, {}) for j in unsched}
    dev = resolve_device(device)

    R = snap.cap.shape[1]
    rank = canonical_rank(snap.resource_names)
    rank_to_name = {int(rank[r]): name
                    for r, name in enumerate(snap.resource_names)}
    band_prio = snap.band_prio if snap.band_prio is not None \
        else np.zeros(0, np.int32)
    B = len(band_prio)

    # mutable carry replay state (wave-start planes, copied)
    fit_used = snap.fit_used.astype(np.int64)
    ports = snap.node_ports.copy()
    pds = snap.node_pds.copy()
    evict_cap = snap.evict_cap.copy() if B else None

    can_p = snap.pod_can_preempt if snap.pod_can_preempt is not None \
        else np.ones(P, bool)

    def on_dev(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=dev, dtype=dtype)

    # the planes no commit changes go to the device once per wave
    cap_t = on_dev(snap.cap, torch.int64)
    exceeded_t = on_dev(snap.fit_exceeded, torch.bool)
    sel_t = on_dev(snap.node_sel, torch.bool)
    extra_t = on_dev(snap.node_extra_ok, torch.bool)
    rank_t = on_dev(rank, torch.int64)
    out: Dict[int, PodDiagnosis] = {}

    def flush(batch: List[int]) -> None:
        fit_t = on_dev(fit_used, torch.int64)
        ports_t = on_dev(ports, torch.bool)
        pds_t = on_dev(pds, torch.bool)
        for lo in range(0, len(batch), _EXPLAIN_MAX_BATCH):
            rows = np.asarray(batch[lo:lo + _EXPLAIN_MAX_BATCH], np.int64)
            counts = _diag_counts(
                cap_t, fit_t, exceeded_t, ports_t, pds_t, sel_t, extra_t,
                rank_t, on_dev(snap.req[rows], torch.int64),
                on_dev(snap.pod_ports[rows], torch.bool),
                on_dev(snap.pod_pds[rows], torch.bool),
                on_dev(snap.pod_sel[rows], torch.bool),
                on_dev(snap.pod_host_idx[rows], torch.int64),
                pol).cpu().numpy()
            for k, j in enumerate(rows):
                row = counts[k]
                d: Dict[str, int] = {name: int(row[code])
                                     for code, name in _FIXED_REASONS
                                     if row[code]}
                for r in range(R):
                    c = row[_CODE_RES + r]
                    if c:
                        d[insufficient_reason(rank_to_name[r])] = int(c)
                pstate = ""
                if B:
                    # the scan already searched every (node, threshold)
                    # prefix and found none — re-deriving it would only
                    # restate chosen == -1 (module docstring)
                    pstate = "no_prefix" if can_p[j] else "Never"
                out[int(j)] = PodDiagnosis(N, d, pstate)

    batch: List[int] = []
    for j in range(P):
        c = int(chosen[j])
        if c < 0:
            batch.append(j)
            continue
        if batch:
            flush(batch)
            batch = []
        s = int(scores[j])
        if B and preempt_mod.is_preempt_score(s):
            # preempting commit: evicted bands leave both the fit
            # accumulator and the evictable planes; ports/PDs of victims
            # are conservatively retained (the scan's carry rule)
            ceiling = int(band_prio[preempt_mod.ceiling_slot(s)])
            emask = band_prio <= ceiling
            freed = evict_cap[c][emask].sum(axis=0)
            fit_used[c] += snap.req[j] - freed
            evict_cap[c][emask] = 0
        else:
            fit_used[c] += snap.req[j]
        ports[c] |= snap.pod_ports[j]
        pds[c] |= snap.pod_pds[j]
    if batch:
        flush(batch)
    return out


class Explainer:
    """The live scheduler's diagnosis gate: rate limit + thread
    discipline + metrics around :func:`explain_wave` on ``device``.

    Runs ONLY on the wave loop thread — never on the pipelined loop's
    solve or commit threads (their names are refused outright), so
    diagnosis never rides inside the solve/commit overlap window. A token
    bucket caps invocations (unschedulable pods requeue and re-diagnose
    every wave in a full cluster). Declined waves fall back to the
    generic FitError message and are counted by reason in
    ``scheduler_explain_skipped_total``; every unschedulable pod counts
    in ``scheduler_unschedulable_pods_total`` and exactly one
    ``scheduler_unschedulable_total{reason=...}`` bucket regardless
    (``unexplained`` when diagnosis was skipped), so the by-reason
    family always sums to the pods family.
    """

    _HOT_THREAD_PREFIXES = ("tpu-batch-solve", "tpu-batch-commit")

    def __init__(self, qps: float = 2.0, burst: int = 4, top_k: int = 4,
                 device=None):
        self._qps = qps
        self._burst = float(burst)
        self._tokens = float(burst)
        self._last = time.monotonic()
        self.top_k = top_k
        self.device = resolve_device(device)
        self._mx = metrics.explain_metrics()

    def _admit(self) -> bool:
        if self._qps <= 0:
            return True
        now = time.monotonic()
        self._tokens = min(self._burst,
                           self._tokens + (now - self._last) * self._qps)
        self._last = now
        if self._tokens < 1.0:
            return False
        self._tokens -= 1.0
        return True

    def _skip(self, reason: str, n_pods: int) -> Dict[int, str]:
        self._mx.skipped.inc(reason)
        self._mx.reasons.inc(REASON_UNEXPLAINED, by=n_pods)
        return {}

    def diagnose_wave(self, snap: ClusterSnapshot, chosen, scores,
                      n_unsched: Optional[int] = None) -> Dict[int, str]:
        """-> {wave row: FailedScheduling message} for unschedulable
        rows (empty when diagnosis was declined).

        ``n_unsched`` is the caller's count of pods it is about to fail
        — it can EXCEED count(chosen < 0) (the full-encoder path
        requeues preempt-scored rows by forcing their host to None while
        chosen stays >= 0); those extra rows are counted in the pods
        family and land in the ``unexplained`` bucket, keeping the
        sums-to-pods invariant. None derives the count from ``chosen``.
        """
        P = len(snap.pod_names)
        n_rows = int(np.count_nonzero(np.asarray(chosen)[:P] < 0))
        n = n_rows if n_unsched is None else max(int(n_unsched), n_rows)
        if n == 0:
            return {}
        self._mx.pods.inc(by=n)
        if threading.current_thread().name.startswith(
                self._HOT_THREAD_PREFIXES):
            return self._skip("hot_path", n)
        if not self._admit():
            return self._skip("rate_limited", n)
        t0 = time.thread_time()
        try:
            diags = explain_wave(snap, chosen, scores, device=self.device)
        except ExplainUnsupported:
            return self._skip("unsupported", n)
        except Exception:
            # the pods counter already advanced: the skip bucket must
            # too, or the by-reason family stops summing to it forever
            _log.exception("kube-explain diagnosis failed")
            return self._skip("error", n)
        self._mx.invocations.inc()
        self._mx.seconds.inc(by=max(0.0, time.thread_time() - t0))
        out = {}
        for row, diag in diags.items():
            self._mx.reasons.inc(dominant_reason(diag))
            out[row] = format_message(diag, top_k=self.top_k)
        if n > len(out):
            # rows failed by the caller without a chosen == -1 verdict
            # (the forced-requeue class above): disclosed, not dropped
            self._mx.reasons.inc(REASON_UNEXPLAINED, by=n - len(out))
        return out
