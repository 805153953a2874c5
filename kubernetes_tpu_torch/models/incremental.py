"""IncrementalEncoder — delta-maintained snapshot encoding for churn.

Port of ``kubernetes_tpu/models/incremental.py``. The full encoder
(models/snapshot.encode_snapshot) re-derives every plane from the object
graph each wave — the analog of the reference rebuilding
``MapPodsToMachines`` per scheduling cycle (ref: pkg/scheduler/
predicates.go:354-375). This encoder keeps the node-side planes
*resident* and applies deltas:

- **sticky vocabularies**: host ports, (key,value) node-selector pairs, PD
  names, namespaces, resource dimensions and priority bands intern into
  append-only vocabularies whose axes are pow-2 bucketed, so a churning
  cluster sees few distinct solver shapes;
- **refcounted node planes**: per-node port/PD use, service-group
  membership and zone counts increment on pod arrival and decrement on
  departure, so the per-wave cost is O(changed pods), not O(cluster);
- **order-exact overflow handling**: greedy-fit usage equals the plain sum
  on every node whose total fits; only overflowing nodes walk the
  existing list in order (and ``encode_delta``, which has no list, bails
  out to the full path), keeping bit-identity with the full encoder and
  the serial oracle;
- **pod-axis bucketing**: the pending wave pads to a pow-2 length with
  rows pinned to an impossible host (-2) and zero requests, which never
  place and never perturb real decisions.

The caller keeps the lister-shaped interface of the full encoder —
``encode(nodes, existing, pending, services)`` — and the encoder diffs
against its cached state by object identity + uid. ``checkpoint`` /
``restore`` snapshot the resident state for the scheduler's journal-replay
resync.

Not supported: policies with CheckServiceAffinity labels (anchor state is
first-peer-in-list-order dependent); construction raises ValueError and
the scheduler uses the full encoder. Pod specs are treated as immutable
after creation (only status/host change post-bind).
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.models import gang
from kubernetes_tpu_torch.models import preempt as _preempt
from kubernetes_tpu_torch.models.policy import (BatchPolicy,
                                                DEFAULT_BATCH_POLICY)
from kubernetes_tpu_torch.models.snapshot import (
    ClusterSnapshot,
    _fnv1a64_batch,
    _pow2_pad,
    greedy_fit_accumulators,
)
from kubernetes_tpu_torch.scheduler import predicates as _preds
from kubernetes_tpu_torch.scheduler.generic import pod_tie_break_key

__all__ = ["IncrementalEncoder"]

# KTPU_DEBUG=1: re-derive the resident evictable planes from the cached
# pod records every emitted wave and assert equality with the O(bands)
# incrementally-maintained ones (models/preempt.derive_evict_planes is
# the authoritative from-scratch twin)
_DEBUG_VERIFY_EVICT = os.environ.get("KTPU_DEBUG", "") not in ("", "0")


class _PodRec:
    """Cached contribution of one existing pod to the resident planes."""

    __slots__ = ("host_idx", "req", "ports", "pds", "ns_code", "svc_mask",
                 "prio", "name", "ns")

    def __init__(self, host_idx: int, req: List[Tuple[int, int]],
                 ports: List[int], pds: List[int], ns_code: int,
                 svc_mask: np.ndarray, prio: int = 0, name: str = "",
                 ns: str = ""):
        self.host_idx = host_idx   # node row, or N-sentinel for off-list
        self.req = req             # [(resource column, amount)]
        self.ports = ports         # port vocab columns (with multiplicity)
        self.pds = pds             # pd vocab columns
        self.ns_code = ns_code
        self.svc_mask = svc_mask   # [S] bool — selector-subset match per svc
        self.prio = prio           # resolved pod priority
        self.name = name           # pod name (victim materialization)
        self.ns = ns               # pod namespace


class _Vocab:
    """Append-only interner with pow-2 bucketed capacity."""

    def __init__(self):
        self.index: Dict = {}

    def intern(self, key) -> int:
        i = self.index.get(key)
        if i is None:
            i = self.index[key] = len(self.index)
        return i

    def __len__(self):
        return len(self.index)

    @property
    def cap(self) -> int:
        return _pow2_pad(len(self.index))


class IncrementalEncoder:
    def __init__(self, policy: Optional[BatchPolicy] = None):
        self.policy = policy or DEFAULT_BATCH_POLICY
        if self.policy.affinity_labels:
            raise ValueError(
                "IncrementalEncoder does not support CheckServiceAffinity "
                "policies (anchor state is arrival-order dependent); use "
                "encode_snapshot")
        self._nodes_key: Optional[List[Tuple]] = None
        self._svc_key: Optional[List[Tuple]] = None
        self._pods: Dict[str, _PodRec] = {}
        self._ports = _Vocab()
        self._sels = _Vocab()
        self._pds = _Vocab()
        self._ns = _Vocab()
        # sticky priority-band vocabulary (value -> slot) +
        # the monotone minimum over every value ever interned; bands emit
        # (self._preempt_emitted, sticky for shape stability) once any
        # pending pod sits strictly above the floor
        self._bands = _Vocab()
        self._band_min: Optional[int] = None
        self._preempt_emitted = False
        self._resource_names: List[str] = []
        # resident planes (allocated by _rebuild_nodes)
        self._N = 0
        # O(changed) accounting, read by the complexity guards of
        # tests/test_torch_incremental.py: zone_writes counts
        # single-element zone-plane updates, group_writes the group-count
        # ones, evict_writes the per-band evictable-plane updates,
        # node_rebuilds the full resident-plane rebuilds
        self.op_counts: Dict[str, int] = {
            "zone_writes": 0, "group_writes": 0, "node_rebuilds": 0,
            "evict_writes": 0}

    # -- node side ----------------------------------------------------------
    @staticmethod
    def _node_fp(n: api.Node) -> Tuple:
        return (n.metadata.name,
                bool(n.spec.unschedulable),
                tuple(sorted((n.metadata.labels or {}).items())),
                tuple(sorted((k, str(v.value)) for k, v in
                             (n.spec.capacity or {}).items())))

    def _nodes_changed(self, nodes: Sequence[api.Node]) -> bool:
        if self._nodes_key is None or len(nodes) != self._N:
            return True
        key = self._nodes_key
        for i, n in enumerate(nodes):
            cached_obj, cached_fp = key[i]
            if n is cached_obj:
                continue  # same object the store handed out before
                # (the cache holds the reference, so CPython can't reuse
                # the address for a different node behind our back)
            if self._node_fp(n) != cached_fp:
                return True
            key[i] = (n, cached_fp)  # relisted but identical
        return False

    def _rebuild_nodes(self, nodes: Sequence[api.Node],
                       existing: Sequence[api.Pod],
                       services: Sequence[api.Service]) -> None:
        """Node set/order/labels/capacity changed: rebuild every resident
        plane (node order defines the tie-break axis, so there is no safe
        partial update on reorder). Sticky vocabularies survive."""
        self._nodes_key = [(n, self._node_fp(n)) for n in nodes]
        self._N = N = len(nodes)
        self._node_names = [n.metadata.name for n in nodes]
        self._node_index = {nm: i for i, nm in enumerate(self._node_names)}
        self._node_labels = [dict(n.metadata.labels or {}) for n in nodes]

        scored = _preds.resource_universe(nodes)
        # sticky universe: scored dims first, previously-seen request-only
        # dims keep their columns (append-only indices)
        old = self._resource_names
        extras = [r for r in old if r not in scored]
        self._resource_names = scored + extras
        self._rix = {name: r for r, name in enumerate(self._resource_names)}
        R = len(self._resource_names)
        self._cap = np.zeros((N, R), np.int64)
        self._advertised = np.zeros((N, R), bool)
        for i, n in enumerate(nodes):
            for name, q in (n.spec.capacity or {}).items():
                r = self._rix.get(name)
                if r is not None:
                    self._cap[i, r] = _preds.resource_value(name, q)
                    self._advertised[i, r] = True

        self._score_used = np.zeros((N, R), np.int64)
        self._port_cnt = np.zeros((N, self._ports.cap), np.int32)
        self._pd_cnt = np.zeros((N, self._pds.cap), np.int32)
        self._node_sel = np.zeros((N, self._sels.cap), bool)
        for (k, v), col in self._sels.index.items():
            for i, lbls in enumerate(self._node_labels):
                if lbls.get(k) == v:
                    self._node_sel[i, col] = True

        # policy planes (all node-derived); cordon folds in first,
        # unconditionally (spec.unschedulable is in the fingerprint, so
        # a cordon/uncordon triggers the rebuild that lands here)
        self._extra_ok = np.ones(N, bool)
        for i, n in enumerate(nodes):
            if n.spec.unschedulable:
                self._extra_ok[i] = False
        for i, lbls in enumerate(self._node_labels):
            for labels, presence in self.policy.label_presence:
                if any((l in lbls) != presence for l in labels):
                    self._extra_ok[i] = False
                    break
        self._score_static = np.zeros(N, np.int32)
        for i, lbls in enumerate(self._node_labels):
            self._score_static[i] = sum(
                10 * w for label, presence, w in self.policy.label_prefs
                if (label in lbls) == presence)
        A = len(self.policy.anti_affinity)
        self._node_zone = np.full((A, N), -1, np.int32)
        for a, (label, _w) in enumerate(self.policy.anti_affinity):
            vocab: Dict[str, int] = {}
            for i, lbls in enumerate(self._node_labels):
                v = lbls.get(label)
                if v is not None:
                    if v not in vocab:
                        vocab[v] = len(vocab)
                    self._node_zone[a, i] = vocab[v]
        # zone codes are node-label-derived, so V is fixed until the next
        # node-plane rebuild; same V rule as snapshot_to_host_inputs
        self._zone_V = max(1, int(self._node_zone.max(initial=-1)) + 1)

        # group counts get a fresh [G, N+1] layout (and the zone-count
        # planes a matching [A, G, V] one); re-apply cached pods
        self._grp_rows: Dict[Tuple[int, int], int] = {}
        self._grp_cnt = np.zeros((8, N + 1), np.int32)
        self._zone_cnt = np.zeros((A, 8, self._zone_V), np.int32)
        # preemption resident planes: [N, B, R] evictable capacity +
        # [N, B] counts over the sticky band vocabulary, plus the
        # per-node pod registry victim materialization reads
        Bc = self._bands.cap if len(self._bands) else 0
        self._evict_cap = np.zeros((N, Bc, R), np.int64)
        self._evict_cnt = np.zeros((N, Bc), np.int32)
        self._node_pods: Dict[int, Dict[str, _PodRec]] = {}
        self.op_counts["node_rebuilds"] += 1
        self._pods.clear()
        self._set_services(services)
        for p in existing:
            self._add_pod(p)

    # -- services -----------------------------------------------------------
    @staticmethod
    def _svc_fp(s: api.Service) -> Tuple:
        return (s.metadata.namespace, s.metadata.name,
                tuple(sorted((s.spec.selector or {}).items())))

    def _set_services(self, services: Sequence[api.Service]) -> None:
        self._svc_key = [self._svc_fp(s) for s in services]
        self._services = list(services)
        S = len(services)
        self._svc_vocab = _Vocab()
        sv_ij = []
        for si, s in enumerate(services):
            for kv in (s.spec.selector or {}).items():
                sv_ij.append((si, self._svc_vocab.intern(kv)))
        T = max(1, len(self._svc_vocab))
        self._svc_req = np.zeros((max(1, S), T), bool)
        for si, t in sv_ij:
            self._svc_req[si, t] = True
        self._svc_req = self._svc_req[:S]
        self._svc_reqcnt = self._svc_req.sum(axis=1).astype(np.int32)
        self._svc_ns = np.array(
            [self._ns.intern(s.metadata.namespace)
             if s.metadata.namespace else -1 for s in services],
            np.int32) if S else np.zeros(0, np.int32)

    def _services_changed(self, services: Sequence[api.Service]) -> bool:
        if self._svc_key is None or len(services) != len(self._svc_key):
            return True
        return any(self._svc_fp(s) != k
                   for s, k in zip(services, self._svc_key))

    def _svc_subset_mask(self, pod: api.Pod) -> np.ndarray:
        """[S] bool: which services' selectors the pod's labels satisfy
        (subset match; namespace checked per group row at count time)."""
        S = len(self._services)
        if not S:
            return np.zeros(0, bool)
        feat = np.zeros(self._svc_req.shape[1], bool)
        for kv in (pod.metadata.labels or {}).items():
            t = self._svc_vocab.index.get(kv)
            if t is not None:
                feat[t] = True
        hits = (self._svc_req & feat[None, :]).sum(axis=1)
        return (hits == self._svc_reqcnt) & (self._svc_reqcnt > 0)

    def _new_group_row(self, key: Tuple[int, int]) -> int:
        """Materialize a sticky (namespace, service) group row, backfilled
        with every cached existing pod the group's service selects in that
        namespace — a pod counts toward EVERY matching group, exactly as
        the full encoder's member_exist matrix does (an existing peer is a
        peer of any service that selects it, not just its own first)."""
        row = self._grp_rows[key] = len(self._grp_rows)
        if row >= self._grp_cnt.shape[0]:
            grown = np.zeros((_pow2_pad(row + 1), self._N + 1), np.int32)
            grown[:self._grp_cnt.shape[0]] = self._grp_cnt
            self._grp_cnt = grown
            zgrown = np.zeros((self._zone_cnt.shape[0], grown.shape[0],
                               self._zone_V), np.int32)
            zgrown[:, :self._zone_cnt.shape[1]] = self._zone_cnt
            self._zone_cnt = zgrown
        ns_code, si = key
        for rec in self._pods.values():
            if rec.ns_code == ns_code and si < rec.svc_mask.size and \
                    rec.svc_mask[si]:
                self._grp_cnt[row, rec.host_idx] += 1
                self.op_counts["group_writes"] += 1
                self._zone_delta(row, rec.host_idx, 1)
        return row

    def _zone_delta(self, row: int, host_idx: int, d: int) -> None:
        """Mirror one group-count update into the resident zone planes:
        the pod on ``host_idx`` adds/removes one peer in that node's zone
        for every anti-affinity dim. Off-list (host_idx == N) and
        unlabeled nodes belong to no zone — exactly the nodes the former
        per-wave one-hot contraction zeroed out."""
        if host_idx >= self._N:
            return
        for a in range(self._node_zone.shape[0]):
            zv = int(self._node_zone[a, host_idx])
            if zv >= 0:
                self._zone_cnt[a, row, zv] += d
                self.op_counts["zone_writes"] += 1

    # -- pod deltas ---------------------------------------------------------
    def _grow_cols(self, arr: np.ndarray, cap: int, fill=0) -> np.ndarray:
        if arr.shape[1] >= cap:
            return arr
        grown = np.full((arr.shape[0], cap), fill, arr.dtype)
        grown[:, :arr.shape[1]] = arr
        return grown

    def _resource_col(self, name: str) -> int:
        r = self._rix.get(name)
        if r is None:
            r = self._rix[name] = len(self._resource_names)
            self._resource_names.append(name)
            self._cap = np.pad(self._cap, ((0, 0), (0, 1)))
            self._advertised = np.pad(self._advertised, ((0, 0), (0, 1)))
            self._score_used = np.pad(self._score_used, ((0, 0), (0, 1)))
            self._evict_cap = np.pad(self._evict_cap,
                                     ((0, 0), (0, 0), (0, 1)))
        return r

    def _band_col(self, prio: int) -> int:
        """Sticky band slot for a priority value, growing the resident
        evictable planes' band axis on first sight."""
        b = self._bands.intern(prio)
        if self._band_min is None or prio < self._band_min:
            self._band_min = prio
        cap = self._bands.cap
        if self._evict_cnt.shape[1] < cap:
            self._evict_cap = np.pad(
                self._evict_cap,
                ((0, 0), (0, cap - self._evict_cap.shape[1]), (0, 0)))
            self._evict_cnt = self._grow_cols(self._evict_cnt, cap)
        return b

    def _port_col(self, port: int) -> int:
        col = self._ports.intern(port)
        self._port_cnt = self._grow_cols(self._port_cnt, self._ports.cap)
        return col

    def _pd_col(self, pd: str) -> int:
        col = self._pds.intern(pd)
        self._pd_cnt = self._grow_cols(self._pd_cnt, self._pds.cap)
        return col

    def _sel_col(self, kv: Tuple[str, str]) -> int:
        known = kv in self._sels.index
        col = self._sels.intern(kv)
        self._node_sel = self._grow_cols(self._node_sel, self._sels.cap,
                                         fill=False)
        if not known:  # backfill the new column from resident node labels
            k, v = kv
            for i, lbls in enumerate(self._node_labels):
                if lbls.get(k) == v:
                    self._node_sel[i, col] = True
        return col

    def _add_pod(self, pod: api.Pod) -> None:
        uid = pod.metadata.uid
        host = pod.status.host
        i = self._node_index.get(host, self._N)  # N = off-list/unassigned
        req: List[Tuple[int, int]] = []
        ports: List[int] = []
        for c in pod.spec.containers:
            for name, q in c.resources.limits.items():
                req.append((self._resource_col(name),
                            _preds.resource_value(name, q)))
            if i < self._N:
                for cp in c.ports:
                    if cp.host_port:
                        ports.append(self._port_col(cp.host_port))
        pds: List[int] = []
        if i < self._N:
            for v in pod.spec.volumes:
                if v.source.gce_persistent_disk is not None:
                    pds.append(self._pd_col(
                        v.source.gce_persistent_disk.pd_name))
        ns_code = self._ns.intern(pod.metadata.namespace)
        svc_mask = self._svc_subset_mask(pod)
        rec = _PodRec(i, req, ports, pds, ns_code, svc_mask,
                      prio=api.pod_priority(pod), name=pod.metadata.name,
                      ns=pod.metadata.namespace)
        self._pods[uid] = rec
        if i < self._N:
            for r, amt in req:
                self._score_used[i, r] += amt
            for col in ports:
                self._port_cnt[i, col] += 1
            for col in pds:
                self._pd_cnt[i, col] += 1
            # O(1) single-element evictable-plane updates
            b = self._band_col(rec.prio)
            for r, amt in req:
                self._evict_cap[i, b, r] += amt
            self._evict_cnt[i, b] += 1
            self.op_counts["evict_writes"] += 1
            self._node_pods.setdefault(i, {})[uid] = rec
        if svc_mask.any():
            for (g_ns, si), row in self._grp_rows.items():
                if g_ns == ns_code and svc_mask[si]:
                    self._grp_cnt[row, i] += 1
                    self.op_counts["group_writes"] += 1
                    self._zone_delta(row, i, 1)

    def _remove_pod(self, uid: str) -> None:
        rec = self._pods.pop(uid)
        i = rec.host_idx
        if i < self._N:
            for r, amt in rec.req:
                self._score_used[i, r] -= amt
            for col in rec.ports:
                self._port_cnt[i, col] -= 1
            for col in rec.pds:
                self._pd_cnt[i, col] -= 1
            b = self._band_col(rec.prio)
            for r, amt in rec.req:
                self._evict_cap[i, b, r] -= amt
            self._evict_cnt[i, b] -= 1
            self.op_counts["evict_writes"] += 1
            node = self._node_pods.get(i)
            if node is not None:
                node.pop(uid, None)
        if rec.svc_mask.any():
            for (g_ns, si), row in self._grp_rows.items():
                if g_ns == rec.ns_code and rec.svc_mask[si]:
                    self._grp_cnt[row, i] -= 1
                    self.op_counts["group_writes"] += 1
                    self._zone_delta(row, i, -1)

    # -- victim materialization ---------------------------------------------
    def resident_on(self, node_idx: int):
        """ResidentPod rows for one node — the per-node registry a
        preemption wave names its victims from (O(pods on the node), not
        O(cluster))."""
        return [_preempt.ResidentPod(uid, rec.name, rec.ns, rec.host_idx,
                                     rec.prio)
                for uid, rec in self._node_pods.get(node_idx, {}).items()]

    # -- checkpoint / journal replay -----------------------------------------
    # Everything the encoder mutates between waves, grouped by how it must
    # be captured. Arrays mutate IN PLACE (+=/grow) and are copied; lists
    # and dicts are reassigned or mutated and get shallow copies; _PodRec
    # values and api objects are immutable post-construction and shared
    # copy-on-write across every checkpoint. op_counts is deliberately NOT
    # captured: it counts operations performed, and a restore does not
    # un-perform them.
    _CKPT_ARRAYS = ("_cap", "_advertised", "_score_used", "_port_cnt",
                    "_pd_cnt", "_node_sel", "_extra_ok", "_score_static",
                    "_node_zone", "_grp_cnt", "_zone_cnt", "_evict_cap",
                    "_evict_cnt", "_svc_req", "_svc_reqcnt", "_svc_ns")
    _CKPT_LISTS = ("_nodes_key", "_svc_key", "_services", "_resource_names",
                   "_node_names", "_node_labels")
    _CKPT_DICTS = ("_grp_rows", "_rix", "_node_index")
    _CKPT_SCALARS = ("_N", "_band_min", "_preempt_emitted", "_zone_V")
    _CKPT_VOCABS = ("_ports", "_sels", "_pds", "_ns", "_bands", "_svc_vocab")

    def checkpoint(self) -> dict:
        """Capture the resident planes + sticky vocabularies + per-node pod
        registry as an opaque restore() token (journal replay:
        scheduler/tpu_batch.py restores the last checkpoint and
        replays the modeler changelog instead of re-encoding the cluster).
        Pod records and cluster objects are shared copy-on-write; the
        numpy planes are memcpy'd. The
        checkpoint is immutable with respect to later encoder mutation
        and stays restorable any number of times. Raises ValueError
        before the first wave established resident planes."""
        if self._nodes_key is None:
            raise ValueError("nothing resident: encode a wave before "
                             "checkpointing")
        st: dict = {}
        for a in self._CKPT_ARRAYS:
            st[a] = getattr(self, a).copy()
        for a in self._CKPT_LISTS:
            st[a] = list(getattr(self, a))
        for a in self._CKPT_DICTS:
            st[a] = dict(getattr(self, a))
        for a in self._CKPT_SCALARS:
            st[a] = getattr(self, a)
        for a in self._CKPT_VOCABS:
            st[a] = dict(getattr(self, a).index)
        st["_pods"] = dict(self._pods)
        st["_node_pods"] = {i: dict(d) for i, d in self._node_pods.items()}
        return st

    def restore(self, ckpt: dict) -> None:
        """Reset the encoder to a checkpoint() state wholesale — including
        dropping any pods applied (speculatively or otherwise) since. The
        checkpoint itself is re-copied, so it remains valid for further
        restores."""
        for a in self._CKPT_ARRAYS:
            setattr(self, a, ckpt[a].copy())
        for a in self._CKPT_LISTS:
            setattr(self, a, list(ckpt[a]))
        for a in self._CKPT_DICTS:
            setattr(self, a, dict(ckpt[a]))
        for a in self._CKPT_SCALARS:
            setattr(self, a, ckpt[a])
        for a in self._CKPT_VOCABS:
            v = _Vocab()
            v.index = dict(ckpt[a])
            setattr(self, a, v)
        self._pods = dict(ckpt["_pods"])
        self._node_pods = {i: dict(d)
                           for i, d in ckpt["_node_pods"].items()}

    def resident_fingerprint(self) -> tuple:
        """Order-stable digest of every resident plane + the pod registry.
        Bit-equal states (same vocab order, same planes, same pods at the
        same hosts) produce equal fingerprints. The replay check compares
        the fingerprint after a journal replay against the one after a
        full diff-walk over the authoritative list: equality proves the
        replay reconstructed the exact causal state (the walk found
        nothing to fix)."""
        parts = []
        for a in self._CKPT_ARRAYS:
            arr = getattr(self, a)
            parts.append((a, arr.shape, str(arr.dtype),
                          zlib.crc32(np.ascontiguousarray(arr).tobytes())))
        for a in self._CKPT_VOCABS:
            parts.append((a, tuple(getattr(self, a).index.items())))
        parts.append(("_pods", tuple(sorted(
            (uid, rec.host_idx, rec.prio) for uid, rec in
            self._pods.items()))))
        parts.append(("_grp_rows", tuple(sorted(self._grp_rows.items()))))
        parts.append(("scalars", self._N, self._band_min,
                      self._preempt_emitted, self._zone_V,
                      tuple(self._resource_names)))
        return tuple(parts)

    def fill_dims(self) -> dict:
        """True (unpadded) occupancy of the pow-2-bucketed vocabulary
        axes, in the axis units of the device inputs (port/pd sets pack
        32 vocab entries per uint32 word)."""
        return {
            "Wp": (len(self._ports) + 31) // 32,
            "Wd": (len(self._pds) + 31) // 32,
            "Ks": len(self._sels),
            "G": len(self._grp_rows),
            "B": len(self._bands),
        }

    # -- speculation support (the pipelined loop) ----------------------------
    def has_pod(self, uid: str) -> bool:
        """Whether ``uid`` already contributes to the resident planes."""
        return uid in self._pods

    def is_noop_upsert(self, pod: api.Pod) -> bool:
        """True when applying ``pod`` as an upsert would not change the
        resident planes: same uid already accounted at the same host row.
        (Pod specs are immutable post-creation — see module docstring — so
        host identity is the whole delta surface.) The pipelined
        scheduler's divergence check uses this to classify watch-confirm
        migrations (assumed -> scheduled re-delivery of a pod it already
        applied speculatively) as benign."""
        rec = self._pods.get(pod.metadata.uid)
        if rec is None:
            return False
        return rec.host_idx == self._node_index.get(pod.status.host, self._N)

    def forget_pods(self, uids) -> None:
        """Exact rollback of speculative upserts: remove each uid's
        contribution from the resident planes (no-op for absent uids).
        Only sound for pods that were NOT resident before the speculative
        apply — the pipelined scheduler refuses to speculate otherwise."""
        for uid in uids:
            if uid in self._pods:
                self._remove_pod(uid)

    # -- wave encode --------------------------------------------------------
    def encode(self, nodes: Sequence[api.Node],
               existing_pods: Sequence[api.Pod],
               pending_pods: Sequence[api.Pod],
               services: Sequence[api.Service] = (),
               pad_pods: bool = True) -> ClusterSnapshot:
        services = list(services)
        if self._nodes_changed(nodes) or self._services_changed(services):
            self._rebuild_nodes(nodes, existing_pods, services)
        else:
            cur = {}
            for p in existing_pods:
                cur[p.metadata.uid] = p
            cached = self._pods
            removed = [u for u in cached if u not in cur]
            for u in removed:
                self._remove_pod(u)
            for u, p in cur.items():
                rec = cached.get(u)
                if rec is None:
                    self._add_pod(p)
                elif rec.host_idx != self._node_index.get(p.status.host,
                                                          self._N):
                    self._remove_pod(u)   # host changed: re-account
                    self._add_pod(p)
        return self._build(existing_pods, pending_pods, pad_pods)

    def encode_delta(self, nodes: Sequence[api.Node],
                     upserted: Sequence[api.Pod],
                     removed: Sequence[api.Pod],
                     pending_pods: Sequence[api.Pod],
                     services: Sequence[api.Service] = (),
                     pad_pods: bool = True) -> Optional[ClusterSnapshot]:
        """O(changed + pending) wave encode: apply a SimpleModeler.delta
        (upserts first, then removes — see its contract) instead of
        re-walking the whole existing-pod list. Returns None — caller must
        fall back to encode() with the full list — when the node/service
        planes changed, or when some node's usage exceeds its capacity:
        the greedy fit accumulators are existing-LIST-order exact there
        (snapshot.greedy_fit_accumulators), and only the full walk carries
        that order."""
        services = list(services)
        if self._nodes_key is None or self._nodes_changed(nodes) \
                or self._services_changed(services):
            return None
        for p in upserted:
            rec = self._pods.get(p.metadata.uid)
            host = self._node_index.get(p.status.host, self._N)
            if rec is None:
                self._add_pod(p)
            elif rec.host_idx != host:
                self._remove_pod(p.metadata.uid)
                self._add_pod(p)
        for p in removed:
            if p.metadata.uid in self._pods:
                self._remove_pod(p.metadata.uid)
        # overflow anywhere -> the order-exact slow path is required
        R = self._score_used.shape[1]
        cap = self._cap if self._cap.shape[1] == R else \
            np.pad(self._cap, ((0, 0), (0, R - self._cap.shape[1])))
        unconstrained = (cap == 0) & (np.arange(R) < 2)[None, :]
        if not (unconstrained | (self._score_used <= cap)).all():
            return None
        return self._build(None, pending_pods, pad_pods)

    def _build(self, existing_pods, pending_pods, pad_pods) -> ClusterSnapshot:
        """The pending-pod pass + snapshot assembly over the resident
        planes. ``existing_pods`` feeds the greedy overflow walk; None
        (delta path) is only legal when no node overflows — encode_delta
        checked before calling."""
        N = self._N
        P = len(pending_pods)
        Ppad = _pow2_pad(P, minimum=1) if pad_pods else max(P, 0)
        R0 = len(self._resource_names)

        # -- pending pods pass (sticky vocabs; may grow columns) ------------
        req = np.zeros((Ppad, R0), np.int64)
        grow_req: List[Tuple[int, int, int]] = []  # (row, rcol, amt) overflow
        pp_ij: List[Tuple[int, int]] = []
        ps_ij: List[Tuple[int, int]] = []
        pg_ij: List[Tuple[int, int]] = []
        pod_host_idx = np.full(Ppad, -2, np.int32)
        pod_host_idx[:P] = -1
        pod_prio = np.zeros(Ppad, np.int32)
        pod_can_preempt = np.zeros(Ppad, bool)  # padding rows never preempt
        pod_names: List[str] = []
        pod_ns = np.zeros(P, np.int32)
        feats: List[Tuple[int, int]] = []  # (pod, svc-vocab col)
        for j, p in enumerate(pending_pods):
            meta = p.metadata
            pod_names.append(f"{meta.namespace}/{meta.name}")
            pod_ns[j] = self._ns.intern(meta.namespace)
            for kv in (meta.labels or {}).items():
                t = self._svc_vocab.index.get(kv)
                if t is not None:
                    feats.append((j, t))
            for c in p.spec.containers:
                for name, q in c.resources.limits.items():
                    r = self._rix.get(name)
                    amt = _preds.resource_value(name, q)
                    if r is None:
                        grow_req.append((j, self._resource_col(name), amt))
                    elif r < R0:
                        req[j, r] += amt
                    else:
                        grow_req.append((j, r, amt))
                for cp in c.ports:
                    if cp.host_port:
                        pp_ij.append((j, self._port_col(cp.host_port)))
            for kv in (p.spec.node_selector or {}).items():
                ps_ij.append((j, self._sel_col(kv)))
            for v in p.spec.volumes:
                if v.source.gce_persistent_disk is not None:
                    pg_ij.append((j, self._pd_col(
                        v.source.gce_persistent_disk.pd_name)))
            if p.spec.host:
                pod_host_idx[j] = self._node_index.get(p.spec.host, -2)
            pod_prio[j] = api.pod_priority(p)
            pod_can_preempt[j] = api.pod_can_preempt(p)
        R = len(self._resource_names)
        if R > R0:
            req = np.pad(req, ((0, 0), (0, R - R0)))
        for row, r, amt in grow_req:
            req[row, r] += amt

        def scatter(pairs, rows, cols, dtype=bool):
            out = np.zeros((rows, cols), dtype)
            if pairs:
                idx = np.asarray(pairs, np.int64)
                out[idx[:, 0], idx[:, 1]] = True
            return out

        Kp, Ks, Kd = self._ports.cap, self._sels.cap, self._pds.cap
        pod_ports = scatter(pp_ij, Ppad, Kp)
        pod_sel = scatter(ps_ij, Ppad, Ks)
        pod_pds = scatter(pg_ij, Ppad, Kd)

        # -- pending service groups (matmul over the sticky svc vocab) ------
        G = self._grp_cnt.shape[0]
        pod_gid = np.full(Ppad, -1, np.int32)
        member = np.zeros((Ppad, G), bool)
        S = len(self._services)
        if S and P:
            T = self._svc_req.shape[1]
            feat = scatter(feats, P, T).astype(np.float32)
            hits = feat @ self._svc_req.astype(np.float32).T      # [P, S]
            subset = hits == self._svc_reqcnt[None, :]
            eligible = subset & (self._svc_reqcnt[None, :] > 0) & \
                ((self._svc_ns[None, :] == -1) |
                 (self._svc_ns[None, :] == pod_ns[:, None]))
            has = eligible.any(axis=1)
            first = np.argmax(eligible, axis=1)
            for j in np.nonzero(has)[0]:
                key = (int(pod_ns[j]), int(first[j]))
                row = self._grp_rows.get(key)
                if row is None:
                    row = self._new_group_row(key)
                pod_gid[j] = row
            G = self._grp_cnt.shape[0]
            if member.shape[1] < G:
                member = np.pad(member, ((0, 0), (0, G - member.shape[1])))
            if len(self._grp_rows):
                g_ns = np.array([k[0] for k in self._grp_rows], np.int32)
                g_si = np.array([k[1] for k in self._grp_rows], np.int64)
                member[:P, :len(self._grp_rows)] = \
                    subset[:, g_si] & (pod_ns[:, None] == g_ns[None, :])

        # -- fit accumulators (greedy only for genuine overflow) ------------
        cap = self._cap
        if cap.shape[1] < R:
            cap = np.pad(cap, ((0, 0), (0, R - cap.shape[1])))
            self._cap = cap
        if self._advertised.shape[1] < R:
            self._advertised = np.pad(
                self._advertised, ((0, 0), (0, R - self._advertised.shape[1])))
        score_used = self._score_used
        if score_used.shape[1] < R:
            score_used = np.pad(score_used, ((0, 0), (0, R - score_used.shape[1])))
            self._score_used = score_used
        def recs_in_list_order():
            # current list order == what the oracle's full encode would see.
            # The delta path passes existing_pods=None: legal because it
            # bailed to the full path before any node overflowed, and
            # greedy_fit_accumulators only consumes this on overflow.
            for p in existing_pods or ():
                rec = self._pods.get(p.metadata.uid)
                if rec is None:
                    continue
                e_req = np.zeros(R, np.int64)
                for r, amt in rec.req:
                    e_req[r] += amt
                yield rec.host_idx, e_req

        fit_used, fit_exceeded = greedy_fit_accumulators(
            cap, score_used, recs_in_list_order())

        tie = _fnv1a64_batch([pod_tie_break_key(p) for p in pending_pods])
        tie_hi = np.zeros(Ppad, np.int64)
        tie_lo = np.zeros(Ppad, np.int64)
        tie_hi[:P] = (tie >> np.uint64(32)).astype(np.int64)
        tie_lo[:P] = (tie & np.uint64(0xFFFFFFFF)).astype(np.int64)

        rid, run_start = gang.pod_run_ids(pending_pods)
        pod_rid = np.full(Ppad, -1, np.int32)
        pod_rid[:P] = rid
        pod_run_start = np.ones(Ppad, bool)
        pod_run_start[:P] = run_start

        # -- preemption planes (sticky emit gate) ----------------------------
        if not self._preempt_emitted and len(self._bands) and P \
                and int(pod_prio[:P].max()) > self._band_min:
            self._preempt_emitted = True
        if self._preempt_emitted:
            Bc = self._bands.cap
            band_prio = np.full(Bc, _preempt.BAND_EMPTY, np.int32)
            for v, b in self._bands.index.items():
                band_prio[b] = v
            evict_cap = self._evict_cap[:, :Bc, :R].copy()
            evict_cnt = self._evict_cnt[:, :Bc].copy()
            if evict_cap.shape[2] < R:
                evict_cap = np.pad(
                    evict_cap, ((0, 0), (0, 0),
                                (0, R - evict_cap.shape[2])))
            if _DEBUG_VERIFY_EVICT:
                e_host = np.array([rec.host_idx
                                   for rec in self._pods.values()])
                e_prio = np.array([rec.prio
                                   for rec in self._pods.values()])
                e_req = np.zeros((len(self._pods), R), np.int64)
                for k, rec in enumerate(self._pods.values()):
                    for r, amt in rec.req:
                        e_req[k, r] += amt
                want_cap, want_cnt = _preempt.derive_evict_planes(
                    e_host, e_prio, e_req, band_prio, N)
                assert np.array_equal(want_cap, evict_cap) and \
                    np.array_equal(want_cnt, evict_cnt), (
                        "resident evictable planes diverged from the "
                        "derive_evict_planes from-scratch twin — the "
                        "O(bands) incremental maintenance is out of sync")
        else:
            band_prio = np.zeros(0, np.int32)
            evict_cap = np.zeros((N, 0, R), np.int64)
            evict_cnt = np.zeros((N, 0), np.int32)

        return ClusterSnapshot(
            node_names=self._node_names,
            resource_names=list(self._resource_names),
            cap=cap, advertised=self._advertised,
            fit_used=fit_used, fit_exceeded=fit_exceeded,
            score_used=score_used,
            node_ports=self._port_cnt > 0,
            node_sel=self._node_sel,
            node_pds=self._pd_cnt > 0,
            node_extra_ok=self._extra_ok.copy(),
            pod_names=pod_names,
            req=req,
            pod_ports=pod_ports, pod_sel=pod_sel, pod_pds=pod_pds,
            pod_host_idx=pod_host_idx, tie_hi=tie_hi, tie_lo=tie_lo,
            pod_gid=pod_gid, pod_group_member=member,
            group_counts=self._grp_cnt.copy(),
            pod_rid=pod_rid, pod_run_start=pod_run_start,
            score_static=self._score_static,
            node_zone=self._node_zone,
            zone_counts0=self._zone_cnt.copy(),
            pod_prio=pod_prio, pod_can_preempt=pod_can_preempt,
            band_prio=band_prio, evict_cap=evict_cap, evict_cnt=evict_cnt,
            policy=self.policy,
        )
