"""The batch scheduler's wave solve, in PyTorch.

Port of ``kubernetes_tpu/models/batch_solver.py``. The reference's serial
per-pod loop (pkg/scheduler/generic_scheduler.go:54-128 and plugin/pkg/
scheduler/scheduler.go:90-119) becomes one call over a dense (pending pods
x nodes) problem: a batched Filter pre-pass (node selector as an exact 0/1
matmul, host pins, cordon and label presence, selector-pinned service
affinity) and a sequential-commit loop over pods, in which each decision
updates node state before the next. Decisions are bit-identical to the
serial oracle: the same integer score truncation, the same float32 spread
rounding, the same FNV-1a-mod-count tie-break over nodes in list order.

The whole policy vocabulary of models/policy is solved: service affinity
anchors and zone anti-affinity ride the commit loop's state, label
preferences are a static score plane, and gang (PodGroup) waves checkpoint
that state at each scheduling unit and roll a failed run back; ``solve``
then drops the failed runs' earlier members (gang.apply_all_or_nothing).

Preemption (models/preempt): a wave whose pending pods sit above some
resident priority band carries the evictable planes; a pod that finds no
node may evict the lowest sufficient prefix of bands on the node with the
fewest victims, and reports that threshold through its score.

Host side (numpy): ``snapshot_to_host_inputs`` scales every resource
column by its gcd (floor division and comparison are invariant under a
common scaling), narrows to int32 when every accumulator fits and keeps
int64 otherwise, and packs port and PD sets into uint32 bitmask words.
``ship_inputs`` moves the wave to a torch device. ``solve_device`` runs
the hand-written CUDA kernel (ops/commit_solver) for waves inside its
domain, int64, preemption and large-cluster waves included (up to 65,536
nodes, 1,024 service groups, peer totals below 2^24), and ``solve_scan``
for the rest, as the reference sends both of these to ``solve_jit``.

``solve(..., mesh=)`` sends waves at or above the mesh node floor
through the device mesh (parallel/mesh.py).

Not ported yet (ROADMAP): the host-vs-device WaveRouter and the packed
transfer.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.models import gang
from kubernetes_tpu_torch.models.policy import BatchPolicy
from kubernetes_tpu_torch.models.snapshot import ClusterSnapshot
from kubernetes_tpu_torch.ops import commit_solver

__all__ = ["SolverInputs", "snapshot_to_host_inputs", "snapshot_to_inputs",
           "ship_inputs", "solve_scan", "solve_device", "solve",
           "peer_bound_of", "decisions_to_names", "resolve_device",
           "derive_zone_counts"]

NEG = -1
_I32_HEADROOM = (2**31 - 1) // 10  # calculate_score multiplies by 10


# KTPU_DEBUG=1: recompute encoder-resident zone_counts0 planes from the
# group_counts/node_zone planes and assert they match (the same class of
# insurance as the reference's _ktpu_rows verification)
_DEBUG_VERIFY_ZONES = os.environ.get("KTPU_DEBUG", "") not in ("", "0")


class SolverInputs(NamedTuple):
    """One wave's arrays (see ClusterSnapshot for meaning): numpy on the
    host, torch tensors after ``ship_inputs``. Resource planes are [_, R],
    int32 when the gcd-scaled wave fits, else int64; port/PD sets are
    packed uint32 words on the host and their int32 bit patterns on a
    device."""

    cap: object                  # [N, R]
    advertises: object           # [N, R] bool — capacity key present
    fit_used: object             # [N, R]
    fit_exceeded: object         # [N] bool
    score_used: object           # [N, R]
    node_ports: object           # [N, Wp] packed words
    node_sel: object             # [N, K2] bool
    node_pds: object             # [N, Wd] packed words
    node_extra_ok: object        # [N] bool
    req: object                  # [P, R]
    pod_ports: object            # [P, Wp] packed words
    pod_sel: object              # [P, K2] bool
    pod_pds: object              # [P, Wd] packed words
    pod_host_idx: object         # [P] i32
    tie_hi: object               # [P] i64
    tie_lo: object               # [P] i64
    pod_gid: object              # [P] i32
    pod_group_member: object     # [P, G] bool
    group_counts: object         # [G, N+1] i32
    gang_start: object           # [P] bool — rollback checkpoint markers
    # policy extensions (zero-size planes when unused)
    score_static: object         # [N] i32
    node_aff_vals: object        # [N, L] i32
    pod_aff_static: object       # [P, L] i32
    anchor_vals0: object         # [G, L] i32
    has_anchor0: object          # [G] bool
    zone_idx: object             # [A, N] i32 zone codes, -1 unlabeled
    zone_counts0: object         # [A, G, V] i32 initial per-group peers/zone
    # preemption planes (models/preempt; B == 0 when the wave has none)
    pod_prio: object             # [P] i32 resolved pod priorities
    pod_can_preempt: object      # [P] bool — PreemptionPolicy != Never
    band_prio: object            # [B] i32 band values, BAND_EMPTY padded
    evict_cap: object            # [N, B, R] evictable capacity (res dtype)
    evict_cnt: object            # [N, B] i32 evictable pod counts


def _pack_bits(a: np.ndarray) -> np.ndarray:
    """[rows, K] bool -> [rows, W] uint32 bitmask words (little-endian)."""
    rows, K = a.shape
    W = max(1, (K + 31) // 32)
    padded = np.zeros((rows, W * 32), dtype=bool)
    padded[:, :K] = a
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    words = (padded.reshape(rows, W, 32) * weights).sum(axis=2)
    return words.astype(np.uint32)


def _resource_scales(snap: ClusterSnapshot) -> np.ndarray:
    """Per-dimension gcd of every value in that resource column: dividing
    a column by a common factor is exact for every comparison and floor
    division the solver performs (memory reduces by Mi granularity). The
    per-band evictable sums take part: each must divide exactly too."""
    parts = [snap.cap, snap.fit_used, snap.score_used, snap.req]
    if snap.evict_cap is not None and snap.evict_cap.size:
        parts.append(snap.evict_cap.reshape(-1, snap.evict_cap.shape[2]))
    cols = np.concatenate(parts, axis=0)                    # [*, R]
    R = cols.shape[1]
    scales = np.ones(R, np.int64)
    for r in range(R):
        vals = cols[:, r]
        vals = vals[vals != 0]
        if vals.size:
            scales[r] = np.gcd.reduce(np.abs(vals))
    return scales


def _fits_i32(*arrays) -> bool:
    total = 0
    for a in arrays:
        if a.size:
            total = max(total, int(np.abs(a).max()))
    return total <= _I32_HEADROOM


def derive_zone_counts(node_zone: np.ndarray, group_counts: np.ndarray,
                       V: int) -> np.ndarray:
    """[A, G, V] per-group per-zone peer totals: zone_counts[a, g, v] is
    the sum of group_counts[g, n] over nodes n whose zone code for label
    ``a`` is ``v``. Unlabeled nodes (code -1) and the off-list slot N
    count toward no zone."""
    A, N = node_zone.shape
    G = group_counts.shape[0]
    out = np.zeros((A, G, V), np.int32)
    gc = np.asarray(group_counts[:, :N], np.int32)
    for a in range(A):
        zi = node_zone[a]
        m = zi >= 0
        if m.any():
            np.add.at(out[a].T, zi[m].astype(np.int64), gc[:, m].T)
    return out


def snapshot_to_host_inputs(snap: ClusterSnapshot) -> SolverInputs:
    """encode_snapshot output -> host (numpy) SolverInputs: scaling, dtype
    narrowing, bit-packing — everything up to the device transfer."""
    g = _resource_scales(snap)[None, :]                    # [1, R]
    cap = snap.cap // g
    fit_used = snap.fit_used // g
    score_used = snap.score_used // g
    req = snap.req // g
    N, P, G = len(snap.node_names), req.shape[0], snap.group_counts.shape[0]
    R = snap.cap.shape[1]
    evict_cap = (snap.evict_cap if snap.evict_cap is not None
                 else np.zeros((N, 0, R), np.int64)) // g[None, :, :]
    evict_cnt = (snap.evict_cnt if snap.evict_cnt is not None
                 else np.zeros((N, 0), np.int32))
    band_prio = (snap.band_prio if snap.band_prio is not None
                 else np.zeros(0, np.int32))
    # int32 is safe when no running sum can reach 2^31/10: the largest
    # initial value plus the whole batch's requests bounds every
    # accumulator; otherwise the planes stay int64
    req_total = req.sum(axis=0, keepdims=True)             # [1, R]
    use_i32 = _fits_i32(cap, fit_used, score_used + req_total,
                        cap + req_total, evict_cap)
    rdt = np.int32 if use_i32 else np.int64
    i32 = np.int32

    def plane(a, empty_shape, dtype=i32):
        return np.ascontiguousarray(
            np.zeros(empty_shape, dtype) if a is None else a, dtype)

    node_zone = plane(snap.node_zone, (0, N))
    V = max(1, int(node_zone.max(initial=-1)) + 1)
    zone_counts0 = snap.zone_counts0
    if zone_counts0 is None:
        zone_counts0 = derive_zone_counts(node_zone, snap.group_counts, V)
    elif _DEBUG_VERIFY_ZONES:
        want = derive_zone_counts(node_zone, snap.group_counts, V)
        assert zone_counts0.shape == want.shape and \
            np.array_equal(zone_counts0, want), (
                "resident zone_counts0 diverged from the group_counts/"
                "node_zone planes — the incremental encoder's O(changed) "
                "zone maintenance is out of sync")
    return SolverInputs(
        cap=cap.astype(rdt),
        advertises=np.asarray(snap.advertised, bool),
        fit_used=fit_used.astype(rdt),
        fit_exceeded=np.asarray(snap.fit_exceeded, bool),
        score_used=score_used.astype(rdt),
        node_ports=_pack_bits(snap.node_ports),
        node_sel=np.ascontiguousarray(snap.node_sel),
        node_pds=_pack_bits(snap.node_pds),
        node_extra_ok=np.asarray(snap.node_extra_ok, bool),
        req=req.astype(rdt),
        pod_ports=_pack_bits(snap.pod_ports),
        pod_sel=np.ascontiguousarray(snap.pod_sel),
        pod_pds=_pack_bits(snap.pod_pds),
        pod_host_idx=np.ascontiguousarray(snap.pod_host_idx),
        tie_hi=np.ascontiguousarray(snap.tie_hi),
        tie_lo=np.ascontiguousarray(snap.tie_lo),
        pod_gid=np.ascontiguousarray(snap.pod_gid),
        pod_group_member=np.ascontiguousarray(snap.pod_group_member),
        group_counts=np.ascontiguousarray(snap.group_counts),
        gang_start=np.ascontiguousarray(
            np.ones(P, bool) if snap.pod_run_start is None
            else snap.pod_run_start, bool),
        score_static=plane(snap.score_static, N),
        node_aff_vals=plane(snap.node_aff_vals, (N, 0)),
        pod_aff_static=plane(snap.pod_aff_static, (P, 0)),
        anchor_vals0=plane(snap.anchor_vals0, (G, 0)),
        has_anchor0=plane(snap.has_anchor0, G, bool),
        zone_idx=node_zone,
        zone_counts0=np.ascontiguousarray(zone_counts0, i32),
        pod_prio=np.ascontiguousarray(
            np.zeros(P, i32) if snap.pod_prio is None else snap.pod_prio,
            i32),
        pod_can_preempt=np.ascontiguousarray(
            np.ones(P, bool) if snap.pod_can_preempt is None
            else snap.pod_can_preempt, bool),
        band_prio=np.ascontiguousarray(band_prio, i32),
        evict_cap=np.ascontiguousarray(evict_cap.astype(rdt)),
        evict_cnt=np.ascontiguousarray(evict_cnt, i32),
    )


def resolve_device(device=None) -> torch.device:
    """The device a wave runs on: ``cuda`` unless the caller names another.
    Without a CUDA device the default, or a named cuda device, raises; it
    never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on cuda by default; pass "
            "device='cpu' to run the plain version on the CPU")
    return dev


def ship_inputs(host: SolverInputs, device) -> SolverInputs:
    """Place host (numpy) SolverInputs on a torch device. uint32 words
    travel as their int32 bit patterns (torch's uint32 has few ops)."""
    out = []
    for a in host:
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out.append(torch.from_numpy(a).to(device))
    return SolverInputs(*out)


def snapshot_to_inputs(snap: ClusterSnapshot, device=None) -> SolverInputs:
    """encode_snapshot output -> SolverInputs on ``device`` (``cuda``
    unless the caller names another)."""
    return ship_inputs(snapshot_to_host_inputs(snap), resolve_device(device))


def solve_scan(inp: SolverInputs, pol: Optional[BatchPolicy] = None,
               gangs: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain per-pod solve on any device and any wave size (the port
    of ``solve_jit``, every policy branch, int64 planes, preemption and
    the gang checkpoint and rollback): the prolog, then the commit loop of
    ops/commit_solver.solve_commit_reference."""
    pol = pol or BatchPolicy()
    if pol.all_infeasible:
        # no nonzero-weight priorities: every pod fails
        # (generic_scheduler.go:76-80)
        P = inp.req.shape[0]
        full = torch.full((P,), NEG, dtype=torch.int32,
                          device=inp.req.device)
        return full, full.clone()
    return commit_solver.solve_commit_reference(
        commit_solver.prepare(inp, pol, gangs))


def solve_device(inp: SolverInputs, pol: Optional[BatchPolicy],
                 gangs: bool, peer_bound: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compiled-solve dispatch, the one every main path takes: a wave
    inside the kernel's domain (commit_solver.eligible) runs the CUDA
    kernel — on a CPU tensor its plain version — and every other wave runs
    ``solve_scan`` on the same device, as the reference sends it to
    ``solve_jit`` (a wave over commit_solver.MAX_N nodes, MAX_G groups,
    MAX_B bands or peer totals of MAX_COUNT, or wider than 8 resources,
    port or PD words, 4 labels or 64 zones). ``gangs`` turns on the
    checkpoint and rollback of PodGroup runs."""
    pol = pol or BatchPolicy()
    if commit_solver.eligible(inp, pol, peer_bound):
        return commit_solver.solve_commit(
            commit_solver.prepare(inp, pol, gangs, peer_bound))
    return solve_scan(inp, pol, gangs)


def peer_bound_of(source) -> int:
    """Largest initial per-group peer total — the kernel-domain bound on
    the spread arithmetic. ``source`` carries a ``group_counts`` [G, N+1]
    array (a ClusterSnapshot, numpy SolverInputs) or tensor (shipped
    SolverInputs; read back from its device)."""
    gc = source.group_counts
    if gc.shape[0] == 0 or gc.shape[1] == 0:
        return 0
    return int(gc.sum(1).max())


def _mesh_min_nodes() -> int:
    """parallel.mesh.DEFAULT_MESH_MIN_NODES, read at call time: parallel/
    mesh imports this module at load, so the constant cannot be a
    top-level import here."""
    from kubernetes_tpu_torch.parallel.mesh import DEFAULT_MESH_MIN_NODES
    return DEFAULT_MESH_MIN_NODES


def solve(snap: ClusterSnapshot, host: Optional[SolverInputs] = None,
          device=None, mesh=None) -> Tuple[np.ndarray, np.ndarray]:
    """Host entry: encoded wave -> device -> solve -> host decisions
    (chosen node index or -1, winning score or -1, int32 [P]; a score at
    or below preempt.PREEMPT_SCORE_BASE placed by preemption and encodes
    its band slot), with the all-or-nothing post-pass when the wave has
    PodGroups. ``host`` skips the host-side encode when the caller already
    holds ``snapshot_to_host_inputs(snap)`` (the solver client's fallback,
    which encoded before it learned the daemon could not take the wave).
    Runs on ``cuda`` unless ``device`` says otherwise.

    ``mesh`` (a parallel.mesh Mesh, kube-scheduler --mesh) routes waves at
    or above the mesh node floor through ``parallel.mesh.solve_sharded``
    on the mesh's devices: its kernel-vs-mesh crossover sends a wave
    inside the kernel's domain to one commit_solve launch on the mesh's
    first device, and shards the rest. Decisions are identical either
    way; the gang post-pass is applied here on both paths."""
    if host is None:
        host = snapshot_to_host_inputs(snap)
    has_gangs = snap.has_gangs
    if mesh is not None and int(host.cap.shape[0]) >= _mesh_min_nodes():
        from kubernetes_tpu_torch.parallel.mesh import solve_sharded
        chosen, scores = solve_sharded(host, mesh, pol=snap.policy,
                                       gangs=has_gangs,
                                       peer_bound=peer_bound_of(snap))
    else:
        inp = ship_inputs(host, resolve_device(device))
        chosen, scores = solve_device(inp, snap.policy, has_gangs,
                                      peer_bound_of(snap))
        # one device -> host readback
        both = torch.stack([chosen, scores]).cpu().numpy()
        chosen, scores = both[0], both[1]
    if has_gangs:
        chosen = gang.apply_all_or_nothing(snap.pod_rid, chosen)
        # a rolled-back member's tentative score is as stale as its host
        scores = np.where(chosen < 0, np.int32(NEG), scores)
    return chosen, scores


def decisions_to_names(snap: ClusterSnapshot, chosen: np.ndarray):
    """Map node indices back to host names; None = unschedulable. Slices
    off any pod-axis padding."""
    return [snap.node_names[i] if i >= 0 else None
            for i in chosen[:len(snap.pod_names)]]
