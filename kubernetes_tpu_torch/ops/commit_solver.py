"""The sequential-commit wave solve: prolog, CUDA kernel wrapper, plain
version.

Counterpart of ``kubernetes_tpu/ops/pallas_solver.py`` (the JAX package's
only Pallas kernel, ``_solve_pallas_x32`` at :772), with every branch of
its body: the default filters and priorities, CheckNodeLabelPresence (in
the static mask), CheckServiceAffinity anchors, NodeLabelPriority,
ServiceAntiAffinity zones, and the gang checkpoint and rollback. Its
domain is wider than the Pallas kernel's: waves with int64 resource
planes and waves with priority bands (preemption), which the reference
solves in ``solve_jit``'s scan (kubernetes_tpu/models/batch_solver.py
:676-790), run here too, with the same decisions.

- ``eligible`` is the kernel's domain: the reference's (:90-157), plus
  int64 planes and up to ``MAX_B`` bands.
- ``prepare`` is the prolog (:599-733): the static feasibility mask (node
  selector, host pin, cordon and label presence, selector-pinned service
  affinity) and the per-pod and per-node planes, as torch ops on the
  wave's device. It is not a kernel: the selector-violation product is a
  float32 ``torch.matmul``, as in the reference it was an XLA matmul
  outside the Pallas kernel, and runs with TF32 off so every count (a sum
  of 0/1 products, far below 2^24) is exact.
- ``solve_commit`` is the wrapper of the CUDA kernel
  (``csrc/commit_solve.cuh``, its C interface ``csrc/commit_solve.cu``):
  on a CUDA tensor it launches the kernel or raises; on a CPU tensor it
  runs ``solve_commit_reference``, the plain version, a per-pod loop of
  torch ops built on ``ops/kernels``.
  ``solve_commit.launches`` counts kernel launches and
  ``solve_commit_reference.calls`` calls of the plain version.
- ``shared_layout`` is where the kernel keeps a wave's node state: in the
  block's shared memory when it fits, else in a global buffer.
- ``spread_eval`` runs the kernel's spread-score device function over
  arrays of (total, count), for checking it exhaustively on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from kubernetes_tpu_torch.models.policy import BatchPolicy
from kubernetes_tpu_torch.models.preempt import PREEMPT_SCORE_BASE
from kubernetes_tpu_torch.ops import build
from kubernetes_tpu_torch.ops.kernels import (
    calculate_score,
    masked_top_count,
    select_kth_true,
    spread_score,
    u64_mod_small,
)

__all__ = ["CommitInputs", "eligible", "layout_of", "mask_pitch", "prepare",
           "shared_layout", "solve_commit", "solve_commit_reference",
           "spread_eval", "MAX_B", "MAX_N"]

NEG = -1
MAX_R = 8
MAX_W = 8
MAX_G = 31           # member bitmask must fit a non-negative int32
MAX_N = 32640        # the reference's domain (counts below 2^15); the
                     # kernel itself takes N <= 1024 * 32
MAX_COUNT = 1 << 15
MAX_A = 4            # anti-affinity labels
MAX_V = 64           # zones per anti-affinity label
MAX_L = 4            # service-affinity labels
MAX_B = 32           # priority bands: a preempting pod walks them per node
PREEMPT_BIG = 1 << 30  # preemption selects on PREEMPT_BIG - victim count

# the kernel's policy flags (csrc/commit_solve.cuh kUse*, kGangs)
_USE_RESOURCES, _USE_PORTS, _USE_DISK, _USE_STATIC, _GANGS = 1, 2, 4, 8, 16
# the podrow's unit field (csrc/commit_solve.cuh kStart, kCheckpoint,
# kCanPreempt): a scheduling unit starts here; a gang run starts here
# (checkpoint); the pod may preempt
_START, _CHECKPOINT, _CAN_PREEMPT = 1, 2, 4
_ROW_FIXED = 7       # tie_hi, tie_lo, gid, member bits, zreq, unit, prio

# Shared memory one block may use on an H100 (static + dynamic), and the
# room kept for the kernel's static shared arrays (at most 3.7 KB in any
# instance); the kernel checks the real figures before it launches.
SMEM_PER_BLOCK = 232_448
STATIC_SMEM = 4_096


def mask_pitch(n_nodes: int) -> int:
    """Bytes per static-mask row: N rounded up to 16, so the kernel can
    fetch a row in 16-byte pieces."""
    return -(-n_nodes // 16) * 16


def state_bytes(N: int, R: int, Wp: int, Wd: int, G: int, B: int = 0,
                res_bytes: int = 4) -> int:
    """Bytes of one wave's packed node state: the [R, N] fit usage and the
    [B, R, N] evictable capacity in the resource type, the [Wp + Wd + B,
    N] int32 port words, PD words and evictable counts, and the [G, N]
    int16 peer counts. Mirrors state_bytes in csrc/commit_solve.cuh."""
    return (res_bytes * (R + B * R) * N + 4 * (Wp + Wd + B) * N
            + 2 * G * N)


def shared_layout(N: int, R: int, Wp: int, Wd: int, G: int, B: int = 0,
                  res_bytes: int = 4) -> Tuple[bool, int]:
    """Where the kernel keeps one wave's node state -> (on_chip, bytes of
    dynamic shared memory). The kernel always takes a two-row ring for the
    static mask; the state (``state_bytes``) joins it when both fit a
    block's shared memory, and otherwise lives in a global buffer of the
    same packed layout. Mirrors shared_bytes in csrc/commit_solve.cu."""
    ring = 2 * mask_pitch(N)
    state = state_bytes(N, R, Wp, Wd, G, B, res_bytes)
    on_chip = ring + state <= SMEM_PER_BLOCK - STATIC_SMEM
    return on_chip, ring + (state if on_chip else 0)


def _dims(ci: "CommitInputs"):
    """(N, R, Wp, Wd, G, B, bytes per resource value) of a prepared wave."""
    R, N = ci.cap.shape
    return (N, R, ci.ports0.shape[0], ci.pds0.shape[0], ci.counts0.shape[0],
            ci.band.shape[0], ci.cap.element_size())


def layout_of(ci: "CommitInputs") -> Tuple[bool, int]:
    """``shared_layout`` of one prepared wave."""
    return shared_layout(*_dims(ci))


class CommitInputs(NamedTuple):
    """One wave, laid out for the kernel. Node planes are [axis, N]; port
    and PD words are uint32 carried as int32 bit patterns. Resource planes
    are int32 or int64 (the "resource type", one per wave). Extension and
    preemption planes have a zero-size axis when the wave does not use
    them."""

    smask: torch.Tensor       # [P, mask_pitch(N)] uint8 static
                              # feasibility; columns N.. are 0
    podrow: Optional[torch.Tensor]  # [P, RW+Wp+Wd+7+L] int32, RW the int32
                                    # words of R requests; None if G > 31
    cap: torch.Tensor         # [R, N] resource type
    fit0: torch.Tensor        # [R, N] greedy-fitting usage
    score0: torch.Tensor      # [R, N] all-pods usage
    off: torch.Tensor         # [R, N] score0 - fit0: every commit and
                              # rollback moves both usages alike
    advx: torch.Tensor        # [R, N] uint8 capacity key advertised
    fitexc: torch.Tensor      # [N] uint8 pre-exceeded node
    ports0: torch.Tensor      # [Wp, N] int32
    pds0: torch.Tensor        # [Wd, N] int32
    counts0: torch.Tensor     # [G, N] int32 service peers per node
    offl: torch.Tensor        # [G] int32 peers on no listed node
    sstat: torch.Tensor       # [N] int32 NodeLabelPriority plane, or [0]
    affv: torch.Tensor        # [L, N] int32 affinity value codes, -1 absent
    anchor0: torch.Tensor     # [G, L] int32 initial anchor values
    has0: torch.Tensor        # [G] uint8 the group has an anchor
    zone: torch.Tensor        # [A, N] int32 zone codes, -1 unlabeled
    ecap0: torch.Tensor       # [B, R, N] evictable capacity per band
    ecnt0: torch.Tensor       # [B, N] int32 evictable pods per band
    band: torch.Tensor        # [B] int32 band values by slot (BAND_EMPTY
                              # pads); B = 0 unless the wave can preempt
    bord: torch.Tensor        # [B] int32 slots in ascending band value
                              # (stable: equal values keep slot order)
    req: torch.Tensor         # [P, R] resource type
    pod_ports: torch.Tensor   # [P, Wp] int32
    pod_pds: torch.Tensor     # [P, Wd] int32
    pins: torch.Tensor        # [P, L] int32 selector-pinned codes, -2 none
    tie_hi: torch.Tensor      # [P] int64, 0 <= v < 2^32
    tie_lo: torch.Tensor      # [P] int64
    gid: torch.Tensor         # [P] int64, -1 = no service
    member: torch.Tensor      # [P, G] bool
    zreq: torch.Tensor        # [P] bool — requests zero of everything
    start: torch.Tensor       # [P] bool — a scheduling unit starts here
    prio: torch.Tensor        # [P] int32 pod priorities
    canp: torch.Tensor        # [P] bool — the pod may preempt
    flags: int                # _USE_* and _GANGS bits
    w_lr: int
    w_spread: int
    w_equal: int
    w_anti: Tuple[int, ...]   # weight per anti-affinity label (A of them)
    V: int                    # zone codes are < V


def eligible(inp, pol: Optional[BatchPolicy], peer_bound: int) -> bool:
    """True when the wave is in the kernel's domain: the reference's
    (pallas_solver.eligible) whole domain — R and port/PD words <= 8, G <=
    31 groups, N <= 32,640 nodes, A <= 4 anti-affinity labels of V <= 64
    zones, L <= 4 service-affinity labels, the snapshot encoded for this
    policy's labels, spread counts below 2^15, gang waves — and beyond it
    int64 resource planes and preemption waves of at most MAX_B bands,
    which the reference runs in its scan. The reference also refuses a
    wave whose planes overflow its TPU core's memory; the kernel keeps its
    state in global memory when shared memory is too small
    (``shared_layout``), so it has no such budget. ``inp`` is a
    SolverInputs of tensors; ``peer_bound`` the largest initial per-group
    peer total (batch_solver.peer_bound_of)."""
    if pol is None or pol.all_infeasible:
        return False
    if inp.cap.dtype not in (torch.int32, torch.int64):
        return False
    N, R = inp.cap.shape
    G = inp.group_counts.shape[0]
    if not (R <= MAX_R and inp.node_ports.shape[1] <= MAX_W
            and inp.node_pds.shape[1] <= MAX_W and G <= MAX_G
            and N <= MAX_N):
        return False
    if pol.use_resources and inp.band_prio.shape[0] > MAX_B:
        return False
    if pol.anti_affinity:
        A, V = inp.zone_idx.shape[0], inp.zone_counts0.shape[2]
        if not (0 < A <= MAX_A and V <= MAX_V
                and A == len(pol.anti_affinity)):
            return False
    if pol.has_affinity:
        L = inp.node_aff_vals.shape[1]
        if not (0 < L <= MAX_L and L == len(pol.affinity_labels)):
            return False
    # spread and anti-affinity totals stay below 2^15: initial peers plus
    # every wave commit
    return peer_bound + inp.req.shape[0] < MAX_COUNT


def _u32_as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def prepare(inp, pol: BatchPolicy, gangs: bool = False) -> CommitInputs:
    """The prolog: SolverInputs (tensors on one device) -> CommitInputs on
    the same device. ``gangs`` turns on the checkpoint and rollback of
    PodGroup runs (``inp.gang_start`` marks each unit's first pod). The
    band planes are kept only where preemption can happen: bands present
    and the resource filter on (the reference's ``enable_p``)."""
    N, R = inp.cap.shape
    P = inp.req.shape[0]
    dev = inp.cap.device
    i32 = torch.int32
    L = inp.node_aff_vals.shape[1] if pol.has_affinity else 0
    A = len(pol.anti_affinity)
    static = inp.node_extra_ok[None, :].expand(P, N)
    if pol.use_selector:
        # required (key, value) pairs the node lacks; exact in float32
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            violations = torch.matmul(inp.pod_sel.to(torch.float32),
                                      (~inp.node_sel).to(torch.float32).T)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        static = static & (violations == 0)
    if pol.use_host:
        host = inp.pod_host_idx.to(torch.int64)[:, None]
        static = static & ((host == -1) | (host == torch.arange(
            N, device=dev)[None, :]))
    affv = inp.node_aff_vals[:, :L].T.to(i32).contiguous()      # [L, N]
    pins = inp.pod_aff_static[:, :L].to(i32).contiguous()       # [P, L]
    for l in range(L):
        # node-selector-pinned affinity labels are static per pod
        # (predicates.go:247-254); -2 = the selector does not pin label l
        pin = pins[:, l, None]
        static = static & ((pin == -2) | (affv[None, l, :] == pin))
    G = inp.group_counts.shape[0]
    rdt = inp.cap.dtype
    req = inp.req.to(rdt)
    B = inp.band_prio.shape[0] if pol.use_resources else 0
    band = inp.band_prio[:B].to(i32).contiguous()
    bord = torch.argsort(band, stable=True).to(i32)
    prio = inp.pod_prio.to(i32).contiguous()
    canp = inp.pod_can_preempt.to(torch.bool).contiguous()
    tie_hi = inp.tie_hi.to(torch.int64)
    tie_lo = inp.tie_lo.to(torch.int64)
    gid = inp.pod_gid.to(torch.int64)
    member = inp.pod_group_member.to(torch.bool)
    zreq = (inp.req == 0).all(dim=1)
    start = (inp.gang_start.to(torch.bool) if gangs
             else torch.ones(P, dtype=torch.bool, device=dev))
    podrow = None
    if G <= MAX_G:
        bits = (member.to(torch.int64) << torch.arange(
            G, device=dev)[None, :]).sum(dim=1)
        # a gang run starts where a unit start is followed by a member of
        # the same run: only there does the kernel checkpoint its state
        run_head = start & torch.cat([~start[1:], start.new_zeros(1)])
        unit = (start.to(i32) * _START + run_head.to(i32) * _CHECKPOINT
                + canp.to(i32) * _CAN_PREEMPT)
        # an int64 request rides as its two int32 words (little-endian)
        podrow = torch.cat([
            req.contiguous().view(i32), inp.pod_ports, inp.pod_pds,
            _u32_as_i32(tie_hi)[:, None], _u32_as_i32(tie_lo)[:, None],
            gid.to(i32)[:, None], bits.to(i32)[:, None],
            zreq.to(i32)[:, None], unit[:, None], prio[:, None], pins],
            dim=1).contiguous()
    flags = ((_USE_RESOURCES if pol.use_resources else 0)
             | (_USE_PORTS if pol.use_ports else 0)
             | (_USE_DISK if pol.use_disk else 0)
             | (_USE_STATIC if pol.label_prefs else 0)
             | (_GANGS if gangs else 0))
    smask = torch.zeros((P, mask_pitch(N)), dtype=torch.uint8, device=dev)
    smask[:, :N] = static
    fit0 = inp.fit_used.T.to(rdt).contiguous()
    score0 = inp.score_used.T.to(rdt).contiguous()
    return CommitInputs(
        smask=smask,
        podrow=podrow,
        cap=inp.cap.T.to(rdt).contiguous(),
        fit0=fit0,
        score0=score0,
        off=score0 - fit0,
        advx=inp.advertises.T.to(torch.uint8).contiguous(),
        fitexc=inp.fit_exceeded.to(torch.uint8).contiguous(),
        ports0=inp.node_ports.T.contiguous(),
        pds0=inp.node_pds.T.contiguous(),
        counts0=inp.group_counts[:, :N].to(i32).contiguous(),
        offl=inp.group_counts[:, N].to(i32).contiguous(),
        sstat=(inp.score_static.to(i32) if pol.label_prefs
               else torch.zeros(0, dtype=i32, device=dev)).contiguous(),
        affv=affv,
        anchor0=inp.anchor_vals0[:, :L].to(i32).contiguous(),
        has0=(inp.has_anchor0.to(torch.uint8) if L
              else torch.zeros(G, dtype=torch.uint8, device=dev)
              ).contiguous(),
        zone=inp.zone_idx[:A].to(i32).contiguous(),
        ecap0=inp.evict_cap[:, :B, :].to(rdt).permute(1, 2, 0).contiguous(),
        ecnt0=inp.evict_cnt[:, :B].to(i32).T.contiguous(),
        band=band, bord=bord,
        req=req.contiguous(),
        pod_ports=inp.pod_ports.contiguous(),
        pod_pds=inp.pod_pds.contiguous(),
        pins=pins,
        tie_hi=tie_hi, tie_lo=tie_lo, gid=gid, member=member, zreq=zreq,
        start=start.contiguous(), prio=prio, canp=canp,
        flags=flags, w_lr=int(pol.w_lr), w_spread=int(pol.w_spread),
        w_equal=int(pol.w_equal),
        w_anti=tuple(int(w) for _label, w in pol.anti_affinity),
        V=int(inp.zone_counts0.shape[2]) if A else 0)


def solve_commit_reference(ci: CommitInputs, stats: Optional[dict] = None):
    """The plain version: the same (chosen[P], win[P]) int32 as the kernel,
    one pod at a time in torch ops on the inputs' device, with no host
    synchronisation inside the loop (the unit starts are read once before
    it). Follows the reference's scan step by step, the preemption branch
    included (kubernetes_tpu/models/batch_solver.py:676-790). ``stats``,
    when given, receives ``feasible``: the number of normally feasible
    nodes per pod (int64 [P]), ``fit`` and ``score_used``: the two usage
    planes after the wave, and ``preempt_pairs``: the (pod, node) pairs
    the preemption branch examined (nodes passing every filter but the
    resource fit, of pods with no normal node that may preempt)."""
    solve_commit_reference.calls += 1
    P = ci.smask.shape[0]
    R, N = ci.cap.shape
    L, A = ci.affv.shape[0], ci.zone.shape[0]
    B = ci.band.shape[0]
    dev = ci.cap.device
    rdt = ci.cap.dtype
    gangs = bool(ci.flags & _GANGS)
    # the mutable state, in the order the gang checkpoint copies it
    state = [ci.fit0.clone(), ci.score0.clone(), ci.ports0.clone(),
             ci.pds0.clone(), ci.counts0.clone(), ci.anchor0.clone(),
             ci.has0 != 0, ci.ecap0.clone(), ci.ecnt0.clone()]
    dims = torch.arange(R, device=dev)[:, None]
    unconstrained = (ci.cap == 0) & (dims < 2)            # [R, N]
    adv_extra = (ci.advx != 0) & (dims >= 2)              # [R, N]
    fitexc = ci.fitexc != 0
    labeled = ci.zone >= 0                                # [A, N]
    safe_zone = ci.zone.clamp_min(0).to(torch.int64)
    chosen = torch.full((P,), NEG, dtype=torch.int32, device=dev)
    win = torch.full((P,), NEG, dtype=torch.int32, device=dev)
    feasible_count = torch.zeros(P, dtype=torch.int64, device=dev)
    preempt_pairs = torch.zeros(P, dtype=torch.int64, device=dev)
    if stats is not None:
        stats["feasible"] = feasible_count
        stats["preempt_pairs"] = preempt_pairs
    if N == 0:
        return chosen, win
    ten = torch.full((N,), 10, dtype=torch.int32, device=dev)
    neg = torch.tensor(NEG, dtype=torch.int32, device=dev)
    if B:
        # leq_all[b, c]: band b falls under threshold band c
        leq_all = ci.band[:, None] <= ci.band[None, :]
        band_max = torch.full((B, N), 2**31 - 1, dtype=torch.int32,
                              device=dev)
    starts = ci.start.tolist() if gangs else []
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    ckpt = state
    for p in range(P):
        (fit, score_used, ports, pds, counts, anchor, has_anchor, ecap,
         ecnt) = state
        if gangs and starts[p]:
            # a new scheduling unit: checkpoint the committed state
            ckpt = [t.clone() for t in state]
            failed = torch.zeros_like(failed)
        req = ci.req[p]
        g = ci.gid[p]
        safe_g = g.clamp_min(0)
        in_group = g >= 0
        feasible = ci.smask[p, :N] != 0
        if gangs:
            # the rest of an already-failed run places nowhere
            feasible = feasible & ~failed
        if ci.flags & _USE_PORTS:
            feasible = feasible & ~((ports & ci.pod_ports[p][:, None]) != 0
                                    ).any(dim=0)
        if ci.flags & _USE_DISK:
            feasible = feasible & ~((pds & ci.pod_pds[p][:, None]) != 0
                                    ).any(dim=0)
        if L:
            # anchor-derived affinity (predicates.go:256-276): labels the
            # selector did not pin must equal the group's anchor values
            arow = anchor[safe_g]                              # [L]
            need = (ci.pins[p] == -2) & (arow >= 0)            # [L]
            dyn = (~need[:, None] | (ci.affv == arow[:, None])).all(dim=0)
            feasible = feasible & (~(in_group & has_anchor[safe_g]) | dyn)
        # every filter but the resources: the preemption branch re-checks
        # the fit with freed capacity against exactly this
        feasible_nores = feasible
        if ci.flags & _USE_RESOURCES:
            res_ok = (unconstrained | (ci.cap - fit >= req[:, None])).all(0)
            feasible = feasible & (ci.zreq[p] | (~fitexc & res_ok))
        score = torch.zeros(N, dtype=torch.int32, device=dev)
        if ci.w_lr:
            n_dyn = 2 + (adv_extra & feasible[None, :]).any(dim=1).sum()
            raw = calculate_score(score_used + req[:, None], ci.cap).sum(0)
            lr = torch.div(raw, n_dyn, rounding_mode="floor")
            score = score + (lr * ci.w_lr).to(torch.int32)
        if ci.w_spread:
            row = counts[safe_g]
            max_count = torch.maximum(row.max(), ci.offl[safe_g])
            spread = torch.where(in_group, spread_score(max_count, row), ten)
            score = score + spread * ci.w_spread
        if A:
            # ServiceAntiAffinity (spreading.go:104-168): per-zone peers
            # over the FEASIBLE nodes; num counts every peer, off-list too;
            # a serviceless pod has no peers (spread of total 0 is 10)
            row = counts[safe_g] * in_group
            num = row.sum() + ci.offl[safe_g] * in_group
            on = row * feasible
            for a in range(A):
                per_zone = torch.zeros(ci.V, dtype=torch.int32, device=dev)
                per_zone.index_add_(0, safe_zone[a], on * labeled[a])
                s = spread_score(num, per_zone[safe_zone[a]])
                score = score + s * labeled[a] * ci.w_anti[a]
        if ci.flags & _USE_STATIC:
            score = score + ci.sstat
        if ci.w_equal:
            score = score + ci.w_equal
        masked = torch.where(feasible, score, torch.full_like(score, NEG))
        top, any_f, best, cnt = masked_top_count(masked, NEG)
        best = best & feasible
        k = u64_mod_small(ci.tie_hi[p], ci.tie_lo[p], cnt)
        pick = torch.where(any_f, select_kth_true(best, k), neg)
        won = torch.where(any_f, top, neg)
        freed_sel = torch.zeros(R, dtype=rdt, device=dev)
        if B:
            # ---- preemption: lowest sufficient band prefix per node, the
            # fewest victims across nodes (batch_solver.py:676-732) ------
            below = ci.band < ci.prio[p]                          # [B]
            leq = leq_all & below[:, None]                        # [B, B]
            freed = (ecap[:, None] * leq[:, :, None, None].to(rdt)
                     ).sum(0, dtype=rdt)                          # [B, R, N]
            ccost = (ecnt[:, None] * leq[:, :, None].to(torch.int32)
                     ).sum(0, dtype=torch.int32)                  # [B, N]
            head = (ci.cap - fit)[None] + freed
            fits = (unconstrained[None] | (head >= req[None, :, None])
                    ).all(1)                                      # [B, N]
            fits = (fits & below[:, None] & feasible_nores[None]
                    & ~fitexc[None])
            # the smallest fitting band value; argmin takes the first slot
            bidx = torch.argmin(torch.where(fits, ci.band[:, None],
                                            band_max), dim=0)     # [N]
            cost = ccost.gather(0, bidx[None])[0]
            pmask = fits.any(0) & ci.canp[p]
            masked_p = torch.where(pmask, PREEMPT_BIG - cost,
                                   torch.full_like(cost, NEG))
            _ptop, p_any, pbest, pcnt = masked_top_count(masked_p, NEG)
            pchosen = select_kth_true(
                pbest & pmask, u64_mod_small(ci.tie_hi[p], ci.tie_lo[p], pcnt))
            did = ~any_f & p_any
            pick = torch.where(did, pchosen, pick)
            bsel = bidx[pick.clamp_min(0).to(torch.int64)]
            won = torch.where(did, PREEMPT_SCORE_BASE - bsel.to(torch.int32),
                              won)
            evicted = leq[:, bsel] & did                          # [B]
            freed_sel = torch.where(
                did, freed[bsel, :, pick.clamp_min(0).to(torch.int64)],
                freed_sel)
            if stats is not None:
                preempt_pairs[p] = (feasible_nores.sum()
                                    * (~any_f & ci.canp[p]))
        chosen[p] = pick
        win[p] = won
        if stats is not None:
            feasible_count[p] = feasible.sum()
        # commit the chosen row (an unplaced pod adds zeros at row 0); a
        # preemption's evicted bands leave both usages and the band planes
        at = pick.clamp_min(0).to(torch.int64).view(1)
        placed = pick >= 0
        on = placed.to(torch.int32)
        delta = ((req - freed_sel) * placed.to(rdt))[:, None]
        fit.index_add_(1, at, delta)
        score_used.index_add_(1, at, delta)
        ports.index_copy_(1, at, ports.index_select(1, at)
                          | (ci.pod_ports[p] * on)[:, None])
        pds.index_copy_(1, at, pds.index_select(1, at)
                        | (ci.pod_pds[p] * on)[:, None])
        counts.index_add_(1, at, (ci.member[p].to(torch.int32)
                                  * on)[:, None])
        if L:
            # every group this commit gives its first peer is anchored at
            # the chosen node's values
            newly = ci.member[p] & ~has_anchor & placed          # [G]
            state[5] = torch.where(newly[:, None],
                                   ci.affv[:, at].T, anchor)
            state[6] = has_anchor | newly
        if B:
            ecap.index_copy_(2, at, torch.where(
                evicted[:, None, None], torch.zeros((), dtype=rdt,
                                                    device=dev),
                ecap.index_select(2, at)))
            ecnt.index_copy_(1, at, torch.where(
                evicted[:, None], torch.zeros((), dtype=torch.int32,
                                              device=dev),
                ecnt.index_select(1, at)))
        if gangs:
            # a failed member pins the state at the run's checkpoint
            failed = failed | ~placed
            state = [torch.where(failed, c, t) for c, t in zip(ckpt, state)]
    if stats is not None:
        stats["fit"], stats["score_used"] = state[0], state[1]
    return chosen, win


solve_commit_reference.calls = 0


_SIGNATURES = {
    "kgpu_commit_solve": (ctypes.c_int, [ctypes.c_void_p] * 24
                          + [ctypes.c_int] * 22
                          + [ctypes.c_longlong, ctypes.c_void_p]),
    "kgpu_spread_eval": (ctypes.c_int, [ctypes.c_void_p] * 3
                         + [ctypes.c_longlong, ctypes.c_void_p]),
    "kgpu_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _lib() -> ctypes.CDLL:
    return build.load("commit_solve", _SIGNATURES)


def _check_launch(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} launch failed: {lib.kgpu_error_string(rc).decode()}")


def _row_words(ci: CommitInputs) -> int:
    """int32 words of one pod row: the requests in the resource type, the
    port and PD words, the fixed fields and the pinned affinity codes."""
    R = ci.cap.shape[0]
    return (R * ci.cap.element_size() // 4 + ci.ports0.shape[0]
            + ci.pds0.shape[0] + _ROW_FIXED + ci.affv.shape[0])


def _check(ci: CommitInputs) -> None:
    """Every plane of ``ci`` has the dtype, shape, device and layout the
    kernel reads; the resource type (int32 or int64) is the wave's own."""
    P = ci.smask.shape[0]
    R, N = ci.cap.shape
    Wp, Wd, G = ci.ports0.shape[0], ci.pds0.shape[0], ci.counts0.shape[0]
    L, A, B = ci.affv.shape[0], ci.zone.shape[0], ci.band.shape[0]
    dev = ci.smask.device
    rdt = ci.cap.dtype
    if rdt not in (torch.int32, torch.int64):
        raise ValueError(f"CommitInputs.cap: want int32 or int64, got {rdt}")
    want = {
        "smask": (torch.uint8, (P, mask_pitch(N))),
        "cap": (rdt, (R, N)),
        "fit0": (rdt, (R, N)), "score0": (rdt, (R, N)),
        "off": (rdt, (R, N)),
        "advx": (torch.uint8, (R, N)), "fitexc": (torch.uint8, (N,)),
        "ports0": (torch.int32, (Wp, N)), "pds0": (torch.int32, (Wd, N)),
        "counts0": (torch.int32, (G, N)), "offl": (torch.int32, (G,)),
        "sstat": (torch.int32, (N if ci.flags & _USE_STATIC else 0,)),
        "affv": (torch.int32, (L, N)), "anchor0": (torch.int32, (G, L)),
        "has0": (torch.uint8, (G,)), "zone": (torch.int32, (A, N)),
        "ecap0": (rdt, (B, R, N)), "ecnt0": (torch.int32, (B, N)),
        "band": (torch.int32, (B,)), "bord": (torch.int32, (B,)),
        "req": (rdt, (P, R)), "pod_ports": (torch.int32, (P, Wp)),
        "pod_pds": (torch.int32, (P, Wd)), "pins": (torch.int32, (P, L)),
        "tie_hi": (torch.int64, (P,)), "tie_lo": (torch.int64, (P,)),
        "gid": (torch.int64, (P,)), "member": (torch.bool, (P, G)),
        "zreq": (torch.bool, (P,)), "start": (torch.bool, (P,)),
        "prio": (torch.int32, (P,)), "canp": (torch.bool, (P,)),
    }
    if ci.podrow is not None:
        want["podrow"] = (torch.int32, (P, _row_words(ci)))
    for name, (dtype, shape) in want.items():
        t = getattr(ci, name)
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"CommitInputs.{name}: want {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"CommitInputs.{name} is on {t.device}, "
                             f"the wave on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"CommitInputs.{name} is not contiguous")
    if len(ci.w_anti) != A:
        raise ValueError(f"CommitInputs.w_anti: want {A} weights, got "
                         f"{len(ci.w_anti)}")


def solve_commit(ci: CommitInputs):
    """Solve one wave -> (chosen[P], win[P]) int32: chosen node index or -1,
    the winning score, -1, or for a preempting placement
    PREEMPT_SCORE_BASE - its band slot. A CUDA wave launches the kernel (or
    raises); a CPU wave runs the plain version."""
    _check(ci)
    dev = ci.smask.device
    if dev.type == "cpu":
        return solve_commit_reference(ci)
    if dev.type != "cuda":
        raise ValueError(f"solve_commit runs on cuda or cpu, not {dev}")
    P = ci.smask.shape[0]
    N, R, Wp, Wd, G, B, res_bytes = _dims(ci)
    L, A = ci.affv.shape[0], ci.zone.shape[0]
    if (ci.podrow is None or N > MAX_N or R > MAX_R or Wp > MAX_W
            or Wd > MAX_W or G > MAX_G or L > MAX_L or A > MAX_A
            or ci.V > MAX_V or B > MAX_B):
        raise ValueError(
            f"wave outside the kernel's domain (N={N} R={R} Wp={Wp} "
            f"Wd={Wd} G={G} L={L} A={A} V={ci.V} B={B}); dispatch it with "
            f"eligible()")
    lib = _lib()
    on_chip, dyn_bytes = layout_of(ci)
    # the packed state planes (the kernel's layout, used when they do not
    # fit on chip) and the gang checkpoint, one more copy of them
    nbytes = state_bytes(N, R, Wp, Wd, G, B, res_bytes)
    gstate = (None if on_chip else
              torch.empty(nbytes, dtype=torch.uint8, device=dev))
    ckpt = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
            if ci.flags & _GANGS else None)
    chosen = torch.empty(P, dtype=torch.int32, device=dev)
    win = torch.empty(P, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() if t is not None else None for t in (
        ci.smask, ci.podrow, ci.cap, ci.fit0, ci.off, ci.advx, ci.fitexc,
        ci.ports0, ci.pds0, ci.counts0, ci.offl, ci.sstat, ci.affv,
        ci.anchor0, ci.has0, ci.zone, ci.ecap0, ci.ecnt0, ci.band, ci.bord,
        gstate, ckpt, chosen, win)]
    w_anti = list(ci.w_anti) + [0] * (MAX_A - A)
    rc = lib.kgpu_commit_solve(
        *ptrs, P, N, mask_pitch(N), R, Wp, Wd, G, L, A, ci.V, B, res_bytes,
        _row_words(ci), ci.flags, ci.w_lr, ci.w_spread, ci.w_equal, *w_anti,
        int(on_chip), dyn_bytes, stream)
    _check_launch(lib, rc, "commit_solve")
    solve_commit.launches += 1
    return chosen, win


solve_commit.launches = 0


def spread_eval(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The kernel's spread-score device function over int32 CUDA tensors
    of (total, count) pairs -> int32 scores."""
    if total.device.type != "cuda" or count.device != total.device:
        raise ValueError("spread_eval runs on CUDA tensors only")
    if total.dtype != torch.int32 or count.dtype != torch.int32 \
            or total.shape != count.shape or not total.is_contiguous() \
            or not count.is_contiguous():
        raise ValueError("spread_eval takes contiguous int32 tensors of one "
                         "shape")
    lib = _lib()
    out = torch.empty_like(total)
    stream = torch.cuda.current_stream(total.device).cuda_stream
    rc = lib.kgpu_spread_eval(total.data_ptr(), count.data_ptr(),
                              out.data_ptr(), total.numel(), stream)
    _check_launch(lib, rc, "spread_eval")
    return out
