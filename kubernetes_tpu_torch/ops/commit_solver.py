"""The sequential-commit wave solve: prolog, CUDA kernel wrapper, plain
version.

Counterpart of ``kubernetes_tpu/ops/pallas_solver.py`` (the JAX package's
only Pallas kernel, ``_solve_pallas_x32`` at :772), with every branch of
its body: the default filters and priorities, CheckNodeLabelPresence (in
the static mask), CheckServiceAffinity anchors, NodeLabelPriority,
ServiceAntiAffinity zones, and the gang checkpoint and rollback. Its
domain is wider than the Pallas kernel's: waves with int64 resource
planes, waves with priority bands (preemption), and large clusters (up to
``MAX_N`` nodes, ``MAX_G`` service groups, peer totals below 2^24), which
the reference solves in ``solve_jit``'s scan (kubernetes_tpu/models/
batch_solver.py:398, :676-790), run here too, with the same decisions.

- ``eligible`` is the kernel's domain: the reference's (:90-157), plus
  int64 planes, up to ``MAX_B`` bands, and the large-cluster limits,
  which the kernel's large instances take (``is_large``).
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
- ``solve_commit_batch`` solves several waves of one shape in one launch,
  one block (one SM) per wave: the counterpart of the batch axis the
  reference's solver daemon puts on ``solve_jit`` with ``vmap``
  (kubernetes_tpu/solver/service.py:176-186). On the CPU it is the plain
  version, wave by wave.
- ``shared_layout`` is where the kernel keeps a wave's node state: in the
  block's shared memory when it fits, else in a global buffer.
- ``spread_eval`` runs the kernel's spread-score device function over
  arrays of (total, count), for checking it exhaustively on the card.
"""

from __future__ import annotations

import ctypes
import functools
import warnings
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
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

__all__ = ["CommitInputs", "count_bytes_for", "eligible", "is_large",
           "launch_key", "layout_of", "mask_pitch", "prepare",
           "shared_layout", "solve_commit",
           "solve_commit_batch", "solve_commit_reference", "spread_eval",
           "MAX_B", "MAX_N"]

NEG = -1
MAX_R = 8
MAX_W = 8
MAX_G = 1024         # a 1,024-pod wave names at most this many groups
MAX_N = 65536        # 1,024 threads of 64 nodes (the large instances)
MAX_COUNT = 1 << 24  # peer totals: the spread score's float32 is exact
                     # below (ops/kernels.spread_score)
# The narrow instances' limits: 32 nodes a thread in a 32-bit mask, one
# int32 of member bits, int16 peer counts. A wave past any of them takes
# the large instances (csrc/commit_solve.cuh kLarge).
NARROW_N = 1024 * 32
NARROW_G = 31
NARROW_COUNT = 1 << 15
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
                res_bytes: int = 4, cnt_bytes: int = 2) -> int:
    """Bytes of one wave's packed node state: the [R, N] fit usage and the
    [B, R, N] evictable capacity in the resource type, the [Wp + Wd + B,
    N] int32 port words, PD words and evictable counts, and the [G, N]
    peer counts, int16 (``cnt_bytes`` 2) or int32 (4, a large wave whose
    totals may reach 2^15). Mirrors state_bytes in csrc/commit_solve.cuh."""
    return (res_bytes * (R + B * R) * N + 4 * (Wp + Wd + B) * N
            + cnt_bytes * G * N)


def state_stride(N: int, R: int, Wp: int, Wd: int, G: int, B: int = 0,
                 res_bytes: int = 4, cnt_bytes: int = 2) -> int:
    """Bytes from one wave's packed state to the next in a batched launch
    (the global state and the gang checkpoint): ``state_bytes`` rounded up
    to 16, so every wave's planes are as aligned as the first wave's (an
    odd G * N leaves ``state_bytes`` 2 mod 4). Mirrors state_stride in
    csrc/commit_solve.cuh, which only batched waves (int16 counts) take;
    a large wave's one buffer is sized here too."""
    return -(-state_bytes(N, R, Wp, Wd, G, B, res_bytes, cnt_bytes)
             // 16) * 16


def count_bytes_for(peer_bound: int, n_pods: int) -> int:
    """Bytes of one peer count in the kernel's state: int16 while every
    total (the initial peers plus a commit per pod) stays below 2^15, else
    int32."""
    return 2 if peer_bound + n_pods < NARROW_COUNT else 4


def is_large(N: int, G: int, cnt_bytes: int = 2) -> bool:
    """A wave past the narrow instances' limits, which the large
    instances take. Mirrors is_large in csrc/commit_solve.cu."""
    return N > NARROW_N or G > NARROW_G or cnt_bytes != 2


def member_words(G: int) -> int:
    """int32 words of member bits in a pod row: one per 32 groups, at
    least one. Mirrors member_words in csrc/commit_solve.cuh."""
    return -(-G // 32) if G > 32 else 1


def anchor_bytes(G: int, L: int) -> int:
    """Bytes of a large wave's anchor block in dynamic shared memory: the
    [G, L] anchors, the [G] has-anchor flags and their gang checkpoint,
    none without affinity labels. Mirrors anchor_bytes in
    csrc/commit_solve.cuh."""
    return 4 * (2 * G * L + 2 * G) if L > 0 else 0


def shared_layout(N: int, R: int, Wp: int, Wd: int, G: int, B: int = 0,
                  res_bytes: int = 4, cnt_bytes: int = 2, L: int = 0
                  ) -> Tuple[bool, int]:
    """Where the kernel keeps one wave's node state -> (on_chip, bytes of
    dynamic shared memory). The kernel always takes a two-row ring for the
    static mask, and a large wave (``is_large``) its anchor block after
    it; the state (``state_bytes``) joins them when all fit a block's
    shared memory, and otherwise lives in a global buffer of the same
    packed layout. Mirrors shared_bytes in csrc/commit_solve.cu."""
    fixed = 2 * mask_pitch(N) + (anchor_bytes(G, L)
                                 if is_large(N, G, cnt_bytes) else 0)
    state = state_bytes(N, R, Wp, Wd, G, B, res_bytes, cnt_bytes)
    on_chip = fixed + state <= SMEM_PER_BLOCK - STATIC_SMEM
    return on_chip, fixed + (state if on_chip else 0)


def _dims(ci: "CommitInputs"):
    """(N, R, Wp, Wd, G, B, bytes per resource value, bytes per peer
    count) of a prepared wave."""
    R, N = ci.cap.shape
    return (N, R, ci.ports0.shape[0], ci.pds0.shape[0], ci.counts0.shape[0],
            ci.band.shape[0], ci.cap.element_size(), ci.count_bytes)


def layout_of(ci: "CommitInputs") -> Tuple[bool, int]:
    """``shared_layout`` of one prepared wave."""
    return shared_layout(*_dims(ci), L=ci.affv.shape[0])


class CommitInputs(NamedTuple):
    """One wave, laid out for the kernel. Node planes are [axis, N]; port
    and PD words are uint32 carried as int32 bit patterns. Resource planes
    are int32 or int64 (the "resource type", one per wave). Extension and
    preemption planes have a zero-size axis when the wave does not use
    them."""

    smask: torch.Tensor       # [P, mask_pitch(N)] uint8 static
                              # feasibility; columns N.. are 0
    podrow: Optional[torch.Tensor]  # [P, RW+Wp+Wd+6+MW+L] int32, RW the
                                    # int32 words of R requests, MW those
                                    # of the member bits (member_words);
                                    # None if G > MAX_G
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
    count_bytes: int = 2      # the kernel's peer counts: int16, or int32
                              # where a total may reach 2^15


def eligible(inp, pol: Optional[BatchPolicy], peer_bound: int) -> bool:
    """True when the wave is in the kernel's domain: the reference's
    (pallas_solver.eligible) whole domain — R and port/PD words <= 8, A <=
    4 anti-affinity labels of V <= 64 zones, L <= 4 service-affinity
    labels, the snapshot encoded for this policy's labels, gang waves —
    and beyond it what the reference runs in its scan: int64 resource
    planes, preemption waves of at most MAX_B bands, up to MAX_N = 65,536
    nodes (the reference: 32,640), MAX_G = 1,024 groups (31), and peer
    totals below 2^24 (2^15). The reference also refuses a
    wave whose planes overflow its TPU core's memory; the kernel keeps its
    state in global memory when shared memory is too small
    (``shared_layout``), so it has no such budget. ``inp`` is a
    SolverInputs of tensors or of host (numpy) arrays; ``peer_bound`` the
    largest initial per-group peer total (batch_solver.peer_bound_of)."""
    if pol is None or pol.all_infeasible:
        return False
    if inp.cap.dtype not in (torch.int32, torch.int64, np.int32, np.int64):
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
    # spread and anti-affinity totals (and every zone sum) stay below
    # 2^24: initial peers plus every wave commit
    return peer_bound + inp.req.shape[0] < MAX_COUNT


def _u32_as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def prepare(inp, pol: BatchPolicy, gangs: bool = False,
            peer_bound: Optional[int] = None) -> CommitInputs:
    """The prolog: SolverInputs (tensors on one device) -> CommitInputs on
    the same device. ``gangs`` turns on the checkpoint and rollback of
    PodGroup runs (``inp.gang_start`` marks each unit's first pod). The
    band planes are kept only where preemption can happen: bands present
    and the resource filter on (the reference's ``enable_p``).
    ``peer_bound`` (batch_solver.peer_bound_of) sizes the kernel's peer
    counts (``count_bytes_for``); None reads it off ``inp.group_counts``,
    which on a card waits for the device."""
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
    if peer_bound is None:
        gc = inp.group_counts
        peer_bound = int(gc.sum(1).max()) if gc.numel() else 0
    podrow = None
    if G <= MAX_G:
        # bit g % 32 of word g // 32; a word is uint32 carried as int32
        words = member_words(G)
        padded = torch.zeros((P, words * 32), dtype=torch.int64, device=dev)
        padded[:, :G] = member.to(torch.int64)
        bits = _u32_as_i32((padded.view(P, words, 32) << torch.arange(
            32, device=dev)).sum(dim=2))
        # a gang run starts where a unit start is followed by a member of
        # the same run: only there does the kernel checkpoint its state
        run_head = start & torch.cat([~start[1:], start.new_zeros(1)])
        unit = (start.to(i32) * _START + run_head.to(i32) * _CHECKPOINT
                + canp.to(i32) * _CAN_PREEMPT)
        # an int64 request rides as its two int32 words (little-endian)
        podrow = torch.cat([
            req.contiguous().view(i32), inp.pod_ports, inp.pod_pds,
            _u32_as_i32(tie_hi)[:, None], _u32_as_i32(tie_lo)[:, None],
            gid.to(i32)[:, None], bits,
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
        V=int(inp.zone_counts0.shape[2]) if A else 0,
        count_bytes=count_bytes_for(peer_bound, P))


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
    resource fit, of pods with no normal node that may preempt).

    The loop is ``_plain_loop``. On the CPU it runs as one TorchScript
    call of that same source, which takes the GIL once a wave: run eagerly,
    each of its tens of ops a pod gives the GIL up and takes it back, and
    in a process whose other threads are busy each take waits for them
    (milliseconds an op at a 10 us switch interval). On CUDA it runs
    eagerly, each op an asynchronous launch."""
    solve_commit_reference.calls += 1
    loop = _scripted_loop() if ci.cap.device.type == "cpu" else _plain_loop
    chosen, win, feasible, pairs, fit, score_used = loop(
        ci.smask, ci.cap, ci.fit0, ci.score0, ci.advx, ci.fitexc, ci.ports0,
        ci.pds0, ci.counts0, ci.offl, ci.sstat, ci.affv, ci.anchor0,
        ci.has0, ci.zone, ci.ecap0, ci.ecnt0, ci.band, ci.req, ci.pod_ports,
        ci.pod_pds, ci.pins, ci.tie_hi, ci.tie_lo, ci.gid, ci.member,
        ci.zreq, ci.start, ci.prio, ci.canp, ci.flags, ci.w_lr, ci.w_spread,
        ci.w_equal, list(ci.w_anti), ci.V, stats is not None)
    if stats is not None:
        stats.update(feasible=feasible, preempt_pairs=pairs, fit=fit,
                     score_used=score_used)
    return chosen, win


@functools.cache
def _scripted_loop():
    """``_plain_loop`` compiled by TorchScript, once a process, on first
    use (never at import)."""
    with warnings.catch_warnings():
        # TorchScript is deprecated for new models, not removed; the loop
        # needs only its interpreter
        warnings.simplefilter("ignore", DeprecationWarning)
        return torch.jit.script(_plain_loop)


def _plain_loop(smask: torch.Tensor, cap: torch.Tensor, fit0: torch.Tensor,
                score0: torch.Tensor, advx: torch.Tensor,
                fitexc_u8: torch.Tensor, ports0: torch.Tensor,
                pds0: torch.Tensor, counts0: torch.Tensor,
                offl: torch.Tensor, sstat: torch.Tensor, affv: torch.Tensor,
                anchor0: torch.Tensor, has0: torch.Tensor,
                zone: torch.Tensor, ecap0: torch.Tensor,
                ecnt0: torch.Tensor, band: torch.Tensor, req_all: torch.Tensor,
                pod_ports: torch.Tensor, pod_pds: torch.Tensor,
                pins: torch.Tensor, tie_hi: torch.Tensor,
                tie_lo: torch.Tensor, gid: torch.Tensor,
                member: torch.Tensor, zreq: torch.Tensor,
                start: torch.Tensor, prio: torch.Tensor, canp: torch.Tensor,
                flags: int, w_lr: int, w_spread: int, w_equal: int,
                w_anti: List[int], V: int, want_stats: bool,
                NEG: int = NEG, PREEMPT_BIG: int = PREEMPT_BIG,
                PREEMPT_SCORE_BASE: int = PREEMPT_SCORE_BASE,
                _USE_RESOURCES: int = _USE_RESOURCES,
                _USE_PORTS: int = _USE_PORTS, _USE_DISK: int = _USE_DISK,
                _USE_STATIC: int = _USE_STATIC, _GANGS: int = _GANGS):
    """The plain version's loop over CommitInputs' planes -> (chosen,
    win, feasible, preempt_pairs, fit, score_used); the last four are the
    ``stats`` of ``solve_commit_reference`` (zeros unless ``want_stats``).
    Written in the TorchScript subset: the CPU runs it compiled.
    TorchScript reads no module-level int, so the module's constants come
    in as the defaults of the parameters that bear their names."""
    P = smask.shape[0]
    R, N = cap.shape[0], cap.shape[1]
    L, A = affv.shape[0], zone.shape[0]
    B = band.shape[0]
    dev = cap.device
    rdt = cap.dtype
    gangs = (flags & _GANGS) != 0
    # the mutable state, in the order the gang checkpoint copies it:
    # fit, score_used, ports, pds, counts, anchor, has_anchor, ecap, ecnt
    state = [fit0.clone(), score0.clone(), ports0.clone(), pds0.clone(),
             counts0.clone(), anchor0.clone(), has0 != 0, ecap0.clone(),
             ecnt0.clone()]
    dims = torch.arange(R, device=dev)[:, None]
    unconstrained = (cap == 0) & (dims < 2)                   # [R, N]
    adv_extra = (advx != 0) & (dims >= 2)                     # [R, N]
    fitexc = fitexc_u8 != 0
    labeled = zone >= 0                                       # [A, N]
    safe_zone = zone.clamp_min(0).to(torch.int64)
    chosen = torch.full((P,), NEG, dtype=torch.int32, device=dev)
    win = torch.full((P,), NEG, dtype=torch.int32, device=dev)
    feasible_count = torch.zeros(P, dtype=torch.int64, device=dev)
    preempt_pairs = torch.zeros(P, dtype=torch.int64, device=dev)
    if N == 0:
        return chosen, win, feasible_count, preempt_pairs, state[0], state[1]
    ten = torch.full((N,), 10, dtype=torch.int32, device=dev)
    neg = torch.full((), NEG, dtype=torch.int32, device=dev)
    # leq_all[b, c]: band b falls under threshold band c
    leq_all = band[:, None] <= band[None, :]
    band_max = torch.full((B, N), 2147483647, dtype=torch.int32,
                          device=dev)
    no_band = torch.zeros(B, dtype=torch.bool, device=dev)
    starts: List[bool] = start.tolist() if gangs else []
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    ckpt = state
    for p in range(P):
        fit, score_used, ports, pds = state[0], state[1], state[2], state[3]
        counts, anchor, has_anchor = state[4], state[5], state[6]
        ecap, ecnt = state[7], state[8]
        if gangs and starts[p]:
            # a new scheduling unit: checkpoint the committed state
            ckpt = [t.clone() for t in state]
            failed = torch.zeros_like(failed)
        req = req_all[p]
        g = gid[p]
        safe_g = g.clamp_min(0)
        in_group = g >= 0
        feasible = smask[p, :N] != 0
        if gangs:
            # the rest of an already-failed run places nowhere
            feasible = feasible & ~failed
        if (flags & _USE_PORTS) != 0:
            feasible = feasible & ~((ports & pod_ports[p][:, None]) != 0
                                    ).any(dim=0)
        if (flags & _USE_DISK) != 0:
            feasible = feasible & ~((pds & pod_pds[p][:, None]) != 0
                                    ).any(dim=0)
        if L > 0:
            # anchor-derived affinity (predicates.go:256-276): labels the
            # selector did not pin must equal the group's anchor values
            arow = anchor[safe_g]                              # [L]
            need = (pins[p] == -2) & (arow >= 0)               # [L]
            dyn = (~need[:, None] | (affv == arow[:, None])).all(dim=0)
            feasible = feasible & (~(in_group & has_anchor[safe_g]) | dyn)
        # every filter but the resources: the preemption branch re-checks
        # the fit with freed capacity against exactly this
        feasible_nores = feasible
        if (flags & _USE_RESOURCES) != 0:
            res_ok = (unconstrained | (cap - fit >= req[:, None])).all(0)
            feasible = feasible & (zreq[p] | (~fitexc & res_ok))
        score = torch.zeros(N, dtype=torch.int32, device=dev)
        if w_lr != 0:
            n_dyn = (adv_extra & feasible[None, :]).any(dim=1).sum() + 2
            raw = calculate_score(score_used + req[:, None], cap).sum(0)
            lr = torch.div(raw, n_dyn, rounding_mode="floor")
            score = score + (lr * w_lr).to(torch.int32)
        if w_spread != 0:
            row = counts[safe_g]
            max_count = torch.maximum(row.max(), offl[safe_g])
            spread = torch.where(in_group, spread_score(max_count, row), ten)
            score = score + spread * w_spread
        if A > 0:
            # ServiceAntiAffinity (spreading.go:104-168): per-zone peers
            # over the FEASIBLE nodes; num counts every peer, off-list too;
            # a serviceless pod has no peers (spread of total 0 is 10)
            row = counts[safe_g] * in_group
            num = row.sum() + offl[safe_g] * in_group
            on = row * feasible
            for a in range(A):
                per_zone = torch.zeros(V, dtype=torch.int32, device=dev)
                per_zone.index_add_(0, safe_zone[a], on * labeled[a])
                s = spread_score(num, per_zone[safe_zone[a]])
                score = score + s * labeled[a] * w_anti[a]
        if (flags & _USE_STATIC) != 0:
            score = score + sstat
        if w_equal != 0:
            score = score + w_equal
        masked = torch.where(feasible, score, torch.full_like(score, NEG))
        top, any_f, best, cnt = masked_top_count(masked, NEG)
        best = best & feasible
        k = u64_mod_small(tie_hi[p], tie_lo[p], cnt)
        pick = torch.where(any_f, select_kth_true(best, k), neg)
        won = torch.where(any_f, top, neg)
        freed_sel = torch.zeros(R, dtype=rdt, device=dev)
        evicted = no_band
        if B > 0:
            # ---- preemption: lowest sufficient band prefix per node, the
            # fewest victims across nodes (batch_solver.py:676-732) ------
            below = band < prio[p]                                # [B]
            leq = leq_all & below[:, None]                        # [B, B]
            freed = (ecap[:, None] * leq[:, :, None, None].to(rdt)
                     ).sum(0, dtype=rdt)                          # [B, R, N]
            ccost = (ecnt[:, None] * leq[:, :, None].to(torch.int32)
                     ).sum(0, dtype=torch.int32)                  # [B, N]
            head = (cap - fit)[None] + freed
            fits = (unconstrained[None] | (head >= req[None, :, None])
                    ).all(1)                                      # [B, N]
            fits = (fits & below[:, None] & feasible_nores[None]
                    & ~fitexc[None])
            # the smallest fitting band value; argmin takes the first slot
            bidx = torch.argmin(torch.where(fits, band[:, None],
                                            band_max), dim=0)     # [N]
            cost = ccost.gather(0, bidx[None])[0]
            pmask = fits.any(0) & canp[p]
            masked_p = torch.where(pmask, torch.neg(cost) + PREEMPT_BIG,
                                   torch.full_like(cost, NEG))
            _ptop, p_any, pbest, pcnt = masked_top_count(masked_p, NEG)
            pchosen = select_kth_true(
                pbest & pmask, u64_mod_small(tie_hi[p], tie_lo[p], pcnt))
            did = ~any_f & p_any
            pick = torch.where(did, pchosen, pick)
            bsel = bidx[pick.clamp_min(0).to(torch.int64)]
            won = torch.where(
                did, torch.neg(bsel.to(torch.int32)) + PREEMPT_SCORE_BASE,
                won)
            evicted = leq[:, bsel] & did                          # [B]
            freed_sel = torch.where(
                did, freed[bsel, :, pick.clamp_min(0).to(torch.int64)],
                freed_sel)
            if want_stats:
                preempt_pairs[p] = (feasible_nores.sum()
                                    * (~any_f & canp[p]))
        chosen[p] = pick
        win[p] = won
        if want_stats:
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
                          | (pod_ports[p] * on)[:, None])
        pds.index_copy_(1, at, pds.index_select(1, at)
                        | (pod_pds[p] * on)[:, None])
        counts.index_add_(1, at, (member[p].to(torch.int32)
                                  * on)[:, None])
        if L > 0:
            # every group this commit gives its first peer is anchored at
            # the chosen node's values
            newly = member[p] & ~has_anchor & placed          # [G]
            state[5] = torch.where(newly[:, None], affv[:, at].T, anchor)
            state[6] = has_anchor | newly
        if B > 0:
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
            rolled: List[torch.Tensor] = []
            for i in range(len(state)):
                rolled.append(torch.where(failed, ckpt[i], state[i]))
            state = rolled
    return chosen, win, feasible_count, preempt_pairs, state[0], state[1]


solve_commit_reference.calls = 0


_SIGNATURES = {
    "kgpu_commit_solve_batch": (ctypes.c_int, [ctypes.c_void_p] * 24
                                + [ctypes.c_int] * 23
                                + [ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_void_p]),
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
    port and PD words, the fixed fields, the member words and the pinned
    affinity codes."""
    R = ci.cap.shape[0]
    return (R * ci.cap.element_size() // 4 + ci.ports0.shape[0]
            + ci.pds0.shape[0] + _ROW_FIXED - 1
            + member_words(ci.counts0.shape[0]) + ci.affv.shape[0])


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
    if ci.count_bytes not in (2, 4):
        raise ValueError(f"CommitInputs.count_bytes: want 2 or 4, got "
                         f"{ci.count_bytes}")


# the kernel's input planes, in the order of its C interface
_KERNEL_PLANES = ("smask", "podrow", "cap", "fit0", "off", "advx", "fitexc",
                  "ports0", "pds0", "counts0", "offl", "sstat", "affv",
                  "anchor0", "has0", "zone", "ecap0", "ecnt0", "band", "bord")


def launch_stacked(ci: CommitInputs, planes, batch: int):
    """One launch of the kernel over ``batch`` waves shaped and flagged
    like ``ci``, one block each; ``planes`` are the ``_KERNEL_PLANES`` as
    [batch, ...] stacks (or ``ci``'s own for one wave) -> (chosen, win)
    int32 [batch, P] on the card. A large wave (``is_large``) launches
    alone. Raises when the launch is refused."""
    dev = ci.smask.device
    P = ci.smask.shape[0]
    N, R, Wp, Wd, G, B, res_bytes, cnt_bytes = _dims(ci)
    L, A = ci.affv.shape[0], ci.zone.shape[0]
    if (ci.podrow is None or N > MAX_N or R > MAX_R or Wp > MAX_W
            or Wd > MAX_W or G > MAX_G or L > MAX_L or A > MAX_A
            or ci.V > MAX_V or B > MAX_B):
        raise ValueError(
            f"wave outside the kernel's domain (N={N} R={R} Wp={Wp} "
            f"Wd={Wd} G={G} L={L} A={A} V={ci.V} B={B}); dispatch it with "
            f"eligible()")
    if batch > 1 and is_large(N, G, cnt_bytes):
        raise ValueError("a large wave launches alone (solve_commit_batch "
                         "launches such waves one by one)")
    lib = _lib()
    on_chip, dyn_bytes = layout_of(ci)
    # the packed state planes (the kernel's layout, used when they do not
    # fit on chip) and the gang checkpoint, one more copy of them; one of
    # each per wave
    nbytes = batch * state_stride(N, R, Wp, Wd, G, B, res_bytes, cnt_bytes)
    gstate = (None if on_chip else
              torch.empty(nbytes, dtype=torch.uint8, device=dev))
    ckpt = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
            if ci.flags & _GANGS else None)
    chosen = torch.empty((batch, P), dtype=torch.int32, device=dev)
    win = torch.empty((batch, P), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() if t is not None else None
            for t in (*planes, gstate, ckpt, chosen, win)]
    w_anti = list(ci.w_anti) + [0] * (MAX_A - A)
    rc = lib.kgpu_commit_solve_batch(
        *ptrs, P, N, mask_pitch(N), R, Wp, Wd, G, L, A, ci.V, B, res_bytes,
        cnt_bytes, _row_words(ci), ci.flags, ci.w_lr, ci.w_spread,
        ci.w_equal, *w_anti, int(on_chip), dyn_bytes, batch, stream)
    _check_launch(lib, rc, "commit_solve")
    solve_commit.launches += 1
    solve_commit.instances.add(instance_of(ci, batch))
    if batch > 1:
        solve_commit_batch.launches += 1
    return chosen, win


def _instance_name(res_bytes: int, N: int, R: int, Wp: int, Wd: int,
                   G: int, B: int, L: int, A: int, gang: bool, static: bool,
                   batch: int, cnt_bytes: int = 2) -> str:
    """Mirrors the dispatch of kgpu_commit_solve_batch in
    csrc/commit_solve.cu: a large wave takes the large instances, int32
    waves without bands the narrow ones, the others the wide ones
    (extensions on, decided at run time)."""
    on_chip, _ = shared_layout(N, R, Wp, Wd, G, B, res_bytes, cnt_bytes, L)
    res = "int32" if res_bytes == 4 else "int64"
    if is_large(N, G, cnt_bytes):
        return (f"commit_solve_large<{res},counts{8 * cnt_bytes},"
                f"{int(on_chip)}>")
    if res_bytes == 4 and B == 0:
        pre, aff, anti = False, L > 0, A > 0
    else:
        pre, aff, anti, static = res_bytes == 4 or B > 0, True, True, True
    bits = ",".join(str(int(f)) for f in (pre, aff, anti, gang, static,
                                          on_chip, batch > 1))
    return f"commit_solve<{res},{bits}>"


def instance_of(ci: CommitInputs, batch: int = 1) -> str:
    """The kernel instance a launch of ``batch`` waves shaped and flagged
    like ``ci`` takes, named as ptxas' report names it:
    ``commit_solve<int32|int64,pre,aff,anti,gang,static,shared,batch>``
    with 0/1 flags, or for a large wave (one a launch)
    ``commit_solve_large<int32|int64,counts16|counts32,shared>``."""
    N, R, Wp, Wd, G, B, res_bytes, cnt_bytes = _dims(ci)
    return _instance_name(res_bytes, N, R, Wp, Wd, G, B, ci.affv.shape[0],
                          ci.zone.shape[0], bool(ci.flags & _GANGS),
                          bool(ci.flags & _USE_STATIC), batch, cnt_bytes)


def instance_for(inp, pol: BatchPolicy, gangs: bool, batch: int = 1,
                 peer_bound: int = 0) -> str:
    """``instance_of`` the wave ``prepare`` would make of host (numpy)
    SolverInputs, read off their shapes without preparing them."""
    N, R = inp.cap.shape
    return _instance_name(
        np.dtype(inp.cap.dtype).itemsize, N, R, inp.node_ports.shape[1],
        inp.node_pds.shape[1], inp.group_counts.shape[0],
        inp.band_prio.shape[0] if pol.use_resources else 0,
        inp.node_aff_vals.shape[1] if pol.has_affinity else 0,
        len(pol.anti_affinity), gangs, bool(pol.label_prefs), batch,
        count_bytes_for(peer_bound, inp.req.shape[0]))


def solve_commit(ci: CommitInputs):
    """Solve one wave -> (chosen[P], win[P]) int32: chosen node index or -1,
    the winning score, -1, or for a preempting placement
    PREEMPT_SCORE_BASE - its band slot. A CUDA wave launches the kernel (or
    raises); a CPU wave runs the plain version. ``solve_commit.calls``
    counts the calls, on either device."""
    _check(ci)
    # through the module's own reference, which a test's stand-in for
    # ``solve_commit`` does not replace
    _solve_commit.calls += 1
    dev = ci.smask.device
    if dev.type == "cpu":
        return solve_commit_reference(ci)
    if dev.type != "cuda":
        raise ValueError(f"solve_commit runs on cuda or cpu, not {dev}")
    chosen, win = launch_stacked(
        ci, [getattr(ci, n) for n in _KERNEL_PLANES], 1)
    return chosen[0], win[0]


def launch_key(ci: CommitInputs) -> tuple:
    """What a batched launch fixes: waves with equal keys (every shape,
    the resource and peer-count types, the policy flags and weights) run
    as blocks of one launch."""
    return (tuple(ci.smask.shape), _dims(ci), ci.affv.shape[0],
            ci.zone.shape[0], ci.V, ci.flags, ci.w_lr, ci.w_spread,
            ci.w_equal, tuple(ci.w_anti), ci.podrow is None)


def stack_planes(cis):
    """The kernel's input planes (``_KERNEL_PLANES``) of waves that share a
    ``launch_key``, each stacked on a new leading axis: what one batched
    launch reads."""
    return [torch.stack([getattr(ci, n) for ci in cis])
            for n in _KERNEL_PLANES]


def solve_commit_batch(cis):
    """Solve several waves -> [(chosen[P], win[P]) per wave], each what
    ``solve_commit`` gives it alone. On CUDA the waves that share a
    ``launch_key`` run as one launch of the kernel, one block (one SM) per
    wave, and the waves of each key stack their planes on a new leading
    axis; each launch counts once in ``solve_commit.launches``, and a
    launch of two or more waves (the batched instances) in
    ``solve_commit_batch.launches`` too. A key with one wave takes the
    single-wave instance, and a large wave (``is_large``, which has no
    batched instance) launches alone. On the CPU each wave goes through
    ``solve_commit``, the plain version."""
    cis = list(cis)
    for ci in cis:
        _check(ci)
    if not cis:
        return []
    dev = cis[0].smask.device
    for ci in cis:
        if ci.smask.device != dev:
            raise ValueError(f"solve_commit_batch: waves on {dev} and "
                             f"{ci.smask.device}")
    if dev.type == "cpu":
        return [solve_commit(ci) for ci in cis]
    if dev.type != "cuda":
        raise ValueError(f"solve_commit_batch runs on cuda or cpu, not {dev}")
    groups: dict = {}
    for i, ci in enumerate(cis):
        N, _R, _Wp, _Wd, G, _B, _rb, cnt_bytes = _dims(ci)
        # a large wave has no batched instance: a launch each
        key = (launch_key(ci), i) if is_large(N, G, cnt_bytes) \
            else launch_key(ci)
        groups.setdefault(key, []).append(i)
    out: list = [None] * len(cis)
    for idx in groups.values():
        chosen, win = launch_stacked(
            cis[idx[0]], stack_planes([cis[i] for i in idx]), len(idx))
        for j, i in enumerate(idx):
            out[i] = (chosen[j], win[j])
    return out


solve_commit_batch.launches = 0


_solve_commit = solve_commit
solve_commit.launches = 0
solve_commit.calls = 0
# the instances this process has launched (instance_of), a set
solve_commit.instances = set()


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
