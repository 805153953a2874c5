"""Active sub-meshing — per-wave node-axis compaction for the plain scan.

Port of ``kubernetes_tpu/models/submesh.py``. The sequential-commit loop
does O(N) vector work per pod step. Late-churn waves see a cluster where
most nodes are full: a node that cannot place ANY pod of the wave
contributes nothing to the answer, only to the per-step arithmetic. This
module drops those nodes before the loop and maps the decisions back,
bit-identically. Its caller is the solver daemon's mesh executor
(solver/mesh_exec.py), on its single-device layout.

**The keep rule.** A node survives compaction iff any of:

- ``pinned``: some pod's ``pod_host_idx`` names it;
- ``peers``: any group holds a committed peer on it (its counts feed the
  spread max and the anti-affinity zone sums every step);
- ``possible``: it is statically allowed (``node_extra_ok``), not
  pre-exceeded (``fit_exceeded``), and its MAXIMUM achievable headroom
  fits the wave's componentwise-minimum request:
  ``headmax = cap - fit_used + sum_{b reachable} evict_cap[:, b, :]``
  (a band is reachable when its priority sits strictly below some real
  pod's) and ``all_r (unconstrained[n, r] or headmax[n, r] >= minreq[r])``
  with ``minreq`` the per-dimension min over REAL pods (padding rows,
  ``pod_host_idx == -2``, excluded).

**Why dropped nodes are decision-invisible.** During the loop
``fit_used[n]`` falls below its initial value only by preemption commits,
which free at most the node's evictable capacity in reachable bands, so
per-step headroom never exceeds ``headmax``: a dropped node fails the
resource filter for every pod at every step, on the normal and the
preemption branch. Infeasible nodes influence nothing global: they are
masked out of the tie-break's top and count, out of the LeastRequested
divisor, and, holding no peers, add nothing to the spread max or the zone
sums. Compaction preserves node order, so ``select_kth_true`` picks the
same surviving node for the same ``k``.

Two shapes invalidate the rule and force the full solve: a REAL pod
requesting zero of everything, and a policy without the resource
predicate. Both return ``keep=None``; so does a policy without the
HostName predicate when the wave has padding rows (only that predicate
keeps a padding row from placing).

**Residency-preserving gather.** The executor's device-resident planes
stay [N]-shaped; compaction is a gather on their device
(``compact_inputs``) driven by a small host-computed ``keep_idx [Ncb]
int32`` + ``valid [Ncb] bool`` pair. ``Ncb`` is the kept count padded to
a two-buckets-per-octave size (``padded_size``); pad rows gather node 0
but are forced infeasible and zeroed out of every global aggregate.
Engagement requires the padded size to clear the ``KEEP_ENGAGE`` fraction
of N. The buckets are the reference's compile buckets; here they only
keep the reference's engagement rule.

``KTPU_SUBMESH``: ``auto`` (default), ``off`` (never compact), ``force``
(compact whenever any node is droppable; tests and A/B runs).

``zone_bf16`` is the reference's TPU matmul precision choice for the zone
planes, gated by ``zone_bf16_ok``'s proof that bf16 equals exact
integers there. The port's zone sums are exact integers already: the flag
is accepted and the sums stay exact either way.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from kubernetes_tpu_torch.models.batch_solver import SolverInputs, solve_scan

__all__ = ["keep_mask", "padded_size", "plan_wave", "compact_inputs",
           "submesh_program", "remap_pod_host_idx", "SubmeshPlan",
           "KEEP_ENGAGE", "submesh_mode", "zone_bf16_ok"]

# A compaction must shrink the padded node axis below this fraction of
# the resident N to engage.
KEEP_ENGAGE = 0.75


def submesh_mode() -> str:
    mode = os.environ.get("KTPU_SUBMESH", "auto").strip().lower()
    if mode not in ("auto", "off", "force"):
        raise ValueError(
            f"KTPU_SUBMESH={mode!r}: expected auto|off|force")
    return mode


def keep_mask(inp: SolverInputs, pol=None) -> Optional[np.ndarray]:
    """bool [N] keep mask of host (numpy) inputs, or None when the rule
    cannot apply (zero-req real pod, resource predicate disabled, or no
    real pods). O(N*R + P*R)."""
    if pol is not None and not pol.use_resources:
        return None  # feasibility never consults resources: rule invalid
    ph = np.asarray(inp.pod_host_idx)
    real = ph != -2
    if pol is not None and not pol.use_host and not real.all():
        # pod-axis padding rows are "never feasible" only through the
        # HostName predicate (pinned to host -2)
        return None
    if not real.any():
        return None
    req = np.asarray(inp.req)
    rreq = req[real]
    if (rreq == 0).all(axis=1).any():
        # a zero-request pod fits every non-exceeded allowed node
        return None
    minreq = rreq.min(axis=0)                                 # [R]
    cap = np.asarray(inp.cap)
    N, R = cap.shape
    headmax = cap - np.asarray(inp.fit_used)
    evict_cap = np.asarray(inp.evict_cap)
    if evict_cap.size:
        # only bands strictly below SOME pod's priority can ever evict;
        # the max real priority bounds every pod's reach, and BAND_EMPTY
        # slots sit above every legal priority
        maxprio = np.asarray(inp.pod_prio)[real].max()
        reachable = np.asarray(inp.band_prio) < maxprio       # [B]
        headmax = headmax + (evict_cap
                             * reachable[None, :, None]).sum(axis=1)
    unconstrained = (cap == 0) & (np.arange(R) < 2)[None, :]
    res_ok = (unconstrained | (headmax >= minreq[None, :])).all(axis=1)
    possible = (np.asarray(inp.node_extra_ok)
                & ~np.asarray(inp.fit_exceeded) & res_ok)
    pinned = np.zeros(N, bool)
    targets = ph[real]
    targets = targets[(targets >= 0) & (targets < N)]
    pinned[targets] = True
    peers = np.asarray(inp.group_counts)[:, :N].any(axis=0)
    return possible | pinned | peers


def padded_size(nc: int) -> int:
    """Two size buckets per octave (2^k and 3*2^(k-1)), floored at 256."""
    if nc <= 256:
        return 256
    k = (nc - 1).bit_length()
    p15 = 3 << (k - 2)
    return p15 if p15 >= nc else 1 << k


class SubmeshPlan:
    """One wave's compaction decision: the padded keep indices + valid
    mask, and the inverse map for pod pins."""

    __slots__ = ("keep_idx", "valid", "inv", "n_kept", "n_total")

    def __init__(self, keep_idx: np.ndarray, valid: np.ndarray,
                 inv: np.ndarray, n_kept: int, n_total: int):
        self.keep_idx = keep_idx   # [Ncb] i32 original node indices
        self.valid = valid         # [Ncb] bool (False = pad row)
        self.inv = inv             # [N] i32 original -> compact (-1 gone)
        self.n_kept = n_kept
        self.n_total = n_total


def plan_wave(inp: SolverInputs, pol=None,
              mode: Optional[str] = None) -> Optional[SubmeshPlan]:
    """Decide compaction for one wave -> SubmeshPlan, or None for the
    full solve."""
    mode = submesh_mode() if mode is None else mode
    if mode == "off":
        return None
    keep = keep_mask(inp, pol)
    if keep is None:
        return None
    n = keep.shape[0]
    nc = int(keep.sum())
    if nc == n:
        return None
    ncb = padded_size(nc)
    if ncb >= n or (mode != "force" and ncb > KEEP_ENGAGE * n):
        return None
    kept = np.flatnonzero(keep).astype(np.int32)              # sorted
    keep_idx = np.zeros(ncb, np.int32)
    keep_idx[:nc] = kept
    valid = np.zeros(ncb, bool)
    valid[:nc] = True
    inv = np.full(n, -1, np.int32)
    inv[kept] = np.arange(nc, dtype=np.int32)
    return SubmeshPlan(keep_idx, valid, inv, nc, n)


def remap_pod_host_idx(pod_host_idx: np.ndarray,
                       plan: SubmeshPlan) -> np.ndarray:
    """Pod host pins in original node indices -> compact indices.
    Sentinels (-1 unpinned, -2 padding) pass through; pinned nodes are
    kept by construction, so the map never loses a pin."""
    ph = np.asarray(pod_host_idx)
    out = np.where(ph >= 0, plan.inv[np.maximum(ph, 0)], ph)
    return out.astype(ph.dtype)


def compact_inputs(inp: SolverInputs, keep_idx: torch.Tensor,
                   valid: torch.Tensor) -> SolverInputs:
    """Gather the node-axis planes (tensors on one device) down to the
    compact axis, on that device. Pad rows (valid False) duplicate node
    0's planes but are forced infeasible and zeroed out of every globally
    aggregated plane (group counts, zone labels, advertised dims);
    ``pod_host_idx`` arrives already remapped (``remap_pod_host_idx``)."""
    keep = keep_idx.to(torch.int64)

    def g(a):
        return a.index_select(0, keep)

    gc = inp.group_counts[:, :-1].index_select(1, keep)
    gc = torch.where(valid[None, :], gc, 0)
    # the off-list slot stays the LAST column at the compact width
    gc = torch.cat([gc, inp.group_counts[:, -1:]], dim=1)
    zi = inp.zone_idx.index_select(1, keep)
    zi = torch.where(valid[None, :], zi, -1)
    return inp._replace(
        cap=g(inp.cap),
        advertises=g(inp.advertises) & valid[:, None],
        fit_used=g(inp.fit_used),
        fit_exceeded=g(inp.fit_exceeded) | ~valid,
        score_used=g(inp.score_used),
        node_ports=g(inp.node_ports),
        node_sel=g(inp.node_sel),
        node_pds=g(inp.node_pds),
        node_extra_ok=g(inp.node_extra_ok) & valid,
        group_counts=gc,
        score_static=g(inp.score_static),
        node_aff_vals=g(inp.node_aff_vals),
        zone_idx=zi,
        evict_cap=g(inp.evict_cap),
        evict_cnt=g(inp.evict_cnt),
    )


def submesh_program(pol, gangs: bool, zone_bf16: bool = False):
    """The gather-compact-solve-remap program: ``fn(resident, wave,
    keep_idx, valid) -> (chosen, scores)``, int32 [P] tensors on the
    resident planes' device, with decisions mapped back to ORIGINAL node
    indices so callers (and the parity probes) compare directly against
    the full-plane answer. ``resident`` and ``wave`` are tuples in
    parallel.mesh.RESIDENT_FIELDS / WAVE_FIELDS order (one device's
    planes, or host arrays to ship there). ``zone_bf16`` is accepted for
    the reference's signature; the zone sums are exact either way."""
    from kubernetes_tpu_torch.parallel.mesh import (RESIDENT_FIELDS,
                                                    WAVE_FIELDS, as_tensor)

    def run(resident, wave, keep_idx, valid):
        dev = resident[0].device
        kw = {f: as_tensor(a).to(dev)
              for f, a in zip(RESIDENT_FIELDS + WAVE_FIELDS,
                              tuple(resident) + tuple(wave))}
        keep = as_tensor(np.asarray(keep_idx, np.int32)).to(dev)
        comp = compact_inputs(SolverInputs(**kw), keep,
                              as_tensor(np.asarray(valid, bool)).to(dev))
        chosen, scores = solve_scan(comp, pol, gangs)
        chosen = torch.where(
            chosen >= 0,
            keep.index_select(0, chosen.clamp_min(0).to(torch.int64)),
            chosen)
        return chosen, scores

    return run


def zone_bf16_ok(inp: SolverInputs, pol) -> bool:
    """The reference's gate for its reduced-precision (bf16) zone planes:
    every value the zone contraction sums is an integer peer count bounded
    by the initial per-group peer total plus the wave's pod count, and
    integers through 256 are exact in bf16. The port sums zones exactly
    in any case; the gate is kept for the executor's accounting."""
    if pol is None or not getattr(pol, "anti_affinity", ()):
        return False
    gc = np.asarray(inp.group_counts)
    bound = int(gc.sum(axis=1).max()) if gc.size else 0
    return bound + int(inp.req.shape[0]) <= 256
