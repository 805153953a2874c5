"""The sequential-commit loop over node shards.

The explicit counterpart of what the reference's SPMD partitioner inserts
into ``solve_jit`` when its node planes shard over a mesh
(kubernetes_tpu/parallel/mesh.py:262-328). It follows the plain loop,
``ops/commit_solver.solve_commit_reference``, step by step, over
per-shard node planes: each shard is the wave restricted to a contiguous
slice of the node axis, prepared by ``commit_solver.prepare`` on its own
device (its static mask, its slice of every node plane), and every pod
step runs on all shards. What the plain loop computes over the whole node
axis becomes a reduction across shards of small tensors, gathered onto
the first shard's device (the primary), reduced, and sent back:

- the LeastRequested divisor ``2 + any(adv_extra & feasible)``: an OR of
  the shards' [R] rows;
- the spread maximum with the off-list peers, and the anti-affinity peer
  total and per-zone sums: a max or a sum of the shards' values (the
  off-list count is the replicated last column of each shard's
  ``group_counts``);
- the tie-break (``masked_top_count`` then ``select_kth_true``): the
  global top and the count of nodes at it; then each shard's count of
  best nodes, an exclusive prefix in shard order, and the owner of the
  k-th best picks it locally, so the pick is the k-th best node in global
  node order;
- the same pair for the preemption mask;
- the values read at the chosen node (its anchor label values, its band
  threshold and freed capacity) come from the owning shard; only the
  owner commits into its node state.

Host pins are global node indices: each shard reads a pin inside its
slice as a local index and any other pin as a node it does not hold.
Group state (service-affinity anchors) and the gang's ``failed`` flag are
replicated on the primary; the gang checkpoint and rollback happen on
every shard at the same pod. Nothing inside the pod loop reads a value
back to the host (no ``.item()``), as in the plain loop. The shards may
sit on one device (a virtual mesh) or on several; the loop is the same.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from kubernetes_tpu_torch.models.policy import BatchPolicy
from kubernetes_tpu_torch.models.preempt import PREEMPT_SCORE_BASE
from kubernetes_tpu_torch.ops import commit_solver
from kubernetes_tpu_torch.ops.commit_solver import (
    NEG,
    PREEMPT_BIG,
    _GANGS,
    _USE_DISK,
    _USE_PORTS,
    _USE_RESOURCES,
    _USE_STATIC,
    CommitInputs,
)
from kubernetes_tpu_torch.ops.kernels import (
    calculate_score,
    select_kth_true,
    spread_score,
    u64_mod_small,
)

__all__ = ["prepare_shards", "solve_shards", "sharded_commit"]


def _local_pins(pod_host_idx: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """Global host pins -> this shard's: a pin inside [lo, lo + n) becomes
    its local index, a pin elsewhere -2 (matches none of this shard's
    nodes); -1 (no pin) and -2 (a padding row) pass through."""
    ph = pod_host_idx.to(torch.int64)
    mine = (ph >= lo) & (ph < lo + n)
    out = torch.where(mine, ph - lo, torch.where(ph == -1, ph, -2))
    return out.to(pod_host_idx.dtype)


def prepare_shards(shards, pol: BatchPolicy, gangs: bool
                   ) -> Tuple[List[CommitInputs], List[int]]:
    """Per-shard SolverInputs (each the wave's pod planes and a contiguous
    slice of its node planes, its ``group_counts`` with the off-list
    column last, in global node order) -> (per-shard CommitInputs, each
    on its shard's device; each shard's global node offset)."""
    cis, offsets, lo = [], [], 0
    for inp in shards:
        n = int(inp.cap.shape[0])
        local = inp._replace(pod_host_idx=_local_pins(inp.pod_host_idx,
                                                      lo, n))
        cis.append(commit_solver.prepare(local, pol, gangs))
        offsets.append(lo)
        lo += n
    return cis, offsets


def solve_shards(shards, pol=None, gangs: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve one wave held as node shards (see ``prepare_shards``) ->
    (chosen[P], win[P]) int32 on the first shard's device, chosen in
    global node indices: what ``batch_solver.solve_scan`` gives the whole
    wave on one device."""
    pol = pol or BatchPolicy()
    if pol.all_infeasible:
        P = shards[0].req.shape[0]
        full = torch.full((P,), NEG, dtype=torch.int32,
                          device=shards[0].req.device)
        return full, full.clone()
    cis, offsets = prepare_shards(shards, pol, gangs)
    return sharded_commit(cis, offsets)


def _gather(xs, dev) -> torch.Tensor:
    """Stack one small tensor per shard on ``dev`` (shard order)."""
    return torch.stack([x.to(dev) for x in xs])


def sharded_commit(cis: Sequence[CommitInputs], offsets: Sequence[int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The commit loop over prepared shards (``prepare_shards``) ->
    (chosen[P], win[P]) int32 on the first shard's device, bit-identical
    to ``solve_commit_reference`` of the unsharded wave.
    ``sharded_commit.calls`` counts its calls."""
    sharded_commit.calls += 1
    S = len(cis)
    c0 = cis[0]
    d0 = c0.cap.device
    devs = [ci.cap.device for ci in cis]
    P = c0.smask.shape[0]
    R = c0.cap.shape[0]
    sizes = [ci.cap.shape[1] for ci in cis]
    L, A = c0.affv.shape[0], c0.zone.shape[0]
    B = c0.band.shape[0]
    rdt = c0.cap.dtype
    i32, i64 = torch.int32, torch.int64
    gangs = bool(c0.flags & _GANGS)
    flags = c0.flags
    chosen = torch.full((P,), NEG, dtype=i32, device=d0)
    win = torch.full((P,), NEG, dtype=i32, device=d0)
    if sum(sizes) == 0:
        return chosen, win
    if min(sizes) == 0:
        raise ValueError(f"sharded_commit: an empty shard ({sizes})")
    # per-shard mutable state, in the order the gang checkpoint copies it
    state = [[ci.fit0.clone(), ci.score0.clone(), ci.ports0.clone(),
              ci.pds0.clone(), ci.counts0.clone(), ci.ecap0.clone(),
              ci.ecnt0.clone()] for ci in cis]
    # replicated group state, on the primary
    anchor, has_anchor = c0.anchor0.clone(), c0.has0 != 0
    consts = []
    for ci, dev in zip(cis, devs):
        dims = torch.arange(R, device=dev)[:, None]
        consts.append(dict(
            unconstrained=(ci.cap == 0) & (dims < 2),
            adv_extra=(ci.advx != 0) & (dims >= 2),
            fitexc=ci.fitexc != 0,
            labeled=ci.zone >= 0,
            safe_zone=ci.zone.clamp_min(0).to(i64),
            ten=torch.full((ci.cap.shape[1],), 10, dtype=i32, device=dev)))
    offs = torch.tensor(offsets, dtype=i64, device=d0)
    ends = offs + torch.tensor(sizes, dtype=i64, device=d0)
    neg = torch.tensor(NEG, dtype=i32, device=d0)
    if B:
        leq_all = [ci.band[:, None] <= ci.band[None, :] for ci in cis]
        band_max = [torch.full((B, n), 2**31 - 1, dtype=i32, device=dev)
                    for n, dev in zip(sizes, devs)]
    starts = c0.start.tolist() if gangs else []
    failed = torch.zeros((), dtype=torch.bool, device=d0)
    ckpt = None

    def tie_break(masked, feasible, p):
        """The global masked_top_count + select_kth_true over the shards'
        masked rows -> (top, any, pick int32 global)."""
        top = _gather([m.max() for m in masked], d0).max()
        any_f = top > NEG
        tops = [top.to(dev) for dev in devs]
        best = [m == t for m, t in zip(masked, tops)]
        cnt = _gather([b.sum(dtype=i64) for b in best], d0).sum(
            ).clamp_min(1)
        best = [b & f for b, f in zip(best, feasible)]
        k = u64_mod_small(c0.tie_hi[p], c0.tie_lo[p], cnt)
        # the k-th best in global node order: the owner is the shard whose
        # exclusive prefix of best-node counts brackets k
        counts = _gather([b.sum(dtype=i64) for b in best], d0)
        prefix = torch.cumsum(counts, 0) - counts
        local = _gather([select_kth_true(b, (k - prefix[s]).to(devs[s]))
                         for s, b in enumerate(best)], d0).to(i64)
        owned = (prefix <= k) & (k < prefix + counts)
        owner = owned.to(i32).argmax().view(1)
        pick = (offs + local).index_select(0, owner)[0].to(i32)
        return top, any_f, pick

    def at_owner(values, own):
        """The owning shard's value of a per-shard tensor (one per shard,
        equal shapes) -> on the primary."""
        return _gather(values, d0).index_select(0, own)[0]

    for p in range(P):
        if gangs and starts[p]:
            # a new scheduling unit: checkpoint the committed state
            ckpt = ([[t.clone() for t in st] for st in state],
                    anchor.clone(), has_anchor.clone())
            failed = torch.zeros_like(failed)
        g = c0.gid[p]
        safe_g = g.clamp_min(0)
        in_group = g >= 0
        if L:
            arow = anchor[safe_g]                               # [L]
            anchored = in_group & has_anchor[safe_g]
        feasible, feasible_nores = [], []
        for s, ci in enumerate(cis):
            fit, _su, ports, pds = state[s][:4]
            dev = devs[s]
            f = ci.smask[p, :sizes[s]] != 0
            if gangs:
                f = f & ~failed.to(dev)
            if flags & _USE_PORTS:
                f = f & ~((ports & ci.pod_ports[p][:, None]) != 0).any(dim=0)
            if flags & _USE_DISK:
                f = f & ~((pds & ci.pod_pds[p][:, None]) != 0).any(dim=0)
            if L:
                arow_s = arow.to(dev)
                need = (ci.pins[p] == -2) & (arow_s >= 0)
                dyn = (~need[:, None] | (ci.affv == arow_s[:, None])
                       ).all(dim=0)
                f = f & (~anchored.to(dev) | dyn)
            feasible_nores.append(f)
            if flags & _USE_RESOURCES:
                cs = consts[s]
                res_ok = (cs["unconstrained"]
                          | (ci.cap - fit >= ci.req[p][:, None])).all(0)
                f = f & (ci.zreq[p] | (~cs["fitexc"] & res_ok))
            feasible.append(f)
        score = [torch.zeros(n, dtype=i32, device=dev)
                 for n, dev in zip(sizes, devs)]
        if c0.w_lr:
            adv = _gather([(consts[s]["adv_extra"] & feasible[s][None, :]
                            ).any(dim=1) for s in range(S)], d0)
            n_dyn = 2 + adv.any(dim=0).sum()
            for s, ci in enumerate(cis):
                raw = calculate_score(state[s][1] + ci.req[p][:, None],
                                      ci.cap).sum(0)
                lr = torch.div(raw, n_dyn.to(devs[s]), rounding_mode="floor")
                score[s] = score[s] + (lr * ci.w_lr).to(i32)
        if c0.w_spread:
            rows = [state[s][4][safe_g.to(devs[s])] for s in range(S)]
            max_count = torch.maximum(
                _gather([r.max() for r in rows], d0).max(), c0.offl[safe_g])
            for s in range(S):
                dev = devs[s]
                spread = torch.where(in_group.to(dev),
                                     spread_score(max_count.to(dev), rows[s]),
                                     consts[s]["ten"])
                score[s] = score[s] + spread * c0.w_spread
        if A:
            # ServiceAntiAffinity: the peer total counts every peer (the
            # off-list ones too); the per-zone sums only feasible nodes'
            rows = [state[s][4][safe_g.to(devs[s])] * in_group.to(devs[s])
                    for s in range(S)]
            num = (_gather([r.sum() for r in rows], d0).sum()
                   + c0.offl[safe_g] * in_group)
            on = [r * f for r, f in zip(rows, feasible)]
            for a in range(A):
                parts = []
                for s in range(S):
                    cs = consts[s]
                    pz = torch.zeros(c0.V, dtype=i32, device=devs[s])
                    pz.index_add_(0, cs["safe_zone"][a],
                                  on[s] * cs["labeled"][a])
                    parts.append(pz)
                per_zone = _gather(parts, d0).sum(0, dtype=i32)
                for s in range(S):
                    cs = consts[s]
                    dev = devs[s]
                    sc = spread_score(num.to(dev),
                                      per_zone.to(dev)[cs["safe_zone"][a]])
                    score[s] = score[s] + sc * cs["labeled"][a] * c0.w_anti[a]
        for s, ci in enumerate(cis):
            if flags & _USE_STATIC:
                score[s] = score[s] + ci.sstat
            if c0.w_equal:
                score[s] = score[s] + c0.w_equal
        masked = [torch.where(f, sc, torch.full_like(sc, NEG))
                  for f, sc in zip(feasible, score)]
        top, any_f, pick = tie_break(masked, feasible, p)
        pick = torch.where(any_f, pick, neg)
        won = torch.where(any_f, top, neg)
        freed_sel = torch.zeros(R, dtype=rdt, device=d0)
        if B:
            # ---- preemption: per node the lowest sufficient band prefix;
            # across nodes the fewest victims --------------------------------
            below0 = c0.band < c0.prio[p]
            leq0 = leq_all[0] & below0[:, None]
            freed, bidx, pmask, masked_p = [], [], [], []
            for s, ci in enumerate(cis):
                cs = consts[s]
                below = ci.band < ci.prio[p]
                leq = leq_all[s] & below[:, None]
                ecap, ecnt = state[s][5], state[s][6]
                fr = (ecap[:, None] * leq[:, :, None, None].to(rdt)
                      ).sum(0, dtype=rdt)                      # [B, R, n]
                ccost = (ecnt[:, None] * leq[:, :, None].to(i32)
                         ).sum(0, dtype=i32)                   # [B, n]
                head = (ci.cap - state[s][0])[None] + fr
                fits = (cs["unconstrained"][None]
                        | (head >= ci.req[p][None, :, None])).all(1)
                fits = (fits & below[:, None] & feasible_nores[s][None]
                        & ~cs["fitexc"][None])
                bi = torch.argmin(torch.where(fits, ci.band[:, None],
                                              band_max[s]), dim=0)
                cost = ccost.gather(0, bi[None])[0]
                pm = fits.any(0) & ci.canp[p]
                freed.append(fr)
                bidx.append(bi)
                pmask.append(pm)
                masked_p.append(torch.where(pm, PREEMPT_BIG - cost,
                                            torch.full_like(cost, NEG)))
            _ptop, p_any, pchosen = tie_break(masked_p, pmask, p)
            did = ~any_f & p_any
            pick = torch.where(did, pchosen, pick)
        # the chosen node's owner (an unplaced pod reads node 0, as the
        # plain loop's clamp does) and its local index on each shard
        at = pick.clamp_min(0).to(i64)
        own = ((at >= offs) & (at < ends)).to(i32).argmax().view(1)
        local_at = [(at - offsets[s]).clamp(0, sizes[s] - 1).to(devs[s]
                                                                 ).view(1)
                    for s in range(S)]
        placed = pick >= 0
        if B:
            bsel = at_owner([bidx[s].index_select(0, local_at[s])[0]
                             for s in range(S)], own)
            won = torch.where(did, PREEMPT_SCORE_BASE - bsel.to(i32), won)
            evicted = leq0[:, bsel] & did                       # [B]
            fsel = at_owner([freed[s].index_select(2, local_at[s])
                             .index_select(0, bsel.to(devs[s]).view(1))[0, :, 0]
                             for s in range(S)], own)
            freed_sel = torch.where(did, fsel, freed_sel)
        chosen[p] = pick
        win[p] = won
        if L:
            # every group this commit gives its first peer is anchored at
            # the chosen node's values
            affv_at = at_owner([cis[s].affv.index_select(1, local_at[s])[:, 0]
                                for s in range(S)], own)
            newly = c0.member[p] & ~has_anchor & placed
            anchor = torch.where(newly[:, None], affv_at[None, :], anchor)
            has_anchor = has_anchor | newly
        # commit the chosen row on its owner only
        for s, ci in enumerate(cis):
            dev = devs[s]
            mine = placed.to(dev) & (own.to(dev)[0] == s)
            la = local_at[s]
            on = mine.to(i32)
            fit, score_used, ports, pds, counts, ecap, ecnt = state[s]
            delta = ((ci.req[p] - freed_sel.to(dev)) * mine.to(rdt))[:, None]
            fit.index_add_(1, la, delta)
            score_used.index_add_(1, la, delta)
            ports.index_copy_(1, la, ports.index_select(1, la)
                              | (ci.pod_ports[p] * on)[:, None])
            pds.index_copy_(1, la, pds.index_select(1, la)
                            | (ci.pod_pds[p] * on)[:, None])
            counts.index_add_(1, la, (ci.member[p].to(i32) * on)[:, None])
            if B:
                ev = evicted.to(dev) & mine
                ecap.index_copy_(2, la, torch.where(
                    ev[:, None, None], torch.zeros((), dtype=rdt, device=dev),
                    ecap.index_select(2, la)))
                ecnt.index_copy_(1, la, torch.where(
                    ev[:, None], torch.zeros((), dtype=i32, device=dev),
                    ecnt.index_select(1, la)))
        if gangs:
            # a failed member pins the state at the run's checkpoint (no
            # unit has started before the first start: nothing to restore)
            failed = failed | ~placed
            if ckpt is None:
                continue
            cstate, canchor, chas = ckpt
            for s in range(S):
                fs = failed.to(devs[s])
                state[s] = [torch.where(fs, c, t)
                            for c, t in zip(cstate[s], state[s])]
            anchor = torch.where(failed, canchor, anchor)
            has_anchor = torch.where(failed, chas, has_anchor)
    return chosen, win


sharded_commit.calls = 0
