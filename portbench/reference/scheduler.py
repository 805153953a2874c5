"""The plain reference of a wave under the default provider, in NumPy.

It works from the plain description the generator hands it (numbers, not
API objects) and imports nothing of the program. Semantics, as the
serial scheduler of this era states them:

- Filters: PodFitsPorts (no host port used twice on a node),
  PodFitsResources (cpu and memory; a zero capacity never constrains; a
  node whose residents already exceed it, walked greedily in list order,
  takes no pod that requests anything; a pod requesting nothing always
  fits), NoDiskConflict, MatchNodeSelector and HostName (the traffic has
  no volumes, selectors or host pins, so they pass everywhere).
- Scores: LeastRequested, ((cap - used) * 10) // cap per dimension over
  every pod on the node plus this one, 0 where the capacity is 0 or
  exceeded, the two summed and halved; ServiceSpreading,
  int(10 * (f32(max - count) / f32(max))) in float32 over the pod's
  service peers per node, 10 everywhere when the pod has no service or
  its service no placed peer. Weights 1 and 1.
- Choice: among the feasible nodes with the top score, in node order, the
  k-th, k = FNV-1a-64(pod key) mod their number.
- Commit: each decision is applied before the next pod is looked at.
- PodGroups: a run of consecutive pods of one group is all or nothing; a
  member that fits nowhere undoes the run's commits and leaves every
  member of the run unplaced.

``commit_block`` and ``spread_dtype`` exist for the controls only: each
block of that many pods decided against the state at the block's start
(a block of the whole wave is a step that leaves the state unchanged),
and the spread expression in bfloat16.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

__all__ = ["Cluster", "Wave", "fnv1a64", "spread_table", "solve"]

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


class Cluster(NamedTuple):
    """The base cluster: nodes in list order and the resident pods."""

    node_names: List[str]
    cap_cpu: np.ndarray      # [N] int64 milli-cpu
    cap_mem: np.ndarray      # [N] int64 bytes
    res_node: np.ndarray     # [E] int64 node index of each resident
    res_cpu: np.ndarray      # [E] int64
    res_mem: np.ndarray      # [E] int64
    res_port: np.ndarray     # [E] int64 host port, 0 = none
    res_service: np.ndarray  # [E] int64 service index, -1 = none
    n_services: int


class Wave(NamedTuple):
    """One burst of pending pods, in the order they are handed over."""

    keys: List[str]          # the tie-break key of each pod (its uid)
    cpu: np.ndarray          # [P] int64 milli-cpu
    mem: np.ndarray          # [P] int64 bytes
    port: np.ndarray         # [P] int64 host port, 0 = none
    service: np.ndarray      # [P] int64 service index, -1 = none
    group: np.ndarray        # [P] int64 PodGroup index, -1 = none


def fnv1a64(key: str) -> int:
    h = _FNV_OFFSET
    for b in key.encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bfloat16, round half to even, as float32."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def spread_table(top: int, dtype: str = "float32") -> np.ndarray:
    """Spread score for each peer count 0..top when the most peers on a
    node is ``top`` (> 0)."""
    c = np.arange(top + 1)
    num = np.float32(top) - c.astype(np.float32)
    if dtype == "bfloat16":
        q = _bf16(_bf16(num) / _bf16(np.float32(top)))
        return np.trunc(_bf16(np.float32(10) * q)).astype(np.int64)
    q = num / np.float32(top)
    return np.trunc(np.float32(10) * q).astype(np.int64)


def _lr(cap: np.ndarray, used: np.ndarray) -> np.ndarray:
    safe = np.where(cap == 0, 1, cap)
    s = ((cap - used) * 10) // safe
    return np.where((cap == 0) | (used > cap), 0, s)


class _Dim:
    """One resource dimension's usage, and for each request value asked so
    far its fit and its LeastRequested score on every node, kept current
    as commits change one node at a time."""

    def __init__(self, cap, fit, use):
        self.cap, self.fit, self.use = cap, fit, use
        self._fits, self._lr = {}, {}

    def fits(self, v: int) -> np.ndarray:
        f = self._fits.get(v)
        if f is None:
            f = self._fits[v] = (self.cap == 0) | (self.cap - self.fit >= v)
        return f

    def lr(self, v: int) -> np.ndarray:
        s = self._lr.get(v)
        if s is None:
            s = self._lr[v] = _lr(self.cap, self.use + v)
        return s

    def commit(self, n: int, v: int) -> None:
        self.fit[n] += v
        self.use[n] += v
        cap, fit, use = int(self.cap[n]), int(self.fit[n]), int(self.use[n])
        for w, f in self._fits.items():
            f[n] = cap == 0 or cap - fit >= w
        for w, s in self._lr.items():
            u = use + w
            s[n] = 0 if cap == 0 or u > cap else (cap - u) * 10 // cap

    def copy(self) -> "_Dim":
        d = _Dim(self.cap, self.fit.copy(), self.use.copy())
        d._fits = {w: f.copy() for w, f in self._fits.items()}
        d._lr = {w: s.copy() for w, s in self._lr.items()}
        return d


class _State:
    """What a commit changes: cpu and memory, ports, peer counts."""

    def __init__(self, cpu: _Dim, mem: _Dim, ports, counts):
        self.cpu, self.mem, self.ports, self.counts = cpu, mem, ports, counts

    def copy(self) -> "_State":
        return _State(self.cpu.copy(), self.mem.copy(), self.ports.copy(),
                      self.counts.copy())


def _initial(cluster: Cluster, port_index: dict) -> Tuple[_State, np.ndarray]:
    N = len(cluster.node_names)
    fit_cpu, fit_mem, exceeded = [0] * N, [0] * N, [False] * N
    cap_cpu, cap_mem = cluster.cap_cpu.tolist(), cluster.cap_mem.tolist()
    # the greedy walk in list order: a resident that does not fit leaves
    # the node exceeded and adds nothing to the fit usage
    for n, c, m in zip(cluster.res_node.tolist(), cluster.res_cpu.tolist(),
                       cluster.res_mem.tolist()):
        ok = ((cap_cpu[n] == 0 or cap_cpu[n] - fit_cpu[n] >= c)
              and (cap_mem[n] == 0 or cap_mem[n] - fit_mem[n] >= m))
        if ok:
            fit_cpu[n] += c
            fit_mem[n] += m
        else:
            exceeded[n] = True
    fit_cpu, fit_mem = np.array(fit_cpu, np.int64), np.array(fit_mem, np.int64)
    exceeded = np.array(exceeded, bool)
    cap_cpu, cap_mem = cluster.cap_cpu, cluster.cap_mem
    use_cpu = np.bincount(cluster.res_node, cluster.res_cpu,
                          minlength=N).astype(np.int64)
    use_mem = np.bincount(cluster.res_node, cluster.res_mem,
                          minlength=N).astype(np.int64)
    ports = np.zeros((max(1, len(port_index)), N), bool)
    for n, p in zip(cluster.res_node.tolist(), cluster.res_port.tolist()):
        if p and p in port_index:
            ports[port_index[p], n] = True
    counts = np.zeros((max(1, cluster.n_services), N), np.int64)
    on = cluster.res_service >= 0
    np.add.at(counts, (cluster.res_service[on], cluster.res_node[on]), 1)
    state = _State(_Dim(cap_cpu, fit_cpu, use_cpu),
                   _Dim(cap_mem, fit_mem, use_mem), ports, counts)
    return state, exceeded


def solve(cluster: Cluster, wave: Wave, commit_block: int = 1,
          spread_dtype: str = "float32") -> Tuple[np.ndarray, int]:
    """-> (node index per pod or -1, feasible pairs): the decisions of the
    serial scheduler over the wave, and the number of (pod, node) pairs
    that passed every filter."""
    N, P = len(cluster.node_names), len(wave.keys)
    port_index = {p: i for i, p in enumerate(sorted(
        {int(p) for p in wave.port.tolist() if p}))}
    state, exceeded = _initial(cluster, port_index)
    open_node = ~exceeded
    tables = {}
    chosen = np.full(P, -1, np.int64)
    feasible_pairs = 0
    group = wave.group
    run_start = 0
    ckpt = None
    failed = False
    seen = state
    for p in range(P):
        g = int(group[p])
        if p == 0 or g < 0 or g != int(group[p - 1]):
            # a new scheduling unit: close the last run, checkpoint
            if failed:
                chosen[run_start:p] = -1
                state = ckpt
            run_start, failed = p, False
            ckpt = state.copy() if g >= 0 else None
        if p % commit_block == 0:
            seen = state if commit_block == 1 else state.copy()
        if failed:
            continue
        c, m = int(wave.cpu[p]), int(wave.mem[p])
        port, svc = int(wave.port[p]), int(wave.service[p])
        if c == 0 and m == 0:
            feasible = np.ones(N, bool)
        else:
            feasible = open_node & seen.cpu.fits(c) & seen.mem.fits(m)
        if port:
            feasible &= ~seen.ports[port_index[port]]
        n_feasible = int(np.count_nonzero(feasible))
        feasible_pairs += n_feasible
        if n_feasible == 0:
            if g >= 0:
                failed = True
            continue
        score = (seen.cpu.lr(c) + seen.mem.lr(m)) // 2
        if svc >= 0:
            row = seen.counts[svc]
            top = int(row.max())
            if top:
                if top not in tables:
                    tables[top] = spread_table(top, spread_dtype)
                score = score + tables[top][row]
            else:
                score = score + 10
        else:
            score = score + 10
        score = np.where(feasible, score, -1)
        best = np.flatnonzero(score == score.max())
        node = int(best[fnv1a64(wave.keys[p]) % len(best)])
        chosen[p] = node
        state.cpu.commit(node, c)
        state.mem.commit(node, m)
        if port:
            state.ports[port_index[port], node] = True
        if svc >= 0:
            state.counts[svc, node] += 1
    if failed:
        chosen[run_start:] = -1
    return chosen, feasible_pairs
