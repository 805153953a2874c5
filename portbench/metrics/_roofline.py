"""The least time one wave's commit_solve launch could take on the card,
from the work the wave needs: the larger of its bytes (each input read
once, each output written once) over the HBM rate, and its operations
over the non-tensor rate.

Operations, counted as the serial scheduler states them, not as the
kernel computes them: every (pod, node) pair runs the filter (1 + 3R +
2Wp + 2Wd); every feasible pair is scored: LeastRequested 6 per dimension
plus the divisor and the weight (6R + 2), ServiceSpreading's float32
expression (8), 9 per anti-affinity label, 2L affinity compares, one add
each for a label-preference plane and EqualPriority, and the running max
(2). Every pair the preemption branch examines adds 2BR.

The shapes are the kernel's planes as the port lays them out for the
wave, worked out here from the benchmark's own description of it: R
resource rows in the wave's resource type (int32 when every gcd-scaled
running sum stays below 2^31 / 10, else int64), port and PD sets in
32-bit words over vocabularies padded to a power of two (at least 8), the
service groups padded likewise.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np

__all__ = ["HBM_BYTES_PER_S", "OPS_PER_S", "Dims", "bound", "dims"]

# NVIDIA H100 SXM data sheet, at its 700 W power limit
HBM_BYTES_PER_S = 3.35e12
# assumed: the data sheet's float32 rate outside the tensor cores, applied
# to the kernel's integer operations (the data sheet gives no integer rate)
OPS_PER_S = 67e12
_I32_HEADROOM = (2**31 - 1) // 10


class Dims(NamedTuple):
    P: int
    N: int
    R: int = 2
    Wp: int = 1
    Wd: int = 1
    G: int = 8
    L: int = 0
    A: int = 0
    B: int = 0
    res_bytes: int = 4
    label_prefs: bool = False
    w_lr: int = 1
    w_spread: int = 1
    w_equal: int = 0


def _pow2(n: int, minimum: int = 8) -> int:
    out = minimum
    while out < n:
        out *= 2
    return out


def _words(k: int) -> int:
    return max(1, -(-k // 32))


def dims(cluster, wave) -> Dims:
    """The kernel's shapes for a default-provider wave of ``wave``'s pods
    on ``cluster`` (portbench.reference.scheduler's Cluster and Wave)."""
    N, P = len(cluster.node_names), len(wave.keys)
    ports = len({int(p) for p in wave.port.tolist() if p})
    groups = len({int(s) for s in wave.service.tolist() if s >= 0})
    res_bytes = 4
    for cap, res, req in ((cluster.cap_cpu, cluster.res_cpu, wave.cpu),
                          (cluster.cap_mem, cluster.res_mem, wave.mem)):
        on = np.bincount(cluster.res_node, res, minlength=N).astype(np.int64)
        vals = np.concatenate([cap, on, req])
        vals = vals[vals != 0]
        g = int(np.gcd.reduce(vals)) if vals.size else 1
        total = int(req.sum())
        top = max(int(cap.max(initial=0)) + total,
                  int(on.max(initial=0)) + total) // g
        if top > _I32_HEADROOM:
            res_bytes = 8
    return Dims(P=P, N=N, Wp=_words(_pow2(ports)), Wd=_words(_pow2(0)),
                G=_pow2(max(1, groups)), res_bytes=res_bytes)


def bound(d: Dims, feasible_pairs: int,
          preempt_pairs: int = 0) -> Tuple[float, str, int, int]:
    """-> (least milliseconds, "bytes" or "operations", bytes, ops)."""
    P, N, R, G, L, A, B = d.P, d.N, d.R, d.G, d.L, d.A, d.B
    rb = d.res_bytes
    mw = math.ceil(G / 32) if G > 32 else 1
    row_words = R * rb // 4 + d.Wp + d.Wd + 6 + mw + L
    nbytes = (P * N                                   # static mask
              + P * row_words * 4                     # pod rows
              + 3 * R * N * rb                        # cap, fit, score
              + R * N + N                             # advertised, exceeded
              + (d.Wp + d.Wd) * N * 4                 # port and PD words
              + G * N * 4 + G * 4                     # peers, off-list
              + (N * 4 if d.label_prefs else 0)       # label plane
              + L * N * 4 + G * L * 4 + G             # affinity
              + A * N * 4                             # zones
              + B * R * N * rb + B * N * 4 + B * 4    # preemption
              + 2 * P * 4)                            # chosen, score
    per_feasible = ((6 * R + 2 if d.w_lr else 0) + (8 if d.w_spread else 0)
                    + 9 * A + 2 * L + (1 if d.label_prefs else 0)
                    + (1 if d.w_equal else 0) + 2)
    ops = (P * N * (1 + 3 * R + 2 * d.Wp + 2 * d.Wd)
           + feasible_pairs * per_feasible + preempt_pairs * 2 * B * R)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / OPS_PER_S * 1e3
    if ops_ms > bytes_ms:
        return ops_ms, "operations", nbytes, ops
    return bytes_ms, "bytes", nbytes, ops
