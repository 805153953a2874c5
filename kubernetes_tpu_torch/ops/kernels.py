"""Scoring and selection primitives of the sequential-commit solve.

Torch port of ``kubernetes_tpu/ops/kernels.py``; each function cites the
serial semantics it reproduces. They are the plain versions the wave's
plain solve (ops/commit_solver.solve_commit_reference) is built from, and
the CUDA kernel's device code repeats the same integer arithmetic.

Integer division here is torch floor division on non-negative numerators,
so it equals both Python's ``//`` and C's truncating ``/``.
"""

from __future__ import annotations

import torch

__all__ = ["calculate_score", "spread_score", "u64_mod_small",
           "select_kth_true", "masked_top_count"]


def calculate_score(requested: torch.Tensor,
                    capacity: torch.Tensor) -> torch.Tensor:
    """LeastRequested per-dimension score: ((cap-req)*10)//cap, 0 on zero
    or exceeded capacity (ref: pkg/scheduler/priorities.go:27-37)."""
    safe_cap = torch.where(capacity == 0, torch.ones_like(capacity), capacity)
    # the numerator is >= 0 wherever the result is kept
    score = torch.div((capacity - requested).clamp_min(0) * 10, safe_cap,
                      rounding_mode="floor")
    return torch.where((capacity == 0) | (requested > capacity),
                       torch.zeros_like(score), score)


def spread_score(total: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """ServiceSpreading score ``int(10 * (f32(total-count) / f32(total)))``
    with IEEE round-to-nearest-even at every float32 step (ref:
    spreading.go:76-80), in exact int64 arithmetic — never float
    division, which may be computed as a reciprocal multiply and misround
    (154/154 giving 0.99999994 truncates a score of 10 to 9). The two
    roundings are emulated: q = RN24(a/b) by shift-and-divide with
    round-half-even, y = RN24(10*q), then truncation.
    Domain: 0 <= count <= total < 2^24. Returns int32."""
    a = (total - counts).clamp_min(0).to(torch.int64)
    b = torch.as_tensor(total, dtype=torch.int64,
                        device=a.device).expand_as(a)
    safe_b = b.clamp_min(1)
    # exponents of f32(a), f32(b): frexp is exact for values < 2^24
    ea = torch.frexp(a.to(torch.float32))[1].to(torch.int64)
    eb = torch.frexp(safe_b.to(torch.float32))[1].to(torch.int64)
    # k so that m = (a << k) // b lands in [2^23, 2^24): a <= b gives
    # k >= 23, and a < 2^ea bounds a << k0 below 2^47
    k0 = 23 + (eb - ea)
    m0 = torch.div(a << k0, safe_b, rounding_mode="floor")
    k = k0 + (m0 < 2**23).to(torch.int64) - (m0 >= 2**24).to(torch.int64)
    q_num = a << k
    m1 = torch.div(q_num, safe_b, rounding_mode="floor")
    r = q_num - m1 * safe_b
    # round to nearest, ties to even mantissa
    m = m1 + ((2 * r > safe_b) | ((2 * r == safe_b) & (m1 & 1 == 1))
              ).to(torch.int64)
    roll = m == 2**24
    m = torch.where(roll, torch.full_like(m, 2**23), m)
    k = k - roll.to(torch.int64)
    # q = m * 2^-k is RN_f32(a/b); now y = RN_f32(10 * q)
    z = 10 * m                                   # < 2^28, exact
    d = 3 + (z >= 2**27).to(torch.int64)         # drop to 24 significant bits
    half = torch.ones_like(d) << (d - 1)
    rem = z & ((torch.ones_like(d) << d) - 1)
    zm = z >> d
    zm = zm + ((rem > half) | ((rem == half) & (zm & 1 == 1))
               ).to(torch.int64)
    zroll = zm == 2**24
    zm = torch.where(zroll, torch.full_like(zm, 2**23), zm)
    d = d + zroll.to(torch.int64)
    # y = zm * 2^(d-k) with k-d >= 0: truncation is a right shift
    score = (zm >> (k - d)).to(torch.int32)
    return torch.where(b > 0, score, torch.full_like(score, 10))


def u64_mod_small(hi: torch.Tensor, lo: torch.Tensor,
                  m: torch.Tensor) -> torch.Tensor:
    """(hi*2^32 + lo) % m in int64 (0 <= hi, lo < 2^32 and 1 <= m < 2^31,
    so every partial product fits): the FNV-1a tie-break hash rides as
    (hi, lo) int64 halves because torch's uint64 has few ops."""
    hi, lo, m = hi.to(torch.int64), lo.to(torch.int64), m.to(torch.int64)
    two32_mod = (1 << 32) % m
    return ((hi % m) * two32_mod + lo % m) % m


def masked_top_count(masked_scores: torch.Tensor, sentinel: int):
    """(top, any_valid, best_mask, count) over a sentinel-masked score row:
    the vector form of sort-desc + getBestHosts
    (ref: generic_scheduler.go:84-112)."""
    top = masked_scores.max()
    any_valid = top > sentinel
    best = masked_scores == top
    count = best.sum(dtype=torch.int64).clamp_min(1)
    return top, any_valid, best, count


def select_kth_true(mask: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Index of the (k+1)-th True of ``mask`` in index order (k 0-based):
    the deterministic replacement for rand.Int() % len(bestHosts)."""
    cum = torch.cumsum(mask.to(torch.int64), 0)
    hit = (cum == k.to(torch.int64) + 1) & mask
    # argmax returns the first maximal index
    return torch.argmax(hit.to(torch.int32)).to(torch.int32)
