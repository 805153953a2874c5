// commit_solve.cu — the sequential-commit wave solve, hand-written for
// Hopper (sm_90a).
//
// Replaces the one Pallas TPU kernel of the JAX package,
// kubernetes_tpu/ops/pallas_solver.py::_solve_pallas_x32 (pl.pallas_call at
// :772; body _make_kernel/_pod_step :233-544, device function
// _spread_score_i32 :168), with every branch of its body: PodFitsResources,
// PodFitsPorts, NoDiskConflict, the static selector/host/cordon/label-
// presence mask, CheckServiceAffinity anchors (:375-394, :507-523),
// LeastRequested + ServiceSpreading + Equal priorities, NodeLabelPriority
// (:444-446), ServiceAntiAffinity zones (:428-443), and the gang checkpoint
// and rollback (:337-343, :525-534). For every pod in order it filters,
// scores, selects the k-th best node by the pod's FNV-1a hash, and commits
// one node row; later pods see every earlier commit.
//
// Design. One launch per wave, one block of 1024 threads; the pod loop runs
// inside the kernel. Thread t owns a CONTIGUOUS chunk of ceil(N/1024) nodes
// (at most 32, one bit each in a 32-bit mask), so the k-th best node in node
// order is found by a block exclusive scan of per-thread best counts — this
// replaces the TPU kernel's triangular-matmul prefix ranks. Only the owner
// ever reads or writes a node's mutable state (usage planes, port/PD words,
// peer counts), so the commit needs no barrier: a pod costs three block
// barriers (filter reductions, score max, count scan). The state lives in
// global memory (about 300 KB at 5,000 nodes, resident in the 50 MB L2);
// the kernel copies it in from the inputs, so the inputs stay untouched.
//
// Each extension branch is a template flag of the kernel, and the host
// launches the instance the wave's policy needs: a default-policy wave runs
// none of the code below. The extensions add shared state and barriers:
// - ServiceAffinity anchors are per group, not per node: they live in shared
//   memory, the committing thread writes them, and every thread reads them
//   in the next pod's filter, so a fourth barrier ends the pod when L > 0.
// - ServiceAntiAffinity needs, before any score, the pod's peers per zone
//   over the FEASIBLE nodes: each thread atomically adds its feasible
//   labeled nodes' counts into a shared [A * V] accumulator before the
//   first barrier, and the total peer count joins that barrier's
//   reductions. The accumulator is zeroed between the second and third
//   barriers, when no thread still reads it and none has begun adding.
// - Gang runs: at a run's first pod every thread copies its owned state
//   columns to a checkpoint in global memory (no barrier: owner-local), and
//   the anchors to a shared copy. The member that finds no node (block-
//   uniform: every thread computes the same total) restores them, and the
//   rest of the run is infeasible everywhere until the next unit starts.
//
// Bound. Counting each input byte once, a 10,000-pod x 5,000-node wave moves
// about 50 MB (the uint8 static mask dominates): ~15 us at 3.35 TB/s. The
// kernel sits far above that: what bounds it is the serial chain of pods,
// each paying three or four block-wide barriers and dependent L2 loads.
// Later work attacks the barriers (fewer threads per pod step, state in
// shared memory or registers, several blocks with a cluster barrier).
//
// Integer semantics. C's '/' and '%' truncate where Python and torch floor;
// every division below has a non-negative numerator and a positive divisor,
// so the two agree (each site says so). Shifts are taken in 64 bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math). Bound with ctypes by
//        kubernetes_tpu_torch/ops/build.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 32;
constexpr int kMaxR = 8;
constexpr int kMaxW = 8;
constexpr int kMaxG = 31;
constexpr int kMaxA = 4;   // anti-affinity labels
constexpr int kMaxV = 64;  // zones per anti-affinity label
constexpr int kMaxL = 4;   // service-affinity labels
constexpr unsigned kFull = 0xffffffffu;

// policy flags (the Filter predicates and optional planes the kernel uses)
constexpr int kUseResources = 1;
constexpr int kUsePorts = 2;
constexpr int kUseDisk = 4;
constexpr int kUseStatic = 8;  // NodeLabelPriority plane
constexpr int kGangs = 16;     // checkpoint and rollback of PodGroup runs

// the podrow's unit field
constexpr int kStart = 1;       // a scheduling unit starts at this pod
constexpr int kCheckpoint = 2;  // a gang run starts here: checkpoint

struct Shape {
  int P, N, R, Wp, Wd, G, L, A, V, row;
  int flags, w_lr, w_spread, w_equal;
  int w_anti[kMaxA];  // weight of each anti-affinity label
};

// The per-node mutable state: [R,N] fit, [R,N] score_used, [Wp,N] ports,
// [Wd,N] pds, [G,N] counts.
struct State {
  int* plane[5];
};

struct ConstState {
  const int* plane[5];
};

// Copy this thread's columns [n0, n0+own) of every state plane: the gang
// checkpoint and rollback. Out of line, because inlined in the pod loop it
// would hold registers across the loop.
__device__ __noinline__ void copy_owned(const State dst, const ConstState src,
                                        const Shape& s, int n0, int own) {
  const int rows[5] = {s.R, s.R, s.Wp, s.Wd, s.G};
#pragma unroll
  for (int k = 0; k < 5; ++k)
    for (int r = 0; r < rows[k]; ++r)
      for (int j = 0; j < own; ++j) {
        const size_t i = (size_t)r * s.N + n0 + j;
        dst.plane[k][i] = src.plane[k][i];
      }
}

__device__ __forceinline__ int bit_length(unsigned long long x) {
  // frexp exponent of x: 2^(e-1) <= x < 2^e; exact as float32 below 2^24
  return x ? 64 - __clzll(x) : 0;
}

// ServiceSpreading: int(10 * (f32(total - count) / f32(total))) with IEEE
// round-to-nearest-even at each float32 step, in exact 64-bit integer
// arithmetic (the plain version is ops/kernels.spread_score; the TPU kernel
// used 12-bit limbs only because its lanes lack 64 bits). ServiceAntiAffinity
// scores a zone with the same function.
// Domain: 0 <= count <= total < 2^24.
__device__ int spread_score(long long total, long long count) {
  if (total <= 0) return 10;
  const long long a = total > count ? total - count : 0;
  const long long b = total;  // >= 1
  // k so that m = (a << k) / b lands in [2^23, 2^24); a <= b so k >= 23,
  // and a < 2^ea bounds a << k below 2^48
  const int k0 = 23 + bit_length(b) - bit_length(a);
  const long long m0 = (a << k0) / b;  // a >= 0, b > 0: truncation == floor
  int k = k0 + (m0 < (1LL << 23)) - (m0 >= (1LL << 24));
  const long long q_num = a << k;
  const long long m1 = q_num / b;      // q_num >= 0, b > 0
  const long long r = q_num - m1 * b;
  long long m = m1 + ((2 * r > b) || (2 * r == b && (m1 & 1)));
  if (m == (1LL << 24)) {
    m = 1LL << 23;
    k -= 1;
  }
  // q = m * 2^-k is RN_f32(a / b); now y = RN_f32(10 * q)
  const long long z = 10 * m;          // < 2^28
  int d = 3 + (z >= (1LL << 27));
  const long long half = 1LL << (d - 1);
  const long long rem = z & ((1LL << d) - 1);
  long long zm = z >> d;
  zm += (rem > half) || (rem == half && (zm & 1));
  if (zm == (1LL << 24)) {
    zm = 1LL << 23;
    d += 1;
  }
  // y = zm * 2^(d - k) with k - d >= 18: truncation is a right shift
  return static_cast<int>(zm >> (k - d));
}

__global__ void spread_eval_kernel(const int* __restrict__ total,
                                   const int* __restrict__ count,
                                   int* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = spread_score(total[i], count[i]);
  }
}

// The branch set is fixed at compile time, so a wave pays only for the
// branches its policy uses: kAff = ServiceAffinity anchors (L > 0), kAnti =
// ServiceAntiAffinity zones (A > 0), kGang = gang checkpoint and rollback,
// kStatic = the NodeLabelPriority plane. The host picks the instance.
template <bool kAff, bool kAnti, bool kGang, bool kStatic>
__global__ void __launch_bounds__(kThreads, 1) commit_solve_kernel(
    const uint8_t* __restrict__ smask,   // [P, N] static feasibility
    const int* __restrict__ podrow,      // [P, row] packed pod rows
    const int* __restrict__ cap,         // [R, N]
    const int* __restrict__ fit0,        // [R, N] greedy-fitting usage
    const int* __restrict__ score0,      // [R, N] all-pods usage
    const uint8_t* __restrict__ advx,    // [R, N] capacity key advertised
    const uint8_t* __restrict__ fitexc,  // [N] pre-exceeded node
    const int* __restrict__ ports0,      // [Wp, N] port bitmask words
    const int* __restrict__ pds0,        // [Wd, N] PD bitmask words
    const int* __restrict__ counts0,     // [G, N] service peers per node
    const int* __restrict__ offl,        // [G] peers on no listed node
    const int* __restrict__ sstat,       // [N] NodeLabelPriority plane
    const int* __restrict__ affv,        // [L, N] value codes, -1 absent
    const int* __restrict__ anchor0,     // [G, L] initial anchor values
    const uint8_t* __restrict__ has0,    // [G] the group has an anchor
    const int* __restrict__ zone,        // [A, N] zone codes, -1 unlabeled
    int* __restrict__ fit, int* __restrict__ score_used,
    int* __restrict__ ports, int* __restrict__ pds,
    int* __restrict__ counts,            // mutable state, same layouts
    const State ck,                      // gang checkpoint (kGang only)
    int* __restrict__ chosen, int* __restrict__ win, const Shape s) {
  // the pod's request stays in registers unless a branch that holds more
  // state across the loop runs; then it is read again from the pod row
  constexpr bool kLean = !(kAff || kAnti || kGang);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int N = s.N;
  const int chunk = (N + kThreads - 1) / kThreads;
  const int n0 = min(t * chunk, N);
  const int own = min(n0 + chunk, N) - n0;  // this thread's nodes [n0, n0+own)
  const int L = kAff ? s.L : 0;
  const int A = kAnti ? s.A : 0;

  __shared__ unsigned sh_adv[kWarps];
  __shared__ int sh_cmax[kWarps];
  __shared__ int sh_num[kWarps];
  __shared__ int sh_top[kWarps];
  __shared__ int sh_cnt[kWarps];
  __shared__ int sh_zone[kMaxA * kMaxV];  // the pod's feasible peers per zone
  __shared__ int sh_anchor[kMaxG * kMaxL];
  __shared__ int sh_has[kMaxG];
  __shared__ int sh_ck_anchor[kMaxG * kMaxL];
  __shared__ int sh_ck_has[kMaxG];
  __shared__ int sh_w_anti[kMaxA];

  // copy the owned columns of the state in; only this thread touches them
  for (int j = 0; j < own; ++j) {
    const int n = n0 + j;
    for (int r = 0; r < s.R; ++r) {
      const size_t i = (size_t)r * N + n;
      fit[i] = fit0[i];
      score_used[i] = score0[i];
    }
    for (int w = 0; w < s.Wp; ++w) ports[(size_t)w * N + n] = ports0[(size_t)w * N + n];
    for (int w = 0; w < s.Wd; ++w) pds[(size_t)w * N + n] = pds0[(size_t)w * N + n];
    for (int g = 0; g < s.G; ++g) counts[(size_t)g * N + n] = counts0[(size_t)g * N + n];
  }
  const int GL = s.G * L;
  if constexpr (kAff) {
    for (int i = t; i < GL; i += kThreads) sh_anchor[i] = anchor0[i];
    for (int i = t; i < s.G; i += kThreads) sh_has[i] = has0[i];
  }
  if constexpr (kAnti) {
    for (int i = t; i < A * s.V; i += kThreads) sh_zone[i] = 0;
    if (t < kMaxA) sh_w_anti[t] = s.w_anti[t];
  }
  if constexpr (kAff || kAnti) __syncthreads();

  const bool use_res = s.flags & kUseResources;
  const bool use_ports = s.flags & kUsePorts;
  const bool use_disk = s.flags & kUseDisk;
  // podrow layout: req[R] | ports[Wp] | pds[Wd] | tie_hi tie_lo | gid |
  // member bits | zero-request flag | unit | pinned affinity codes[L]
  const int o_ports = s.R;
  const int o_pds = o_ports + s.Wp;
  const int o_tie = o_pds + s.Wd;
  const int o_gid = o_tie + 2;
  const int o_member = o_gid + 1;
  const int o_zreq = o_gid + 2;
  const int o_unit = o_gid + 3;
  const int o_pins = o_gid + 4;

  bool failed = false;  // a member of the current gang run found no node
  for (int p = 0; p < s.P; ++p) {
    const int* row = podrow + (size_t)p * s.row;
    const uint8_t* srow = smask + (size_t)p * N;
    const int gid = __ldg(row + o_gid);
    const bool zreq = __ldg(row + o_zreq) != 0;
    int req[kMaxR];
    if constexpr (kLean) {
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) req[r] = r < s.R ? __ldg(row + r) : 0;
    }
    auto request = [&](int r) -> int {
      if constexpr (kLean) return req[r];
      else return __ldg(row + r);
    };

    // ---- gang bookkeeping (solve_jit gang_step) -------------------------
    int unit = kStart;
    bool was_failed = false;
    if constexpr (kGang) {
      unit = __ldg(row + o_unit);
      if (unit & kStart) failed = false;
      was_failed = failed;
      if (unit & kCheckpoint) {
        copy_owned(ck, ConstState{{fit, score_used, ports, pds, counts}}, s,
                   n0, own);
        // the same thread copies back on rollback: no barrier needed here
        if constexpr (kAff) {
          for (int i = t; i < GL; i += kThreads) sh_ck_anchor[i] = sh_anchor[i];
          for (int i = t; i < s.G; i += kThreads) sh_ck_has[i] = sh_has[i];
        }
      }
    }
    // anchor-derived affinity (predicates.go:256-276): bit l set when label
    // l was not pinned by the selector and the group's anchor has a value
    unsigned need = 0;
    if constexpr (kAff) {
      if (gid >= 0 && sh_has[gid]) {
        for (int l = 0; l < L; ++l)
          if (__ldg(row + o_pins + l) == -2 && sh_anchor[gid * L + l] >= 0)
            need |= 1u << l;
      }
    }

    // ---- filter (and the per-pod reductions it feeds) -------------------
    unsigned feas = 0;  // bit j: node n0 + j is feasible
    unsigned adv = 0;   // bit r: a feasible node advertises extra dim r
    int cmax = 0;       // max peers of the pod's group over owned nodes
    int csum = 0;       // all peers of the pod's group over owned nodes
    for (int j = 0; j < own; ++j) {
      const int n = n0 + j;
      bool ok = srow[n] != 0;
      if constexpr (kGang) ok = ok && !failed;
      if constexpr (kAff) {
        for (int l = 0; ok && l < L; ++l)
          if ((need >> l) & 1u)
            ok = affv[(size_t)l * N + n] == sh_anchor[gid * L + l];
      }
      if (ok && use_res && !zreq) {
        // a zero-request pod skips both the fit check and fit_exceeded
        ok = fitexc[n] == 0;
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          if (r < s.R) {
            const size_t i = (size_t)r * N + n;
            const int c = cap[i];
            // cpu and memory (dims 0, 1) are unconstrained at zero capacity
            ok = ok && (c - fit[i] >= request(r) || (r < 2 && c == 0));
          }
        }
      }
      if (ok && use_ports) {
        for (int w = 0; w < s.Wp; ++w)
          ok = ok && (ports[(size_t)w * N + n] & __ldg(row + o_ports + w)) == 0;
      }
      if (ok && use_disk) {
        for (int w = 0; w < s.Wd; ++w)
          ok = ok && (pds[(size_t)w * N + n] & __ldg(row + o_pds + w)) == 0;
      }
      if (ok) {
        feas |= 1u << j;
        for (int r = 2; r < s.R; ++r)
          if (advx[(size_t)r * N + n]) adv |= 1u << r;
      }
      if constexpr (!kAnti) {
        if (gid >= 0) cmax = max(cmax, counts[(size_t)gid * N + n]);
      }
    }
    if constexpr (kAnti) {
      // the peers again, now that every owned node's feasibility is known
      if (gid >= 0) {
        const int* crow = counts + (size_t)gid * N;
        for (int j = 0; j < own; ++j) {
          const int c = crow[n0 + j];
          cmax = max(cmax, c);
          csum += c;
          // ServiceAntiAffinity: the pod's peers per zone, feasible nodes
          if (!c || !((feas >> j) & 1u)) continue;
          for (int a = 0; a < A; ++a) {
            const int z = zone[(size_t)a * N + n0 + j];
            if (z >= 0) atomicAdd(&sh_zone[a * s.V + z], c);
          }
        }
      }
    }
    adv = __reduce_or_sync(kFull, adv);
    cmax = __reduce_max_sync(kFull, cmax);
    if constexpr (kAnti) csum = __reduce_add_sync(kFull, csum);
    if (lane == 0) {
      sh_adv[warp] = adv;
      sh_cmax[warp] = cmax;
      if constexpr (kAnti) sh_num[warp] = csum;
    }
    __syncthreads();
    adv = 0;
    cmax = 0;
    csum = 0;
    for (int i = 0; i < kWarps; ++i) {
      adv |= sh_adv[i];
      cmax = max(cmax, sh_cmax[i]);
      if constexpr (kAnti) csum += sh_num[i];
    }
    // the spread max counts the off-list slot too; a serviceless pod
    // scores the constant 10 (spread of total 0)
    const int max_count = gid >= 0 ? max(cmax, offl[gid]) : 0;
    // anti-affinity's num counts every peer of the group, off-list included
    const int num = kAnti && gid >= 0 ? csum + offl[gid] : 0;
    // LeastRequested divisor: cpu + memory + every extra dimension some
    // FEASIBLE node advertises (by name presence, not capacity)
    const int n_dyn = 2 + __popc(adv);

    // ---- score: per-thread max and the owned nodes that reach it ------
    int lmax = -1;
    unsigned lbest = 0;
    for (int j = 0; j < own; ++j) {
      if (!((feas >> j) & 1u)) continue;
      const int n = n0 + j;
      int sc = 0;
      if (s.w_lr) {
        int raw = 0;
        for (int r = 0; r < s.R; ++r) {
          const size_t i = (size_t)r * N + n;
          const long long c = cap[i];
          const long long tot = (long long)score_used[i] + request(r);
          // kept only when 0 <= tot <= c: numerator >= 0, divisor > 0
          if (c != 0 && tot <= c) raw += (int)(((c - tot) * 10) / c);
        }
        sc += (raw / n_dyn) * s.w_lr;  // raw >= 0, n_dyn >= 2
      }
      if (s.w_spread) {
        const int peers = gid >= 0 ? counts[(size_t)gid * N + n] : 0;
        sc += spread_score(max_count, peers) * s.w_spread;
      }
      if constexpr (kAnti) {
        for (int a = 0; a < A; ++a) {
          // an unlabeled node scores 0 on this term
          const int z = zone[(size_t)a * N + n];
          if (z >= 0)
            sc += spread_score(num, sh_zone[a * s.V + z]) * sh_w_anti[a];
        }
      }
      if constexpr (kStatic) sc += sstat[n];
      sc += s.w_equal;
      if (sc > lmax) {
        lmax = sc;
        lbest = 1u << j;
      } else if (sc == lmax) {
        lbest |= 1u << j;
      }
    }
    int top = __reduce_max_sync(kFull, lmax);
    if (lane == 0) sh_top[warp] = top;
    __syncthreads();
    top = -1;
    for (int i = 0; i < kWarps; ++i) top = max(top, sh_top[i]);
    if constexpr (kAnti) {
      // every thread has read the zone sums: clear them for the next pod
      for (int i = t; i < A * s.V; i += kThreads) sh_zone[i] = 0;
    }

    // ---- select: rank of the k-th best node in node order -------------
    const int mine = (top >= 0 && lmax == top) ? __popc(lbest) : 0;
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) sh_cnt[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
    for (int i = 0; i < kWarps; ++i) {
      const int v = sh_cnt[i];
      before += i < warp ? v : 0;
      total += v;
    }
    if (total == 0) {  // no feasible node (uniform across the block)
      if constexpr (kGang) {
        if (!was_failed && !(unit & kStart)) {
          // ---- gang rollback: pin the state at the run's checkpoint ----
          copy_owned(State{{fit, score_used, ports, pds, counts}},
                     ConstState{{ck.plane[0], ck.plane[1], ck.plane[2],
                                 ck.plane[3], ck.plane[4]}}, s, n0, own);
          if constexpr (kAff) {
            for (int i = t; i < GL; i += kThreads) sh_anchor[i] = sh_ck_anchor[i];
            for (int i = t; i < s.G; i += kThreads) sh_has[i] = sh_ck_has[i];
          }
        }
        failed = true;
      }
      if (t == 0) {
        chosen[p] = -1;
        win[p] = -1;
      }
    } else {
      const unsigned long long h =
          ((unsigned long long)(unsigned)__ldg(row + o_tie) << 32) |
          (unsigned)__ldg(row + o_tie + 1);
      const int k = (int)(h % (unsigned long long)total);  // unsigned modulo
      const int excl = before + incl - mine;
      if (k >= excl && k < excl + mine) {
        // ---- commit: the owner updates its node row --------------------
        unsigned m = lbest;
        for (int i = 0; i < k - excl; ++i) m &= m - 1;  // drop lower best bits
        const int n = n0 + __ffs(m) - 1;
        for (int r = 0; r < s.R; ++r) {
          const size_t i = (size_t)r * N + n;
          const int q = request(r);
          fit[i] += q;
          score_used[i] += q;
        }
        for (int w = 0; w < s.Wp; ++w) ports[(size_t)w * N + n] |= __ldg(row + o_ports + w);
        for (int w = 0; w < s.Wd; ++w) pds[(size_t)w * N + n] |= __ldg(row + o_pds + w);
        const unsigned member = (unsigned)__ldg(row + o_member);
        for (int g = 0; g < s.G; ++g) {
          if (!((member >> g) & 1u)) continue;
          counts[(size_t)g * N + n] += 1;
          if constexpr (kAff) {
            // the group's first peer anchors it at this node's values
            if (!sh_has[g]) {
              for (int l = 0; l < L; ++l)
                sh_anchor[g * L + l] = affv[(size_t)l * N + n];
              sh_has[g] = 1;
            }
          }
        }
        chosen[p] = n;
        win[p] = top;
      }
    }
    // the anchors (committed or restored) are read by every thread in the
    // next pod's filter
    if constexpr (kAff) __syncthreads();
  }
}

using CommitKernel = decltype(&commit_solve_kernel<false, false, false, false>);

// instance I: bit 0 kAff, bit 1 kAnti, bit 2 kGang, bit 3 kStatic
template <int I>
constexpr CommitKernel instance() {
  return &commit_solve_kernel<(I & 1) != 0, (I & 2) != 0, (I & 4) != 0,
                              (I & 8) != 0>;
}

}  // namespace

extern "C" {

// One wave. Pointers are device pointers; the wrapper allocates the state,
// the gang checkpoint (gang waves only; null otherwise) and the outputs.
// Returns the launch's cudaError_t (0 = launched).
int kgpu_commit_solve(const void* smask, const void* podrow, const void* cap,
                      const void* fit0, const void* score0, const void* advx,
                      const void* fitexc, const void* ports0, const void* pds0,
                      const void* counts0, const void* offl, const void* sstat,
                      const void* affv, const void* anchor0, const void* has0,
                      const void* zone, void* fit, void* score_used,
                      void* ports, void* pds, void* counts, void* ck_fit,
                      void* ck_score_used, void* ck_ports, void* ck_pds,
                      void* ck_counts, void* chosen, void* win, int P, int N,
                      int R, int Wp, int Wd, int G, int L, int A, int V,
                      int row, int flags, int w_lr, int w_spread, int w_equal,
                      int w_anti0, int w_anti1, int w_anti2, int w_anti3,
                      void* stream) {
  if (P < 0 || N < 0 || N > kThreads * kMaxChunk || R < 0 || R > kMaxR ||
      Wp < 0 || Wp > kMaxW || Wd < 0 || Wd > kMaxW || G < 0 || G > kMaxG ||
      L < 0 || L > kMaxL || A < 0 || A > kMaxA || V < 0 || V > kMaxV ||
      row != R + Wp + Wd + 6 + L ||
      ((flags & kGangs) && !(ck_fit && ck_score_used && ck_counts &&
                             (Wp == 0 || ck_ports) && (Wd == 0 || ck_pds))))
    return (int)cudaErrorInvalidValue;
  static const CommitKernel kernels[16] = {
      instance<0>(),  instance<1>(),  instance<2>(),  instance<3>(),
      instance<4>(),  instance<5>(),  instance<6>(),  instance<7>(),
      instance<8>(),  instance<9>(),  instance<10>(), instance<11>(),
      instance<12>(), instance<13>(), instance<14>(), instance<15>()};
  const int which = (L > 0) | (A > 0) << 1 | ((flags & kGangs) != 0) << 2 |
                    ((flags & kUseStatic) != 0) << 3;
  const Shape s{P, N, R, Wp, Wd, G, L, A, V, row, flags, w_lr, w_spread,
                w_equal, {w_anti0, w_anti1, w_anti2, w_anti3}};
  const State ck{{(int*)ck_fit, (int*)ck_score_used, (int*)ck_ports,
                  (int*)ck_pds, (int*)ck_counts}};
  kernels[which]<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)smask, (const int*)podrow, (const int*)cap,
      (const int*)fit0, (const int*)score0, (const uint8_t*)advx,
      (const uint8_t*)fitexc, (const int*)ports0, (const int*)pds0,
      (const int*)counts0, (const int*)offl, (const int*)sstat,
      (const int*)affv, (const int*)anchor0, (const uint8_t*)has0,
      (const int*)zone, (int*)fit, (int*)score_used, (int*)ports, (int*)pds,
      (int*)counts, ck, (int*)chosen, (int*)win, s);
  return (int)cudaGetLastError();
}

// The spread device function over n (total, count) pairs, for checking it
// exhaustively against the plain version.
int kgpu_spread_eval(const void* total, const void* count, void* out,
                     long long n, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + 255) / 256;
  if (blocks > 65535) blocks = 65535;
  spread_eval_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const int*)total, (const int*)count, (int*)out, n);
  return (int)cudaGetLastError();
}

const char* kgpu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
