// commit_solve.cu — the sequential-commit wave solve, hand-written for
// Hopper (sm_90a).
//
// Replaces the one Pallas TPU kernel of the JAX package,
// kubernetes_tpu/ops/pallas_solver.py::_solve_pallas_x32 (pl.pallas_call at
// :772; body _make_kernel/_pod_step :233-544, device function
// _spread_score_i32 :168), at default-policy scope: PodFitsResources,
// PodFitsPorts, NoDiskConflict, the static selector/host/cordon mask, and
// LeastRequested + ServiceSpreading + Equal priorities. For every pod in
// order it filters, scores, selects the k-th best node by the pod's FNV-1a
// hash, and commits one node row; later pods see every earlier commit.
//
// Design. One launch per wave, one block of 1024 threads; the pod loop runs
// inside the kernel. Thread t owns a CONTIGUOUS chunk of ceil(N/1024) nodes
// (at most 32, one bit each in a 32-bit mask), so the k-th best node in node
// order is found by a block exclusive scan of per-thread best counts — this
// replaces the TPU kernel's triangular-matmul prefix ranks. Only the owner
// ever reads or writes a node's mutable state (usage planes, port/PD words,
// peer counts), so the commit needs no barrier: a pod costs exactly three
// block barriers (filter reductions, score max, count scan). The state lives
// in global memory (about 300 KB at 5,000 nodes, resident in the 50 MB L2);
// the kernel copies it in from the inputs, so the inputs stay untouched.
//
// Bound. Counting each input byte once, a 10,000-pod x 5,000-node wave moves
// about 50 MB (the uint8 static mask dominates): ~15 us at 3.35 TB/s. The
// kernel sits far above that: what bounds it is the serial chain of pods,
// each paying three block-wide barriers and dependent L2 loads. Later work
// attacks the barriers (fewer threads per pod step, state in shared memory
// or registers, several blocks with a cluster barrier).
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
constexpr unsigned kFull = 0xffffffffu;

// policy flags (the Filter predicates the kernel evaluates)
constexpr int kUseResources = 1;
constexpr int kUsePorts = 2;
constexpr int kUseDisk = 4;

struct Shape {
  int P, N, R, Wp, Wd, G, row;
  int flags, w_lr, w_spread, w_equal;
};

__device__ __forceinline__ int bit_length(unsigned long long x) {
  // frexp exponent of x: 2^(e-1) <= x < 2^e; exact as float32 below 2^24
  return x ? 64 - __clzll(x) : 0;
}

// ServiceSpreading: int(10 * (f32(total - count) / f32(total))) with IEEE
// round-to-nearest-even at each float32 step, in exact 64-bit integer
// arithmetic (the plain version is ops/kernels.spread_score; the TPU kernel
// used 12-bit limbs only because its lanes lack 64 bits).
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
    int* __restrict__ fit, int* __restrict__ score_used,
    int* __restrict__ ports, int* __restrict__ pds,
    int* __restrict__ counts,            // mutable state, same layouts
    int* __restrict__ chosen, int* __restrict__ win, const Shape s) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int N = s.N;
  const int chunk = (N + kThreads - 1) / kThreads;
  const int n0 = min(t * chunk, N);
  const int own = min(n0 + chunk, N) - n0;  // this thread's nodes [n0, n0+own)

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

  __shared__ unsigned sh_adv[kWarps];
  __shared__ int sh_cmax[kWarps];
  __shared__ int sh_top[kWarps];
  __shared__ int sh_cnt[kWarps];

  const bool use_res = s.flags & kUseResources;
  const bool use_ports = s.flags & kUsePorts;
  const bool use_disk = s.flags & kUseDisk;
  // podrow layout: req[R] | ports[Wp] | pds[Wd] | tie_hi tie_lo | gid |
  // member bits | zero-request flag
  const int o_ports = s.R;
  const int o_pds = o_ports + s.Wp;
  const int o_tie = o_pds + s.Wd;
  const int o_gid = o_tie + 2;
  const int o_member = o_gid + 1;
  const int o_zreq = o_gid + 2;

  for (int p = 0; p < s.P; ++p) {
    const int* row = podrow + (size_t)p * s.row;
    const uint8_t* srow = smask + (size_t)p * N;
    const int gid = __ldg(row + o_gid);
    const bool zreq = __ldg(row + o_zreq) != 0;
    int req[kMaxR];
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) req[r] = r < s.R ? __ldg(row + r) : 0;

    // ---- filter (and the two per-pod reductions it feeds) -------------
    unsigned feas = 0;  // bit j: node n0 + j is feasible
    unsigned adv = 0;   // bit r: a feasible node advertises extra dim r
    int cmax = 0;       // max peers of the pod's group over owned nodes
    for (int j = 0; j < own; ++j) {
      const int n = n0 + j;
      bool ok = srow[n] != 0;
      if (ok && use_res && !zreq) {
        // a zero-request pod skips both the fit check and fit_exceeded
        ok = fitexc[n] == 0;
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          if (r < s.R) {
            const size_t i = (size_t)r * N + n;
            const int c = cap[i];
            // cpu and memory (dims 0, 1) are unconstrained at zero capacity
            ok = ok && (c - fit[i] >= req[r] || (r < 2 && c == 0));
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
      if (gid >= 0) cmax = max(cmax, counts[(size_t)gid * N + n]);
    }
    adv = __reduce_or_sync(kFull, adv);
    cmax = __reduce_max_sync(kFull, cmax);
    if (lane == 0) {
      sh_adv[warp] = adv;
      sh_cmax[warp] = cmax;
    }
    __syncthreads();
    adv = 0;
    cmax = 0;
    for (int i = 0; i < kWarps; ++i) {
      adv |= sh_adv[i];
      cmax = max(cmax, sh_cmax[i]);
    }
    // the spread max counts the off-list slot too; a serviceless pod
    // scores the constant 10 (spread of total 0)
    const int max_count = gid >= 0 ? max(cmax, offl[gid]) : 0;
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
          const long long tot = (long long)score_used[i] + req[r];
          // kept only when 0 <= tot <= c: numerator >= 0, divisor > 0
          if (c != 0 && tot <= c) raw += (int)(((c - tot) * 10) / c);
        }
        sc += (raw / n_dyn) * s.w_lr;  // raw >= 0, n_dyn >= 2
      }
      if (s.w_spread) {
        const int peers = gid >= 0 ? counts[(size_t)gid * N + n] : 0;
        sc += spread_score(max_count, peers) * s.w_spread;
      }
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
      if (t == 0) {
        chosen[p] = -1;
        win[p] = -1;
      }
      continue;
    }
    const unsigned long long h =
        ((unsigned long long)(unsigned)__ldg(row + o_tie) << 32) |
        (unsigned)__ldg(row + o_tie + 1);
    const int k = (int)(h % (unsigned long long)total);  // unsigned modulo
    const int excl = before + incl - mine;
    if (k >= excl && k < excl + mine) {
      // ---- commit: the owner updates its node row ----------------------
      unsigned m = lbest;
      for (int i = 0; i < k - excl; ++i) m &= m - 1;  // drop lower best bits
      const int n = n0 + __ffs(m) - 1;
      for (int r = 0; r < s.R; ++r) {
        const size_t i = (size_t)r * N + n;
        fit[i] += req[r];
        score_used[i] += req[r];
      }
      for (int w = 0; w < s.Wp; ++w) ports[(size_t)w * N + n] |= __ldg(row + o_ports + w);
      for (int w = 0; w < s.Wd; ++w) pds[(size_t)w * N + n] |= __ldg(row + o_pds + w);
      const unsigned member = (unsigned)__ldg(row + o_member);
      for (int g = 0; g < s.G; ++g)
        if ((member >> g) & 1u) counts[(size_t)g * N + n] += 1;
      chosen[p] = n;
      win[p] = top;
    }
  }
}

}  // namespace

extern "C" {

// One wave. Pointers are device pointers; the wrapper allocates the state
// and outputs. Returns the launch's cudaError_t (0 = launched).
int kgpu_commit_solve(const void* smask, const void* podrow, const void* cap,
                      const void* fit0, const void* score0, const void* advx,
                      const void* fitexc, const void* ports0, const void* pds0,
                      const void* counts0, const void* offl, void* fit,
                      void* score_used, void* ports, void* pds, void* counts,
                      void* chosen, void* win, int P, int N, int R, int Wp,
                      int Wd, int G, int row, int flags, int w_lr,
                      int w_spread, int w_equal, void* stream) {
  if (P < 0 || N < 0 || N > kThreads * kMaxChunk || R < 0 || R > kMaxR ||
      Wp > kMaxW || Wd > kMaxW || G > kMaxG || row != R + Wp + Wd + 5)
    return (int)cudaErrorInvalidValue;
  const Shape s{P, N, R, Wp, Wd, G, row, flags, w_lr, w_spread, w_equal};
  commit_solve_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)smask, (const int*)podrow, (const int*)cap,
      (const int*)fit0, (const int*)score0, (const uint8_t*)advx,
      (const uint8_t*)fitexc, (const int*)ports0, (const int*)pds0,
      (const int*)counts0, (const int*)offl, (int*)fit, (int*)score_used,
      (int*)ports, (int*)pds, (int*)counts, (int*)chosen, (int*)win, s);
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
