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
// Design. One launch per wave, one block of 1024 threads on one SM; the pod
// loop runs inside the kernel. Thread t owns a CONTIGUOUS chunk of
// ceil(N/1024) nodes (at most 32, one bit each in a 32-bit mask), so the
// k-th best node in node order is found by a block exclusive scan of
// per-thread best counts — this replaces the TPU kernel's triangular-matmul
// prefix ranks. Only the owner ever reads or writes a node's mutable state
// (fit usage, port/PD words, peer counts), so the commit needs no barrier:
// a pod costs three block barriers (filter reductions, score max, count
// scan).
//
// Where the state lives. As the TPU kernel kept its node state in VMEM,
// this one keeps it in the block's dynamic shared memory whenever it fits
// the 227 KB a block may have: [R+Wp+Wd, N] int32 planes and the [G, N]
// peer counts as int16 (every count stays below 2^15, the kernel's domain).
// The all-pods usage is not a plane of its own: every commit and every
// rollback moves it with the fit usage, so it is fit + off, where off =
// score0 - fit0 is a read-only input. A wave whose state does not fit
// (e.g. 32,640 nodes) keeps the same planes, in the same packed layout, in
// a global buffer the wrapper allocates. Both layouts run the same source;
// the layout is a template flag, so the on-chip instance addresses the
// state as shared memory (32-bit LDS/STS) instead of through a generic
// pointer. The host picks the layout from the shapes
// (commit_solver.shared_layout).
//
// The static mask row and the pod row of pod p+1 are fetched with cp.async
// into rings in shared memory while pod p runs; each thread waits for its
// copies before pod p's count-scan barrier, which then publishes the rows.
// No thread waits on HBM or L2 at the start of a pod. The filter issues a
// node's loads before it combines them, and skips the port and PD words
// when the pod (uniformly across the block) has none.
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
// each paying three or four block-wide barriers and the per-node filter and
// score arithmetic of one SM.
//
// Arithmetic. The pod loop computes in 32 bits: LeastRequested divides in
// int32 (batch_solver refuses a wave whose capacities or running sums could
// reach 2^31/10), and the spread score is the reference's own float32
// expression with IEEE round-to-nearest-even steps. The only 64-bit
// operation left is the tie-break's modulo of the 64-bit FNV hash. C's '/'
// truncates where Python and torch floor; every division below has a
// non-negative numerator and a positive divisor, so the two agree.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: the spread score needs IEEE
//        division). Bound with ctypes by kubernetes_tpu_torch/ops/build.py.

#include <array>
#include <cstdint>
#include <type_traits>
#include <utility>

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
constexpr int kMaxRow = kMaxR + 2 * kMaxW + 6 + kMaxL;  // longest pod row
// Resource dimensions the filter and the score unroll; the rest run in a
// loop. Unrolling all eight holds more loads in flight than 64 registers
// take, and every wave has cpu and memory, most at most two more.
constexpr int kUnrollR = 2;
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
  int pitch;  // bytes per static-mask row: N rounded up to 16
  int flags, w_lr, w_spread, w_equal;
  int w_anti[kMaxA];  // weight of each anti-affinity label
};

// The packed state layout (shared memory or a global buffer): the int32
// planes [R,N] fit, [Wp,N] ports, [Wd,N] pds, then the int16 plane [G,N]
// counts. Plane k of the int32 rows starts at word k * N.
__device__ __forceinline__ short* counts_of(unsigned char* base,
                                            const Shape& s) {
  return reinterpret_cast<short*>(base) +
         2 * (s.R + s.Wp + s.Wd) * s.N;
}

// Copy this thread's columns [n0, n0+own) of every state plane between two
// packed layouts: the gang checkpoint and rollback. Out of line, because
// inlined in the pod loop it would hold registers across the loop.
__device__ __noinline__ void copy_owned(unsigned char* dst,
                                        unsigned char* src, const Shape& s,
                                        int n0, int own) {
  const int* si = reinterpret_cast<const int*>(src);
  int* di = reinterpret_cast<int*>(dst);
  const int rows = s.R + s.Wp + s.Wd;
  for (int k = 0; k < rows; ++k)
    for (int j = 0; j < own; ++j) di[k * s.N + n0 + j] = si[k * s.N + n0 + j];
  const short* sc = counts_of(src, s);
  short* dc = counts_of(dst, s);
  for (int g = 0; g < s.G; ++g)
    for (int j = 0; j < own; ++j) dc[g * s.N + n0 + j] = sc[g * s.N + n0 + j];
}

// ServiceSpreading: int(10 * (f32(total - count) / f32(total))), the
// reference's float32 expression (spreading.go:76-80; the plain version is
// ops/kernels.spread_score). Both operands are below 2^24, so they convert
// to float32 exactly; __fdiv_rn and __fmul_rn are IEEE round-to-nearest-
// even and are never contracted into an FMA; the conversion truncates.
// ServiceAntiAffinity scores a zone with the same function.
// Domain: 0 <= count <= total < 2^24.
__device__ __forceinline__ int spread_score(int total, int count) {
  if (total <= 0) return 10;
  const int a = total > count ? total - count : 0;
  const float q = __fdiv_rn(__int2float_rn(a), __int2float_rn(total));
  return __float2int_rz(__fmul_rn(10.f, q));
}

// LeastRequested's share of one dimension: (c - tot) * 10 / c, or 0 when
// the node has no capacity or the pod would overfill it. int32: the
// numerator lies in [0, 10c] and batch_solver refuses a wave whose
// capacities could reach 2^31/10; the divisor is positive.
__device__ __forceinline__ unsigned least_requested(int c, int tot) {
  if (c == 0 || tot > c) return 0;
  return (unsigned)((c - tot) * 10) / (unsigned)c;
}

__global__ void spread_eval_kernel(const int* __restrict__ total,
                                   const int* __restrict__ count,
                                   int* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = spread_score(total[i], count[i]);
  }
}

// cp.async of 16 bytes, global -> shared, bypassing L1
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// cp.async of 4 bytes, global -> shared
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start fetching pod q's static-mask row into mask slot q & 1 and its pod
// row into row slot q % 3; every thread copies its pieces (16 bytes of the
// mask, or one word of the pod row) and later waits for them itself. The
// pod row takes three slots because the committing thread still reads pod
// q-2's row while the others start fetching pod q's.
__device__ __forceinline__ void fetch_pod(unsigned char* ring, int* rows,
                                          const uint8_t* smask,
                                          const int* podrow, int q,
                                          const Shape& s) {
  // 64-bit row offsets: P x pitch may pass 2^31 bytes
  const uint8_t* src = smask + (size_t)q * s.pitch;
  unsigned char* dst = ring + (q & 1) * s.pitch;
  for (int c = threadIdx.x * 16; c < s.pitch; c += kThreads * 16)
    cp_async16(dst + c, src + c);
  // the last threads of the block, which the mask leaves idle first
  const int w = (int)threadIdx.x - (kThreads - s.row);
  if (w >= 0)
    cp_async4(rows + (q % 3) * kMaxRow + w, podrow + (size_t)q * s.row + w);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The branch set is fixed at compile time, so a wave pays only for the
// branches its policy uses: kAff = ServiceAffinity anchors (L > 0), kAnti =
// ServiceAntiAffinity zones (A > 0), kGang = gang checkpoint and rollback,
// kStatic = the NodeLabelPriority plane; kShared = the state lives in
// dynamic shared memory (else in gstate). The host picks the instance.
template <bool kAff, bool kAnti, bool kGang, bool kStatic, bool kShared>
__global__ void __launch_bounds__(kThreads, 1) commit_solve_kernel(
    const uint8_t* __restrict__ smask,   // [P, pitch] static feasibility
    const int* __restrict__ podrow,      // [P, row] packed pod rows
    const int* __restrict__ cap,         // [R, N]
    const int* __restrict__ fit0,        // [R, N] greedy-fitting usage
    const int* __restrict__ off,         // [R, N] all-pods minus fit usage
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
    unsigned char* __restrict__ gstate,  // packed state (global layout only)
    unsigned char* __restrict__ ck,      // packed gang checkpoint (kGang)
    int* __restrict__ chosen, int* __restrict__ win, const Shape s) {
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
  __shared__ int sh_rows[3 * kMaxRow];  // pod-row ring
  // [2, pitch] mask ring, then the packed state when it lives on chip
  extern __shared__ __align__(16) unsigned char dsm[];
  unsigned char* const ring = dsm;
  unsigned char* const base = kShared ? dsm + 2 * s.pitch : gstate;
  int* const fit = reinterpret_cast<int*>(base);
  int* const ports = fit + s.R * N;
  int* const pds = ports + s.Wp * N;
  short* const counts = counts_of(base, s);

  // copy the owned columns of the state in; only this thread touches them
  for (int j = 0; j < own; ++j) {
    const int n = n0 + j;
    for (int r = 0; r < s.R; ++r) fit[r * N + n] = fit0[r * N + n];
    for (int w = 0; w < s.Wp; ++w) ports[w * N + n] = ports0[w * N + n];
    for (int w = 0; w < s.Wd; ++w) pds[w * N + n] = pds0[w * N + n];
    for (int g = 0; g < s.G; ++g)
      counts[g * N + n] = (short)counts0[g * N + n];
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
  if (s.P > 0) fetch_pod(ring, sh_rows, smask, podrow, 0, s);
  cp_async_wait_all();
  __syncthreads();

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
    // the next pod's mask row and pod row stream in while this pod runs
    if (p + 1 < s.P) fetch_pod(ring, sh_rows, smask, podrow, p + 1, s);
    const unsigned char* srow = ring + (p & 1) * s.pitch;
    // req[R] at row[0..R). The on-chip anti-affinity instance reads the
    // pod row again at each use: holding its words in registers across the
    // zone pass spills there (64 registers a thread); the others keep them.
    using RowPtr = std::conditional_t<kAnti && kShared, const volatile int*,
                                      const int*>;
    const RowPtr row = sh_rows + (p % 3) * kMaxRow;
    const int gid = row[o_gid];
    const bool zreq = row[o_zreq] != 0;
    // block-uniform: does the pod hold a host port or a PD at all?
    bool pod_ports = false, pod_pds = false;
    if (use_ports)
      for (int w = 0; w < s.Wp; ++w) pod_ports |= row[o_ports + w] != 0;
    if (use_disk)
      for (int w = 0; w < s.Wd; ++w) pod_pds |= row[o_pds + w] != 0;

    // ---- gang bookkeeping (solve_jit gang_step) -------------------------
    int unit = kStart;
    bool was_failed = false;
    if constexpr (kGang) {
      unit = row[o_unit];
      if (unit & kStart) failed = false;
      was_failed = failed;
      if (unit & kCheckpoint) {
        copy_owned(ck, base, s, n0, own);
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
          if (row[o_pins + l] == -2 && sh_anchor[gid * L + l] >= 0)
            need |= 1u << l;
      }
    }

    // ---- filter (and the per-pod reductions it feeds) -------------------
    // Every word a node's verdict needs is loaded before any is tested, so
    // the loads of one node overlap instead of forming a chain.
    unsigned feas = 0;  // bit j: node n0 + j is feasible
    unsigned adv = 0;   // bit r: a feasible node advertises extra dim r
    int cmax = 0;       // max peers of the pod's group over owned nodes
    int csum = 0;       // all peers of the pod's group over owned nodes
    const bool check_res = use_res && !zreq;  // a zero-request pod skips
                                              // the fit and fit_exceeded
    for (int j = 0; j < own; ++j) {
      const int n = n0 + j;
      bool ok = srow[n] != 0;
      if constexpr (kGang) ok &= !failed;
      if constexpr (kAff) {
        for (int l = 0; l < L; ++l)
          if ((need >> l) & 1u) ok &= affv[l * N + n] == sh_anchor[gid * L + l];
      }
      if (check_res) {
        bool fits = fitexc[n] == 0;
#pragma unroll
        for (int r = 0; r < kUnrollR; ++r) {
          if (r < s.R) {
            const int c = cap[r * N + n];
            // cpu and memory (dims 0, 1) are unconstrained at zero capacity
            fits &= (c - fit[r * N + n] >= row[r]) | (r < 2 && c == 0);
          }
        }
        for (int r = kUnrollR; r < s.R; ++r)
          fits &= cap[r * N + n] - fit[r * N + n] >= row[r];
        ok &= fits;
      }
      if (pod_ports) {
        for (int w = 0; w < s.Wp; ++w)
          ok &= (ports[w * N + n] & row[o_ports + w]) == 0;
      }
      if (pod_pds) {
        for (int w = 0; w < s.Wd; ++w)
          ok &= (pds[w * N + n] & row[o_pds + w]) == 0;
      }
      if (ok) {
        feas |= 1u << j;
        for (int r = 2; r < s.R; ++r)
          if (advx[r * N + n]) adv |= 1u << r;
      }
    }
    // the pod's peers over the owned nodes, in a pass of their own: the
    // spread max, and for anti-affinity the total and the per-zone sums
    // over the feasible nodes
    if (gid >= 0) {
      const short* crow = counts + gid * N;
      for (int j = 0; j < own; ++j) {
        const int c = crow[n0 + j];
        cmax = max(cmax, c);
        if constexpr (kAnti) {
          csum += c;
          if (!c || !((feas >> j) & 1u)) continue;
          for (int a = 0; a < A; ++a) {
            const int z = zone[a * N + n0 + j];
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
    const unsigned n_dyn = 2 + __popc(adv);

    // ---- score: per-thread max and the owned nodes that reach it ------
    int lmax = -1;
    unsigned lbest = 0;
    for (int j = 0; j < own; ++j) {
      if (!((feas >> j) & 1u)) continue;
      const int n = n0 + j;
      int sc = 0;
      if (s.w_lr) {
        // all-pods usage = fit + off
        unsigned raw = 0;
#pragma unroll
        for (int r = 0; r < kUnrollR; ++r) {
          if (r < s.R) {
            const int i = r * N + n;
            raw += least_requested(cap[i], fit[i] + off[i] + row[r]);
          }
        }
        for (int r = kUnrollR; r < s.R; ++r) {
          const int i = r * N + n;
          raw += least_requested(cap[i], fit[i] + off[i] + row[r]);
        }
        sc += (int)(raw / n_dyn) * s.w_lr;  // n_dyn >= 2
      }
      if (s.w_spread) {
        const int peers = gid >= 0 ? counts[gid * N + n] : 0;
        sc += spread_score(max_count, peers) * s.w_spread;
      }
      if constexpr (kAnti) {
        for (int a = 0; a < A; ++a) {
          // an unlabeled node scores 0 on this term
          const int z = zone[a * N + n];
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
    // this thread's pieces of the next pod's rows have landed; the barrier
    // publishes the whole rows
    cp_async_wait_all();
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
          copy_owned(base, ck, s, n0, own);
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
    } else if (mine) {
      // The reference takes the 64-bit FNV-1a hash modulo the count of best
      // nodes, so this modulo is 64-bit; it runs once per pod, and only in
      // the threads that hold a best node.
      const unsigned long long h =
          ((unsigned long long)(unsigned)row[o_tie] << 32) |
          (unsigned)row[o_tie + 1];
      const int k = (int)(h % (unsigned long long)total);
      const int excl = before + incl - mine;
      if (k >= excl && k < excl + mine) {
        // ---- commit: the owner updates its node row --------------------
        unsigned m = lbest;
        for (int i = 0; i < k - excl; ++i) m &= m - 1;  // drop lower best bits
        const int n = n0 + __ffs(m) - 1;
        for (int r = 0; r < s.R; ++r) fit[r * N + n] += row[r];
        for (int w = 0; w < s.Wp; ++w) ports[w * N + n] |= row[o_ports + w];
        for (int w = 0; w < s.Wd; ++w) pds[w * N + n] |= row[o_pds + w];
        const unsigned member = (unsigned)row[o_member];
        for (int g = 0; g < s.G; ++g) {
          if (!((member >> g) & 1u)) continue;
          counts[g * N + n] += 1;
          if constexpr (kAff) {
            // the group's first peer anchors it at this node's values
            if (!sh_has[g]) {
              for (int l = 0; l < L; ++l) sh_anchor[g * L + l] = affv[l * N + n];
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

using CommitKernel =
    decltype(&commit_solve_kernel<false, false, false, false, false>);

// instance I: bit 0 kAff, bit 1 kAnti, bit 2 kGang, bit 3 kStatic,
// bit 4 kShared
template <int I>
constexpr CommitKernel instance() {
  return &commit_solve_kernel<(I & 1) != 0, (I & 2) != 0, (I & 4) != 0,
                              (I & 8) != 0, (I & 16) != 0>;
}

template <int... I>
constexpr std::array<CommitKernel, sizeof...(I)> instances(
    std::integer_sequence<int, I...>) {
  return {instance<I>()...};
}

// Bytes of dynamic shared memory a wave takes: the two-row mask ring, and
// the packed state planes when they live on chip. Mirrors
// commit_solver.shared_layout.
long long shared_bytes(int N, int pitch, int R, int Wp, int Wd, int G,
                       int on_chip) {
  const long long state = on_chip ? 4LL * (R + Wp + Wd) * N + 2LL * G * N : 0;
  return 2LL * pitch + state;
}

}  // namespace

extern "C" {

// One wave. Pointers are device pointers; the wrapper allocates the global
// state (global layout only; null otherwise), the gang checkpoint (gang
// waves only; null otherwise) and the outputs. ``dyn_bytes`` is the dynamic
// shared memory the wrapper reckoned for the layout; it must agree.
// Returns a cudaError_t (0 = launched).
int kgpu_commit_solve(const void* smask, const void* podrow, const void* cap,
                      const void* fit0, const void* off, const void* advx,
                      const void* fitexc, const void* ports0, const void* pds0,
                      const void* counts0, const void* offl, const void* sstat,
                      const void* affv, const void* anchor0, const void* has0,
                      const void* zone, void* gstate, void* ck, void* chosen,
                      void* win, int P, int N, int pitch, int R, int Wp,
                      int Wd, int G, int L, int A, int V, int row, int flags,
                      int w_lr, int w_spread, int w_equal, int w_anti0,
                      int w_anti1, int w_anti2, int w_anti3, int on_chip,
                      long long dyn_bytes, void* stream) {
  if (P < 0 || N < 0 || N > kThreads * kMaxChunk || R < 0 || R > kMaxR ||
      Wp < 0 || Wp > kMaxW || Wd < 0 || Wd > kMaxW || G < 0 || G > kMaxG ||
      L < 0 || L > kMaxL || A < 0 || A > kMaxA || V < 0 || V > kMaxV ||
      row != R + Wp + Wd + 6 + L || pitch % 16 != 0 || pitch < N ||
      pitch >= N + 16 || (!on_chip && !gstate) ||
      ((flags & kGangs) && !ck) ||
      dyn_bytes != shared_bytes(N, pitch, R, Wp, Wd, G, on_chip))
    return (int)cudaErrorInvalidValue;
  static const auto kernels =
      instances(std::make_integer_sequence<int, 32>{});
  const int which = (L > 0) | (A > 0) << 1 | ((flags & kGangs) != 0) << 2 |
                    ((flags & kUseStatic) != 0) << 3 | (on_chip != 0) << 4;
  const CommitKernel kernel = kernels[which];
  // static + dynamic shared memory must fit what one block may opt in to
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  if ((long long)attr.sharedSizeBytes + dyn_bytes > optin)
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dyn_bytes);
  if (err != cudaSuccess) return (int)err;
  const Shape s{P, N, R, Wp, Wd, G, L, A, V, row, pitch, flags,
                w_lr, w_spread, w_equal,
                {w_anti0, w_anti1, w_anti2, w_anti3}};
  kernel<<<1, kThreads, (size_t)dyn_bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)smask, (const int*)podrow, (const int*)cap,
      (const int*)fit0, (const int*)off, (const uint8_t*)advx,
      (const uint8_t*)fitexc, (const int*)ports0, (const int*)pds0,
      (const int*)counts0, (const int*)offl, (const int*)sstat,
      (const int*)affv, (const int*)anchor0, (const uint8_t*)has0,
      (const int*)zone, (unsigned char*)gstate, (unsigned char*)ck,
      (int*)chosen, (int*)win, s);
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
