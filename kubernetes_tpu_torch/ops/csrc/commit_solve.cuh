// commit_solve.cuh — the sequential-commit wave solve, hand-written for
// Hopper (sm_90a): the kernel template, included by the source files that
// instantiate it (commit_solve_*.cu) and by the C interface
// (commit_solve.cu).
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
// Its domain is wider than the Pallas kernel's, which turns these waves
// away to the reference's XLA scan (pallas_solver.py:90-157; the scan is
// solve_jit, kubernetes_tpu/models/batch_solver.py:398, :676-790); this
// kernel solves them with the scan's decisions:
// - int64 resource planes (Res = long long): the resource filter, the
//   LeastRequested division and the commit run in 64 bits;
// - preemption waves (kPre, B > 0 priority bands): a pod that finds no
//   node may evict, on one node, every resident pod of the bands up to a
//   threshold below its priority (models/preempt.py has the rule);
// - large clusters (kLarge): up to 65,536 nodes, 1,024 service groups and
//   peer totals below 2^24. Each thread owns up to 64 nodes, one bit each
//   in a 64-bit mask; the pod row carries ceil(G/32) words of member bits;
//   the peer counts are int32 (Cnt = int) where a total may reach 2^15,
//   else int16; the affinity anchors live in dynamic shared memory after
//   the mask ring, sized by the wave's G and L. These instances fix every
//   extension on (kPre, kAff, kAnti, kGang, kStatic), decide them at run
//   time as the int64 instances do, and launch one wave at a time.
//
// Design. One launch per wave, one block of 1024 threads on one SM; the pod
// loop runs inside the kernel. Thread t owns a CONTIGUOUS chunk of
// ceil(N/1024) nodes (at most 32, one bit each in a 32-bit mask; 64 in a
// 64-bit mask in the kLarge instances), so the
// k-th best node in node order is found by a block exclusive scan of
// per-thread best counts — this replaces the TPU kernel's triangular-matmul
// prefix ranks. Only the owner ever reads or writes a node's mutable state
// (fit usage, port/PD words, peer counts, evictable bands), so the commit
// needs no barrier: a pod costs three block barriers (filter reductions,
// score max, count scan), and two more when it preempts.
//
// A batched launch (commit_solver.solve_commit_batch: the waves the solver
// daemon coalesced, the reference's vmap axis) runs k waves of one shape as
// k blocks of one grid, one SM each; the blocks share nothing, and each
// offsets every plane pointer by its wave once, at entry. The offsets are a
// template flag (kBatch) with instances of their own: held in registers,
// the per-wave plane pointers cost the 64-register pod loop 3-6% (measured
// on north_star and binpack3), so a single wave keeps the instance that
// reads its pointers straight from the kernel's parameters.
//
// Where the state lives. As the TPU kernel kept its node state in VMEM,
// this one keeps it in the block's dynamic shared memory whenever it fits
// the 227 KB a block may have: the [R, N] fit usage and [B, R, N] evictable
// capacity in the resource type, the [Wp + Wd + B, N] int32 port words, PD
// words and evictable counts, and the [G, N] peer counts as int16 (every
// count stays below 2^15; int32 in the kLarge instances whose totals reach
// it). The all-pods usage is not a
// plane of its own: every commit and every rollback moves it with the fit
// usage, so it is fit + off, where off = score0 - fit0 is a read-only
// input. A wave whose state does not fit (e.g. 32,640 nodes, or 32 bands)
// keeps the same planes, in the same packed layout, in a global buffer the
// wrapper allocates. Both layouts run the same source; the layout is a
// template flag, so the on-chip instance addresses the state as shared
// memory instead of through a generic pointer. The host picks the layout
// from the shapes (commit_solver.shared_layout).
//
// The static mask row and the pod row of pod p+1 are fetched with cp.async
// into rings in shared memory while pod p runs; each thread waits for its
// copies before pod p's count-scan barrier, which then publishes the rows.
// No thread waits on HBM or L2 at the start of a pod. The filter issues a
// node's loads before it combines them, and skips the port and PD words
// when the pod (uniformly across the block) has none.
//
// Each extension branch is a template flag of the kernel, and the host
// launches the instance the wave's policy needs: a default-policy int32
// wave runs none of the code below. The instances of the wider domain
// (int64 or kPre) fix only the resource type, preemption, gangs and the
// layout, and take the rarer extensions (anchors, zones, the label plane)
// as run-time flags: kAff, kAnti and kStatic are set and the code checks L,
// A and kUseStatic. The extensions add shared state and barriers:
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
//   The evictable bands are state, so a rollback restores them too.
// - Preemption runs only for a pod that found no node and may preempt (the
//   reference computes it for every pod and discards it otherwise). Band
//   slots are not sorted (the incremental encoder keeps them in arrival
//   order), so the host passes the slots in ascending band value (bord),
//   and a node's candidates are the prefixes of that order below the pod's
//   priority; equal values form one group and are evaluated together. The
//   freed capacity of a prefix grows with it, so per dimension the first
//   sufficient group is found by one running sum, and the node's threshold
//   is the largest of those: O(B R) a node. The nodes with the fewest
//   victims are then selected by the same max / count-scan / k-th step as
//   a normal placement, on 2^30 - victims.
//
// Bound. Counting each input byte once, a 10,000-pod x 5,000-node wave moves
// about 50 MB (the uint8 static mask dominates): ~15 us at 3.35 TB/s. The
// kernel sits far above that: what bounds it is the serial chain of pods,
// each paying three or four block-wide barriers and the per-node filter and
// score arithmetic of one SM.
//
// Arithmetic. The int32 instances compute in 32 bits: LeastRequested
// divides in int32 (batch_solver keeps int32 planes only where capacities
// and running sums stay below 2^31/10), and the spread score is the
// reference's own float32 expression with IEEE round-to-nearest-even steps.
// The int64 instances keep the resource arithmetic in 64 bits, with a true
// 64-bit division in LeastRequested (the reference's _calculate_score; its
// magic multiply is for int32 only). Spread and zone counts stay int32 in
// both, and the tie-break takes the 64-bit FNV hash modulo the count. C's
// '/' truncates where Python and torch floor; every division below has a
// non-negative numerator and a positive divisor, so the two agree.

#pragma once

#include <array>
#include <cstdint>
#include <type_traits>
#include <utility>

#include <cuda_runtime.h>

namespace kgpu {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 32;  // nodes a thread owns (kLarge: 64)
constexpr int kMaxLargeChunk = 64;
constexpr int kMaxR = 8;
constexpr int kMaxW = 8;
constexpr int kMaxG = 31;        // groups: one member word, static anchors
constexpr int kMaxLargeG = 1024; // kLarge: a member word per 32 groups
constexpr int kMaxA = 4;   // anti-affinity labels
constexpr int kMaxV = 64;  // zones per anti-affinity label
constexpr int kMaxL = 4;   // service-affinity labels
constexpr int kMaxB = 32;  // priority bands
constexpr int kMaxBatch = 1024;  // waves in one batched launch
constexpr int kRowFixed = 7;  // tie_hi tie_lo gid member zreq unit prio
// longest pod row: int64 requests take two words each
constexpr int kMaxRow = 2 * kMaxR + 2 * kMaxW + kRowFixed + kMaxL;
constexpr int kMaxLargeRow = kMaxRow - 1 + kMaxLargeG / 32;
constexpr int kPreemptBig = 1 << 30;  // preemption selects on this - cost
constexpr int kPreemptScoreBase = -2;  // a preempting pod scores this - slot
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
constexpr int kCanPreempt = 4;  // the pod's PreemptionPolicy allows it

struct Shape {
  int P, N, R, Wp, Wd, G, L, A, V, B, row;
  int pitch;  // bytes per static-mask row: N rounded up to 16
  int flags, w_lr, w_spread, w_equal;
  int w_anti[kMaxA];  // weight of each anti-affinity label
};

// The device pointers of one wave, as the C interface receives them.
struct Planes {
  const uint8_t* smask;
  const int* podrow;
  const void* cap;
  const void* fit0;
  const void* off;
  const uint8_t* advx;
  const uint8_t* fitexc;
  const int* ports0;
  const int* pds0;
  const int* counts0;
  const int* offl;
  const int* sstat;
  const int* affv;
  const int* anchor0;
  const uint8_t* has0;
  const int* zone;
  const void* ecap0;
  const int* ecnt0;
  const int* band;
  const int* bord;
  unsigned char* gstate;
  unsigned char* ck;
  int* chosen;
  int* win;
};

// Bytes of the packed state: [R + B*R, N] resource-type planes (fit usage,
// evictable capacity), [Wp + Wd + B, N] int32 planes (port words, PD words,
// evictable counts), [G, N] peer counts of cnt_bytes each (int16, or int32
// in a kLarge instance whose totals may reach 2^15). Mirrors
// commit_solver.state_bytes.
__host__ __device__ inline long long state_bytes(int N, int R, int Wp,
                                                 int Wd, int G, int B,
                                                 int res_bytes,
                                                 int cnt_bytes = 2) {
  return (long long)res_bytes * (R + B * R) * N + 4LL * (Wp + Wd + B) * N +
         (long long)cnt_bytes * G * N;
}

// Bytes from one wave's packed state to the next in a batched launch (the
// global state and the gang checkpoint): state_bytes rounded up to 16, so
// every wave's planes are as aligned as the first wave's (an odd G * N
// leaves state_bytes 2 mod 4). Batched waves count peers in int16 (a
// kLarge wave launches alone). Mirrors commit_solver.state_stride.
__host__ __device__ inline long long state_stride(int N, int R, int Wp,
                                                  int Wd, int G, int B,
                                                  int res_bytes) {
  return (state_bytes(N, R, Wp, Wd, G, B, res_bytes) + 15) / 16 * 16;
}

// int32 words of member bits in a pod row: one per 32 groups, at least one.
__host__ __device__ inline int member_words(int G) {
  return G > 32 ? (G + 31) / 32 : 1;
}

// Bytes of a kLarge instance's anchor block in dynamic shared memory, after
// the mask ring: the [G, L] anchor values, the [G] has-anchor flags, and
// their gang checkpoint; none without affinity labels. Mirrors
// commit_solver.anchor_bytes.
__host__ __device__ inline long long anchor_bytes(int G, int L) {
  return L > 0 ? 4LL * (2 * G * L + 2 * G) : 0;
}

// The packed state's planes, in order; plane k of a group starts at k * N.
template <class Res, class Cnt>
struct State {
  Res* fit;     // [R, N]
  Res* ecap;    // [B, R, N]
  int* ports;   // [Wp, N]
  int* pds;     // [Wd, N]
  int* ecnt;    // [B, N]
  Cnt* counts;  // [G, N]
};

template <class Res, class Cnt>
__device__ __forceinline__ State<Res, Cnt> state_of(unsigned char* base,
                                                    const Shape& s, int B) {
  State<Res, Cnt> st;
  st.fit = reinterpret_cast<Res*>(base);
  st.ecap = st.fit + s.R * s.N;
  st.ports = reinterpret_cast<int*>(st.ecap + B * s.R * s.N);
  st.pds = st.ports + s.Wp * s.N;
  st.ecnt = st.pds + s.Wd * s.N;
  st.counts = reinterpret_cast<Cnt*>(st.ecnt + B * s.N);
  return st;
}

// Copy this thread's columns [n0, n0+own) of every state plane between two
// packed layouts: the gang checkpoint and rollback. Out of line, because
// inlined in the pod loop it would hold registers across the loop.
template <class Res, class Cnt>
__device__ __noinline__ void copy_owned(unsigned char* dst,
                                        unsigned char* src, const Shape& s,
                                        int B, int n0, int own) {
  const State<Res, Cnt> d = state_of<Res, Cnt>(dst, s, B);
  const State<Res, Cnt> c = state_of<Res, Cnt>(src, s, B);
  const int N = s.N;
  for (int k = 0; k < s.R + B * s.R; ++k)
    for (int j = 0; j < own; ++j) d.fit[k * N + n0 + j] = c.fit[k * N + n0 + j];
  for (int k = 0; k < s.Wp + s.Wd + B; ++k)
    for (int j = 0; j < own; ++j)
      d.ports[k * N + n0 + j] = c.ports[k * N + n0 + j];
  for (int g = 0; g < s.G; ++g)
    for (int j = 0; j < own; ++j)
      d.counts[g * N + n0 + j] = c.counts[g * N + n0 + j];
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
// the node has no capacity or the pod would overfill it. The numerator lies
// in [0, 10c] and the divisor is positive; in int32 batch_solver keeps 10c
// below 2^31, in int64 the division is a 64-bit one.
template <class Res>
__device__ __forceinline__ unsigned least_requested(Res c, Res tot) {
  if (c == 0 || tot > c) return 0;
  using U = std::make_unsigned_t<Res>;
  return (unsigned)((U)((c - tot) * 10) / (U)c);
}

// A thread's node mask: 32 bits, or 64 in the kLarge instances.
__device__ __forceinline__ int mask_popc(unsigned m) { return __popc(m); }
__device__ __forceinline__ int mask_popc(unsigned long long m) {
  return __popcll(m);
}
__device__ __forceinline__ int mask_ffs(unsigned m) { return __ffs(m); }
__device__ __forceinline__ int mask_ffs(unsigned long long m) {
  return __ffsll((long long)m);
}

// Request r of the pod row: one word, or for int64 two (low word first).
template <class Res, class RowPtr>
__device__ __forceinline__ Res req_of(RowPtr row, int r) {
  if constexpr (sizeof(Res) == 4) {
    return row[r];
  } else {
    return (Res)(((unsigned long long)(unsigned)row[2 * r + 1] << 32) |
                 (unsigned)row[2 * r]);
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
// row into row slot q % 3 (slots of kRowCap words); every thread copies its
// pieces (16 bytes of the mask, or one word of the pod row) and later waits
// for them itself. The pod row takes three slots because the committing
// thread still reads pod q-2's row while the others start fetching pod q's.
template <int kRowCap>
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
    cp_async4(rows + (q % 3) * kRowCap + w, podrow + (size_t)q * s.row + w);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The preemption threshold of node n for a pod with request row ``row``:
// the group-end rank k (into the ascending band order ``bord``, whose
// values are ``bval``) of the smallest band prefix whose eviction frees
// enough on every dimension, or -1 when even all ``nb`` bands below the
// pod's priority do not. Per dimension the freed capacity grows with the
// prefix, so the first sufficient group end is found by one running sum;
// the node's threshold is the largest of those. Dimensions 0 and 1 are
// unconstrained at zero capacity, as in the filter. Out of line, like
// copy_owned: it runs only for pods that found no node.
template <class Res>
__device__ __noinline__ int preempt_rank(int n, const Shape& s, int nb,
                                         const int* bval, const int* bord,
                                         const Res* cap, const Res* fit,
                                         const Res* ecap, const int* row) {
  if (nb <= 0) return -1;
  const int N = s.N;
  int kstar = 0;  // the end of the first group
  while (kstar + 1 < nb && bval[kstar + 1] == bval[0]) ++kstar;
  for (int r = 0; r < s.R; ++r) {
    const Res c = cap[r * N + n];
    if (r < 2 && c == 0) continue;
    const Res need = req_of<Res>(row, r) - (c - fit[r * N + n]);
    if (need <= 0) continue;
    Res freed = 0;
    int k = 0;
    for (; k < nb; ++k) {
      freed += ecap[(bord[k] * s.R + r) * N + n];
      if (k + 1 < nb && bval[k + 1] == bval[k]) continue;  // inside a group
      if (freed >= need) break;
    }
    if (k >= nb) return -1;
    kstar = max(kstar, k);
  }
  return kstar;
}

// The victims of evicting ranks [0, kstar] on node n.
__device__ __forceinline__ int preempt_cost(int n, int N, int kstar,
                                            const int* bord,
                                            const int* ecnt) {
  int cost = 0;
  for (int k = 0; k <= kstar; ++k) cost += ecnt[bord[k] * N + n];
  return cost;
}

template <class Mask>
struct PreemptBest {
  int top;    // this thread's best kPreemptBig - cost, or -1
  Mask best;  // bit j: node n0 + j reaches it
};

// The preemption pass over this thread's nodes that pass every filter but
// the resource fit (``cand``) and are not pre-exceeded.
template <class Res, class Mask>
__device__ __noinline__ PreemptBest<Mask> preempt_pass(
    Mask cand, int n0, const Shape& s, int nb, const int* bval,
    const int* bord, const Res* cap, const uint8_t* fitexc, const Res* fit,
    const Res* ecap, const int* ecnt, const int* row) {
  PreemptBest<Mask> pb{-1, 0u};
  while (cand) {
    const int j = mask_ffs(cand) - 1;
    cand &= cand - 1;
    const int n = n0 + j;
    if (fitexc[n]) continue;
    const int k = preempt_rank<Res>(n, s, nb, bval, bord, cap, fit, ecap, row);
    if (k < 0) continue;
    const int v = kPreemptBig - preempt_cost(n, s.N, k, bord, ecnt);
    if (v > pb.top) {
      pb.top = v;
      pb.best = (Mask)1 << j;
    } else if (v == pb.top) {
      pb.best |= (Mask)1 << j;
    }
  }
  return pb;
}

// The branch set is fixed at compile time, so a wave pays only for the
// branches its policy uses: Res = the resource type (int or long long),
// kPre = preemption (B > 0 bands), kAff = ServiceAffinity anchors (L > 0),
// kAnti = ServiceAntiAffinity zones (A > 0), kGang = gang checkpoint and
// rollback, kStatic = the NodeLabelPriority plane; kShared = the state lives
// in dynamic shared memory (else in gstate); kBatch = block b solves wave b
// of [batch, ...] stacks; kLarge = the large-cluster domain (64-bit node
// masks, member words, anchors in dynamic shared memory) with peer counts
// of type Cnt. The host picks the instance; the wide-domain instances set
// kAff, kAnti and kStatic and let L, A and kUseStatic decide at run time.
template <class Res, bool kPre, bool kAff, bool kAnti, bool kGang,
          bool kStatic, bool kShared, bool kBatch, bool kLarge = false,
          class Cnt = short>
__global__ void __launch_bounds__(kThreads, 1) commit_solve_kernel(
    const uint8_t* __restrict__ smask,   // [P, pitch] static feasibility
    const int* __restrict__ podrow,      // [P, row] packed pod rows
    const Res* __restrict__ cap,         // [R, N]
    const Res* __restrict__ fit0,        // [R, N] greedy-fitting usage
    const Res* __restrict__ off,         // [R, N] all-pods minus fit usage
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
    const Res* __restrict__ ecap0,       // [B, R, N] evictable capacity
    const int* __restrict__ ecnt0,       // [B, N] evictable pods
    const int* __restrict__ band,        // [B] band values by slot
    const int* __restrict__ bord,        // [B] slots by ascending value
    unsigned char* __restrict__ gstate,  // packed state (global layout only)
    unsigned char* __restrict__ ck,      // packed gang checkpoint (kGang)
    int* __restrict__ chosen, int* __restrict__ win, const Shape s) {
  static_assert(kLarge || std::is_same_v<Cnt, short>,
                "int32 peer counts are the kLarge instances' alone");
  static_assert(!(kLarge && kBatch), "kLarge waves launch one at a time");
  // A batched launch runs one wave per block, every wave of one shape: each
  // plane is a [batch, ...] stack, and block b reads and writes item b. The
  // offsets are taken once here.
  if constexpr (kBatch) {
    const size_t b = blockIdx.x;
    const size_t nn = (size_t)s.N;
    const size_t ps = (size_t)s.P;
    smask += b * ps * s.pitch;
    podrow += b * ps * s.row;
    cap += b * s.R * nn;
    fit0 += b * s.R * nn;
    off += b * s.R * nn;
    advx += b * s.R * nn;
    fitexc += b * nn;
    ports0 += b * s.Wp * nn;
    pds0 += b * s.Wd * nn;
    counts0 += b * s.G * nn;
    offl += b * s.G;
    if (s.flags & kUseStatic) sstat += b * nn;
    affv += b * s.L * nn;
    anchor0 += b * s.G * s.L;
    has0 += b * s.G;
    zone += b * s.A * nn;
    ecap0 += b * s.B * s.R * nn;
    ecnt0 += b * s.B * nn;
    band += b * s.B;
    bord += b * s.B;
    const size_t sb =
        (size_t)state_stride(s.N, s.R, s.Wp, s.Wd, s.G, s.B, sizeof(Res));
    if constexpr (!kShared) gstate += b * sb;
    if constexpr (kGang) ck += b * sb;
    chosen += b * ps;
    win += b * ps;
  }
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int N = s.N;
  const int chunk = (N + kThreads - 1) / kThreads;
  const int n0 = min(t * chunk, N);
  const int own = min(n0 + chunk, N) - n0;  // this thread's nodes [n0, n0+own)
  const int L = kAff ? s.L : 0;
  const int A = kAnti ? s.A : 0;
  const int B = kPre ? s.B : 0;
  // requests take one int32 word each, or two in int64
  constexpr int kReqWords = sizeof(Res) / 4;
  // a thread's node mask, its pod-row slots, and the row's member words
  using Mask = std::conditional_t<kLarge, unsigned long long, unsigned>;
  constexpr int kRowCap = kLarge ? kMaxLargeRow : kMaxRow;
  const int Mw = kLarge ? member_words(s.G) : 1;

  __shared__ unsigned sh_adv[kWarps];
  __shared__ int sh_cmax[kWarps];
  __shared__ int sh_num[kWarps];
  __shared__ int sh_top[kWarps];
  __shared__ int sh_cnt[kWarps];
  __shared__ int sh_zone[kMaxA * kMaxV];  // the pod's feasible peers per zone
  // the anchors and their checkpoint (kLarge: in dynamic shared memory)
  __shared__ int sh_anchor[kLarge ? 1 : kMaxG * kMaxL];
  __shared__ int sh_has[kLarge ? 1 : kMaxG];
  __shared__ int sh_ck_anchor[kLarge ? 1 : kMaxG * kMaxL];
  __shared__ int sh_ck_has[kLarge ? 1 : kMaxG];
  __shared__ int sh_w_anti[kMaxA];
  __shared__ int sh_rows[3 * kRowCap];  // pod-row ring
  __shared__ int sh_bval[kPre ? kMaxB : 1];  // band values, ascending
  __shared__ int sh_bord[kPre ? kMaxB : 1];  // their slots
  // [2, pitch] mask ring, then (kLarge) the anchor block, then the packed
  // state when it lives on chip
  extern __shared__ __align__(16) unsigned char dsm[];
  unsigned char* const ring = dsm;
  int* const anchors =
      kLarge ? reinterpret_cast<int*>(dsm + 2 * s.pitch) : sh_anchor;
  int* const has = kLarge ? anchors + s.G * L : sh_has;
  int* const ck_anchors = kLarge ? has + s.G : sh_ck_anchor;
  int* const ck_has = kLarge ? ck_anchors + s.G * L : sh_ck_has;
  // kLarge without affinity labels keeps no anchor block (anchor_bytes)
  const bool use_has = !kLarge || L > 0;
  unsigned char* const base =
      kShared ? dsm + 2 * s.pitch + (kLarge ? anchor_bytes(s.G, L) : 0)
              : gstate;
  const State<Res, Cnt> st = state_of<Res, Cnt>(base, s, B);
  Res* const fit = st.fit;
  Res* const ecap = st.ecap;
  int* const ports = st.ports;
  int* const pds = st.pds;
  int* const ecnt = st.ecnt;
  Cnt* const counts = st.counts;

  // copy the owned columns of the state in; only this thread touches them
  for (int j = 0; j < own; ++j) {
    const int n = n0 + j;
    for (int r = 0; r < s.R; ++r) fit[r * N + n] = fit0[r * N + n];
    for (int w = 0; w < s.Wp; ++w) ports[w * N + n] = ports0[w * N + n];
    for (int w = 0; w < s.Wd; ++w) pds[w * N + n] = pds0[w * N + n];
    for (int g = 0; g < s.G; ++g)
      counts[g * N + n] = (Cnt)counts0[g * N + n];
    if constexpr (kPre) {
      for (int k = 0; k < B * s.R; ++k) ecap[k * N + n] = ecap0[k * N + n];
      for (int b = 0; b < B; ++b) ecnt[b * N + n] = ecnt0[b * N + n];
    }
  }
  const int GL = s.G * L;
  if constexpr (kAff) {
    for (int i = t; i < GL; i += kThreads) anchors[i] = anchor0[i];
    if (use_has)
      for (int i = t; i < s.G; i += kThreads) has[i] = has0[i];
  }
  if constexpr (kAnti) {
    for (int i = t; i < A * s.V; i += kThreads) sh_zone[i] = 0;
    if (t < kMaxA) sh_w_anti[t] = s.w_anti[t];
  }
  if constexpr (kPre) {
    if (t < B) {
      sh_bord[t] = bord[t];
      sh_bval[t] = band[bord[t]];
    }
  }
  if (s.P > 0) fetch_pod<kRowCap>(ring, sh_rows, smask, podrow, 0, s);
  cp_async_wait_all();
  __syncthreads();

  const bool use_res = s.flags & kUseResources;
  const bool use_ports = s.flags & kUsePorts;
  const bool use_disk = s.flags & kUseDisk;
  const bool use_static = kStatic && (s.flags & kUseStatic);
  // podrow layout: req[R] (in kReqWords words each) | ports[Wp] | pds[Wd] |
  // tie_hi tie_lo | gid | member bits[Mw] | zero-request flag | unit |
  // priority | pinned affinity codes[L]
  const int o_ports = s.R * kReqWords;
  const int o_pds = o_ports + s.Wp;
  const int o_tie = o_pds + s.Wd;
  const int o_gid = o_tie + 2;
  const int o_member = o_gid + 1;  // Mw words
  const int o_zreq = o_member + Mw;
  const int o_unit = o_zreq + 1;
  const int o_prio = o_zreq + 2;
  const int o_pins = o_zreq + 3;

  bool failed = false;  // a member of the current gang run found no node
  for (int p = 0; p < s.P; ++p) {
    // the next pod's mask row and pod row stream in while this pod runs
    if (p + 1 < s.P)
      fetch_pod<kRowCap>(ring, sh_rows, smask, podrow, p + 1, s);
    const unsigned char* srow = ring + (p & 1) * s.pitch;
    // The on-chip anti-affinity instance reads the pod row again at each
    // use: holding its words in registers across the zone pass spills there
    // (64 registers a thread); the others keep them.
    using RowPtr = std::conditional_t<kAnti && kShared, const volatile int*,
                                      const int*>;
    const RowPtr row = sh_rows + (p % 3) * kRowCap;
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
        copy_owned<Res, Cnt>(ck, base, s, B, n0, own);
        // the same thread copies back on rollback: no barrier needed here
        if constexpr (kAff) {
          for (int i = t; i < GL; i += kThreads) ck_anchors[i] = anchors[i];
          if (use_has)
            for (int i = t; i < s.G; i += kThreads) ck_has[i] = has[i];
        }
      }
    }
    // anchor-derived affinity (predicates.go:256-276): bit l set when label
    // l was not pinned by the selector and the group's anchor has a value
    unsigned need = 0;
    if constexpr (kAff) {
      if (use_has && gid >= 0 && has[gid]) {
        for (int l = 0; l < L; ++l)
          if (row[o_pins + l] == -2 && anchors[gid * L + l] >= 0)
            need |= 1u << l;
      }
    }

    // ---- filter (and the per-pod reductions it feeds) -------------------
    // Every word a node's verdict needs is loaded before any is tested, so
    // the loads of one node overlap instead of forming a chain.
    Mask feas = 0;      // bit j: node n0 + j is feasible
    Mask nres = 0;      // bit j: ... passes every filter but the resources
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
          if ((need >> l) & 1u) ok &= affv[l * N + n] == anchors[gid * L + l];
      }
      bool res_ok = true;  // the resource fit, kept apart only for kPre
      if (check_res) {
        bool fits = fitexc[n] == 0;
#pragma unroll
        for (int r = 0; r < kUnrollR; ++r) {
          if (r < s.R) {
            const Res c = cap[r * N + n];
            // cpu and memory (dims 0, 1) are unconstrained at zero capacity
            fits &= (c - fit[r * N + n] >= req_of<Res>(row, r)) |
                    (r < 2 && c == 0);
          }
        }
        for (int r = kUnrollR; r < s.R; ++r)
          fits &= cap[r * N + n] - fit[r * N + n] >= req_of<Res>(row, r);
        if constexpr (kPre) {
          res_ok = fits;
        } else {
          ok &= fits;
        }
      }
      if (pod_ports) {
        for (int w = 0; w < s.Wp; ++w)
          ok &= (ports[w * N + n] & row[o_ports + w]) == 0;
      }
      if (pod_pds) {
        for (int w = 0; w < s.Wd; ++w)
          ok &= (pds[w * N + n] & row[o_pds + w]) == 0;
      }
      if constexpr (kPre) {
        nres |= (Mask)ok << j;
        ok &= res_ok;
      }
      if (ok) {
        feas |= (Mask)1 << j;
        for (int r = 2; r < s.R; ++r)
          if (advx[r * N + n]) adv |= 1u << r;
      }
    }
    // the pod's peers over the owned nodes, in a pass of their own: the
    // spread max, and for anti-affinity the total and the per-zone sums
    // over the feasible nodes
    if (gid >= 0) {
      const Cnt* crow = counts + gid * N;
      for (int j = 0; j < own; ++j) {
        const int c = crow[n0 + j];
        cmax = max(cmax, c);
        if constexpr (kAnti) {
          csum += c;
          if (!c || !((feas >> j) & 1)) continue;
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
    Mask lbest = 0;
    for (int j = 0; j < own; ++j) {
      if (!((feas >> j) & 1)) continue;
      const int n = n0 + j;
      int sc = 0;
      if (s.w_lr) {
        // all-pods usage = fit + off
        unsigned raw = 0;
#pragma unroll
        for (int r = 0; r < kUnrollR; ++r) {
          if (r < s.R) {
            const int i = r * N + n;
            raw += least_requested<Res>(cap[i],
                                        fit[i] + off[i] + req_of<Res>(row, r));
          }
        }
        for (int r = kUnrollR; r < s.R; ++r) {
          const int i = r * N + n;
          raw += least_requested<Res>(cap[i],
                                      fit[i] + off[i] + req_of<Res>(row, r));
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
      if (use_static) sc += sstat[n];
      sc += s.w_equal;
      if (sc > lmax) {
        lmax = sc;
        lbest = (Mask)1 << j;
      } else if (sc == lmax) {
        lbest |= (Mask)1 << j;
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
    const int mine = (top >= 0 && lmax == top) ? mask_popc(lbest) : 0;
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
    // the pod's 64-bit FNV-1a hash, read where a placement is taken
    auto tie_hash = [&]() {
      return ((unsigned long long)(unsigned)row[o_tie] << 32) |
             (unsigned)row[o_tie + 1];
    };

    // the owner's commit of a placement at node n; a preemption's evicted
    // ranks [0, kstar] leave both usages and the band planes
    const int* const border = sh_bord;
    // group g gains a peer at node n
    auto join = [&](int g, int n) {
      counts[g * N + n] += 1;
      if constexpr (kAff) {
        // the group's first peer anchors it at this node's values
        if (use_has && !has[g]) {
          for (int l = 0; l < L; ++l) anchors[g * L + l] = affv[l * N + n];
          has[g] = 1;
        }
      }
    };
    auto commit = [&](int n, int kstar) {
      if constexpr (kPre) {
        for (int r = 0; r < s.R; ++r) {
          Res freed = 0;
          for (int k = 0; k <= kstar; ++k)
            freed += ecap[(border[k] * s.R + r) * N + n];
          fit[r * N + n] += req_of<Res>(row, r) - freed;
        }
        for (int k = 0; k <= kstar; ++k) {
          const int b = border[k];
          for (int r = 0; r < s.R; ++r) ecap[(b * s.R + r) * N + n] = 0;
          ecnt[b * N + n] = 0;
        }
      } else {
        for (int r = 0; r < s.R; ++r) fit[r * N + n] += req_of<Res>(row, r);
      }
      for (int w = 0; w < s.Wp; ++w) ports[w * N + n] |= row[o_ports + w];
      for (int w = 0; w < s.Wd; ++w) pds[w * N + n] |= row[o_pds + w];
      if constexpr (kLarge) {
        for (int wi = 0; wi < Mw; ++wi) {
          unsigned bits = (unsigned)row[o_member + wi];
          while (bits) {
            join(wi * 32 + __ffs(bits) - 1, n);
            bits &= bits - 1;
          }
        }
      } else {
        const unsigned member = (unsigned)row[o_member];
        for (int g = 0; g < s.G; ++g) {
          if (!((member >> g) & 1u)) continue;
          join(g, n);
        }
      }
    };

    // ---- preemption: no node fits and the pod may evict ----------------
    // (batch_solver.py:676-732; every condition below is block-uniform)
    int ptotal = 0;
    if constexpr (kPre) {
      const int prio = row[o_prio];
      if (total == 0 && B > 0 && use_res && !failed &&
          (row[o_unit] & kCanPreempt)) {
        int nb = 0;  // bands strictly below the pod's priority
        while (nb < B && sh_bval[nb] < prio) ++nb;
        const int* prow = const_cast<const int*>(row);
        const PreemptBest<Mask> pb = preempt_pass<Res, Mask>(
            nb ? nres : (Mask)0, n0, s, nb, sh_bval, sh_bord, cap, fitexc,
            fit, ecap, ecnt, prow);
        int ptop = __reduce_max_sync(kFull, pb.top);
        if (lane == 0) sh_top[warp] = ptop;
        __syncthreads();
        ptop = -1;
        for (int i = 0; i < kWarps; ++i) ptop = max(ptop, sh_top[i]);
        const int pmine =
            (ptop >= 0 && pb.top == ptop) ? mask_popc(pb.best) : 0;
        int pincl = pmine;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(kFull, pincl, o);
          if (lane >= o) pincl += v;
        }
        if (lane == 31) sh_cnt[warp] = pincl;
        __syncthreads();
        int pbefore = 0;
        for (int i = 0; i < kWarps; ++i) {
          const int v = sh_cnt[i];
          pbefore += i < warp ? v : 0;
          ptotal += v;
        }
        if (ptotal > 0 && pmine) {
          const int k = (int)(tie_hash() % (unsigned long long)ptotal);
          const int excl = pbefore + pincl - pmine;
          if (k >= excl && k < excl + pmine) {
            Mask m = pb.best;
            for (int i = 0; i < k - excl; ++i) m &= m - 1;
            const int n = n0 + mask_ffs(m) - 1;
            const int kstar = preempt_rank<Res>(n, s, nb, sh_bval, sh_bord,
                                                cap, fit, ecap, prow);
            // report the threshold group's first slot
            int gs = kstar;
            while (gs > 0 && sh_bval[gs - 1] == sh_bval[kstar]) --gs;
            commit(n, kstar);
            chosen[p] = n;
            win[p] = kPreemptScoreBase - sh_bord[gs];
          }
        }
      }
    }

    if (total == 0 && ptotal == 0) {  // no node (uniform across the block)
      if constexpr (kGang) {
        if (!was_failed && !(unit & kStart)) {
          // ---- gang rollback: pin the state at the run's checkpoint ----
          copy_owned<Res, Cnt>(base, ck, s, B, n0, own);
          if constexpr (kAff) {
            for (int i = t; i < GL; i += kThreads) anchors[i] = ck_anchors[i];
            if (use_has)
              for (int i = t; i < s.G; i += kThreads) has[i] = ck_has[i];
          }
        }
        failed = true;
      }
      if (t == 0) {
        chosen[p] = -1;
        win[p] = -1;
      }
    } else if (total > 0 && mine) {
      // The reference takes the 64-bit FNV-1a hash modulo the count of best
      // nodes, so this modulo is 64-bit; it runs once per pod, and only in
      // the threads that hold a best node.
      const int k = (int)(tie_hash() % (unsigned long long)total);
      const int excl = before + incl - mine;
      if (k >= excl && k < excl + mine) {
        // ---- commit: the owner updates its node row --------------------
        Mask m = lbest;
        for (int i = 0; i < k - excl; ++i) m &= m - 1;  // drop lower best bits
        const int n = n0 + mask_ffs(m) - 1;
        commit(n, -1);
        chosen[p] = n;
        win[p] = top;
      }
    }
    // the anchors (committed or restored) are read by every thread in the
    // next pod's filter
    if constexpr (kAff) {
      if (L > 0) __syncthreads();
    }
  }
}

using Launch = int (*)(const Planes&, const Shape&, long long, int,
                       cudaStream_t);

// Launch one instance over ``batch`` waves of one shape, one block each:
// check that its static and the wave's dynamic shared memory fit what one
// block may opt in to, raise the dynamic limit, launch. Returns a
// cudaError_t (0 = launched).
template <class Res, bool kPre, bool kAff, bool kAnti, bool kGang,
          bool kStatic, bool kShared, bool kBatch, bool kLarge = false,
          class Cnt = short>
int launch_one(const Planes& a, const Shape& s, long long dyn_bytes,
               int batch, cudaStream_t stream) {
  if (!kBatch && batch != 1) return (int)cudaErrorInvalidValue;
  const auto kernel =
      &commit_solve_kernel<Res, kPre, kAff, kAnti, kGang, kStatic, kShared,
                           kBatch, kLarge, Cnt>;
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
  kernel<<<batch, kThreads, (size_t)dyn_bytes, stream>>>(
      a.smask, a.podrow, (const Res*)a.cap, (const Res*)a.fit0,
      (const Res*)a.off, a.advx, a.fitexc, a.ports0, a.pds0, a.counts0,
      a.offl, a.sstat, a.affv, a.anchor0, a.has0, a.zone,
      (const Res*)a.ecap0, a.ecnt0, a.band, a.bord, a.gstate, a.ck,
      a.chosen, a.win, s);
  return (int)cudaGetLastError();
}

// The int32 instances without preemption, one table per layout (and per
// kBatch): index bit 0 kAff, bit 1 kAnti, bit 2 kGang, bit 3 kStatic.
template <bool kShared, bool kBatch, int I>
constexpr Launch narrow_instance() {
  return &launch_one<int, false, (I & 1) != 0, (I & 2) != 0, (I & 4) != 0,
                     (I & 8) != 0, kShared, kBatch>;
}

template <bool kShared, bool kBatch, int... I>
constexpr std::array<Launch, sizeof...(I)> narrow_table(
    std::integer_sequence<int, I...>) {
  return {narrow_instance<kShared, kBatch, I>()...};
}

// The wide-domain instances of one (Res, kPre, kBatch): index bit 0 kGang,
// bit 1 kShared; the extensions are run-time flags.
template <class Res, bool kPre, bool kBatch, int I>
constexpr Launch wide_instance() {
  return &launch_one<Res, kPre, true, true, (I & 1) != 0, true, (I & 2) != 0,
                     kBatch>;
}

template <class Res, bool kPre, bool kBatch>
constexpr std::array<Launch, 4> wide_table() {
  return {wide_instance<Res, kPre, kBatch, 0>(),
          wide_instance<Res, kPre, kBatch, 1>(),
          wide_instance<Res, kPre, kBatch, 2>(),
          wide_instance<Res, kPre, kBatch, 3>()};
}

// The large-cluster instances of one (Res, Cnt): index bit 0 kShared.
// Every extension is on (preemption, anchors, zones, gangs, the label
// plane) and decided at run time by B, L, A and the flags; one wave a
// launch.
template <class Res, class Cnt>
constexpr std::array<Launch, 2> large_table() {
  return {&launch_one<Res, true, true, true, true, true, false, false, true,
                      Cnt>,
          &launch_one<Res, true, true, true, true, true, true, false, true,
                      Cnt>};
}

// Defined one per source file, so the instances compile in parallel:
// commit_solve_i32_shared.cu, commit_solve_i32_global.cu (``which``: the
// narrow index), commit_solve_preempt.cu (int32 with preemption) and
// commit_solve_i64.cu (int64, ``pre`` picks preemption; ``which``: the wide
// index) take ``batch`` = 1; their kBatch twins, commit_solve_batch_*.cu,
// any ``batch``. commit_solve_large_i32.cu and commit_solve_large_i64.cu
// hold the large-cluster instances (``cnt32`` picks int32 peer counts;
// ``which``: the large index), ``batch`` = 1.
int launch_i32_shared(int which, const Planes& a, const Shape& s,
                      long long dyn_bytes, int batch, cudaStream_t stream);
int launch_i32_global(int which, const Planes& a, const Shape& s,
                      long long dyn_bytes, int batch, cudaStream_t stream);
int launch_i32_preempt(int which, const Planes& a, const Shape& s,
                       long long dyn_bytes, int batch, cudaStream_t stream);
int launch_i64(bool pre, int which, const Planes& a, const Shape& s,
               long long dyn_bytes, int batch, cudaStream_t stream);
int launch_batch_i32_shared(int which, const Planes& a, const Shape& s,
                            long long dyn_bytes, int batch,
                            cudaStream_t stream);
int launch_batch_i32_global(int which, const Planes& a, const Shape& s,
                            long long dyn_bytes, int batch,
                            cudaStream_t stream);
int launch_batch_i32_preempt(int which, const Planes& a, const Shape& s,
                             long long dyn_bytes, int batch,
                             cudaStream_t stream);
int launch_batch_i64(bool pre, int which, const Planes& a, const Shape& s,
                     long long dyn_bytes, int batch, cudaStream_t stream);
int launch_large_i32(bool cnt32, int which, const Planes& a, const Shape& s,
                     long long dyn_bytes, int batch, cudaStream_t stream);
int launch_large_i64(bool cnt32, int which, const Planes& a, const Shape& s,
                     long long dyn_bytes, int batch, cudaStream_t stream);

}  // namespace kgpu
