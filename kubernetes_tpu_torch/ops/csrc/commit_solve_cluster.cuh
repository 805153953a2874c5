// commit_solve_cluster.cuh — the sequential-commit wave solve for large
// clusters, hand-written for Hopper (sm_90a): one thread-block cluster of C
// blocks a wave (C a power of two, 2 <= C <= 16), one block of 1024 threads
// an SM, each block owning a contiguous slice of the nodes. Included by the
// source files that instantiate it (commit_solve_large_i32.cu,
// commit_solve_large_i64.cu) and by the C interface (commit_solve.cu).
//
// Replaces the Pallas TPU kernel kubernetes_tpu/ops/pallas_solver.py::
// _solve_pallas_x32 (pl.pallas_call at :772) for the waves its domain turns
// away to the reference's XLA scan, solve_jit (kubernetes_tpu/models/
// batch_solver.py:398, :676-790): past 32,768 nodes, 31 service groups or
// peer totals of 2^15. Its domain: up to 65,536 nodes, 1,024 groups (the pod
// row carries ceil(G/32) words of member bits), peer totals below 2^24
// (int16 counts, or int32 where a total may reach 2^15: Cnt), int32 or
// int64 resource planes (Res), and every extension decided at run time:
// preemption with up to 32 bands, affinity anchors, zones, gangs, the label
// plane. It computes what commit_solver.solve_commit_reference computes,
// ties included, with the one-block kernel's arithmetic (commit_solve.cuh,
// whose device helpers it shares).
//
// Bound. Counting each input byte once, planet's 40,000-node x 10,000-pod
// wave moves ~0.2 ms of bytes; what bounds the kernel is the serial chain
// of pods: per pod one slice's filter and score, and two cluster barriers
// (the filter's reductions; the best score with its count), one more when
// a pod preempts and one when the wave has affinity labels.
//
// What the design does about the one-block kernel's limits on such waves.
// One SM walked the whole wave, its state (~24 B a node at planet, ~1 MB)
// in global memory, each thread a contiguous chunk of 40 nodes, so a warp's
// load of "node j of each thread" touched 32 sectors. Here:
// - C SMs share a wave. Block b (its rank in the cluster) owns nodes
//   [b S, b S + S), S = N / C rounded up to 16, so each block fetches only
//   its own 16-byte-aligned slice of the static-mask row (cp.async, a pod
//   ahead, into a two-slot ring).
// - Inside a block, ownership is interleaved: thread t owns local nodes t +
//   1024 i (row i), at most 4 at C = 16. A warp's loads fall on
//   consecutive addresses: coalesced in global memory, free of bank
//   conflicts in shared memory.
// - The slice's planes live in the block's dynamic shared memory whenever
//   they fit: the read-only capacity and all-pods offset (cap, off: staged
//   once at entry, read every pod) and the packed state of state_of (fit
//   usage, evictable capacity, port and PD words, evictable counts, peer
//   counts), after the mask ring and (L > 0) the anchor block. A slice that
//   does not fit keeps the same planes in a global buffer, one region a
//   block, owned and read the same way. The layout is a template flag.
// - The k-th best node in node order (the tie-break) is found in three
//   layers: the block's place in the cluster (an exclusive sum of the C
//   blocks' counts), the (row, warp) cell inside the block (row-major
//   prefix of per-warp ballot counts), the lane inside the warp
//   (popc(ballot & lanemask_lt)).
// - A reduction across the cluster is one __syncthreads for the block's
//   partial, which C lanes of warp 0 then store into slot b of every
//   block's inbox through distributed shared memory (map_shared_rank), and
//   one cluster barrier; after it every warp reads the C partials from its
//   own block's inbox. (Each warp reading the C partials remotely instead,
//   512 remote loads a block a step at 16 blocks, cost planet 8.5 us a pod
//   on the H100.) The inboxes come in two copies by pod parity, so a fast
//   block cannot overwrite a partial that a slow block still reads. Every
//   block computes the same totals, so "no node", gang failure and
//   preemption stay uniform across the cluster. The score max and the
//   count scan share one cluster barrier: each block publishes its own
//   best score and the count of its nodes that reach it, and only the
//   blocks whose best is the cluster's count.
// - Anchors (per group) are copied in every block, with their gang
//   checkpoint. The committing thread stores the chosen node into every
//   block's pick slot; after a cluster barrier every block applies the
//   same update. Gang checkpoint and rollback copy each block's own slice
//   (global ck buffer, one region a block).
// - A last cluster barrier keeps every block's shared memory alive until
//   no block reads it.

#pragma once

#include <cooperative_groups.h>

#include "commit_solve.cuh"

namespace kgpu {

namespace cg = cooperative_groups;

constexpr int kMaxN = 65536;       // nodes of a wave
constexpr int kMaxLargeG = 1024;   // groups: a member word per 32
constexpr int kMaxLargeRow = kMaxRow - 1 + kMaxLargeG / 32;
constexpr int kMaxCluster = 16;    // blocks of a cluster (non-portable > 8)
constexpr int kMaxRows = 32;       // nodes a thread owns: S <= 32,768

__host__ __device__ inline long long round16(long long x) {
  return (x + 15) / 16 * 16;
}

// Nodes of one block's slice: N / C rounded up to 16. Mirrors
// commit_solver.slice_nodes.
__host__ __device__ inline int slice_nodes(int N, int C) {
  return (int)round16((N + C - 1) / C);
}

// Bytes of one block's slice planes: cap and off [R, S] in the resource
// type, then the packed state (state_bytes) of S nodes. A global region a
// block, or the gang checkpoint's (the state alone), is rounded up to 16.
__host__ __device__ inline long long slice_bytes(int S, int R, int Wp,
                                                 int Wd, int G, int B,
                                                 int res_bytes,
                                                 int cnt_bytes) {
  return 2LL * res_bytes * R * S +
         state_bytes(S, R, Wp, Wd, G, B, res_bytes, cnt_bytes);
}

// The anchor block after the mask ring: [G, L] anchors, [G] has-anchor
// flags and their gang checkpoint, rounded up to 16; none without
// affinity labels. Mirrors commit_solver.anchor_bytes.
__host__ __device__ inline long long anchor_bytes(int G, int L) {
  return L > 0 ? round16(4LL * (2 * G * L + 2 * G)) : 0;
}

// Dynamic shared memory of one block: the [2, S] mask ring, the anchor
// block, and the slice planes when they live on chip. Mirrors
// commit_solver.cluster_for.
__host__ __device__ inline long long cluster_bytes(int N, int C, int R,
                                                   int Wp, int Wd, int G,
                                                   int L, int B,
                                                   int res_bytes,
                                                   int cnt_bytes,
                                                   int on_chip) {
  const int S = slice_nodes(N, C);
  return 2LL * S + anchor_bytes(G, L) +
         (on_chip ? slice_bytes(S, R, Wp, Wd, G, B, res_bytes, cnt_bytes)
                  : 0);
}

// One block's partials of one pod, which it stores into its slot of every
// block's inbox before the step's cluster barrier.
struct ClusterPart {
  unsigned adv;  // extra dimensions some feasible node advertises
  int cmax;      // max peers of the pod's group on one node
  int csum;      // peers of the pod's group
  int top;       // this block's best score
  int cnt;       // its nodes at that score
  int ptop;      // this block's best preemption value
  int pcnt;      // its nodes at that value
};

// This thread's owned columns (local nodes t + 1024 i < own) of every state
// plane, between two packed layouts of a slice: the gang checkpoint and
// rollback. Out of line, like copy_owned.
template <class Res, class Cnt>
__device__ __noinline__ void copy_slice(unsigned char* dst,
                                        unsigned char* src, const Shape& sl,
                                        int B, int own) {
  const State<Res, Cnt> d = state_of<Res, Cnt>(dst, sl, B);
  const State<Res, Cnt> c = state_of<Res, Cnt>(src, sl, B);
  const int S = sl.N;
  for (int k = 0; k < sl.R + B * sl.R; ++k)
    for (int j = threadIdx.x; j < own; j += kThreads)
      d.fit[k * S + j] = c.fit[k * S + j];
  for (int k = 0; k < sl.Wp + sl.Wd + B; ++k)
    for (int j = threadIdx.x; j < own; j += kThreads)
      d.ports[k * S + j] = c.ports[k * S + j];
  for (int g = 0; g < sl.G; ++g)
    for (int j = threadIdx.x; j < own; j += kThreads)
      d.counts[g * S + j] = c.counts[g * S + j];
}

// Start fetching pod q's static-mask slice [lo, lo + S) into mask slot q &
// 1 and its pod row into row slot q % 3, as fetch_pod does for a whole row.
__device__ __forceinline__ void fetch_slice(unsigned char* ring, int* rows,
                                            const uint8_t* smask,
                                            const int* podrow, int q,
                                            const Shape& s, int lo, int S) {
  const uint8_t* src = smask + (size_t)q * s.pitch + lo;
  unsigned char* dst = ring + (q & 1) * S;
  const int len = min(S, s.pitch - lo);  // lo, S and pitch are 16-aligned
  for (int c = threadIdx.x * 16; c < len; c += kThreads * 16)
    cp_async16(dst + c, src + c);
  const int w = (int)threadIdx.x - (kThreads - s.row);
  if (w >= 0)
    cp_async4(rows + (q % 3) * kMaxLargeRow + w,
              podrow + (size_t)q * s.row + w);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The preemption pass over this thread's nodes (rows set in ``cand``) that
// pass every filter but the resource fit and are not pre-exceeded; local
// node j = t + 1024 i, slice planes of stride sl.N.
template <class Res>
__device__ __noinline__ PreemptBest cluster_preempt_pass(
    unsigned cand, int lo, const Shape& sl, int nb, const int* bval,
    const int* bord, const Res* cap, const uint8_t* fitexc, const Res* fit,
    const Res* ecap, const int* ecnt, const int* row) {
  PreemptBest pb{-1, 0u};
  while (cand) {
    const int i = __ffs(cand) - 1;
    cand &= cand - 1;
    const int j = threadIdx.x + kThreads * i;
    if (fitexc[lo + j]) continue;
    const int k = preempt_rank<Res>(j, sl, nb, bval, bord, cap, fit, ecap,
                                    row);
    if (k < 0) continue;
    const int v = kPreemptBig - preempt_cost(j, sl.N, k, bord, ecnt);
    if (v > pb.top) {
      pb.top = v;
      pb.best = 1u << i;
    } else if (v == pb.top) {
      pb.best |= 1u << i;
    }
  }
  return pb;
}

__device__ __forceinline__ void cluster_barrier() {
  cg::this_cluster().sync();
}

// The cluster's best value and the k-th (k = hash mod total) of the nodes
// that reach it, in node order. ``value`` is the best of this thread's
// nodes (-1: none) and ``best`` has bit i set when its node of row i
// reaches it; ``nrow`` is the block's rows; ``inbox`` the pod's inbox, of
// whose partials the fields ``top_f`` and ``cnt_f`` carry this step. Each
// block publishes its own best and the count of its nodes at it; the
// blocks at the cluster's best count. Returns the number of nodes at the
// cluster's best (0: none), the best in ``top``, and sets ``pick`` to the
// row of the k-th node in the thread that owns it (else -1). Two block
// barriers (the second after this thread's cp.async copies land) and one
// cluster barrier.
__device__ __forceinline__ int select_kth(int value, unsigned best, int nrow,
                                          unsigned long long hash,
                                          int* sh_top, int* sh_cell,
                                          ClusterPart* inbox,
                                          int ClusterPart::*top_f,
                                          int ClusterPart::*cnt_f, int C,
                                          int rank, int* top, int* pick) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wmax = __reduce_max_sync(kFull, value);
  if (lane == 0) sh_top[warp] = wmax;
  __syncthreads();
  const int bmax = __reduce_max_sync(kFull, sh_top[lane]);
  if (bmax < 0 || value != bmax) best = 0u;
  for (int i = 0; i < nrow; ++i) {
    const unsigned b = __ballot_sync(kFull, (best >> i) & 1u);
    if (lane == 0) sh_cell[i * kWarps + warp] = __popc(b);
  }
  cp_async_wait_all();
  __syncthreads();
  if (warp == 0) {
    int c = 0;
    for (int i = 0; i < nrow; ++i) c += sh_cell[i * kWarps + lane];
    c = __reduce_add_sync(kFull, c);
    if (lane < C) {
      ClusterPart* dst = cg::this_cluster().map_shared_rank(inbox + rank,
                                                             lane);
      dst->*top_f = bmax;
      dst->*cnt_f = c;
    }
  }
  cluster_barrier();
  const int btop = lane < C ? inbox[lane].*top_f : -1;
  const int bcnt = lane < C ? inbox[lane].*cnt_f : 0;
  *top = __reduce_max_sync(kFull, btop);
  const int v = *top >= 0 && btop == *top ? bcnt : 0;
  const int total = __reduce_add_sync(kFull, v);
  const int before = __reduce_add_sync(kFull, lane < rank ? v : 0);
  const int mine = __shfl_sync(kFull, v, rank);
  *pick = -1;
  if (total == 0) return 0;
  int k = (int)(hash % (unsigned long long)total) - before;
  if (k < 0 || k >= mine) return total;  // uniform across the block
  for (int i = 0; i < nrow; ++i) {  // uniform: the same k in every thread
    const int x = sh_cell[i * kWarps + lane];
    int incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int rowtot = __shfl_sync(kFull, incl, 31);
    if (k < rowtot) {
      const int wincl = __shfl_sync(kFull, incl, warp);
      const int wexcl = wincl - __shfl_sync(kFull, x, warp);
      if (k >= wexcl && k < wincl) {  // uniform across the warp
        const unsigned b = __ballot_sync(kFull, (best >> i) & 1u);
        if (((b >> lane) & 1u) &&
            __popc(b & ((1u << lane) - 1u)) == k - wexcl)
          *pick = i;
      }
      break;
    }
    k -= rowtot;
  }
  return total;
}

template <class Res, class Cnt, bool kShared>
__global__ void __launch_bounds__(kThreads, 1) commit_solve_cluster_kernel(
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
    unsigned char* __restrict__ gstate,  // C slice regions (global layout)
    unsigned char* __restrict__ ck,      // C checkpoint regions (gangs)
    int* __restrict__ chosen, int* __restrict__ win, const Shape s,
    const int S) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)gridDim.x;  // one cluster: the whole grid
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int N = s.N;
  const int lo = rank * S;                        // this block's slice
  const int own = max(0, min(S, N - lo));         // nodes [lo, lo + own)
  const int nrow = (own + kThreads - 1) / kThreads;
  const int R = s.R, L = s.L, A = s.A, B = s.B, G = s.G;
  constexpr int kReqWords = sizeof(Res) / 4;
  const int Mw = member_words(G);
  Shape sl = s;  // the slice planes' shape: stride S
  sl.N = S;

  __shared__ unsigned sh_adv[kWarps];
  __shared__ int sh_cmax[kWarps];
  __shared__ int sh_num[kWarps];
  __shared__ int sh_top[kWarps];
  __shared__ int sh_cell[kMaxRows * kWarps];  // best nodes per (row, warp)
  // by pod parity: slot b holds block b's partial; the node committed
  __shared__ ClusterPart cl_in[2][kMaxCluster];
  __shared__ int cl_pick[2];
  __shared__ int cl_zone[2][kMaxA * kMaxV];   // this block's zone peers
  __shared__ int sh_ztot[kMaxA * kMaxV];      // the cluster's
  __shared__ int sh_w_anti[kMaxA];
  __shared__ int sh_rows[3 * kMaxLargeRow];   // pod-row ring
  __shared__ int sh_bval[kMaxB];              // band values, ascending
  __shared__ int sh_bord[kMaxB];              // their slots
  // [2, S] mask ring, the anchor block, then the slice planes on chip
  extern __shared__ __align__(16) unsigned char dsm[];
  unsigned char* const ring = dsm;
  int* const anchors = reinterpret_cast<int*>(dsm + 2 * S);
  int* const has = anchors + G * L;
  int* const ck_anchors = has + G;
  int* const ck_has = ck_anchors + G * L;
  const long long region = round16(
      slice_bytes(S, R, s.Wp, s.Wd, G, B, sizeof(Res), sizeof(Cnt)));
  unsigned char* const slice =
      kShared ? dsm + 2 * S + anchor_bytes(G, L)
              : gstate + (size_t)rank * (size_t)region;
  Res* const scap = reinterpret_cast<Res*>(slice);
  Res* const soff = scap + R * S;
  unsigned char* const base = reinterpret_cast<unsigned char*>(soff + R * S);
  const State<Res, Cnt> st = state_of<Res, Cnt>(base, sl, B);
  Res* const fit = st.fit;
  Res* const ecap = st.ecap;
  int* const ports = st.ports;
  int* const pds = st.pds;
  int* const ecnt = st.ecnt;
  Cnt* const counts = st.counts;
  const bool gangs = (s.flags & kGangs) != 0;
  unsigned char* const ckb =
      gangs ? ck + (size_t)rank * (size_t)round16(state_bytes(
                  S, R, s.Wp, s.Wd, G, B, sizeof(Res), sizeof(Cnt)))
            : nullptr;

  // stage the slice: read-only cap and off, and the state
  for (int j = t; j < own; j += kThreads) {
    const int n = lo + j;
    for (int r = 0; r < R; ++r) {
      scap[r * S + j] = cap[r * N + n];
      soff[r * S + j] = off[r * N + n];
      fit[r * S + j] = fit0[r * N + n];
    }
    for (int w = 0; w < s.Wp; ++w) ports[w * S + j] = ports0[w * N + n];
    for (int w = 0; w < s.Wd; ++w) pds[w * S + j] = pds0[w * N + n];
    for (int g = 0; g < G; ++g) counts[g * S + j] = (Cnt)counts0[g * N + n];
    for (int k = 0; k < B * R; ++k) ecap[k * S + j] = ecap0[k * N + n];
    for (int b = 0; b < B; ++b) ecnt[b * S + j] = ecnt0[b * N + n];
  }
  const int GL = G * L;
  if (L > 0) {
    for (int i = t; i < GL; i += kThreads) anchors[i] = anchor0[i];
    for (int i = t; i < G; i += kThreads) has[i] = has0[i];
  }
  for (int i = t; i < 2 * kMaxA * kMaxV; i += kThreads)
    (&cl_zone[0][0])[i] = 0;
  if (t < kMaxA) sh_w_anti[t] = s.w_anti[t];
  if (t < B) {
    sh_bord[t] = bord[t];
    sh_bval[t] = band[bord[t]];
  }
  if (s.P > 0) fetch_slice(ring, sh_rows, smask, podrow, 0, s, lo, S);
  cp_async_wait_all();
  __syncthreads();

  const bool use_res = s.flags & kUseResources;
  const bool use_ports = s.flags & kUsePorts;
  const bool use_disk = s.flags & kUseDisk;
  const bool use_static = s.flags & kUseStatic;
  // podrow layout: req[R] (in kReqWords words each) | ports[Wp] | pds[Wd] |
  // tie_hi tie_lo | gid | member bits[Mw] | zero-request flag | unit |
  // priority | pinned affinity codes[L]
  const int o_ports = R * kReqWords;
  const int o_pds = o_ports + s.Wp;
  const int o_tie = o_pds + s.Wd;
  const int o_gid = o_tie + 2;
  const int o_member = o_gid + 1;
  const int o_zreq = o_member + Mw;
  const int o_unit = o_zreq + 1;
  const int o_prio = o_zreq + 2;
  const int o_pins = o_zreq + 3;

  bool failed = false;  // a member of the current gang run found no node
  for (int p = 0; p < s.P; ++p) {
    const int par = p & 1;
    ClusterPart* const inbox = cl_in[par];
    // every block's last read of this slot was two pods ago; the owner of
    // this pod's node stores it here only after the select's barrier
    if (t == 0) cl_pick[par] = -1;
    if (p + 1 < s.P)
      fetch_slice(ring, sh_rows, smask, podrow, p + 1, s, lo, S);
    const unsigned char* srow = ring + (p & 1) * S;
    const int* row = sh_rows + (p % 3) * kMaxLargeRow;
    const int gid = row[o_gid];
    const bool zreq = row[o_zreq] != 0;
    const unsigned long long hash =
        ((unsigned long long)(unsigned)row[o_tie] << 32) |
        (unsigned)row[o_tie + 1];
    // block-uniform: does the pod hold a host port or a PD at all?
    bool pod_ports = false, pod_pds = false;
    if (use_ports)
      for (int w = 0; w < s.Wp; ++w) pod_ports |= row[o_ports + w] != 0;
    if (use_disk)
      for (int w = 0; w < s.Wd; ++w) pod_pds |= row[o_pds + w] != 0;

    // ---- gang bookkeeping (solve_jit gang_step) -------------------------
    int unit = kStart;
    bool was_failed = false;
    if (gangs) {
      unit = row[o_unit];
      if (unit & kStart) failed = false;
      was_failed = failed;
      if (unit & kCheckpoint) {
        // owner-local: the same thread copies back on rollback
        copy_slice<Res, Cnt>(ckb, base, sl, B, own);
        if (L > 0) {
          for (int i = t; i < GL; i += kThreads) ck_anchors[i] = anchors[i];
          for (int i = t; i < G; i += kThreads) ck_has[i] = has[i];
        }
      }
    }
    // anchor-derived affinity (predicates.go:256-276): bit l set when label
    // l was not pinned by the selector and the group's anchor has a value
    unsigned need = 0;
    if (L > 0 && gid >= 0 && has[gid]) {
      for (int l = 0; l < L; ++l)
        if (row[o_pins + l] == -2 && anchors[gid * L + l] >= 0)
          need |= 1u << l;
    }

    // ---- filter (and the per-pod reductions it feeds) -------------------
    unsigned feas = 0;  // bit i: this thread's node of row i is feasible
    unsigned nres = 0;  // bit i: ... passes every filter but the resources
    unsigned adv = 0;   // bit r: a feasible node advertises extra dim r
    int cmax = 0;       // max peers of the pod's group over owned nodes
    int csum = 0;       // all peers of the pod's group over owned nodes
    const bool check_res = use_res && !zreq;
    for (int i = 0, j = t; j < own; ++i, j += kThreads) {
      const int n = lo + j;
      bool ok = srow[j] != 0 && !failed;
      for (int l = 0; l < L; ++l)
        if ((need >> l) & 1u) ok &= affv[l * N + n] == anchors[gid * L + l];
      bool res_ok = true;
      if (check_res) {
        bool fits = fitexc[n] == 0;
#pragma unroll
        for (int r = 0; r < kUnrollR; ++r) {
          if (r < R) {
            const Res c = scap[r * S + j];
            // cpu and memory (dims 0, 1) are unconstrained at zero capacity
            fits &= (c - fit[r * S + j] >= req_of<Res>(row, r)) |
                    (r < 2 && c == 0);
          }
        }
        for (int r = kUnrollR; r < R; ++r)
          fits &= scap[r * S + j] - fit[r * S + j] >= req_of<Res>(row, r);
        res_ok = fits;
      }
      if (pod_ports) {
        for (int w = 0; w < s.Wp; ++w)
          ok &= (ports[w * S + j] & row[o_ports + w]) == 0;
      }
      if (pod_pds) {
        for (int w = 0; w < s.Wd; ++w)
          ok &= (pds[w * S + j] & row[o_pds + w]) == 0;
      }
      nres |= (unsigned)ok << i;
      ok &= res_ok;
      if (ok) {
        feas |= 1u << i;
        for (int r = 2; r < R; ++r)
          if (advx[r * N + n]) adv |= 1u << r;
      }
    }
    // the pod's peers over the owned nodes: the spread max, and for
    // anti-affinity the total and this block's per-zone sums over the
    // feasible nodes
    if (gid >= 0) {
      const Cnt* crow = counts + gid * S;
      for (int i = 0, j = t; j < own; ++i, j += kThreads) {
        const int c = crow[j];
        cmax = max(cmax, c);
        csum += c;
        if (!c || !((feas >> i) & 1u)) continue;
        for (int a = 0; a < A; ++a) {
          const int z = zone[a * N + lo + j];
          if (z >= 0) atomicAdd(&cl_zone[par][a * s.V + z], c);
        }
      }
    }
    adv = __reduce_or_sync(kFull, adv);
    cmax = __reduce_max_sync(kFull, cmax);
    csum = __reduce_add_sync(kFull, csum);
    if (lane == 0) {
      sh_adv[warp] = adv;
      sh_cmax[warp] = cmax;
      sh_num[warp] = csum;
    }
    __syncthreads();
    if (warp == 0) {
      const unsigned a = __reduce_or_sync(kFull, sh_adv[lane]);
      const int m = __reduce_max_sync(kFull, sh_cmax[lane]);
      const int u = __reduce_add_sync(kFull, sh_num[lane]);
      if (lane < C) {
        ClusterPart* dst = cluster.map_shared_rank(inbox + rank, lane);
        dst->adv = a;
        dst->cmax = m;
        dst->csum = u;
      }
    }
    cluster_barrier();
    {
      const ClusterPart* q = lane < C ? inbox + lane : nullptr;
      adv = __reduce_or_sync(kFull, q ? q->adv : 0u);
      cmax = __reduce_max_sync(kFull, q ? q->cmax : 0);
      csum = __reduce_add_sync(kFull, q ? q->csum : 0);
    }
    if (A > 0) {
      // the cluster's feasible peers per zone, summed once per block
      for (int i = t; i < A * s.V; i += kThreads) {
        int z = 0;
        for (int c = 0; c < C; ++c)
          z += *cluster.map_shared_rank(&cl_zone[par][i], c);
        sh_ztot[i] = z;
      }
      __syncthreads();
    }
    // the spread max counts the off-list slot too; a serviceless pod
    // scores the constant 10 (spread of total 0)
    const int max_count = gid >= 0 ? max(cmax, offl[gid]) : 0;
    // anti-affinity's num counts every peer of the group, off-list included
    const int num = A > 0 && gid >= 0 ? csum + offl[gid] : 0;
    // LeastRequested divisor: cpu + memory + every extra dimension some
    // FEASIBLE node advertises (by name presence, not capacity)
    const unsigned n_dyn = 2 + __popc(adv);

    // ---- score: per-thread max and the owned nodes that reach it ------
    int lmax = -1;
    unsigned lbest = 0;
    for (int i = 0, j = t; j < own; ++i, j += kThreads) {
      if (!((feas >> i) & 1u)) continue;
      const int n = lo + j;
      int sc = 0;
      if (s.w_lr) {
        // all-pods usage = fit + off
        unsigned raw = 0;
#pragma unroll
        for (int r = 0; r < kUnrollR; ++r) {
          if (r < R) {
            const int x = r * S + j;
            raw += least_requested<Res>(
                scap[x], fit[x] + soff[x] + req_of<Res>(row, r));
          }
        }
        for (int r = kUnrollR; r < R; ++r) {
          const int x = r * S + j;
          raw += least_requested<Res>(
              scap[x], fit[x] + soff[x] + req_of<Res>(row, r));
        }
        sc += (int)(raw / n_dyn) * s.w_lr;  // n_dyn >= 2
      }
      if (s.w_spread) {
        const int peers = gid >= 0 ? counts[gid * S + j] : 0;
        sc += spread_score(max_count, peers) * s.w_spread;
      }
      for (int a = 0; a < A; ++a) {
        // an unlabeled node scores 0 on this term
        const int z = zone[a * N + n];
        if (z >= 0)
          sc += spread_score(num, sh_ztot[a * s.V + z]) * sh_w_anti[a];
      }
      if (use_static) sc += sstat[n];
      sc += s.w_equal;
      if (sc > lmax) {
        lmax = sc;
        lbest = 1u << i;
      } else if (sc == lmax) {
        lbest |= 1u << i;
      }
    }
    // ---- select: the best score, the k-th node at it in node order ----
    int top = -1;
    int pick = -1;  // the row of this thread's node that takes the pod
    const int total =
        select_kth(lmax, lbest, nrow, hash, sh_top, sh_cell, inbox,
                   &ClusterPart::top, &ClusterPart::cnt, C, rank, &top,
                   &pick);
    // every block has read this block's zone sums: clear them for pod p + 2
    for (int i = t; i < A * s.V; i += kThreads) cl_zone[par][i] = 0;

    // the owner's commit of a placement at local node j; a preemption's
    // evicted ranks [0, kstar] leave both usages and the band planes
    auto commit = [&](int j, int kstar) {
      for (int r = 0; r < R; ++r) {
        Res freed = 0;
        for (int k = 0; k <= kstar; ++k)
          freed += ecap[(sh_bord[k] * R + r) * S + j];
        fit[r * S + j] += req_of<Res>(row, r) - freed;
      }
      for (int k = 0; k <= kstar; ++k) {
        const int b = sh_bord[k];
        for (int r = 0; r < R; ++r) ecap[(b * R + r) * S + j] = 0;
        ecnt[b * S + j] = 0;
      }
      for (int w = 0; w < s.Wp; ++w) ports[w * S + j] |= row[o_ports + w];
      for (int w = 0; w < s.Wd; ++w) pds[w * S + j] |= row[o_pds + w];
      for (int wi = 0; wi < Mw; ++wi) {
        unsigned bits = (unsigned)row[o_member + wi];
        while (bits) {
          counts[(wi * 32 + __ffs(bits) - 1) * S + j] += 1;
          bits &= bits - 1;
        }
      }
    };

    // ---- preemption: no node fits and the pod may evict ----------------
    // (batch_solver.py:676-732; every condition below is cluster-uniform)
    int ptotal = 0;
    int committed = -1;  // the local node this thread committed
    if (total == 0 && B > 0 && use_res && !failed &&
        (row[o_unit] & kCanPreempt)) {
      const int prio = row[o_prio];
      int nb = 0;  // bands strictly below the pod's priority
      while (nb < B && sh_bval[nb] < prio) ++nb;
      const PreemptBest pb = cluster_preempt_pass<Res>(
          nb ? nres : 0u, lo, sl, nb, sh_bval, sh_bord, scap, fitexc, fit,
          ecap, ecnt, row);
      int ptop = -1;
      int prow = -1;
      ptotal = select_kth(pb.top, pb.best, nrow, hash, sh_top, sh_cell,
                          inbox, &ClusterPart::ptop, &ClusterPart::pcnt, C,
                          rank, &ptop, &prow);
      if (prow >= 0) {
        const int j = t + kThreads * prow;
        const int kstar = preempt_rank<Res>(j, sl, nb, sh_bval, sh_bord,
                                            scap, fit, ecap, row);
        // report the threshold group's first slot
        int gs = kstar;
        while (gs > 0 && sh_bval[gs - 1] == sh_bval[kstar]) --gs;
        commit(j, kstar);
        chosen[p] = lo + j;
        win[p] = kPreemptScoreBase - sh_bord[gs];
        committed = j;
      }
    }

    if (total == 0 && ptotal == 0) {  // no node (uniform across the cluster)
      if (gangs) {
        if (!was_failed && !(unit & kStart)) {
          // ---- gang rollback: pin the slice at the run's checkpoint ----
          copy_slice<Res, Cnt>(base, ckb, sl, B, own);
          if (L > 0) {
            for (int i = t; i < GL; i += kThreads) anchors[i] = ck_anchors[i];
            for (int i = t; i < G; i += kThreads) has[i] = ck_has[i];
          }
        }
        failed = true;
      }
      if (rank == 0 && t == 0) {
        chosen[p] = -1;
        win[p] = -1;
      }
    } else if (total > 0 && pick >= 0) {
      // ---- commit: the owner updates its node row ----------------------
      const int j = t + kThreads * pick;
      commit(j, -1);
      chosen[p] = lo + j;
      win[p] = top;
      committed = j;
    }
    // ---- anchors: every block applies the owner's commit ---------------
    if (L > 0) {
      if (committed >= 0)
        for (int c = 0; c < C; ++c)
          *cluster.map_shared_rank(&cl_pick[par], c) = lo + committed;
      cluster_barrier();
      const int n = cl_pick[par];
      if (n >= 0) {
        // the groups this commit gives their first peer are anchored at
        // the chosen node's values
        for (int g = t; g < G; g += kThreads) {
          const unsigned bit =
              ((unsigned)row[o_member + (g >> 5)] >> (g & 31)) & 1u;
          if (bit && !has[g]) {
            for (int l = 0; l < L; ++l) anchors[g * L + l] = affv[l * N + n];
            has[g] = 1;
          }
        }
      }
      __syncthreads();
    }
  }
  // no block's shared memory may go while another still reads it
  cluster_barrier();
}

using ClusterLaunch = int (*)(const Planes&, const Shape&, int, int,
                              long long, cudaStream_t);

// The launch configuration of one wave: C blocks of kThreads, one cluster.
struct ClusterConfig {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  ClusterConfig(int C, long long dyn_bytes, cudaStream_t stream) : cfg{} {
    cfg.gridDim = dim3((unsigned)C);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = (size_t)dyn_bytes;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Prepare one instance for ``dyn_bytes`` of dynamic shared memory a block
// (at most what a block may opt in to beside its static arrays) and for
// clusters of up to 16 blocks. Returns a cudaError_t.
template <class Res, class Cnt, bool kShared>
int prepare_cluster(long long dyn_bytes) {
  const auto kernel = &commit_solve_cluster_kernel<Res, Cnt, kShared>;
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
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return (int)err;
}

// Launch one wave on a cluster of C blocks with slices of S nodes, after
// checking that the card can schedule such a cluster at all (no fallback to
// another C: the error goes back to the wrapper, which raises). Returns a
// cudaError_t (0 = launched).
template <class Res, class Cnt, bool kShared>
int launch_cluster(const Planes& a, const Shape& s, int C, int S,
                   long long dyn_bytes, cudaStream_t stream) {
  const auto kernel = &commit_solve_cluster_kernel<Res, Cnt, kShared>;
  int err = prepare_cluster<Res, Cnt, kShared>(dyn_bytes);
  if (err != 0) return err;
  ClusterConfig cc(C, dyn_bytes, stream);
  int clusters = 0;
  err = (int)cudaOccupancyMaxActiveClusters(&clusters, kernel, &cc.cfg);
  if (err != 0) return err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  err = (int)cudaLaunchKernelEx(
      &cc.cfg, kernel, a.smask, a.podrow, (const Res*)a.cap,
      (const Res*)a.fit0, (const Res*)a.off, a.advx, a.fitexc, a.ports0,
      a.pds0, a.counts0, a.offl, a.sstat, a.affv, a.anchor0, a.has0, a.zone,
      (const Res*)a.ecap0, a.ecnt0, a.band, a.bord, a.gstate, a.ck, a.chosen,
      a.win, s, S);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// The largest C (16, 8, 4 or 2) of which the card can schedule one cluster
// of this instance with the most dynamic shared memory a block may have,
// into ``out`` (0: none). Returns a cudaError_t.
template <class Res, class Cnt, bool kShared>
int cluster_limit(int* out) {
  const auto kernel = &commit_solve_cluster_kernel<Res, Cnt, kShared>;
  *out = 0;
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  const long long dyn = optin - (long long)attr.sharedSizeBytes;
  int err = prepare_cluster<Res, Cnt, kShared>(dyn);
  if (err != 0) return err;
  for (int C = kMaxCluster; C >= 2; C /= 2) {
    ClusterConfig cc(C, dyn, nullptr);
    int clusters = 0;
    err = (int)cudaOccupancyMaxActiveClusters(&clusters, kernel, &cc.cfg);
    if (err != 0) return err;
    if (clusters >= 1) {
      *out = C;
      return 0;
    }
  }
  return 0;
}

// Defined one per source file, so the instances compile in parallel:
// commit_solve_large_i32.cu and commit_solve_large_i64.cu hold the four
// instances of their resource type (``cnt32``: int32 peer counts;
// ``on_chip``: the slice planes in shared memory).
int launch_large_i32(bool cnt32, bool on_chip, const Planes& a,
                     const Shape& s, int C, int S, long long dyn_bytes,
                     cudaStream_t stream);
int launch_large_i64(bool cnt32, bool on_chip, const Planes& a,
                     const Shape& s, int C, int S, long long dyn_bytes,
                     cudaStream_t stream);
int limit_large_i32(bool cnt32, bool on_chip, int* out);
int limit_large_i64(bool cnt32, bool on_chip, int* out);

}  // namespace kgpu
