// commit_solve.cu — the C interface of the sequential-commit wave solve:
// one wave or a batch of waves of one shape in one launch, one block a wave
// (the kernel is in commit_solve.cuh), or one large wave on a thread-block
// cluster (commit_solve_cluster.cuh); their instances are in
// commit_solve_*.cu, which compile in parallel. And the spread-score check
// kernel.
//
// Build: each source with nvcc -gencode arch=compute_90a,code=sm_90a
//        -std=c++17 -O3 -c -Xcompiler -fPIC (no --use_fast_math: the spread
//        score needs IEEE division), linked with nvcc -shared. Bound with
//        ctypes by kubernetes_tpu_torch/ops/build.py.

#include "commit_solve_cluster.cuh"

namespace {

using namespace kgpu;

__global__ void spread_eval_kernel(const int* __restrict__ total,
                                   const int* __restrict__ count,
                                   int* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = spread_score(total[i], count[i]);
  }
}

// A wave the one-block instances cannot take: more nodes than 32 a
// thread, more than 31 groups, or int32 peer counts; a thread-block cluster
// takes it. Mirrors commit_solver.is_large.
bool is_large(int N, int G, int cnt_bytes) {
  return N > kThreads * kMaxChunk || G > kMaxG || cnt_bytes != 2;
}

// Bytes of dynamic shared memory a one-block wave takes: the two-row mask
// ring, and the packed state planes when they live on chip. Mirrors
// commit_solver.shared_layout.
long long shared_bytes(int N, int pitch, int R, int Wp, int Wd, int G, int B,
                       int res_bytes, int on_chip) {
  return 2LL * pitch +
         (on_chip ? state_bytes(N, R, Wp, Wd, G, B, res_bytes) : 0);
}

// The planes and shape of one call, as the kernels take them.
Planes planes_of(const void* smask, const void* podrow, const void* cap,
                 const void* fit0, const void* off, const void* advx,
                 const void* fitexc, const void* ports0, const void* pds0,
                 const void* counts0, const void* offl, const void* sstat,
                 const void* affv, const void* anchor0, const void* has0,
                 const void* zone, const void* ecap0, const void* ecnt0,
                 const void* band, const void* bord, void* gstate, void* ck,
                 void* chosen, void* win) {
  return Planes{(const uint8_t*)smask, (const int*)podrow, cap, fit0, off,
                (const uint8_t*)advx, (const uint8_t*)fitexc,
                (const int*)ports0, (const int*)pds0, (const int*)counts0,
                (const int*)offl, (const int*)sstat, (const int*)affv,
                (const int*)anchor0, (const uint8_t*)has0, (const int*)zone,
                ecap0, (const int*)ecnt0, (const int*)band, (const int*)bord,
                (unsigned char*)gstate, (unsigned char*)ck, (int*)chosen,
                (int*)win};
}

}  // namespace

extern "C" {

// ``batch`` waves of one shape in one launch, one block each. Pointers are
// device pointers to [batch, ...] stacks of each plane; the wrapper
// allocates the global state (global layout only; null otherwise), the
// gang checkpoint (gang waves only; null otherwise), one per wave, and the
// outputs. ``B`` is the number of priority bands (0: no preemption),
// ``res_bytes`` the resource type's size (4: int32, 8: int64),
// ``cnt_bytes`` the peer counts' (2: int16; int32 waves are large),
// ``dyn_bytes`` the dynamic shared memory the wrapper reckoned for one
// wave's layout; it must agree. A large wave (is_large) is refused: it
// takes kgpu_commit_solve_cluster. Returns a cudaError_t (0 = launched).
int kgpu_commit_solve_batch(
    const void* smask, const void* podrow, const void* cap, const void* fit0,
    const void* off, const void* advx, const void* fitexc, const void* ports0,
    const void* pds0, const void* counts0, const void* offl,
    const void* sstat, const void* affv, const void* anchor0,
    const void* has0, const void* zone, const void* ecap0, const void* ecnt0,
    const void* band, const void* bord, void* gstate, void* ck, void* chosen,
    void* win, int P, int N, int pitch, int R, int Wp, int Wd, int G, int L,
    int A, int V, int B, int res_bytes, int cnt_bytes, int row, int flags,
    int w_lr, int w_spread, int w_equal, int w_anti0, int w_anti1,
    int w_anti2, int w_anti3, int on_chip, long long dyn_bytes, int batch,
    void* stream) {
  if (batch < 1 || batch > kMaxBatch || P < 0 || N < 0 ||
      is_large(N, G, cnt_bytes) || R < 0 || R > kMaxR || Wp < 0 ||
      Wp > kMaxW || Wd < 0 || Wd > kMaxW || G < 0 || L < 0 || L > kMaxL ||
      A < 0 || A > kMaxA || V < 0 || V > kMaxV || B < 0 || B > kMaxB ||
      (res_bytes != 4 && res_bytes != 8) ||
      row != R * (res_bytes / 4) + Wp + Wd + kRowFixed + L ||
      pitch % 16 != 0 || pitch < N || pitch >= N + 16 ||
      (!on_chip && !gstate) || ((flags & kGangs) && !ck) ||
      dyn_bytes !=
          shared_bytes(N, pitch, R, Wp, Wd, G, B, res_bytes, on_chip))
    return (int)cudaErrorInvalidValue;
  const Planes a = planes_of(smask, podrow, cap, fit0, off, advx, fitexc,
                             ports0, pds0, counts0, offl, sstat, affv,
                             anchor0, has0, zone, ecap0, ecnt0, band, bord,
                             gstate, ck, chosen, win);
  const Shape s{P, N, R, Wp, Wd, G, L, A, V, B, row, pitch, flags,
                w_lr, w_spread, w_equal,
                {w_anti0, w_anti1, w_anti2, w_anti3}};
  const cudaStream_t st = (cudaStream_t)stream;
  const bool gangs = (flags & kGangs) != 0;
  // one wave takes the instances without the batch offsets
  const bool many = batch > 1;
  if (res_bytes == 4 && B == 0) {
    const int which = (L > 0) | (A > 0) << 1 | gangs << 2 |
                      ((flags & kUseStatic) != 0) << 3;
    if (on_chip)
      return many ? launch_batch_i32_shared(which, a, s, dyn_bytes, batch, st)
                  : launch_i32_shared(which, a, s, dyn_bytes, 1, st);
    return many ? launch_batch_i32_global(which, a, s, dyn_bytes, batch, st)
                : launch_i32_global(which, a, s, dyn_bytes, 1, st);
  }
  const int which = gangs | (on_chip != 0) << 1;
  if (res_bytes == 4)
    return many ? launch_batch_i32_preempt(which, a, s, dyn_bytes, batch, st)
                : launch_i32_preempt(which, a, s, dyn_bytes, 1, st);
  return many ? launch_batch_i64(B > 0, which, a, s, dyn_bytes, batch, st)
              : launch_i64(B > 0, which, a, s, dyn_bytes, 1, st);
}

// One large wave (is_large, up to 65,536 nodes and 1,024 groups) on a
// thread-block cluster of ``cluster`` blocks (2, 4, 8 or 16), each owning a
// slice of slice_nodes(N, cluster) nodes. The planes and the scalars are
// kgpu_commit_solve_batch's, for one wave; ``gstate`` holds ``cluster``
// slice regions (global layout only; null otherwise), ``ck`` as many
// checkpoint regions (gang waves only). ``dyn_bytes`` must equal
// cluster_bytes. Returns a cudaError_t (0 = launched); a cluster the card
// cannot schedule is an error, never a smaller one.
int kgpu_commit_solve_cluster(
    const void* smask, const void* podrow, const void* cap, const void* fit0,
    const void* off, const void* advx, const void* fitexc, const void* ports0,
    const void* pds0, const void* counts0, const void* offl,
    const void* sstat, const void* affv, const void* anchor0,
    const void* has0, const void* zone, const void* ecap0, const void* ecnt0,
    const void* band, const void* bord, void* gstate, void* ck, void* chosen,
    void* win, int P, int N, int pitch, int R, int Wp, int Wd, int G, int L,
    int A, int V, int B, int res_bytes, int cnt_bytes, int row, int flags,
    int w_lr, int w_spread, int w_equal, int w_anti0, int w_anti1,
    int w_anti2, int w_anti3, int cluster, int on_chip, long long dyn_bytes,
    void* stream) {
  const bool pow2 = cluster > 0 && (cluster & (cluster - 1)) == 0;
  if (!pow2 || cluster < 2 || cluster > kMaxCluster || P < 0 || N < 0 ||
      N > kMaxN || slice_nodes(N, cluster) > kThreads * kMaxRows || R < 0 ||
      R > kMaxR || Wp < 0 || Wp > kMaxW || Wd < 0 || Wd > kMaxW || G < 0 ||
      G > kMaxLargeG || L < 0 || L > kMaxL || A < 0 || A > kMaxA || V < 0 ||
      V > kMaxV || B < 0 || B > kMaxB || (res_bytes != 4 && res_bytes != 8) ||
      (cnt_bytes != 2 && cnt_bytes != 4) ||
      row != R * (res_bytes / 4) + Wp + Wd + kRowFixed - 1 +
                 member_words(G) + L ||
      pitch % 16 != 0 || pitch < N || pitch >= N + 16 ||
      (!on_chip && !gstate) || ((flags & kGangs) && !ck) ||
      dyn_bytes != cluster_bytes(N, cluster, R, Wp, Wd, G, L, B, res_bytes,
                                 cnt_bytes, on_chip))
    return (int)cudaErrorInvalidValue;
  const Planes a = planes_of(smask, podrow, cap, fit0, off, advx, fitexc,
                             ports0, pds0, counts0, offl, sstat, affv,
                             anchor0, has0, zone, ecap0, ecnt0, band, bord,
                             gstate, ck, chosen, win);
  const Shape s{P, N, R, Wp, Wd, G, L, A, V, B, row, pitch, flags,
                w_lr, w_spread, w_equal,
                {w_anti0, w_anti1, w_anti2, w_anti3}};
  const int S = slice_nodes(N, cluster);
  const bool cnt32 = cnt_bytes == 4;
  const cudaStream_t st = (cudaStream_t)stream;
  return res_bytes == 4 ? launch_large_i32(cnt32, on_chip != 0, a, s,
                                           cluster, S, dyn_bytes, st)
                        : launch_large_i64(cnt32, on_chip != 0, a, s,
                                           cluster, S, dyn_bytes, st);
}

// The largest cluster (16, 8, 4 or 2 blocks) the card can schedule for the
// instance of this resource type, peer-count type and layout, each block
// with the most dynamic shared memory it may have, into ``out`` (0: none).
// Returns a cudaError_t.
int kgpu_commit_solve_cluster_limit(int res_bytes, int cnt_bytes,
                                    int on_chip, int* out) {
  if ((res_bytes != 4 && res_bytes != 8) ||
      (cnt_bytes != 2 && cnt_bytes != 4))
    return (int)cudaErrorInvalidValue;
  return res_bytes == 4
             ? limit_large_i32(cnt_bytes == 4, on_chip != 0, out)
             : limit_large_i64(cnt_bytes == 4, on_chip != 0, out);
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
