// commit_solve.cu — the C interface of the sequential-commit wave solve
// (the kernel is in commit_solve.cuh; its instances in commit_solve_*.cu,
// which compile in parallel) and the spread-score check kernel.
//
// Build: each source with nvcc -gencode arch=compute_90a,code=sm_90a
//        -std=c++17 -O3 -c -Xcompiler -fPIC (no --use_fast_math: the spread
//        score needs IEEE division), linked with nvcc -shared. Bound with
//        ctypes by kubernetes_tpu_torch/ops/build.py.

#include "commit_solve.cuh"

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

// Bytes of dynamic shared memory a wave takes: the two-row mask ring, and
// the packed state planes when they live on chip. Mirrors
// commit_solver.shared_layout.
long long shared_bytes(int N, int pitch, int R, int Wp, int Wd, int G, int B,
                       int res_bytes, int on_chip) {
  return 2LL * pitch +
         (on_chip ? state_bytes(N, R, Wp, Wd, G, B, res_bytes) : 0);
}

}  // namespace

extern "C" {

// One wave. Pointers are device pointers; the wrapper allocates the global
// state (global layout only; null otherwise), the gang checkpoint (gang
// waves only; null otherwise) and the outputs. ``B`` is the number of
// priority bands (0: no preemption), ``res_bytes`` the resource type's
// size (4: int32, 8: int64), ``dyn_bytes`` the dynamic shared memory the
// wrapper reckoned for the layout; it must agree. Returns a cudaError_t
// (0 = launched).
int kgpu_commit_solve(const void* smask, const void* podrow, const void* cap,
                      const void* fit0, const void* off, const void* advx,
                      const void* fitexc, const void* ports0, const void* pds0,
                      const void* counts0, const void* offl, const void* sstat,
                      const void* affv, const void* anchor0, const void* has0,
                      const void* zone, const void* ecap0, const void* ecnt0,
                      const void* band, const void* bord, void* gstate,
                      void* ck, void* chosen, void* win, int P, int N,
                      int pitch, int R, int Wp, int Wd, int G, int L, int A,
                      int V, int B, int res_bytes, int row, int flags,
                      int w_lr, int w_spread, int w_equal, int w_anti0,
                      int w_anti1, int w_anti2, int w_anti3, int on_chip,
                      long long dyn_bytes, void* stream) {
  if (P < 0 || N < 0 || N > kThreads * kMaxChunk || R < 0 || R > kMaxR ||
      Wp < 0 || Wp > kMaxW || Wd < 0 || Wd > kMaxW || G < 0 || G > kMaxG ||
      L < 0 || L > kMaxL || A < 0 || A > kMaxA || V < 0 || V > kMaxV ||
      B < 0 || B > kMaxB || (res_bytes != 4 && res_bytes != 8) ||
      row != R * (res_bytes / 4) + Wp + Wd + kRowFixed + L ||
      pitch % 16 != 0 || pitch < N || pitch >= N + 16 ||
      (!on_chip && !gstate) || ((flags & kGangs) && !ck) ||
      dyn_bytes !=
          shared_bytes(N, pitch, R, Wp, Wd, G, B, res_bytes, on_chip))
    return (int)cudaErrorInvalidValue;
  const Planes a{(const uint8_t*)smask, (const int*)podrow, cap, fit0, off,
                 (const uint8_t*)advx, (const uint8_t*)fitexc,
                 (const int*)ports0, (const int*)pds0, (const int*)counts0,
                 (const int*)offl, (const int*)sstat, (const int*)affv,
                 (const int*)anchor0, (const uint8_t*)has0, (const int*)zone,
                 ecap0, (const int*)ecnt0, (const int*)band,
                 (const int*)bord, (unsigned char*)gstate,
                 (unsigned char*)ck, (int*)chosen, (int*)win};
  const Shape s{P, N, R, Wp, Wd, G, L, A, V, B, row, pitch, flags,
                w_lr, w_spread, w_equal,
                {w_anti0, w_anti1, w_anti2, w_anti3}};
  const cudaStream_t st = (cudaStream_t)stream;
  const bool gangs = (flags & kGangs) != 0;
  if (res_bytes == 4 && B == 0) {
    const int which = (L > 0) | (A > 0) << 1 | gangs << 2 |
                      ((flags & kUseStatic) != 0) << 3;
    return on_chip ? launch_i32_shared(which, a, s, dyn_bytes, st)
                   : launch_i32_global(which, a, s, dyn_bytes, st);
  }
  const int which = gangs | (on_chip != 0) << 1;
  if (res_bytes == 4) return launch_i32_preempt(which, a, s, dyn_bytes, st);
  return launch_i64(B > 0, which, a, s, dyn_bytes, st);
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
