// commit_solve_batch_wide.cu — the kBatch twins of commit_solve_preempt.cu
// and commit_solve_i64.cu: one block per wave of a batched launch (see
// commit_solve.cuh). A source of its own, so that the instances compile in
// parallel with the others.

#include "commit_solve.cuh"

namespace kgpu {

int launch_batch_i32_preempt(int which, const Planes& a, const Shape& s,
                             long long dyn_bytes, int batch,
                             cudaStream_t stream) {
  static const auto table = wide_table<int, true, true>();
  return table[which](a, s, dyn_bytes, batch, stream);
}

int launch_batch_i64(bool pre, int which, const Planes& a, const Shape& s,
                     long long dyn_bytes, int batch, cudaStream_t stream) {
  static const auto plain = wide_table<long long, false, true>();
  static const auto with_preemption = wide_table<long long, true, true>();
  return (pre ? with_preemption : plain)[which](a, s, dyn_bytes, batch,
                                                stream);
}

}  // namespace kgpu
