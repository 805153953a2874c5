// commit_solve_i64.cu — the 8 int64 instances of commit_solve (with and
// without preemption and gangs, in each state layout; see
// commit_solve.cuh). A source of its own, so that the instances compile in
// parallel with the others.

#include "commit_solve.cuh"

namespace kgpu {

int launch_i64(bool pre, int which, const Planes& a, const Shape& s,
               long long dyn_bytes, cudaStream_t stream) {
  static const auto plain = wide_table<long long, false>();
  static const auto with_preemption = wide_table<long long, true>();
  return (pre ? with_preemption : plain)[which](a, s, dyn_bytes, stream);
}

}  // namespace kgpu
