// commit_solve_preempt.cu — the 4 int32 instances of commit_solve with
// preemption (with and without gangs, in each state layout; see
// commit_solve.cuh). A source of its own, so that the instances compile in
// parallel with the others.

#include "commit_solve.cuh"

namespace kgpu {

int launch_i32_preempt(int which, const Planes& a, const Shape& s,
                       long long dyn_bytes, int batch, cudaStream_t stream) {
  static const auto table = wide_table<int, true, false>();
  return table[which](a, s, dyn_bytes, batch, stream);
}

}  // namespace kgpu
