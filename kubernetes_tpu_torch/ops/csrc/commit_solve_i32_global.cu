// commit_solve_i32_global.cu — the 16 int32 instances of commit_solve
// without preemption whose node state lives in global memory, one per
// branch set (see commit_solve.cuh). A source of its own, so that the
// instances compile in parallel with the others.

#include "commit_solve.cuh"

namespace kgpu {

int launch_i32_global(int which, const Planes& a, const Shape& s,
                      long long dyn_bytes, cudaStream_t stream) {
  static const auto table =
      narrow_table<false>(std::make_integer_sequence<int, 16>{});
  return table[which](a, s, dyn_bytes, stream);
}

}  // namespace kgpu
