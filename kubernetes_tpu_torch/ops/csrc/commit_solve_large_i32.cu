// commit_solve_large_i32.cu — the 4 large-cluster instances of commit_solve
// with int32 resource planes (int16 or int32 peer counts, in each
// state layout; see commit_solve.cuh): up to 65,536 nodes, 1,024 groups
// and peer totals below 2^24. A source of its own, so that the instances
// compile in parallel with the others.

#include "commit_solve.cuh"

namespace kgpu {

int launch_large_i32(bool cnt32, int which, const Planes& a, const Shape& s,
                     long long dyn_bytes, int batch, cudaStream_t stream) {
  static const auto c16 = large_table<int, short>();
  static const auto c32 = large_table<int, int>();
  return (cnt32 ? c32 : c16)[which](a, s, dyn_bytes, batch, stream);
}

}  // namespace kgpu
