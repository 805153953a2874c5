// commit_solve_batch_i32_shared.cu — the kBatch twins of
// commit_solve_i32_shared.cu: one block per wave of a batched launch (see
// commit_solve.cuh). A source of its own, so that the instances compile in
// parallel with the others.

#include "commit_solve.cuh"

namespace kgpu {

int launch_batch_i32_shared(int which, const Planes& a, const Shape& s,
                            long long dyn_bytes, int batch,
                            cudaStream_t stream) {
  static const auto table =
      narrow_table<true, true>(std::make_integer_sequence<int, 16>{});
  return table[which](a, s, dyn_bytes, batch, stream);
}

}  // namespace kgpu
