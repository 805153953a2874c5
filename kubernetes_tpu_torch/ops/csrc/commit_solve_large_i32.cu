// commit_solve_large_i32.cu — the 4 cluster instances of commit_solve with
// int32 resource planes (int16 or int32 peer counts, in each slice layout;
// see commit_solve_cluster.cuh): up to 65,536 nodes, 1,024 groups and peer
// totals below 2^24, one thread-block cluster a wave. A source of its own,
// so that the instances compile in parallel with the others.

#include "commit_solve_cluster.cuh"

namespace kgpu {

int launch_large_i32(bool cnt32, bool on_chip, const Planes& a,
                     const Shape& s, int C, int S, long long dyn_bytes,
                     cudaStream_t stream) {
  static const ClusterLaunch table[4] = {
      &launch_cluster<int, short, false>, &launch_cluster<int, short, true>,
      &launch_cluster<int, int, false>, &launch_cluster<int, int, true>};
  return table[cnt32 * 2 + on_chip](a, s, C, S, dyn_bytes, stream);
}

int limit_large_i32(bool cnt32, bool on_chip, int* out) {
  static int (*const table[4])(int*) = {
      &cluster_limit<int, short, false>, &cluster_limit<int, short, true>,
      &cluster_limit<int, int, false>, &cluster_limit<int, int, true>};
  return table[cnt32 * 2 + on_chip](out);
}

}  // namespace kgpu
