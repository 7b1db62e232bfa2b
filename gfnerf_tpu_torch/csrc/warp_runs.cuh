// Warp aggregation of runs of equal cells, shared by the two table
// gradients (H2, packed_hash_bwd.cu; H5, hash_anchored_bwd.cu).
//
// Both kernels give each warp 32 consecutive points at one level, one point
// per lane.  The points are ray-major and in t order, so on the coarse
// levels neighbouring lanes fall into the same cell and would add into the
// same table entries.  A lane whose cell equals its left neighbour's joins
// that neighbour's run; a segmented shuffle scan sums the run's payloads
// into the run's first lane (its head), which alone makes the reductions.
// Equal cells address equal entries, so the merge is exact up to the order
// of the f32 sum.  The caller decides what "equal" means and marks the
// heads: lane 0, every masked lane (a run of its own, adding nothing), and
// every lane whose cell differs from its left neighbour's or whose left
// neighbour is masked.

#pragma once

#include <cuda_runtime.h>

namespace gfnerf {

constexpr unsigned kFullWarp = 0xffffffffu;

struct WarpRuns {
  int run_end;  // one past the last lane of this lane's run
  int longest;  // the warp's longest stretch from a lane to its run's end
};

// The runs that the lanes' `head` flags cut the warp into.  All 32 lanes
// call it; lane 0 must be a head.
__device__ __forceinline__ WarpRuns find_runs(bool head, int lane) {
  const unsigned heads = __ballot_sync(kFullWarp, head);
  const unsigned later = lane == 31 ? 0u : heads & (kFullWarp << (lane + 1));
  WarpRuns runs;
  runs.run_end = later ? __ffs(later) - 1 : 32;
  runs.longest = __reduce_max_sync(kFullWarp, runs.run_end - lane);
  return runs;
}

// Segmented suffix scan: lane i ends with the sum of pay over the lanes
// [i, run_end), so a run's head holds the run's total.  It takes only as
// many steps as the warp's longest run needs: none where every lane is a
// run of its own, as on the fine levels.
template <int O, int C>
__device__ __forceinline__ void sum_runs(float (&pay)[O][C],
                                         const WarpRuns& runs, int lane) {
  for (int off = 1; off < runs.longest; off <<= 1) {
    const bool take = lane + off < runs.run_end;
#pragma unroll
    for (int o = 0; o < O; ++o) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        const float v = __shfl_down_sync(kFullWarp, pay[o][ch], off);
        if (take) pay[o][ch] += v;
      }
    }
  }
}

}  // namespace gfnerf
