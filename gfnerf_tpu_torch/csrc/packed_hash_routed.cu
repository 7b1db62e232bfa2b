// Packed (supercell) hash encode with a block per point, forward only (H3).
//
// Replaces gfnerf_tpu/fields/packed_hash.py:336 (packed_hash_encode_routed),
// the eval path's residual encode: the focal tables of all B blocks are
// stacked (B, L, rows, W), every block has its own primes and biases
// (B, L, V, 3), and each point reads the table of its own block, so that one
// render chunk can mix rays of every cluster.  Per (point, level) it is
// H1's computation (packed_hash_fwd.cu) with
//   primes, bias of (block, level, volume)      (packed_hash.py:370-372)
//   row of table (block, level)                 (row_base, :373)
// Output (P, L*C) f32, exactly 0 where the anchor or the block is < 0
// (:362); a block past the last is clipped to it (:364), so a bad block
// never indexes outside the tables.
//
// Bound: as H1's, the random sector reads of the bf16 tables (B x 64 MB at
// the main path's shape, more than the 50 MB L2 from B = 1 on) and the
// (P, L*C) f32 output; the blocks add 4 bytes a point, and a base its
// (P, L*C) f32 read.
// Design: H1's kernel (packed_hash_encode.cuh, ROUTED = true): the same
// level-major warps over consecutive samples, the tile's blocks staged in
// shared memory beside its anchors, masked points skipped, the output
// staged and stored coalesced.  Consecutive samples belong to one ray and
// rays carry one block each, so a warp's 32 points read one block's table
// but for the warps that straddle two rays.  The interpolation rounds as
// the plain version does: equal to it bit for bit.  The eval path's
// residual sum global + routed is folded into the write-back: given the
// global encode as base the kernel stores base + result, in place when out
// is base (packed_hash_encode.cuh), where a separate add took as long as
// this kernel.

#include <cuda_runtime.h>

#include "packed_hash_encode.cuh"

extern "C" int gfnerf_packed_hash_routed(
    const void* tables, const int* primes, const float* bias,
    const float* scales, const int* dense_m, const float* points,
    const int* anchors, const int* blocks, const float* base, float* out,
    long long n_points, int n_blocks, int n_levels, int n_volumes, int n_rows,
    int width, int n_channels, int lattice_edge, void* stream) {
  if (n_blocks < 1) return (int)cudaErrorInvalidValue;
  return gfnerf::dispatch_encode<true>(
      tables, primes, bias, scales, dense_m, points, anchors, blocks, base,
      out, n_points, n_blocks, n_levels, n_volumes, n_rows, width, n_channels,
      lattice_edge, (cudaStream_t)stream);
}
