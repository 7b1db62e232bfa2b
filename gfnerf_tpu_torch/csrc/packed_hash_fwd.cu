// Packed (supercell) anchored hash encode, forward (H1).
//
// Replaces gfnerf_tpu/fields/packed_hash.py:202 (packed_hash_encode_raw) and
// :262 (_interp_level), which the JAX package builds from XLA gathers; it is
// the same kernel class as the reference's Hash3DAnchored_cuda.cu. Per
// (point, level), with the addressing of packed_hash_common.cuh (supercell,
// local cell, fraction, hash or dense row):
//   out[p, level*C + c] = trilinear sum over the cell's 8 corners, read from
//         the row's [i][j][k][c] lattice at offsets (l + {0,1}) per axis.
// Output is (P, L*C) f32, exactly 0 where the anchor is < 0, as the JAX
// encode's multiply by (anchor >= 0) gives.
//
// Bound: random 32-byte sector reads of the bf16 table (8 levels x 2^15 rows
// x 128 columns = 64 MB, against a 50 MB L2), and the (P, L*C) f32 output.
// Design:
// - Level-major warps over consecutive samples (TileMap, shared with H2): a
//   block stages its tile's points and anchors in shared memory; each warp
//   takes 32 consecutive points at ONE level, so a load instruction reads
//   one level's table, and lanes of a run in the same cell read the same
//   sectors (one request instead of up to 32 rows of 8 tables).
// - A tile of 128 points at all 8 levels (kEncodePasses pairs per warp): the
//   block's fixed costs, the staging round trip and the two barriers, are
//   spread over four times the work of one 32-point slice.
// - Each lane reads only its 8 corners' C channels (C*2 bytes each, one
//   vector load), not the whole 256-byte row.
// - Masked points (anchor < 0) issue no table read and no arithmetic, and
//   write exact zeros.
// - The tile's (points x L*C) f32 output is staged in shared memory and
//   written back with coalesced 16-byte stores (a warp per level would
//   otherwise store C floats at a stride of L*C), evict-first like the
//   points' loads, so the L2 keeps the table.
// The corner sums follow _interp_level's z -> y -> x order, each multiply
// and add rounded on its own (__fmul_rn, __fadd_rn: no multiply-add
// contraction), as the plain version's separate PyTorch operations round
// them. The skipped lattice entries have weight exactly 0 there and add
// exact zeros, so the output equals the plain version's bit for bit, and
// the MLPs downstream see the same bf16 inputs on either path. With a base
// the write-back adds it (packed_hash_encode.cuh): bit-equal to the separate
// sum, and the bound then counts the base's read as well.

#include <cuda_runtime.h>

#include "packed_hash_encode.cuh"

// The kernel itself is packed_hash_encode.cuh's, shared with the routed
// encode (H3), here without a block per point.  base: null, or (P, L*C) f32
// that the output is added to (out = base + encode; out may be base): the
// focal stage's residual sum of the frozen global encode and the block's.
extern "C" int gfnerf_packed_hash_fwd(
    const void* table, const int* primes, const float* bias,
    const float* scales, const int* dense_m, const float* points,
    const int* anchors, const float* base, float* out, long long n_points,
    int n_levels, int n_volumes, int n_rows, int width, int n_channels,
    int lattice_edge, void* stream) {
  return gfnerf::dispatch_encode<false>(
      table, primes, bias, scales, dense_m, points, anchors, nullptr, base,
      out, n_points, 1, n_levels, n_volumes, n_rows, width, n_channels,
      lattice_edge, (cudaStream_t)stream);
}
