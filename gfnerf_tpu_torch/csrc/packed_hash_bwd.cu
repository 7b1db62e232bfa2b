// Packed (supercell) anchored hash encode, table gradient (H2).
//
// Replaces gfnerf_tpu/fields/packed_hash.py:490 (_phe_bwd, the custom VJP of
// packed_hash_encode), which builds the dense table gradient on the TPU
// from a sort of each level's (point, level) pairs by table row and a sum
// of each row's segment (_sorted_segment_rows, _runend_diff): an order
// fixed by the sort, so the same inputs give the same bits.  Here it is
// the same owner-computes structure, in exact int64 fixed point
// (fixed_point.cuh), so that it too is a function of its inputs whatever
// order the warps land in.  Per (point, level), with the addressing of
// packed_hash_common.cuh that the forward (H1) uses:
//   grad[level, row, o*C + c] = sum of t = w_o * g[p, level*C + c]
// over the cell's 8 corners o = (l + {0,1}) per axis of the row's lattice,
// with w_o the trilinear weight (wx * wy) * wz as _lattice_weights forms it
// and t rounded to f32 (__fmul_rn), then to the level's fixed point.  The
// other lattice entries have weight exactly 0 there and are skipped;
// columns past lattice*C are never added to and stay 0.  Points with
// anchor < 0 add nothing.  The result equals the plain version
// (packed_hash_backward_reference) bit for bit.
//
// Each (point, level) lands in exactly one row, so the rows own their sums:
// 64-bit reductions only where a row is split, and no int64 accumulator of
// the table's size.  Four launches a call, two zero-fills (the counters,
// the long rows' sums):
// 1. count: per (level, row), the (point, level) pairs that land in it
//    (int32 counters).  A block takes a tile of consecutive points at
//    every level; each warp 32 consecutive points at one level.  Runs of
//    consecutive lanes in one row (warp_runs.cuh) bump their counter once.
// 2. scan: the counters into each row's first record (an exclusive scan in
//    one launch: tiles of 16384 counters, each tile's total chained from the
//    previous tile's).  A row of more than kChunk records is split into
//    chunks of kChunk: it gets a slot of int64 sums and a ticket (both
//    zeroed beforehand) and a work item per chunk after its first.
// 3. scatter: the same pass as the count, now writing one record per
//    (point, level) at its row's cursor (one cursor atomic per run):
//    the local cell per axis (clamped to [-2, E], 4 bits each) and the f32
//    fraction per axis, exactly as axis_factors forms them, and the level's
//    C values of g.  The pass also takes the level maxima of g, for the
//    scale of each level's fixed point.  The order of the records inside a
//    row is free: the sum is exact.
// 4. owner: a warp takes a row (or a chunk of a long one) and reads its
//    records 32 at a time, the next 32 in registers while it sums the
//    current ones from shared memory.  A warp step takes 4 records, a
//    group of 8 lanes each: lane (group, corner) forms its corner's weight
//    once and adds the corner's C terms' q into its group's copy of the
//    row's int64 sums in shared memory (RowSums: a layout in which a
//    half-warp's 16 accesses hit 16 distinct bank pairs).  Then the warp
//    adds the copies, converts the sums and writes the row's W f32 once,
//    zeros included.  A long row's chunks add their sums into the row's
//    slot with 64-bit reductions on that row alone (order-free); the chunk
//    that takes the row's last ticket converts the slot and writes the row.
// Bound: the upstream gradient and the points read, the records written and
// read once, the (L, rows, W) gradient written once.
// With a non-null red_ops (L,) the kernels also count, per level, the
// counter and cursor atomics (one per run of a warp, each pass) and the
// long rows' 64-bit reductions (lattice*C a chunk) they issue.

#include <cuda_runtime.h>

#include "bucket_scan.cuh"
#include "fixed_point.cuh"
#include "packed_hash_common.cuh"
#include "warp_runs.cuh"

namespace {

constexpr unsigned kFull = gfnerf::kFullWarp;
constexpr int kTilePoints = 256;           // count, scatter: a block's points
constexpr int kTileWarps = 8;              // and its warps
constexpr int kSlices = kTilePoints / 32;  // 32-point slices of a tile
constexpr int kChunk = 1024;               // records a warp sums of a row
using gfnerf::kScanThreads;
using gfnerf::kScanTile;

// Where a lane's (point, level) lands, and the run of consecutive lanes in
// the same row that it belongs to.  Every lane of the warp calls it.
struct RowRun {
  gfnerf::HashCell cell;
  bool valid;  // anchor >= 0
  bool head;   // valid, and the first lane of its run
  int len;     // the run's length (lanes)
  int first;   // the run's first lane
};

template <int E>
__device__ __forceinline__ RowRun row_run(const int* __restrict__ primes,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ scales,
                                          const int* __restrict__ dense_m,
                                          const float* pt, int anchor, int l,
                                          int n_volumes, int n_rows,
                                          int lane) {
  RowRun r;
  r.valid = anchor >= 0;
  r.cell.row = 0u;
  if (r.valid)
    r.cell = gfnerf::locate<E - 1>(primes, bias, scales, dense_m, pt, anchor,
                                   l, n_volumes, n_rows);
  // every lane takes part in every shuffle: no && between them
  const unsigned left_row = __shfl_up_sync(kFull, r.cell.row, 1);
  const int left_valid = __shfl_up_sync(kFull, (int)r.valid, 1);
  const bool cut =
      !r.valid || lane == 0 || left_valid == 0 || left_row != r.cell.row;
  const gfnerf::WarpRuns runs = gfnerf::find_runs(cut, lane);
  r.head = r.valid && cut;
  r.len = runs.run_end - lane;
  r.first = runs.head;
  return r;
}

// Adds a warp's count of events at level l to red_ops (if given).
__device__ __forceinline__ void count_ops(unsigned long long* red_ops, int l,
                                          int n, int lane) {
  if (red_ops == nullptr) return;
  n = __reduce_add_sync(kFull, n);
  if (lane == 0 && n > 0) atomicAdd(red_ops + l, (unsigned long long)n);
}

template <int E>
__global__ void __launch_bounds__(kTilePoints) packed_hash_bwd_count_kernel(
    const int* __restrict__ primes, const float* __restrict__ bias,
    const float* __restrict__ scales, const int* __restrict__ dense_m,
    const float* __restrict__ points, const int* __restrict__ anchors,
    int* __restrict__ counts, unsigned long long* __restrict__ red_ops,
    long long n_points, int n_levels, int n_volumes, int n_rows) {
  __shared__ float s_pts[kTilePoints * 3];
  __shared__ int s_anc[kTilePoints];
  const long long p0 = (long long)blockIdx.x * kTilePoints;
  const int n_tile = (int)min((long long)kTilePoints, n_points - p0);
  gfnerf::stage_points(points, anchors, p0, n_tile, kTilePoints, s_pts,
                       s_anc);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int job = warp; job < n_levels * kSlices; job += kTileWarps) {
    const int l = job / kSlices;
    const int lp = (job - l * kSlices) * 32 + lane;
    const RowRun run = row_run<E>(primes, bias, scales, dense_m,
                                  s_pts + lp * 3, s_anc[lp], l, n_volumes,
                                  n_rows, lane);
    if (run.head)
      atomicAdd(counts + (size_t)l * n_rows + run.cell.row, run.len);
    count_ops(red_ops, l, run.head ? 1 : 0, lane);
  }
}

// The counters (n_keys: L * rows) into each row's first record, in place
// (bucket_scan.cuh, a bucket a row); the caller zeroes the long rows' slots
// and tickets.
__global__ void __launch_bounds__(gfnerf::kScanThreads)
    packed_hash_bwd_scan_kernel(int* __restrict__ counts,
                                int* __restrict__ flags, int* __restrict__ ctl,
                                int* __restrict__ slot_of,
                                int2* __restrict__ items, long long n_keys) {
  gfnerf::bucket_scan<kChunk>(counts, flags, ctl, slot_of, items, n_keys,
                              nullptr, 0, nullptr);
}

template <int C>
struct Record {  // one (point, level) in its row: 4 + C f32 words
  static constexpr int kWords = 4 + C;
};

template <int E, int C>
__global__ void __launch_bounds__(kTilePoints) packed_hash_bwd_scatter_kernel(
    const float* __restrict__ g,        // (P, L*C) upstream gradient
    const int* __restrict__ primes,     // (L, V, 3) uint32 bits
    const float* __restrict__ bias,     // (L, V, 3)
    const float* __restrict__ scales,   // (L,)
    const int* __restrict__ dense_m,    // (L,) 0 = hashed level
    const float* __restrict__ points,   // (P, 3)
    const int* __restrict__ anchors,    // (P,)
    int* __restrict__ cursor,           // (L * rows) each row's next record
    float* __restrict__ records,        // (P * L, 4 + C)
    unsigned* __restrict__ gmax,        // (L,) max |g| bits per level, zeroed
    unsigned long long* __restrict__ red_ops,  // (L,) or null
    long long n_points, int n_levels, int n_volumes, int n_rows) {
  constexpr int kWords = Record<C>::kWords;
  __shared__ float s_pts[kTilePoints * 3];
  __shared__ int s_anc[kTilePoints];
  extern __shared__ unsigned s_max[];  // (L,)
  for (int i = threadIdx.x; i < n_levels; i += blockDim.x) s_max[i] = 0u;
  const long long p0 = (long long)blockIdx.x * kTilePoints;
  const int n_tile = (int)min((long long)kTilePoints, n_points - p0);
  gfnerf::stage_points(points, anchors, p0, n_tile, kTilePoints, s_pts,
                       s_anc);
  __syncthreads();
  const int lc = n_levels * C;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int job = warp; job < n_levels * kSlices; job += kTileWarps) {
    const int l = job / kSlices;
    const int lp = (job - l * kSlices) * 32 + lane;
    float gv[C];
    unsigned m = 0u;
    const float* gp = g + (p0 + lp) * lc + l * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      gv[ch] = lp < n_tile ? __ldg(gp + ch) : 0.f;
      m = max(m, gfnerf::abs_bits(gv[ch]));
    }
    m = __reduce_max_sync(kFull, m);
    if (lane == 0 && m != 0u) atomicMax(s_max + l, m);

    const RowRun run = row_run<E>(primes, bias, scales, dense_m,
                                  s_pts + lp * 3, s_anc[lp], l, n_volumes,
                                  n_rows, lane);
    int base = 0;
    if (run.head)
      base = atomicAdd(cursor + (size_t)l * n_rows + run.cell.row, run.len);
    base = __shfl_sync(kFull, base, run.first);
    if (run.valid) {
      float w[kWords];
      unsigned loc = 0u;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        w[a] = run.cell.frac[a];
        loc |= (unsigned)(min(max(run.cell.loc[a], -2), E) + 2) << (4 * a);
      }
      w[3] = __uint_as_float(loc);
#pragma unroll
      for (int ch = 0; ch < C; ++ch) w[4 + ch] = gv[ch];
      // plain stores: a record's halves meet in the L2 before it writes
      // the sector back
      float* dst = records + (size_t)(base + lane - run.first) * kWords;
      if constexpr (kWords % 4 == 0) {
#pragma unroll
        for (int q = 0; q < kWords / 4; ++q)
          reinterpret_cast<float4*>(dst)[q] = make_float4(
              w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < kWords / 2; ++q)
          reinterpret_cast<float2*>(dst)[q] =
              make_float2(w[2 * q], w[2 * q + 1]);
      }
    }
    count_ops(red_ops, l, run.head ? 1 : 0, lane);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_levels; i += blockDim.x)
    if (s_max[i] != 0u) atomicMax(gmax + i, s_max[i]);
}

// What the owner warps read: the rows' record ends (after the scatter each
// row's cursor is one past its last record, so a row's records start at
// the previous row's end), the long rows' slots and tickets, the items.
struct OwnerArgs {
  const float* records;
  const int* ends;
  const int* slot_of;
  const int2* items;
  const int* n_items;
  long long* slot_sums;
  int* tickets;
  const unsigned* gmax;
  float* grad;
  unsigned long long* red_ops;
  long long n_keys;
  int n_rows;
  int width;
  int log2_points;
};

// The owner warp's int64 sums of a row in shared memory.  A warp step takes
// 4 records, one a group of 8 lanes, and lane (group g, corner o) adds its
// corner's C channels of its group's record (so the corner's weight is
// formed once for C terms).  Each group has its own copy of the sums, so no
// two lanes of a step add into one word, and the copies are added when the
// row is done.  Layout: the 8 corners of any cell have distinct parities
// (x, y, z mod 2), so parity p = 4 (x & 1) + 2 (y & 1) + (z & 1) picks the
// bank pair, groups g and g ^ 1 take the halves 0-7 and 8-15 of the 16
// bank pairs (a half-warp), and m = 4 (x >> 1) + 2 (y >> 1) + (z >> 1)
// (unique within a parity for E <= 4) and the channel pick the row of 16:
//   address = (g >> 1) 128 C + 16 (m C + ch) + 8 (g & 1) + p   (int64)
// so each of a step's C 64-bit reads or writes (a channel at a time) hits
// 16 distinct bank pairs in each half-warp.
template <int E, int C>
struct RowSums {
  static_assert(E <= 4, "m = 4 (x >> 1) + ... must stay under 8");
  static constexpr int kGroups = 4;
  static constexpr int kSize = 2 * 128 * C;  // int64 a warp, all groups
  __device__ static int at(int x, int y, int z, int ch, int g) {
    const int par = 4 * (x & 1) + 2 * (y & 1) + (z & 1);
    const int m = 4 * (x >> 1) + 2 * (y >> 1) + (z >> 1);
    return (g >> 1) * 128 * C + 16 * (m * C + ch) + 8 * (g & 1) + par;
  }
  __device__ static int column(int col, int g) {  // col = e * C + ch
    const int e = col / C;
    return at(e / (E * E), (e / E) % E, e % E, col % C, g);
  }
  // column col's sum over the groups' copies
  __device__ static long long total(const long long* acc, int col) {
    const int a = column(col, 0);
    return acc[a] + acc[a + 8] + acc[a + 128 * C] + acc[a + 128 * C + 8];
  }
};

// Warps a block of the owner: the sums and 32 staged records a warp fit
// 48 KB (C = 2: 8, C = 4: 4, C = 8: 2).
template <int C>
struct Owner {
  static constexpr int kWarps = C == 2 ? 8 : (C == 4 ? 4 : 2);
};

// Record i (if below `last`) into registers, 8 bytes a load (records are
// 8-byte aligned at every C).
template <int C>
__device__ __forceinline__ void load_record(
    const float* __restrict__ records, int i, int last,
    float2 (&v)[Record<C>::kWords / 2]) {
  if (i >= last) return;
  const float2* src =
      reinterpret_cast<const float2*>(records + (size_t)i * Record<C>::kWords);
#pragma unroll
  for (int q = 0; q < Record<C>::kWords / 2; ++q) v[q] = __ldcs(src + q);
}

// A warp's sums of chunk `chunk` of row `key` (acc: RowSums, rec: 32
// records of shared memory), then the row's write (or the chunk's share
// of a long row, and the write by the chunk with the last ticket).
template <int E, int C>
__device__ __forceinline__ void owner_item(const OwnerArgs& a, long long key,
                                           int chunk, long long* acc,
                                           float* rec, int lane) {
  using Sums = RowSums<E, C>;
  constexpr int kWords = Record<C>::kWords;
  constexpr int kLive = E * E * E * C;  // the lattice's columns
  const int l = (int)(key / a.n_rows);
  const int end = a.ends[key];
  const int start = key > 0 ? a.ends[key - 1] : 0;
  const int n_chunks = (end - start + kChunk - 1) / kChunk;
  float* out = a.grad + (size_t)key * a.width;
  const int shift = gfnerf::level_shift(a.gmax[l], a.log2_points);
  if (shift == gfnerf::kNonFinite) {  // NaN throughout the level
    if (chunk == 0)
      for (int col = lane; col < a.width; col += 32)
        __stcs(out + col, __int_as_float(0x7fc00000));
    return;
  }
  for (int i = lane; i < Sums::kSize / 2; i += 32)  // 16 bytes a lane
    reinterpret_cast<longlong2*>(acc)[i] = make_longlong2(0, 0);
  __syncwarp();
  const gfnerf::Scale32 scale = gfnerf::scale32(shift);
  const int g = lane >> 3;  // this lane's record of a step, and its corner
  const int u[3] = {(lane >> 2) & 1, (lane >> 1) & 1, lane & 1};
  const int first = start + chunk * kChunk;
  const int last = min(end, first + kChunk);
  // the records 32 at a time, lane i holding record i of the next batch
  // in registers while the warp sums the current one from shared memory
  float2 next[kWords / 2];
  load_record<C>(a.records, first + lane, last, next);
  for (int b = first; b < last; b += 32) {
    const int n = min(32, last - b);
    __syncwarp();  // the previous batch's reads are done
#pragma unroll
    for (int q = 0; q < kWords / 2; ++q)
      reinterpret_cast<float2*>(rec + lane * kWords)[q] = next[q];
    __syncwarp();
    load_record<C>(a.records, b + 32 + lane, last, next);
    for (int r0 = 0; r0 < n; r0 += Sums::kGroups) {  // every lane: a step
      const int r = r0 + g;
      if (r < n) {
        const float* R = rec + r * kWords;
        float f[3];
        unsigned loc;
        if constexpr (kWords % 4 == 0) {  // one 16-byte read
          const float4 head = *reinterpret_cast<const float4*>(R);
          f[0] = head.x;
          f[1] = head.y;
          f[2] = head.z;
          loc = __float_as_uint(head.w);
        } else {
          f[0] = R[0];
          f[1] = R[1];
          f[2] = R[2];
          loc = __float_as_uint(R[3]);
        }
        int pos[3];
        float wt[3];
        bool inside = true;
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          pos[ax] = (int)((loc >> (4 * ax)) & 15u) - 2 + u[ax];
          inside = inside && pos[ax] >= 0 && pos[ax] < E;
          wt[ax] = u[ax] ? f[ax] : 1.f - f[ax];
        }
        if (inside) {  // C independent reads, then C writes
          const float w = __fmul_rn(__fmul_rn(wt[0], wt[1]), wt[2]);
          long long* sum = acc + Sums::at(pos[0], pos[1], pos[2], 0, g);
          long long q[C], old[C];
#pragma unroll
          for (int ch = 0; ch < C; ++ch) {
            q[ch] = gfnerf::quantize32(__fmul_rn(w, R[4 + ch]), scale);
            old[ch] = sum[16 * ch];
          }
#pragma unroll
          for (int ch = 0; ch < C; ++ch) sum[16 * ch] = old[ch] + q[ch];
        }
      }
      __syncwarp();
    }
  }
  __syncwarp();
  const double inv = gfnerf::pow2(-shift);
  if (n_chunks <= 1) {
    for (int col = lane; col < a.width; col += 32)
      __stcs(out + col, gfnerf::fixed_to_f32(
                            col < kLive ? Sums::total(acc, col) : 0LL, inv));
    return;
  }
  // a long row: the chunks meet in its slot
  const int slot = a.slot_of[key];
  long long* sums = a.slot_sums + (size_t)slot * kLive;
  for (int col = lane; col < kLive; col += 32)
    atomicAdd(reinterpret_cast<unsigned long long*>(sums + col),
              (unsigned long long)Sums::total(acc, col));
  count_ops(a.red_ops, l, (kLive - lane + 31) / 32, lane);
  __threadfence();
  __syncwarp();
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(a.tickets + slot, 1);
  ticket = __shfl_sync(kFull, ticket, 0);
  if (ticket != n_chunks - 1) return;
  __threadfence();
  for (int col = lane; col < a.width; col += 32)
    __stcs(out + col, gfnerf::fixed_to_f32(
                          col < kLive ? __ldcg(sums + col) : 0LL, inv));
}

template <int E, int C>
__global__ void __launch_bounds__(32 * Owner<C>::kWarps)
    packed_hash_bwd_owner_kernel(OwnerArgs a) {
  constexpr int kWarps = Owner<C>::kWarps;
  constexpr int kSums = RowSums<E, C>::kSize;
  __shared__ __align__(16) long long s_acc[kWarps * kSums];
  __shared__ __align__(16) float s_rec[kWarps * 32 * Record<C>::kWords];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  long long* acc = s_acc + warp * kSums;
  float* rec = s_rec + warp * 32 * Record<C>::kWords;
  const long long gw = (long long)blockIdx.x * kWarps + warp;
  const long long nw = (long long)gridDim.x * kWarps;
  for (long long key = gw; key < a.n_keys; key += nw)
    owner_item<E, C>(a, key, 0, acc, rec, lane);
  const int n_items = __ldcg(a.n_items);
  for (long long i = gw; i < n_items; i += nw) {
    const int2 it = a.items[i];
    owner_item<E, C>(a, it.x, it.y, acc, rec, lane);
  }
}

#define GFNERF_CHECK(expr)                     \
  do {                                         \
    const cudaError_t err_ = (expr);           \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

template <int E, int C>
int launch(const float* g, const int* primes, const float* bias,
           const float* scales, const int* dense_m, const float* points,
           const int* anchors, float* grad, float* records, int* ctrl,
           int* slot_of, int* items, long long* slot_sums,
           unsigned long long* red_ops, int* launches, int* memsets,
           long long n_points, int n_levels, int n_volumes, int n_rows,
           int width, int n_slots, cudaStream_t stream) {
  const long long n_keys = (long long)n_levels * n_rows;
  if (n_points == 0) {  // no points, no launch
    GFNERF_CHECK(cudaMemsetAsync(grad, 0, sizeof(float) * n_keys * width,
                                 stream));
    ++*memsets;
    return (int)cudaSuccess;
  }
  const long long n_scan = (n_keys + kScanTile - 1) / kScanTile;
  int* counts = ctrl;  // then each row's first record, then its end
  int* flags = ctrl + n_keys;
  int* ctl = flags + n_scan;
  unsigned* gmax = reinterpret_cast<unsigned*>(ctl + 4);
  int* tickets = ctl + 4 + n_levels;
  GFNERF_CHECK(cudaMemsetAsync(
      ctrl, 0, sizeof(int) * (n_keys + n_scan + 4 + n_levels + n_slots),
      stream));
  ++*memsets;
  GFNERF_CHECK(cudaMemsetAsync(
      slot_sums, 0, sizeof(long long) * n_slots * E * E * E * C, stream));
  ++*memsets;
  const unsigned tiles = (unsigned)((n_points + kTilePoints - 1) / kTilePoints);
  packed_hash_bwd_count_kernel<E><<<tiles, kTilePoints, 0, stream>>>(
      primes, bias, scales, dense_m, points, anchors, counts, red_ops,
      n_points, n_levels, n_volumes, n_rows);
  GFNERF_CHECK(cudaGetLastError());
  ++*launches;
  packed_hash_bwd_scan_kernel<<<(unsigned)n_scan, kScanThreads, 0, stream>>>(
      counts, flags, ctl, slot_of, reinterpret_cast<int2*>(items), n_keys);
  GFNERF_CHECK(cudaGetLastError());
  ++*launches;
  packed_hash_bwd_scatter_kernel<E, C>
      <<<tiles, kTilePoints, sizeof(unsigned) * n_levels, stream>>>(
          g, primes, bias, scales, dense_m, points, anchors, counts, records,
          gmax, red_ops, n_points, n_levels, n_volumes, n_rows);
  GFNERF_CHECK(cudaGetLastError());
  ++*launches;
  OwnerArgs a;
  a.records = records;
  a.ends = counts;
  a.slot_of = slot_of;
  a.items = reinterpret_cast<const int2*>(items);
  a.n_items = ctl + 2;
  a.slot_sums = slot_sums;
  a.tickets = tickets;
  a.gmax = gmax;
  a.grad = grad;
  a.red_ops = red_ops;
  a.n_keys = n_keys;
  a.n_rows = n_rows;
  a.width = width;
  a.log2_points = gfnerf::ceil_log2(n_points);
  constexpr int kWarps = Owner<C>::kWarps;
  long long blocks = (n_keys + kWarps - 1) / kWarps;
  blocks = blocks < 132 * 64 / kWarps ? blocks : 132 * 64 / kWarps;
  packed_hash_bwd_owner_kernel<E, C>
      <<<(unsigned)blocks, 32 * kWarps, 0, stream>>>(a);
  GFNERF_CHECK(cudaGetLastError());
  ++*launches;
  return (int)cudaSuccess;
}

}  // namespace

// Supported (lattice edge E, channels C): (2, 8), (3, 4), (4, 2), as for the
// forward. Anything else returns cudaErrorInvalidValue without launching.
// Scratch on the device, none zeroed by the caller:
//   records   (P * L, 4 + C) f32: the (point, level) records;
//   ctrl      (L * rows + ceil(L * rows / 16384) + 4 + L + n_slots) int32:
//             the row counters, the scan's tile flags, its ticket and the
//             counts of long rows and items, the level maxima, the long
//             rows' tickets (zeroed here);
//   slot_of   (L * rows) int32;
//   items     (max(1, P * L / 1024), 2) int32;
//   slot_sums (n_slots, E^3 * C) int64, n_slots >= the rows of more than
//             1024 records (max(1, min(L * rows, P * L / 1025))): the
//             long rows' sums (zeroed here).
// red_ops: null, or (L,) uint64 counters on the device that the kernels add
// the atomics they issued per level to (the counters', the cursors', and,
// at a finite level, the long rows' 64-bit reductions).  launches and
// memsets: host ints that get the kernel launches (4; none without points)
// and the zero-fills (2) made added to them.
extern "C" int gfnerf_packed_hash_bwd(
    const float* g, const int* primes, const float* bias, const float* scales,
    const int* dense_m, const float* points, const int* anchors, float* grad,
    float* records, int* ctrl, int* slot_of, int* items, long long* slot_sums,
    unsigned long long* red_ops, int* launches, int* memsets,
    long long n_points, int n_levels, int n_volumes, int n_rows, int width,
    int n_channels, int lattice_edge, int n_slots, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define GFNERF_H2(E, C)                                                      \
  if (lattice_edge == E && n_channels == C)                                  \
    return launch<E, C>(g, primes, bias, scales, dense_m, points, anchors,   \
                        grad, records, ctrl, slot_of, items, slot_sums,      \
                        red_ops, launches, memsets, n_points, n_levels,      \
                        n_volumes, n_rows, width, n_slots, s);
  GFNERF_H2(2, 8)
  GFNERF_H2(3, 4)
  GFNERF_H2(4, 2)
#undef GFNERF_H2
  return (int)cudaErrorInvalidValue;
}
