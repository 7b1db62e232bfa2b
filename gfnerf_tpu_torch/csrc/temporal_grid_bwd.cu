// Temporal multi-resolution grid encode, table gradient (T2).
//
// Replaces the VJP XLA builds for the gathers of
// gfnerf_tpu/fields/temporal_grid.py:163-171 (a scatter-add of whole
// 66-channel rows, one per (point, level, corner)).  Per (point, level),
// with T1's addressing (temporal_grid_common.cuh: window row r, slot j
// reading channel r + j, j = 0 the interpolating slot), for each corner o,
// gw_j = w_o * g[p, level * C + ((r + j) mod C)]:
//   grad[e_o, r]     += (1 - frac) * gw_0     (the old channel)
//   grad[e_o, r + j] += gw_j                  (j = 1 .. C - 1)
//   grad[e_o, r + C] += frac * gw_0           (the new channel)
// each term an f32 product as the plain version forms it (__fmul_rn).  The
// passthrough value at the interpolating slot gets nothing, as the JAX
// package's jnp.where drops it.
//
// The sum is exact, in int64 fixed point (fixed_point.cuh), so that the
// gradient is a function of its terms and not of the order in which the
// warps land, and equals the plain version (fields/temporal_grid.py,
// temporal_backward_reference) bit for bit.  Each term t is rounded once,
// q = rint(t 2^s), at its table row's shift s = 59 - ceil(log2 P) - E,
// where its row's largest |term| is below 2^E (row_shift).  The shift's
// bound: at one corner a point adds to the channels r, r + 1, ..., r + C,
// each once ((1 - frac) w g_0, w g_j, frac w g_0: distinct channels), so
// an entry takes at most 8 P terms, even where hashed corners collide,
// each below 2^E; its |sum| stays below 2^62 < 2^63.  A scale a row (and
// not a level, as H2 and H5 take) keeps a row of small terms as an f32 sum
// would keep them: at a level's scale, sums below 2^-53 of the level's
// largest |g| rounded to 0, and Adam (eps 1e-15) moves an entry of
// gradient 1e-15 by a whole step.  Each sum is converted once,
// RN_f32(RN_f64(sum) 2^-s).  A level whose g holds a NaN or an inf is NaN
// throughout.
//
// Bound: the bytes.  Compulsory traffic is the upstream gradient (P, L * C)
// f32, the points and times, and the dense (rows, C + T) f32 gradient
// written once (1.6 GB at nerfplayer-nerfacto's field).  The design is
// H2's owner-computes (packed_hash_bwd.cu), with buckets of 8 table rows
// (the level offsets are multiples of 8, so a bucket lies in one level):
// each bucket is written once, its zeros included, by the warp that owns
// it, and no float or int64 accumulator of the table's size exists.  A
// call's launches, in order on the stream, after one zero-fill (the
// bucket counters, the scan's flags and counters, the level maxima, the
// rows' maxima):
// 1. maxima: max |g| per level, one pass over g (fixed_point.cuh): a level
//    that is not finite is NaN throughout and takes no record.
// 2. count, one launch per group of levels (levels_per_launch): the packed
//    hash's tiles (TileMap: a block stages its points, times and the
//    group's columns of g in shared memory; each warp takes 32 consecutive
//    points at one level).  The points are ray-major and in t order, and
//    every sample of a ray has its camera's time, so on the coarse levels
//    neighbouring lanes share the cell and the window row: a lane whose
//    (cell x, y, z; row) equals its left neighbour's joins its run
//    (warp_runs.cuh), whose head makes one record per live corner (one
//    for which a lane of the run has a term that is not 0): the table
//    row, the window row and the run's C + 1 sums, C + 2 int64 words (32
//    bytes at C = 2).  The count takes each run's largest |term| a corner
//    (a segmented max over the lanes) into the corner's row's maximum,
//    and bumps each record's bucket counter, once for a corner and its
//    x-neighbour where both are live and share a bucket (7 in 8 do, dense
//    or hashed: the two rows differ in their low bits), all its atomics in
//    flight together.
// 3. scan (bucket_scan.cuh): the counters into each bucket's first record;
//    a bucket of more than kChunk records gets a slot of int64 sums,
//    zeroed there, and a work item per chunk after its first.
// 4. scatter, per group of levels: the count again, the atomics now
//    claiming each record's place at its bucket's cursor, then the terms
//    rounded at their rows' scales and the runs' int64 sums (a
//    segmented shuffle scan, exact), four corners at a time (fewer
//    registers), each record written where it was claimed.  The order of
//    the records inside a bucket is free: the sum is exact.
// 5. owner: a warp takes a bucket (or a chunk of a long one), adds its
//    records' sums into the bucket's 8 x (C + T) int64 sums in shared
//    memory (a lane a record, 32 at a time, each int64 add two native
//    32-bit shared atomics, add_shared: records of one row and window row
//    hit the same words), converts them at their rows' scales and writes
//    the 8 rows once, coalesced, with 16-byte stores, zeros included (a
//    bucket with no record is written as zeros, or as NaN at a level that
//    is not finite).  A warp loads its next bucket's record range
//    and first 32 records while it sums the current one.  A long bucket's
//    chunks add their sums into its slot with 64-bit reductions; the chunk
//    that takes the slot's last ticket converts it and writes the rows.
// With a non-null level_records (L,) the count pass also counts the
// records it makes per level.

#include <cuda_runtime.h>

#include "bucket_scan.cuh"
#include "fixed_point.cuh"
#include "packed_hash_common.cuh"
#include "temporal_grid_common.cuh"
#include "warp_runs.cuh"

namespace {

using namespace gfnerf::temporal;
using gfnerf::TileMap;

constexpr unsigned kFull = gfnerf::kFullWarp;
// (slice, level) pairs per warp of the tile passes, as H5 takes
constexpr int kPasses = 2;
constexpr int kBucketRows = 8;  // table rows a bucket
// the scatter forms and sums its terms for 4 corners at a time: a corner
// and its x-neighbour in one group, two groups
constexpr int kGroupCorners = 4;
constexpr int kChunk = 1024;    // records a warp sums of a bucket
constexpr int kOwnerWarps = 8;  // warps a block of the owner pass
// blocks a multiprocessor that the tile and owner passes' registers are
// capped for (85 a thread): on an H100 both ran faster so than with no cap
// (2 blocks), and than at 4 to 6 blocks (spilled)
constexpr int kMinBlocks = 3;

#define GFNERF_CHECK(expr)                     \
  do {                                         \
    const cudaError_t err_ = (expr);           \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

// Stage the tile's points (3 floats each) and times in shared memory, with
// evict-first loads.
__device__ __forceinline__ void stage_tile(const float* __restrict__ xyz,
                                           const float* __restrict__ times,
                                           long long p0, int n_tile,
                                           float* s_pts, float* s_t) {
  for (int i = threadIdx.x; i < 3 * n_tile; i += blockDim.x)
    s_pts[i] = __ldcs(xyz + p0 * 3 + i);
  for (int i = threadIdx.x; i < n_tile; i += blockDim.x)
    s_t[i] = __ldcs(times + p0 + i);
}

__global__ void __launch_bounds__(gfnerf::kFixedThreads)
    temporal_grid_bwd_max_kernel(const float* __restrict__ g, long long n,
                                 int lc, int c, unsigned* __restrict__ gmax) {
  extern __shared__ unsigned s_max[];
  gfnerf::level_max_pass(g, n, lc, c, gmax, s_max);
}

// A table row's fixed-point shift from the f32 bits of its largest |term|
// (finite): s = 59 - ceil(log2 P) - E, fixed_point.cuh's level_shift with
// 3 more bits of headroom.  An entry takes at most 8 P terms (8 corners a
// point, each into a channel once), each below 2^E, so its sum at the
// scale 2^s stays below 2^62.
__device__ __forceinline__ int row_shift(unsigned max_bits,
                                         int log2_points) {
  return gfnerf::level_shift(max_bits, log2_points + 3);
}

// Segmented max over the warp's runs (as sum_runs sums): lane i ends with
// the max of m over the lanes [i, run_end), so a run's head holds the
// run's.
__device__ __forceinline__ void max_runs(unsigned (&m)[8],
                                         const gfnerf::WarpRuns& runs,
                                         int lane) {
  for (int off = 1; off < runs.longest; off <<= 1) {
    const bool take = lane + off < runs.run_end;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const unsigned v = __shfl_down_sync(kFull, m[d], off);
      if (take) m[d] = max(m[d], v);
    }
  }
}

// A lane's terms at corner d, channels r .. r + C (j the window's slots:
// gv[j] is g of slot (r + j) mod C).
template <int C>
__device__ __forceinline__ void corner_terms(const float frac[3], float keep_t,
                                             float frac_t, const float gv[C],
                                             int d, float (&t)[C + 1]) {
  const float w = corner_weight(frac, d);
  const float gw = __fmul_rn(w, gv[0]);
  t[0] = __fmul_rn(keep_t, gw);
  t[C] = __fmul_rn(frac_t, gw);
#pragma unroll
  for (int j = 1; j < C; ++j) t[j] = __fmul_rn(w, gv[j]);
}

// Record `at`: word 0 the table row (low 32 bits) and the window row (high
// 32), words 1 .. C + 1 the sums of the channels r .. r + C.  Records are
// 16-byte aligned where C + 2 is even.
template <int C>
__device__ __forceinline__ void write_record(long long* __restrict__ records,
                                             int at, long long row, int r,
                                             const long long (&q)[C + 1]) {
  long long* dst = records + (size_t)at * (C + 2);
  const long long head = (long long)(unsigned)row | ((long long)r << 32);
  if constexpr (C % 2 == 0) {
    longlong2* d2 = reinterpret_cast<longlong2*>(dst);
    d2[0] = make_longlong2(head, q[0]);
#pragma unroll
    for (int k = 1; k + 1 <= C; k += 2)
      d2[(k + 1) / 2] = make_longlong2(q[k], q[k + 1]);
  } else {
    dst[0] = head;
#pragma unroll
    for (int k = 0; k <= C; ++k) dst[1 + k] = q[k];
  }
}

// The count (kScatter false: buckets are the counters) and the scatter
// (true: buckets are the cursors) over a group of levels [l0, l0 + n_lev).
// A run's corner is live where a term of one of its lanes is not 0; the
// count pass takes each live corner's largest |term| over the run into
// its row's maximum (row_max, one atomic a live corner), which sets the
// row's fixed-point scale (row_shift); the scatter writes a live corner's
// record with the run's sums of the terms at that scale.  A head claims
// its live corners' records first, all its atomics in flight together;
// the scatter then forms, rounds and sums the terms kGroupCorners corners
// at a time (fewer registers) and writes the records.
template <int C, bool kScatter>
__global__ void __launch_bounds__(32 * gfnerf::kWarps, kMinBlocks)
    temporal_grid_bwd_tile_kernel(
        const float* __restrict__ g, const float* __restrict__ xyz,
        const float* __restrict__ times, const long long* __restrict__ offsets,
        const int* __restrict__ resolutions, const int* __restrict__ hashed,
        const unsigned* __restrict__ gmax, unsigned* __restrict__ row_max,
        int* __restrict__ buckets, long long* __restrict__ records,
        unsigned long long* __restrict__ level_records, long long n_points,
        int n_levels, int n_rows, float time_scale, TileMap map, int l0,
        int n_lev) {
  const gfnerf::BlockTile work(map, n_points);
  const int lc = n_levels * C;
  const int gc = n_lev * C;  // the launch's columns of g
  const int gs = gc + 1;     // odd stride: a warp's column reads hit 32 banks
  extern __shared__ float smem[];
  float* s_g = smem;                     // [points][gs]
  float* s_pts = s_g + map.points * gs;  // [points][3]
  float* s_t = s_pts + map.points * 3;   // [points]
  stage_tile(xyz, times, work.p0, work.n_tile, s_pts, s_t);
  gfnerf::load_rows(g + work.p0 * lc + l0 * C, s_g, work.n_tile, gc, lc, gs);
  __syncthreads();

  const int log2_points = gfnerf::ceil_log2(n_points);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int pair = warp; pair < map.slices * n_lev; pair += map.warps) {
    const int lg = pair % n_lev;  // level within the group
    const int l = l0 + lg;
    if (gmax[l] >= 0x7f800000u) continue;  // not finite: NaN (the owner)
    const int lp = (pair / n_lev) * 32 + lane;
    const bool valid = lp < work.n_tile;
    const Level lv(offsets, resolutions, hashed, l);
    int key[4] = {0, 0, 0, -1};  // the cell x, y, z and the window row
    float frac[3] = {0.f, 0.f, 0.f}, frac_t = 0.f, keep_t = 0.f;
    float gv[C] = {};  // g in the window's order: slot (r + j) mod C's
    unsigned m[8];     // per corner, the largest |term| as f32 bits
    unsigned nz = 0u;  // bit d: a term of corner d is not 0
#pragma unroll
    for (int d = 0; d < 8; ++d) m[d] = 0u;
    if (valid) {
      key[3] = time_row(s_t[lp], time_scale, n_rows, &frac_t);
      keep_t = __fsub_rn(1.f, frac_t);
      level_cell(s_pts + lp * 3, lv.res, key, frac);
#pragma unroll
      for (int j = 0; j < C; ++j)
        gv[j] = s_g[lp * gs + lg * C + (key[3] + j) % C];
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        float t[C + 1];
        corner_terms<C>(frac, keep_t, frac_t, gv, d, t);
#pragma unroll
        for (int k = 0; k <= C; ++k) m[d] = max(m[d], gfnerf::abs_bits(t[k]));
        nz |= (m[d] != 0u ? 1u : 0u) << d;
      }
    }

    // runs of equal (cell, row) among consecutive lanes; a lane past the
    // end is its own run and ends its left neighbour's (every lane takes
    // part in every shuffle: no && between them)
    bool same = __shfl_up_sync(kFull, (int)valid, 1) != 0;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int left = __shfl_up_sync(kFull, key[a], 1);
      same = same && left == key[a];
    }
    const bool head = !valid || lane == 0 || !same;
    const gfnerf::WarpRuns runs = gfnerf::find_runs(head, lane);
    // a head's run: lanes [lane, run_end)
    const unsigned span = (runs.run_end == 32 ? kFull
                                              : (1u << runs.run_end) - 1u) &
                          (kFull << lane);
    unsigned live = 0u;
#pragma unroll
    for (int d = 0; d < 8; ++d)
      if (__ballot_sync(kFull, (nz >> d) & 1u) & span) live |= 1u << d;
    if (!valid || !head) live = 0u;
    if (!kScatter) max_runs(m, runs, lane);

    // the claims: corner d and its x-neighbour d + 4 with one atomic where
    // both are live and share a bucket (the count also takes the corners'
    // maxima into their rows')
    int at[8];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const bool live0 = (live >> d) & 1u;
      const bool live1 = (live >> (d + 4)) & 1u;
      if (!live0 && !live1) continue;
      const long long row0 = corner_row(key, d, lv);
      const long long row1 = corner_row(key, d + 4, lv);
      const long long b0 = row0 / kBucketRows;
      const long long b1 = row1 / kBucketRows;
      if (!kScatter) {
        if (live0) atomicMax(row_max + row0, m[d]);
        if (live1) atomicMax(row_max + row1, m[d + 4]);
      }
      if (live0 && live1 && b0 == b1) {
        at[d] = atomicAdd(buckets + b0, 2);
        at[d + 4] = at[d] + 1;
      } else {
        if (live0) at[d] = atomicAdd(buckets + b0, 1);
        if (live1) at[d + 4] = atomicAdd(buckets + b1, 1);
      }
    }

    if (kScatter) {
#pragma unroll
      for (int grp = 0; grp < 8 / kGroupCorners; ++grp) {
        // corners c of the group: d = grp O / 2 + c for c < O / 2, their
        // x-neighbours d + 4 after them
        constexpr int kHalf = kGroupCorners / 2;
        long long q[kGroupCorners][C + 1];
#pragma unroll
        for (int c = 0; c < kGroupCorners; ++c) {
          const int d = grp * kHalf + c % kHalf + 4 * (c / kHalf);
          float t[C + 1];
          corner_terms<C>(frac, keep_t, frac_t, gv, d, t);
          // a run's lanes share the corner's row, so its scale
          const gfnerf::Scale32 scale =
              valid ? gfnerf::scale32(row_shift(
                          __ldg(row_max + corner_row(key, d, lv)),
                          log2_points))
                    : gfnerf::Scale32{0.f, 0.f};
#pragma unroll
          for (int k = 0; k <= C; ++k)
            q[c][k] = valid ? gfnerf::quantize32(t[k], scale) : 0;
        }
        gfnerf::sum_runs(q, runs, lane);
#pragma unroll
        for (int c = 0; c < kGroupCorners; ++c) {
          const int d = grp * kHalf + c % kHalf + 4 * (c / kHalf);
          if ((live >> d) & 1u)
            write_record<C>(records, at[d], corner_row(key, d, lv), key[3],
                            q[c]);
        }
      }
    } else if (level_records != nullptr) {
      const int n_rec = __reduce_add_sync(kFull, __popc(live));
      if (lane == 0 && n_rec > 0)
        atomicAdd(level_records + l, (unsigned long long)n_rec);
    }
  }
}

__global__ void __launch_bounds__(gfnerf::kScanThreads)
    temporal_grid_bwd_scan_kernel(int* __restrict__ counts,
                                  int* __restrict__ flags,
                                  int* __restrict__ ctl,
                                  int* __restrict__ slot_of,
                                  int2* __restrict__ items, long long n_keys,
                                  long long* __restrict__ slot_sums,
                                  int slot_words, int* __restrict__ tickets) {
  gfnerf::bucket_scan<kChunk>(counts, flags, ctl, slot_of, items, n_keys,
                              slot_sums, slot_words, tickets);
}

// What the owner warps read: the buckets' record ends (after the scatter
// each bucket's cursor is one past its last record, so a bucket's records
// start at the previous bucket's end), the long buckets' slots, tickets
// and items.
struct OwnerArgs {
  const long long* records;
  const int* ends;
  const int* slot_of;
  const int2* items;
  const int* n_items;
  long long* slot_sums;
  int* tickets;
  const unsigned* gmax;
  const unsigned* row_max;
  const long long* offsets;
  float* grad;
  long long n_keys;
  int n_levels;
  int width;
  int log2_points;
};

// The level of bucket `key`, searched from level l on.
__device__ __forceinline__ int bucket_level(const OwnerArgs& a, long long key,
                                            int l) {
  while (l + 1 < a.n_levels && key * kBucketRows >= __ldg(a.offsets + l + 1))
    ++l;
  return l;
}

// *sum += v for an int64 in shared memory, exactly, from two native 32-bit
// atomics (a 64-bit shared atomic add is a compare-and-swap loop on sm_90,
// which contending lanes retry): the low words' sum wraps at most once an
// add, and the add that wraps sees it in the old value it gets back and
// carries 1 into the high word, so the pair holds the sum modulo 2^64.
__device__ __forceinline__ void add_shared(long long* sum, long long v) {
  unsigned* half = reinterpret_cast<unsigned*>(sum);  // little-endian
  const unsigned lo = (unsigned)v;
  const unsigned old = atomicAdd(half, lo);
  const unsigned hi = (unsigned)((unsigned long long)v >> 32) +
                      (old + lo < old ? 1u : 0u);
  if (hi != 0u) atomicAdd(half + 1, hi);
}

__device__ __forceinline__ void store4(float* out, int v, float4 x) {
  __stcs(reinterpret_cast<float4*>(out) + v, x);
}

// Record i into w (if below last).
template <int C>
__device__ __forceinline__ void load_record(
    const long long* __restrict__ records, int i, int last,
    long long (&w)[C + 2]) {
  if (i >= last) return;
  const long long* src = records + (size_t)i * (C + 2);
  if constexpr ((C + 2) % 2 == 0) {
#pragma unroll
    for (int k = 0; k < (C + 2) / 2; ++k) {
      const longlong2 v = __ldcs(reinterpret_cast<const longlong2*>(src) + k);
      w[2 * k] = v.x;
      w[2 * k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < C + 2; ++k) w[k] = __ldcs(src + k);
  }
}

// The bucket's 8 rows (words f32 of width a row, 16-byte aligned) from
// its int64 sums, each row at its own scale (inv: 2^-s of each row).
__device__ __forceinline__ void write_sums(float* __restrict__ out,
                                           const long long* sums, int words,
                                           int width, const double* inv,
                                           int lane) {
  for (int v = lane; v < words / 4; v += 32) {
    const longlong2 a = reinterpret_cast<const longlong2*>(sums)[2 * v];
    const longlong2 b = reinterpret_cast<const longlong2*>(sums)[2 * v + 1];
    const int k = 4 * v / width;       // the row of the first word
    const int next = (k + 1) * width;  // the words from here: the next row
    const double i0 = inv[k];
    const double i1 = 4 * v + 3 < next ? i0 : inv[k + 1];
    store4(out, v,
           make_float4(gfnerf::fixed_to_f32(a.x, i0),
                       gfnerf::fixed_to_f32(a.y, 4 * v + 1 < next ? i0 : i1),
                       gfnerf::fixed_to_f32(b.x, 4 * v + 2 < next ? i0 : i1),
                       gfnerf::fixed_to_f32(b.y, i1)));
  }
}

// A warp's sums of chunk `chunk` of bucket `key` at level l (acc: the
// bucket's words int64 in shared memory, then its rows' 2^-s as 8
// doubles), then the bucket's write (or the chunk's share of a long
// bucket, and the write by the chunk with the last ticket).
template <int C>
__device__ __forceinline__ void owner_item(const OwnerArgs& a, long long key,
                                           int chunk, int l, int start,
                                           int end,
                                           const long long (&pre)[C + 2],
                                           bool have_pre, long long* acc,
                                           int lane) {
  constexpr int kWords = C + 2;
  const int words = kBucketRows * a.width;
  float* out = a.grad + key * words;
  if (__ldg(a.gmax + l) >= 0x7f800000u) {  // NaN throughout the level
    if (chunk == 0) {
      const float nan = __int_as_float(0x7fc00000);
      for (int v = lane; v < words / 4; v += 32)
        store4(out, v, make_float4(nan, nan, nan, nan));
    }
    return;
  }
  if (end == start) {
    for (int v = lane; v < words / 4; v += 32)
      store4(out, v, make_float4(0.f, 0.f, 0.f, 0.f));
    return;
  }
  const long long row0 = key * kBucketRows;
  double* inv = reinterpret_cast<double*>(acc + words);
  if (lane < kBucketRows)
    inv[lane] = gfnerf::pow2(
        -row_shift(__ldg(a.row_max + row0 + lane), a.log2_points));
  for (int i = lane; i < words / 2; i += 32)
    reinterpret_cast<longlong2*>(acc)[i] = make_longlong2(0, 0);
  __syncwarp();
  const int first = start + chunk * kChunk;
  const int last = min(end, first + kChunk);
  for (int i = first + lane; i < last; i += 32) {
    long long w[kWords];
    if (have_pre && i - lane == first) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) w[k] = pre[k];
    } else {
      load_record<C>(a.records, i, last, w);
    }
    const long long row = (long long)(unsigned)(w[0] & 0xffffffffLL);
    const int r = (int)(w[0] >> 32);
    long long* s = acc + (row - row0) * a.width + r;
#pragma unroll
    for (int k = 0; k <= C; ++k)
      if (w[1 + k] != 0) add_shared(s + k, w[1 + k]);
  }
  __syncwarp();
  const int n_chunks = (end - start + kChunk - 1) / kChunk;
  if (n_chunks == 1) {
    write_sums(out, acc, words, a.width, inv, lane);
    return;
  }
  // a long bucket: the chunks meet in its slot
  const int slot = a.slot_of[key];
  long long* sums = a.slot_sums + (size_t)slot * words;
  for (int i = lane; i < words; i += 32)
    if (acc[i] != 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(sums + i),
                (unsigned long long)acc[i]);
  __threadfence();
  __syncwarp();
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(a.tickets + slot, 1);
  ticket = __shfl_sync(kFull, ticket, 0);
  if (ticket != n_chunks - 1) return;
  __threadfence();
  for (int i = lane; i < words / 2; i += 32)  // the slot through the L2
    reinterpret_cast<longlong2*>(acc)[i] =
        __ldcg(reinterpret_cast<const longlong2*>(sums) + i);
  __syncwarp();
  write_sums(out, acc, words, a.width, inv, lane);
}

template <int C>
__global__ void __launch_bounds__(32 * kOwnerWarps, kMinBlocks)
    temporal_grid_bwd_owner_kernel(OwnerArgs a) {
  extern __shared__ __align__(16) long long s_acc[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  long long* acc = s_acc + warp * (kBucketRows * a.width + kBucketRows);
  const long long gw = (long long)blockIdx.x * kOwnerWarps + warp;
  const long long nw = (long long)gridDim.x * kOwnerWarps;
  int l = 0;  // a warp's buckets come in order, so their levels do
  // each bucket's record range [start, end) loaded two buckets ahead, and
  // the first 32 of its records (a lane each) one bucket ahead, so that
  // their loads overlap the bucket before
  auto range = [&](long long key, int& s0, int& e0) {
    s0 = e0 = 0;
    if (key < a.n_keys) {
      s0 = key > 0 ? a.ends[key - 1] : 0;
      e0 = a.ends[key];
    }
  };
  int s_cur, e_cur, s_nxt, e_nxt;
  range(gw, s_cur, e_cur);
  range(gw + nw, s_nxt, e_nxt);
  long long w_cur[C + 2], w_nxt[C + 2];
  load_record<C>(a.records, s_cur + lane, e_cur, w_cur);
  for (long long key = gw; key < a.n_keys; key += nw) {
    load_record<C>(a.records, s_nxt + lane, e_nxt, w_nxt);
    int s_nn, e_nn;
    range(key + 2 * nw, s_nn, e_nn);
    l = bucket_level(a, key, l);
    owner_item<C>(a, key, 0, l, s_cur, e_cur, w_cur, true, acc, lane);
    s_cur = s_nxt, e_cur = e_nxt, s_nxt = s_nn, e_nxt = e_nn;
#pragma unroll
    for (int k = 0; k < C + 2; ++k) w_cur[k] = w_nxt[k];
  }
  const int n_items = __ldcg(a.n_items);
  for (long long i = gw; i < n_items; i += nw) {
    const int2 it = a.items[i];
    owner_item<C>(a, it.x, it.y, bucket_level(a, it.x, 0),
                  it.x > 0 ? a.ends[it.x - 1] : 0, a.ends[it.x], w_cur, false,
                  acc, lane);
  }
}

template <int C>
int launch(const float* g, const float* xyz, const float* times,
           const long long* offsets, const int* res, const int* hashed,
           float* grad, long long* records, int* ctrl, int* slot_of,
           int* items, long long* slot_sums, int* tickets,
           unsigned long long* level_records, int* launches, int* memsets,
           long long n_points, long long n_grad_rows, int n_levels, int width,
           int n_rows, float time_scale, int group, cudaStream_t stream) {
  if (n_points == 0) {  // no points: the gradient is all zeros
    GFNERF_CHECK(cudaMemsetAsync(grad, 0, sizeof(float) * n_grad_rows * width,
                                 stream));
    ++*memsets;
    return (int)cudaSuccess;
  }
  const long long n_keys = n_grad_rows / kBucketRows;
  const long long n_scan =
      (n_keys + gfnerf::kScanTile - 1) / gfnerf::kScanTile;
  int* counts = ctrl;  // then each bucket's first record, then its end
  int* flags = ctrl + n_keys;
  int* ctl = flags + n_scan;
  unsigned* gmax = reinterpret_cast<unsigned*>(ctl + 4);
  unsigned* row_max = gmax + n_levels;
  GFNERF_CHECK(cudaMemsetAsync(
      ctrl, 0, sizeof(int) * (n_keys + n_scan + 4 + n_levels + n_grad_rows),
      stream));
  ++*memsets;

  const int lc = n_levels * C;
  const long long n = n_points * lc;
  unsigned blocks = gfnerf::fixed_blocks(n, 8);
  const unsigned need =
      (unsigned)((lc + gfnerf::kFixedThreads - 1) / gfnerf::kFixedThreads);
  blocks = blocks > need ? blocks : need;
  temporal_grid_bwd_max_kernel<<<blocks, gfnerf::kFixedThreads,
                                 sizeof(unsigned) * n_levels, stream>>>(
      g, n, lc, C, gmax);
  GFNERF_CHECK(cudaGetLastError());
  ++*launches;

  const TileMap map(n_levels, group, kPasses, n_points);
  const size_t smem = sizeof(float) * map.points * (map.group * C + 1 + 4);
  if (smem > 48 * 1024) {
    GFNERF_CHECK(cudaFuncSetAttribute(
        temporal_grid_bwd_tile_kernel<C, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    GFNERF_CHECK(cudaFuncSetAttribute(
        temporal_grid_bwd_tile_kernel<C, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  }
  const unsigned tiles = (unsigned)map.n_tiles;
  int err = launch_groups(
      n_levels, map.group, map.n_tiles, launches, [&](int l0, int n_lev) {
        temporal_grid_bwd_tile_kernel<C, false>
            <<<tiles, 32 * map.warps, smem, stream>>>(
                g, xyz, times, offsets, res, hashed, gmax, row_max, counts,
                records, level_records, n_points, n_levels, n_rows,
                time_scale, map, l0, n_lev);
      });
  if (err != 0) return err;
  const int words = kBucketRows * width;
  temporal_grid_bwd_scan_kernel<<<(unsigned)n_scan, gfnerf::kScanThreads, 0,
                                  stream>>>(
      counts, flags, ctl, slot_of, reinterpret_cast<int2*>(items), n_keys,
      slot_sums, words, tickets);
  GFNERF_CHECK(cudaGetLastError());
  ++*launches;
  err = launch_groups(
      n_levels, map.group, map.n_tiles, launches, [&](int l0, int n_lev) {
        temporal_grid_bwd_tile_kernel<C, true>
            <<<tiles, 32 * map.warps, smem, stream>>>(
                g, xyz, times, offsets, res, hashed, gmax, row_max, counts,
                records, nullptr, n_points, n_levels, n_rows, time_scale,
                map, l0, n_lev);
      });
  if (err != 0) return err;

  OwnerArgs a;
  a.records = records;
  a.ends = counts;
  a.slot_of = slot_of;
  a.items = reinterpret_cast<const int2*>(items);
  a.n_items = ctl + 2;
  a.slot_sums = slot_sums;
  a.tickets = tickets;
  a.gmax = gmax;
  a.row_max = row_max;
  a.offsets = offsets;
  a.grad = grad;
  a.n_keys = n_keys;
  a.n_levels = n_levels;
  a.width = width;
  a.log2_points = gfnerf::ceil_log2(n_points);
  const size_t owner_smem =
      sizeof(long long) * kOwnerWarps * (words + kBucketRows);
  if (owner_smem > 48 * 1024)
    GFNERF_CHECK(cudaFuncSetAttribute(
        temporal_grid_bwd_owner_kernel<C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)owner_smem));
  long long oblocks = (n_keys + kOwnerWarps - 1) / kOwnerWarps;
  oblocks = oblocks < 132 * kMinBlocks ? oblocks : 132 * kMinBlocks;
  temporal_grid_bwd_owner_kernel<C>
      <<<(unsigned)oblocks, 32 * kOwnerWarps, owner_smem, stream>>>(a);
  GFNERF_CHECK(cudaGetLastError());
  ++*launches;
  return (int)cudaSuccess;
}

}  // namespace

// Supported channels C: 1, 2 and 4.  The grid must hold the facts of
// temporal_grid_common.cuh, level offsets that are multiples of 8 rows
// among them (TemporalGridStatics.tables() checks them); n_grad_rows is
// offsets[L].  The gradient (n_grad_rows, width) f32 must be 16-byte
// aligned and need not be zeroed by the caller.  Scratch on the device,
// none zeroed by the caller (n_keys = n_grad_rows / 8 buckets):
//   records   (P * L * 8, C + 2) int64: the records, at most one a corner;
//   ctrl      (n_keys + ceil(n_keys / 16384) + 4 + L + n_grad_rows)
//             int32: the bucket counters, the scan's tile flags, its ticket
//             and the counts of long buckets and items, the level maxima,
//             the rows' maxima;
//   slot_of   (n_keys) int32;
//   items     (max(1, P * L * 8 / 1024), 2) int32;
//   slot_sums (n_slots, 8 * width) int64 and tickets (n_slots) int32,
//             n_slots >= the buckets of more than 1024 records
//             (max(1, min(n_keys, P * L * 8 / 1025))): zeroed by the scan
//             where used.
// level_records: null, or (L,) uint64 counters on the device that the
// count pass adds the records it makes per level to.  launches and
// memsets: host ints that get the kernel launches (3 + 2 groups, a group
// per levels_per_launch levels, 0 or more than L: all in one; none
// without points) and the zero-fills (1) made added to them.
extern "C" int gfnerf_temporal_grid_bwd(
    const float* g, const float* xyz, const float* times,
    const long long* offsets, const int* res, const int* hashed, float* grad,
    long long* records, int* ctrl, int* slot_of, int* items,
    long long* slot_sums, int* tickets, unsigned long long* level_records,
    int* launches, int* memsets, long long n_points, long long n_grad_rows,
    int n_levels, int level_dim, int width, int n_rows, float time_scale,
    int levels_per_launch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define GFNERF_T2(C)                                                          \
  if (level_dim == C)                                                         \
    return launch<C>(g, xyz, times, offsets, res, hashed, grad, records,     \
                     ctrl, slot_of, items, slot_sums, tickets, level_records, \
                     launches, memsets, n_points, n_grad_rows, n_levels,      \
                     width, n_rows, time_scale, levels_per_launch, s);
  GFNERF_T2(1)
  GFNERF_T2(2)
  GFNERF_T2(4)
#undef GFNERF_T2
  return (int)cudaErrorInvalidValue;
}
