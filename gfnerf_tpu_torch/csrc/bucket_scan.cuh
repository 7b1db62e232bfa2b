// The scan of bucket counters shared by the owner-computes table gradients
// H2 (packed_hash_bwd.cu, a bucket per table row) and T2
// (temporal_grid_bwd.cu, a bucket per 8 table rows).
//
// Both build their gradient in four passes: a count of the records that
// land in each bucket, this scan, a scatter of the records to their
// bucket's cursor, and an owner pass in which a warp sums a bucket (or a
// chunk of a long one) and writes its rows once.  The scan turns the
// counters into each bucket's first record, in place, in one launch: tiles
// of kScanTile counters, each tile's total chained from the previous
// tile's.  A bucket of more than Chunk records is split into chunks of
// Chunk: it gets a slot (its int64 sums and its ticket, where the chunks
// meet) and a work item per chunk after its first.

#pragma once

#include <cuda_runtime.h>

#include "warp_runs.cuh"

namespace gfnerf {

constexpr int kScanThreads = 1024;
constexpr int kScanPer = 16;  // counters a scan thread
constexpr int kScanTile = kScanThreads * kScanPer;

// The exclusive scan of x over a block of kScanThreads threads (s_warp:
// kScanThreads / 32 ints of shared memory); *total gets the block's sum.
__device__ __forceinline__ int block_exclusive(int x, int* s_warp,
                                               int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = x;  // inclusive scan over the warp's lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFullWarp, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFullWarp, w, off);
      if (lane >= off) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  const int excl = (warp > 0 ? s_warp[warp - 1] : 0) + incl - x;
  *total = s_warp[kScanThreads / 32 - 1];
  __syncthreads();  // s_warp is free again
  return excl;
}

// The body of a scan kernel of kScanThreads threads, a tile a block.
// counts (n_keys): the counters, turned into each bucket's first record;
// flags: one word a tile (0 until the tile's inclusive total + 1 is known);
// ctl: [tile ticket, long buckets, work items], zeroed.  A long bucket k
// gets slot_of[k] and one item (k, chunk) per chunk after its first; a
// tile's long buckets take consecutive slots and items, reserved with one
// atomic each.  With a non-null slot_sums the tile's threads also zero
// its slots' slot_words (even) int64 sums together, and their tickets;
// with null the caller zeroes them.
template <int Chunk>
__device__ __forceinline__ void bucket_scan(
    int* __restrict__ counts, int* __restrict__ flags, int* __restrict__ ctl,
    int* __restrict__ slot_of, int2* __restrict__ items, long long n_keys,
    long long* __restrict__ slot_sums, int slot_words,
    int* __restrict__ tickets) {
  __shared__ int s_tile;
  __shared__ int s_prefix;
  __shared__ int s_slot;
  __shared__ int s_item;
  __shared__ int s_warp[kScanThreads / 32];
  // tiles in the order the blocks start: the tile before this one has a
  // block already running, so the wait below ends
  if (threadIdx.x == 0) s_tile = atomicAdd(ctl, 1);
  __syncthreads();
  const int tile = s_tile;
  const long long k0 =
      (long long)tile * kScanTile + (long long)threadIdx.x * kScanPer;
  int v[kScanPer];
  int sum = 0, n_long = 0, n_extra = 0;
#pragma unroll
  for (int i = 0; i < kScanPer; ++i) {
    v[i] = k0 + i < n_keys ? counts[k0 + i] : 0;
    sum += v[i];
    if (v[i] > Chunk) {
      ++n_long;
      n_extra += (v[i] + Chunk - 1) / Chunk - 1;
    }
  }
  int total;
  const int excl = block_exclusive(sum, s_warp, &total);
  if (threadIdx.x == 0) {
    int prefix = 0;
    if (tile > 0) {
      int got;
      while ((got = atomicAdd(flags + tile - 1, 0)) == 0) {
      }
      prefix = got - 1;
    }
    atomicExch(flags + tile, prefix + total + 1);
    s_prefix = prefix;
  }
  int total_long, total_extra;
  const int excl_long = block_exclusive(n_long, s_warp, &total_long);
  const int excl_extra = block_exclusive(n_extra, s_warp, &total_extra);
  if (threadIdx.x == 0) {
    s_slot = total_long > 0 ? atomicAdd(ctl + 1, total_long) : 0;
    s_item = total_extra > 0 ? atomicAdd(ctl + 2, total_extra) : 0;
  }
  __syncthreads();
  int run = s_prefix + excl;
  int slot = s_slot + excl_long;
  int item = s_item + excl_extra;
#pragma unroll
  for (int i = 0; i < kScanPer; ++i) {
    const long long k = k0 + i;
    if (k < n_keys) {
      counts[k] = run;
      if (v[i] > Chunk) {
        const int n_chunks = (v[i] + Chunk - 1) / Chunk;
        slot_of[k] = slot;
        if (tickets != nullptr) tickets[slot] = 0;
        ++slot;
        for (int j = 1; j < n_chunks; ++j)
          items[item++] = make_int2((int)k, j);
      }
    }
    run += v[i];
  }
  if (slot_sums != nullptr && total_long > 0) {
    longlong2* z = reinterpret_cast<longlong2*>(
        slot_sums + (size_t)s_slot * slot_words);
    const long long n2 = (long long)total_long * slot_words / 2;
    for (long long i = threadIdx.x; i < n2; i += blockDim.x)
      z[i] = make_longlong2(0, 0);
  }
}

}  // namespace gfnerf
