// The scan march: a sequential octree point-location march per ray (M1).
//
// Replaces the JAX package's get_samples + locate_points
// (gfnerf_tpu/sampler/perssampler.py:337, 236), a lax.scan over the S
// sample slots whose body descends the octree with a fori_loop; the
// reference runs the same march as CUDA (PersSampler::GetSamples,
// PersSampler_cuda.cu:321-477). Per ray, for each of the S slots:
//   p = o + t d; descend from the root for at most locate_iters levels
//   (child octant of p >= c; a missing child ends at that empty octant);
//   in a valid leaf, the warp's 12 homogeneous projections at p give the
//   warped point and ||J(p) d||, and step = sample_l * noise / (||J d|| +
//   1e-6) (times the distance scale); in an empty region a skip past the
//   cube's exit in whole steps of the last step; the slot is emitted when
//   the ray is alive, in a valid leaf and past its first valid leaf.
//
// Bound: memory (chip_smoke.scan_march_bytes), 45 bytes written a slot
// (world and warped points, delta, t, three int32 indices, valid) and the
// 4-byte noise read for each slot in a valid leaf, the only slots that use
// it; the octree and warp tables (tens of KB to a few MB) stay in L1/L2.
// What keeps the time above that bound is instruction throughput: a slot's
// descent, its 12 projections with three IEEE divisions each, six ordered
// sums and the step's division run one after another, and a ray's slots
// too. The design:
//   - A group of kLanes = 8 lanes marches one ray, four rays a warp, 16 a
//     block: 8192 rays make 2048 warps on the 132 SMs. (One thread per ray,
//     the earlier design, left half the SMs idle at 8192 rays, read each
//     slot's anchor rows one row a lane, and formed the 12 projections one
//     after another.) The descent and the slab tests run in lockstep in the
//     group's lanes, so a group of 16 lanes spends twice the warp
//     instructions on them that 8 do: on one H100, 0.52 against 0.37 ms for
//     8192 rays of 160 slots; 4 lanes held 175 registers and were no faster.
//   - The descent is skipped while p stays inside the planes that bounded
//     the last one: every comparison of the descent would come out the same
//     and end in the same cell. On one H100 it saves a quarter of a render
//     chunk's time (1.28 against 1.68 ms for 32768 rays of 384 slots) and
//     3% of the train batch's (0.37 against 0.38 ms).
//   - Lane k holds the projections k and k + 8 (lanes 0-3): the anchor's 8
//     floats of each, and A.d and B.d, in registers while the ray's anchor
//     stays the same (consecutive slots mostly stay in one leaf); it reloads
//     them, neighbouring lanes on neighbouring floats, when the anchor
//     changes, and the group puts the anchor's 36 weights in its staging
//     area. Lanes 0-5 form the six sums, taking the projections by shuffles
//     in the order k = 0..11, so that each rounds as the plain version's.
//   - The warp is formed only in a valid leaf: an empty slot's warp fed
//     nothing but a step that the skip replaces.
//   - The outputs of a chunk of kChunk = 32 slots are staged in shared
//     memory, each run at the same address modulo 16 as its destination,
//     one store a value of an emitted slot, and written with 16-byte stores,
//     the group's lanes on neighbouring addresses (the earlier design stored
//     each slot's ten values 4 S bytes apart between neighbouring lanes).
//     The chunk's noise comes in the same way. A chunk is set to the masked
//     values (0, and -1 for the indices) first, so a ray dead for a whole
//     chunk only copies it out.
//
// Rounding follows the plain PyTorch version (perssampler.get_samples)
// operation by operation, so that the two agree bit for bit: fmaf exactly
// where the plain version forms a multiply-add in one rounding (o + t d,
// the sums of the warp's 12 weighted projections, the squared lengths),
// and __f*_rn (never contracted) everywhere else; maxima and minima
// propagate NaN as torch.maximum and torch.clamp do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 8;                  // lanes marching one ray
constexpr int kRaysPerBlock = 16;
constexpr int kThreads = kRaysPerBlock * kLanes;
constexpr int kMinBlocks = 4;              // at most 128 registers a thread
constexpr int kProj = 12;                  // the warp's projections
constexpr int kProjPerLane = (kProj + kLanes - 1) / kLanes;
constexpr int kChunk = 32;                 // slots staged at a time
static_assert(kLanes >= 6 && 32 % kLanes == 0,
              "lanes 0-5 form the six sums; a warp holds whole groups");
// One group's staging area in 4-byte words. Each run has room for a pad of
// up to 3 words (15 bytes for valid) that puts it at its destination's
// address modulo 16. The runs set to 0 come first, then those set to -1,
// then the noise.
constexpr int kPointRun = 3 * kChunk + 4;
constexpr int kWordRun = kChunk + 4;
constexpr int kByteRunWords = (kChunk + 16) / 4;
constexpr int kOffWarp = kPointRun;
constexpr int kOffDist = 2 * kPointRun;
constexpr int kOffT = kOffDist + kWordRun;
constexpr int kOffValid = kOffT + kWordRun;
constexpr int kOffTrans = kOffValid + kByteRunWords;
constexpr int kOffOct = kOffTrans + kWordRun;
constexpr int kOffBlock = kOffOct + kWordRun;
constexpr int kOffNoise = kOffBlock + kWordRun;
constexpr int kOffWeights = kOffNoise + kWordRun;  // the anchor's 36 weights
constexpr int kStageWords = kOffWeights + 3 * kProj;
static_assert(kOffTrans % 4 == 0 && kOffNoise % 4 == 0 &&
                  kStageWords % 4 == 0 && kOffWarp % 4 == 0 &&
                  kOffDist % 4 == 0 && kOffT % 4 == 0 &&
                  kOffValid % 4 == 0 && kOffOct % 4 == 0 &&
                  kOffBlock % 4 == 0 && kOffWeights % 4 == 0,
              "every staged run starts 16-byte aligned");

__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

struct Tables {
  const float* centers;      // (C, 3)
  const float* side_lens;    // (C,)
  const int* childs;         // (C, 8)
  const unsigned char* is_leaf;  // (C,) bool
  const int* trans_idx;      // (C,)
  const int* block_idx;      // (C,)
  const float* w2xz;         // (T, 96) [j][i][k]
  const float* wweight;      // (T, 36) [c][k]
  const float* t_center;     // (T, 3)
  const float* t_dis;        // (T,)
  int n_trans;
  int locate_iters;
};

// The slab test of the ray against the cube (center c, side s).
__device__ __forceinline__ void ray_aabb(const float o[3], const float inv[3],
                                         const float c[3], float side,
                                         float* near, float* far) {
  const float hf = __fmul_rn(side, 0.5f);
  float nr = 0.f, fr = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = __fmul_rn(__fsub_rn(__fsub_rn(c[a], hf), o[a]), inv[a]);
    const float t1 = __fmul_rn(__fsub_rn(__fadd_rn(c[a], hf), o[a]), inv[a]);
    const float lo = nmin(t0, t1), hi = nmax(t0, t1);
    nr = a == 0 ? lo : nmax(nr, lo);
    fr = a == 0 ? hi : nmin(fr, hi);
  }
  *near = nr;
  *far = fr;
}

// The pad, in elements of E, that puts a staged run at the same address
// modulo 16 as its run in global memory.
template <typename E>
__device__ __forceinline__ int pad_of(const E* global) {
  return (int)((uintptr_t)global & 15) / (int)sizeof(E);
}

// Copies n elements of E between the group's staging area and global memory
// (global is whichever of dst and src lies there; both lie at the same
// address modulo 16): the head up to a 16-byte boundary and the tail by
// single elements, the rest in 16-byte vectors, the group's lanes on
// neighbouring addresses.
template <typename E>
__device__ __forceinline__ void copy_run(E* dst, const E* src, int n,
                                         const E* global, int lane) {
  constexpr int kPer = 16 / sizeof(E);
  const int head = min(n, (kPer - pad_of(global)) % kPer);
  for (int i = lane; i < head; i += kLanes) dst[i] = src[i];
  const int nv = (n - head) / kPer;
  uint4* vd = reinterpret_cast<uint4*>(dst + head);
  const uint4* vs = reinterpret_cast<const uint4*>(src + head);
  for (int v = lane; v < nv; v += kLanes) vd[v] = vs[v];
  for (int i = head + nv * kPer + lane; i < n; i += kLanes) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) scan_march_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ noise, Tables tb,
    float* __restrict__ world_out, float* __restrict__ warp_out,
    float* __restrict__ dist_out, float* __restrict__ t_out,
    int* __restrict__ trans_out, int* __restrict__ oct_out,
    int* __restrict__ block_out, unsigned char* __restrict__ valid_out,
    long long* __restrict__ num_valid_out, float* __restrict__ first_oct_out,
    long long n_rays, int n_slots, float sample_l, int scale_by_dis,
    float global_near, float global_far) {
  __shared__ __align__(16) unsigned int stage_all[kRaysPerBlock][kStageWords];
  const int lane = threadIdx.x % kLanes;
  const long long ray =
      (long long)blockIdx.x * kRaysPerBlock + threadIdx.x / kLanes;
  if (ray >= n_rays) return;
  // the group's lanes: every shuffle and __syncwarp names all of them
  const unsigned gmask = ((1u << kLanes) - 1u) << (threadIdx.x & (32 - kLanes));
  unsigned int* stage = stage_all[threadIdx.x / kLanes];

  float o[3], rd[3], d[3], inv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = rays_o[ray * 3 + a];
    rd[a] = rays_d[ray * 3 + a];
  }
  float nn = __fmul_rn(rd[0], rd[0]);
  nn = fmaf(rd[1], rd[1], nn);
  nn = fmaf(rd[2], rd[2], nn);
  const float dn = __fsqrt_rn(nn);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    d[a] = __fdiv_rn(rd[a], dn);
    const float small = d[a] >= 0.f ? 1e-10f : -1e-10f;
    inv[a] = __fdiv_rn(1.0f, fabsf(d[a]) < 1e-10f ? small : d[a]);
  }
  const float root_c[3] = {__ldg(tb.centers), __ldg(tb.centers + 1),
                           __ldg(tb.centers + 2)};
  const float root_s = __ldg(tb.side_lens);
  float root_near, root_far;
  ray_aabb(o, inv, root_c, root_s, &root_near, &root_far);
  float t = nmax(root_near, global_near);
  bool alive = (root_near < root_far) && (root_far > global_near);
  const float t_end = nmin(root_far, global_far);
  float prev_step = 0.f, first_oct = 1e9f;
  bool first = true;
  long long n_valid = 0;
  const size_t base = (size_t)ray * (size_t)n_slots;

  // the anchor held across slots: the projections k = lane + m kLanes
  // (A_j and B_j rows, the two constants, A.d and B.d) in registers, the
  // weights of the six sums in the staging area (lane c < 6: sum c's row,
  // c % 3), and the distance scale
  int anchor = -1;
  float ga[kProjPerLane][3], gb[kProjPerLane][3], ca[kProjPerLane],
      cb[kProjPerLane], ad[kProjPerLane], bd[kProjPerLane];
  float radius = 1.f;
  const float* s_w =
      reinterpret_cast<const float*>(stage + kOffWeights) + (lane % 3) * kProj;
#pragma unroll
  for (int m = 0; m < kProjPerLane; ++m) {
    ca[m] = cb[m] = ad[m] = bd[m] = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) ga[m][a] = gb[m][a] = 0.f;
  }
  // the last descent's cell: its node, cube and anchor, and the tightest
  // of the planes it passed on each side (a point p with lo <= p < hi on
  // every axis makes every comparison of the descent as the last point did,
  // and so ends in the same cell)
  int u = 0, tr = -1;
  float c[3] = {root_c[0], root_c[1], root_c[2]}, s = root_s;
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {INFINITY, INFINITY, INFINITY};

  // this ray's staged runs, as word offsets into the staging area
  const float* noise_g = noise + base;
  float* const s_f = reinterpret_cast<float*>(stage);
  int* const s_i = reinterpret_cast<int*>(stage);
  const int o_world = pad_of(world_out + base * 3);
  const int o_warp = kOffWarp + pad_of(warp_out + base * 3);
  const int o_dist = kOffDist + pad_of(dist_out + base);
  const int o_t = kOffT + pad_of(t_out + base);
  const int o_valid = kOffValid * 4 + pad_of(valid_out + base);  // bytes
  const int o_trans = kOffTrans + pad_of(trans_out + base);
  const int o_oct = kOffOct + pad_of(oct_out + base);
  const int o_block = kOffBlock + pad_of(block_out + base);
  const int o_noise = kOffNoise + pad_of(noise_g);
  // an emitted slot's 12 values, field f by lane f % kLanes: world (0-2),
  // warped (3-5: lanes 3-5 hold those sums), delta, t, trans, oct, block,
  // valid (11, a byte); f_at: the word offset of the field's slot 0 (the
  // points take 3 words a slot)
  constexpr int kFieldRounds = (12 + kLanes - 1) / kLanes;
  int f_at[kFieldRounds];
#pragma unroll
  for (int r = 0; r < kFieldRounds; ++r) {
    const int f = lane + r * kLanes;
    f_at[r] = f < 3    ? o_world + f
              : f < 6  ? o_warp + f - 3
              : f == 6 ? o_dist
              : f == 7 ? o_t
              : f == 8 ? o_trans
              : f == 9 ? o_oct
                       : o_block;
  }
  bool dirty = true;  // the staged runs hold more than the masked values

  for (int i0 = 0; i0 < n_slots; i0 += kChunk) {
    const int n = min(kChunk, n_slots - i0);
    if (dirty) {
      uint4* s4 = reinterpret_cast<uint4*>(stage);
      for (int v = lane; v < kOffTrans / 4; v += kLanes)
        s4[v] = make_uint4(0u, 0u, 0u, 0u);
      for (int v = kOffTrans / 4 + lane; v < kOffNoise / 4; v += kLanes)
        s4[v] = make_uint4(~0u, ~0u, ~0u, ~0u);
      dirty = false;
    }
    if (alive) copy_run(s_f + o_noise, noise_g + i0, n, noise_g + i0, lane);
    __syncwarp(gmask);

    for (int j = 0; j < n && alive; ++j) {
      float p[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) p[a] = fmaf(t, d[a], o[a]);
      const bool same_cell = p[0] >= lo[0] && !(p[0] >= hi[0]) &&
                             p[1] >= lo[1] && !(p[1] >= hi[1]) &&
                             p[2] >= lo[2] && !(p[2] >= hi[2]);
      if (!same_cell) {
        // top-down point location (locate_points)
        u = 0;
        c[0] = root_c[0];
        c[1] = root_c[1];
        c[2] = root_c[2];
        s = root_s;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          lo[a] = -INFINITY;
          hi[a] = INFINITY;
        }
        bool virt = false;
        for (int it = 0; it < tb.locate_iters; ++it) {
          if (__ldg(tb.is_leaf + u) != 0) break;
          const int b0 = p[0] >= c[0], b1 = p[1] >= c[1], b2 = p[2] >= c[2];
          const int child =
              __ldg(tb.childs + (size_t)u * 8 + b0 * 4 + b1 * 2 + b2);
          const int bits[3] = {b0, b1, b2};
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            if (bits[a]) {
              lo[a] = fmaxf(lo[a], c[a]);
            } else {
              hi[a] = fminf(hi[a], c[a]);
            }
          }
          const float hs = __fmul_rn(s, 0.5f);
          c[0] = __fadd_rn(c[0], __fmul_rn(hs, b0 ? 0.5f : -0.5f));
          c[1] = __fadd_rn(c[1], __fmul_rn(hs, b1 ? 0.5f : -0.5f));
          c[2] = __fadd_rn(c[2], __fmul_rn(hs, b2 ? 0.5f : -0.5f));
          s = hs;
          if (child < 0) {
            virt = true;
            break;
          }
          u = child;
        }
        const bool leaf = __ldg(tb.is_leaf + u) != 0;
        tr = (virt || !leaf) ? -1 : __ldg(tb.trans_idx + u);
      }
      float t_next;
      if (tr >= 0) {  // a valid leaf: the warp, one step
        const int trc = tr > tb.n_trans - 1 ? tb.n_trans - 1 : tr;
        if (trc != anchor) {
          anchor = trc;
          const float* g = tb.w2xz + (size_t)trc * 96;
#pragma unroll
          for (int m = 0; m < kProjPerLane; ++m) {
            const int k = lane + m * kLanes;
            if (k < kProj) {
#pragma unroll
              for (int jj = 0; jj < 3; ++jj) {
                ga[m][jj] = __ldg(g + jj * 24 + k);
                gb[m][jj] = __ldg(g + jj * 24 + 12 + k);
              }
              ca[m] = __ldg(g + 72 + k);
              cb[m] = __ldg(g + 84 + k);
              ad[m] = __fmul_rn(ga[m][0], d[0]);
              bd[m] = __fmul_rn(gb[m][0], d[0]);
              ad[m] = __fadd_rn(ad[m], __fmul_rn(ga[m][1], d[1]));
              bd[m] = __fadd_rn(bd[m], __fmul_rn(gb[m][1], d[1]));
              ad[m] = __fadd_rn(ad[m], __fmul_rn(ga[m][2], d[2]));
              bd[m] = __fadd_rn(bd[m], __fmul_rn(gb[m][2], d[2]));
            }
          }
          // no lane reads the old weights past the last slot's shuffles
          for (int i = lane; i < 3 * kProj; i += kLanes)
            s_f[kOffWeights + i] = __ldg(tb.wweight + (size_t)trc * 36 + i);
          __syncwarp(gmask);
          const float q0 = __fsub_rn(o[0], __ldg(tb.t_center + (size_t)trc * 3));
          const float q1 =
              __fsub_rn(o[1], __ldg(tb.t_center + (size_t)trc * 3 + 1));
          const float q2 =
              __fsub_rn(o[2], __ldg(tb.t_center + (size_t)trc * 3 + 2));
          float rr = __fmul_rn(q0, q0);
          rr = fmaf(q1, q1, rr);
          rr = fmaf(q2, q2, rr);
          radius = nmax(__fdiv_rn(__fsqrt_rn(rr), __ldg(tb.t_dis + trc)), 1.0f);
        }
        // the lane's projections: each one's value a / b and its
        // derivative along d
        float proj[kProjPerLane], val[kProjPerLane];
#pragma unroll
        for (int m = 0; m < kProjPerLane; ++m) {
          proj[m] = val[m] = 0.f;
          if (lane + m * kLanes < kProj) {
            float a = __fmul_rn(ga[m][0], p[0]);
            float b = __fmul_rn(gb[m][0], p[0]);
            a = __fadd_rn(a, __fmul_rn(ga[m][1], p[1]));
            b = __fadd_rn(b, __fmul_rn(gb[m][1], p[1]));
            a = __fadd_rn(a, __fmul_rn(ga[m][2], p[2]));
            b = __fadd_rn(b, __fmul_rn(gb[m][2], p[2]));
            a = __fadd_rn(a, ca[m]);
            b = __fadd_rn(b, cb[m]);
            proj[m] = __fsub_rn(__fdiv_rn(ad[m], b),
                                __fmul_rn(__fdiv_rn(a, __fmul_rn(b, b)), bd[m]));
            val[m] = __fdiv_rn(a, b);
          }
        }
        // lanes 0-2: J d's three sums, lanes 3-5: the warped point's, each
        // in the order of the 12 projections (the other lanes' sums go
        // unused)
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < kProj; ++k) {
          const float pk =
              __shfl_sync(gmask, proj[k / kLanes], k % kLanes, kLanes);
          const float vk =
              __shfl_sync(gmask, val[k / kLanes], k % kLanes, kLanes);
          const float x = lane < 3 ? pk : vk;
          acc = k == 0 ? __fmul_rn(s_w[k], x) : fmaf(s_w[k], x, acc);
        }
        const float j0 = __shfl_sync(gmask, acc, 0, kLanes);
        const float j1 = __shfl_sync(gmask, acc, 1, kLanes);
        const float j2 = __shfl_sync(gmask, acc, 2, kLanes);
        const float jn = __fsqrt_rn(__fadd_rn(
            __fadd_rn(__fmul_rn(j0, j0), __fmul_rn(j1, j1)), __fmul_rn(j2, j2)));
        const float jnorm = __fadd_rn(jn, 1e-6f);
        float step = __fdiv_rn(__fmul_rn(sample_l, s_f[o_noise + j]), jnorm);
        if (scale_by_dis) step = __fmul_rn(step, radius);
        if (first_oct >= 1e8f) {
          float cube_near, cube_far;
          ray_aabb(o, inv, c, s, &cube_near, &cube_far);
          first_oct = nmax(cube_near, global_near);
        }
        if (!first) {  // emitted: one staged store a field
          const float dt = __fmul_rn(step, jnorm);
#pragma unroll
          for (int r = 0; r < kFieldRounds; ++r) {
            const int f = lane + r * kLanes;
            const float fv = f == 0   ? p[0]
                             : f == 1 ? p[1]
                             : f == 2 ? p[2]
                             : f < 6  ? acc  // lanes 3-5 hold these sums
                             : f == 6 ? dt
                                      : t;
            const int iv = f == 8 ? tr : f == 9 ? u : __ldg(tb.block_idx + u);
            if (f < 8) {
              s_f[f_at[r] + j * (f < 6 ? 3 : 1)] = fv;
            } else if (f < 11) {
              s_i[f_at[r] + j] = iv;
            } else if (f == 11) {
              reinterpret_cast<unsigned char*>(stage)[o_valid + j] = 1;
            }
          }
          ++n_valid;
          dirty = true;
        }
        prev_step = step;
        first = false;
        t_next = __fadd_rn(t, step);
      } else {  // empty: a quantized skip past the cube's exit
        float cube_near, cube_far;
        ray_aabb(o, inv, c, s, &cube_near, &cube_far);
        const float exit_t = __fadd_rn(nmax(cube_far, t), __fmul_rn(1e-4f, s));
        if (prev_step > 0.f) {
          const float q = nmax(
              ceilf(__fdiv_rn(__fsub_rn(exit_t, t), nmax(prev_step, 1e-8f))),
              1.0f);
          t_next = __fadd_rn(t, __fmul_rn(prev_step, q));
        } else {
          t_next = exit_t;
        }
      }
      alive = t_next < t_end;
      t = t_next;
    }

    __syncwarp(gmask);
    const size_t at = base + (size_t)i0;
    copy_run(world_out + at * 3, s_f + o_world, 3 * n, world_out + at * 3, lane);
    copy_run(warp_out + at * 3, s_f + o_warp, 3 * n, warp_out + at * 3, lane);
    copy_run(dist_out + at, s_f + o_dist, n, dist_out + at, lane);
    copy_run(t_out + at, s_f + o_t, n, t_out + at, lane);
    copy_run(trans_out + at, s_i + o_trans, n, trans_out + at, lane);
    copy_run(oct_out + at, s_i + o_oct, n, oct_out + at, lane);
    copy_run(block_out + at, s_i + o_block, n, block_out + at, lane);
    copy_run(valid_out + at,
             reinterpret_cast<unsigned char*>(stage) + o_valid, n,
             valid_out + at, lane);
    __syncwarp(gmask);
  }
  if (lane == 0) {
    num_valid_out[ray] = n_valid;
    first_oct_out[ray] = first_oct;
  }
}

}  // namespace

extern "C" int gfnerf_scan_march(
    const float* rays_o, const float* rays_d, const float* noise,
    const float* centers, const float* side_lens, const int* childs,
    const unsigned char* is_leaf, const int* trans_idx, const int* block_idx,
    const float* w2xz_flat, const float* warp_weight_flat,
    const float* t_center, const float* t_dis_summary, float* world,
    float* warp, float* dists, float* ts, int* trans, int* oct, int* block,
    bool* valid, long long* num_valid, float* first_oct,
    long long n_rays, int n_slots, int n_trans, int locate_iters,
    float sample_l, int scale_by_dis, float global_near, float global_far,
    void* stream) {
  if (n_rays <= 0) return (int)cudaGetLastError();
  Tables tb{centers, side_lens, childs, is_leaf, trans_idx, block_idx,
            w2xz_flat, warp_weight_flat, t_center, t_dis_summary, n_trans,
            locate_iters};
  const long long blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
  scan_march_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rays_o, rays_d, noise, tb, world, warp, dists, ts, trans, oct, block,
      reinterpret_cast<unsigned char*>(valid), num_valid, first_oct, n_rays,
      n_slots, sample_l, scale_by_dis, global_near, global_far);
  return (int)cudaGetLastError();
}
