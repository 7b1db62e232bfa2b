// The scan march: a sequential octree point-location march per ray (M1).
//
// Replaces the JAX package's get_samples + locate_points
// (gfnerf_tpu/sampler/perssampler.py:337, 236), a lax.scan over the S
// sample slots whose body descends the octree with a fori_loop; the
// reference runs the same march as CUDA (PersSampler::GetSamples,
// PersSampler_cuda.cu:321-477). Per ray, for each of the S slots:
//   p = o + t d; descend from the root for at most locate_iters levels
//   (child octant of p >= c; a missing child ends at that empty octant);
//   the warp's 12 homogeneous projections at p give the warped point and
//   ||J(p) d||; step = sample_l * noise / (||J d|| + 1e-6) (times the
//   distance scale) in a valid leaf, else a skip past the cube's exit in
//   whole steps of the last step; the slot is emitted when the ray is alive,
//   in a valid leaf and past its first valid leaf.
//
// Bound: memory. A slot writes 45 bytes (world and warped points, delta,
// t, three int32 indices, valid) and reads its 4-byte noise; the octree
// and warp tables (tens of KB to a few MB) stay in L1/L2 and are read
// through the read-only path (__ldg). Design: one thread per ray runs the whole
// sequential loop, as the reference's kernel does; the descent stops once
// the point is located (the plain version's later levels change nothing)
// and a ray that has left the root cube writes its remaining masked slots
// without computing them.
//
// Rounding follows the plain PyTorch version (perssampler.get_samples)
// operation by operation, so that the two agree bit for bit: fmaf exactly
// where the plain version forms a multiply-add in one rounding (o + t d,
// the sums of the warp's 12 weighted projections, the squared lengths),
// and __f*_rn (never contracted) everywhere else; maxima and minima
// propagate NaN as torch.maximum and torch.clamp do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

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

__global__ void __launch_bounds__(kThreads) scan_march_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ noise, Tables tb,
    float* __restrict__ world_out, float* __restrict__ warp_out,
    float* __restrict__ dist_out, float* __restrict__ t_out,
    int* __restrict__ trans_out, int* __restrict__ oct_out,
    int* __restrict__ block_out, bool* __restrict__ valid_out,
    long long* __restrict__ num_valid_out, float* __restrict__ first_oct_out,
    long long n_rays, int n_slots, float sample_l, int scale_by_dis,
    float global_near, float global_far) {
  const long long ray = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (ray >= n_rays) return;
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

  for (int i = 0; i < n_slots; ++i) {
    const size_t slot = base + (size_t)i;
    bool emit = false;
    float p[3], wp[3] = {0.f, 0.f, 0.f}, dt = 0.f;
    int trans = -1, node = -1, block = -1;
    if (alive) {
#pragma unroll
      for (int a = 0; a < 3; ++a) p[a] = fmaf(t, d[a], o[a]);
      // top-down point location (locate_points)
      int u = 0;
      float c[3] = {root_c[0], root_c[1], root_c[2]};
      float s = root_s;
      bool virt = false;
      for (int it = 0; it < tb.locate_iters; ++it) {
        if (__ldg(tb.is_leaf + u) != 0) break;
        const int b0 = p[0] >= c[0], b1 = p[1] >= c[1], b2 = p[2] >= c[2];
        const int child = __ldg(tb.childs + (size_t)u * 8 + b0 * 4 + b1 * 2 + b2);
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
      const int tr = (virt || !leaf) ? -1 : __ldg(tb.trans_idx + u);
      const bool valid_leaf = tr >= 0;
      const int trc = tr < 0 ? 0 : (tr > tb.n_trans - 1 ? tb.n_trans - 1 : tr);
      // the warp and ||J(p) d|| from the anchor's 12 projections
      const float* g = tb.w2xz + (size_t)trc * 96;
      const float* wf = tb.wweight + (size_t)trc * 36;
      float jd[3], wsum[3];
#pragma unroll
      for (int k = 0; k < 12; ++k) {
        float a = __fmul_rn(__ldg(g + k), p[0]);
        float b = __fmul_rn(__ldg(g + 12 + k), p[0]);
        float ad = __fmul_rn(__ldg(g + k), d[0]);
        float bd = __fmul_rn(__ldg(g + 12 + k), d[0]);
#pragma unroll
        for (int j = 1; j < 3; ++j) {
          a = __fadd_rn(a, __fmul_rn(__ldg(g + j * 24 + k), p[j]));
          b = __fadd_rn(b, __fmul_rn(__ldg(g + j * 24 + 12 + k), p[j]));
          ad = __fadd_rn(ad, __fmul_rn(__ldg(g + j * 24 + k), d[j]));
          bd = __fadd_rn(bd, __fmul_rn(__ldg(g + j * 24 + 12 + k), d[j]));
        }
        a = __fadd_rn(a, __ldg(g + 72 + k));
        b = __fadd_rn(b, __ldg(g + 84 + k));
        const float proj = __fsub_rn(
            __fdiv_rn(ad, b), __fmul_rn(__fdiv_rn(a, __fmul_rn(b, b)), bd));
        const float val = __fdiv_rn(a, b);
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) {
          const float w = __ldg(wf + cc * 12 + k);
          jd[cc] = k == 0 ? __fmul_rn(w, proj) : fmaf(w, proj, jd[cc]);
          wsum[cc] = k == 0 ? __fmul_rn(w, val) : fmaf(w, val, wsum[cc]);
        }
      }
      const float jn = __fsqrt_rn(__fadd_rn(
          __fadd_rn(__fmul_rn(jd[0], jd[0]), __fmul_rn(jd[1], jd[1])),
          __fmul_rn(jd[2], jd[2])));
      const float jnorm = __fadd_rn(jn, 1e-6f);
      float q0 = __fsub_rn(o[0], __ldg(tb.t_center + (size_t)trc * 3));
      float q1 = __fsub_rn(o[1], __ldg(tb.t_center + (size_t)trc * 3 + 1));
      float q2 = __fsub_rn(o[2], __ldg(tb.t_center + (size_t)trc * 3 + 2));
      float rr = __fmul_rn(q0, q0);
      rr = fmaf(q1, q1, rr);
      rr = fmaf(q2, q2, rr);
      const float radius =
          nmax(__fdiv_rn(__fsqrt_rn(rr), __ldg(tb.t_dis + trc)), 1.0f);
      float step = __fdiv_rn(__fmul_rn(sample_l, noise[slot]), jnorm);
      if (scale_by_dis) step = __fmul_rn(step, radius);
      emit = valid_leaf && !first;
      dt = __fmul_rn(step, jnorm);
      float cube_near, cube_far;
      ray_aabb(o, inv, c, s, &cube_near, &cube_far);
      if (valid_leaf && first_oct >= 1e8f) first_oct = nmax(cube_near, global_near);
      const float exit_t = __fadd_rn(nmax(cube_far, t), __fmul_rn(1e-4f, s));
      const float q = nmax(
          ceilf(__fdiv_rn(__fsub_rn(exit_t, t), nmax(prev_step, 1e-8f))), 1.0f);
      const float skip_t =
          prev_step > 0.f ? __fadd_rn(t, __fmul_rn(prev_step, q)) : exit_t;
      const float t_next = valid_leaf ? __fadd_rn(t, step) : skip_t;
      if (emit) {
        wp[0] = wsum[0];
        wp[1] = wsum[1];
        wp[2] = wsum[2];
        trans = tr;
        node = u;
        block = virt ? -1 : __ldg(tb.block_idx + u);
      }
      if (valid_leaf) {
        prev_step = step;
        first = false;
      }
      if (emit) t_out[slot] = t;
      alive = t_next < t_end;
      t = t_next;
    }
    if (!emit) {
      p[0] = p[1] = p[2] = 0.f;
      dt = 0.f;
      t_out[slot] = 0.f;
    }
    n_valid += emit;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      world_out[slot * 3 + a] = p[a];
      warp_out[slot * 3 + a] = wp[a];
    }
    dist_out[slot] = dt;
    trans_out[slot] = trans;
    oct_out[slot] = node;
    block_out[slot] = block;
    valid_out[slot] = emit;
  }
  num_valid_out[ray] = n_valid;
  first_oct_out[ray] = first_oct;
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
  const long long blocks = (n_rays + kThreads - 1) / kThreads;
  scan_march_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rays_o, rays_d, noise, tb, world, warp, dists, ts, trans, oct, block,
      valid, num_valid, first_oct, n_rays, n_slots, sample_l, scale_by_dis,
      global_near, global_far);
  return (int)cudaGetLastError();
}
