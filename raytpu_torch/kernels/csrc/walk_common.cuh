// Shared parts of the cluster walk kernels (walk.cu, subwalk.cu,
// mxuwalk.cu): the launch arguments, the entry bounds, the block-wide
// reductions and picks, the per-ray prologue and the ray-triangle test.
// Bitwise agreement with the plain PyTorch walks (kernels/fused.py) rests on
// the same operations in the same order, IEEE division, NaN-propagating
// min/max where PyTorch's minimum/maximum propagate NaN, and building with
// -fmad=false so no a*b+c contracts to an FMA.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr float kInf = 0x1.fffffep+127f;     // float32 max, 3.4028235e38
constexpr float kTinyDir = 0x1.4484cp-100f;  // float32(1e-30)
constexpr float kCapScale = 0x1.0000a8p+0f;  // float32(1 + 1e-5)
constexpr int kBlockRows = 24;  // rows per cluster in the block table
constexpr int kGeoRows = 18;    // rows 0-15 geometry, 16 tri id, 17 mesh id
constexpr int kShadeCols = 32;

struct WalkArgs {
  const float* origin;     // (R, 3)
  const float* direction;  // (R, 3)
  const float* tmax;       // (R,)
  const int* ignore_tri;   // (R,)
  const int* ignore_mesh;  // (R,)
  int ts;                  // rays per tile; R is a multiple of it
  const float* root;       // (8,) box min xyz, box max xyz, margin, 0
  const float* aabb;       // (6, ncg) block boxes
  const float* plane;      // (5, ncg) or null (slab interval alone);
                           // unused by the prepick walk
  const float* block;      // (ncg, 24, csize)
  int ncg;
  int csize;
  int recull_every;        // 0: never
  int max_trips;           // 0: no budget
  int picks;               // prepick walk: F
  // subwalk_kernel only: per-sibling tables, block-indexed (sibling 0 is
  // the block itself when subk is 1), the picks per trip and the gate.
  const float* sub_aabb;   // (subk, 6, ncg)
  const float* sub_plane;  // (subk, 5, ncg) or null
  int subk;
  int chunk_k;
  int gate;
  const float* tri_shade;  // (N, 32), nearest only
  float* out_t;
  int* out_code;
  float* out_u;     // nearest only
  float* out_v;     // nearest only
  int* out_tri;     // nearest only
  float* out_rows;  // (R, 32), nearest only; null: no rows
  int* out_res;     // (R,) resolved flag
  int* out_iters;   // (R / ts,) trips per tile
  int* out_tests;   // (R / ts,) clusters tested per tile
  int* out_ray_tests;  // (R / ts,) unresolved rays per tested cluster, summed
  int highest;  // mxu_walk_kernel only: 3xTF32 (1) or one TF32 pass (0)
};

// torch.maximum / torch.minimum: NaN in either operand propagates.
__device__ __forceinline__ float max_nan(float a, float b) {
  if (isnan(a) || isnan(b)) return __int_as_float(0x7fc00000);
  return a > b ? a : b;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  if (isnan(a) || isnan(b)) return __int_as_float(0x7fc00000);
  return a < b ? a : b;
}

// The entry of a consumed cluster: +inf.
__device__ __forceinline__ float consumed() {
  return __int_as_float(0x7f800000);
}

// raytpu_torch/core/intersect.py::det_space_accept.
template <int CULL>
__device__ __forceinline__ bool accept(float det, float udet, float vdet,
                                       float tdet) {
  if (CULL == 2) {
    return udet >= 0.f && vdet >= 0.f && tdet >= 0.f && udet + vdet <= det &&
           det > 0.f;
  }
  if (CULL == 1) {
    return udet <= 0.f && vdet <= 0.f && tdet <= 0.f && udet + vdet >= det &&
           det < 0.f;
  }
  const float s = det < 0.f ? -1.f : 1.f;
  const float us = udet * s, vs = vdet * s, ts = tdet * s, ps = det * s;
  return us >= 0.f && vs >= 0.f && ts >= 0.f && us + vs <= ps && ps > 0.f;
}

// raytpu_torch/core/intersect.py::det_space_accept_within.
template <int CULL>
__device__ __forceinline__ bool accept_within(float det, float udet,
                                              float vdet, float tdet,
                                              float t_max) {
  if (!accept<CULL>(det, udet, vdet, tdet)) return false;
  if (CULL == 2) return tdet < t_max * det;
  if (CULL == 1) return tdet > t_max * det;
  const float s = det < 0.f ? -1.f : 1.f;
  return tdet * s < t_max * (det * s);
}

// Conservative [lo, hi] of t >= 0 with t*g in [s_lo, s_hi] for some g in
// [g_lo, g_hi] (g's reciprocals and signs given); one slab axis or the
// fitted plane.
__device__ __forceinline__ void interval(float s_lo, float s_hi, float inv_lo,
                                         float inv_hi, bool lo_pos,
                                         bool hi_pos, bool lo_neg,
                                         bool hi_neg, float& lo, float& hi) {
  const bool pos = s_lo > 0.f;
  const bool neg = s_hi < 0.f;
  lo = pos ? (hi_pos ? s_lo * inv_hi : kInf)
           : (neg ? (lo_neg ? s_hi * inv_lo : kInf) : 0.f);
  const float hi_same =
      lo_pos ? s_hi * inv_lo : (hi_neg ? s_lo * inv_hi : kInf);
  hi = pos ? (lo_pos ? s_hi * inv_lo : kInf)
           : (neg ? (hi_neg ? s_lo * inv_hi : kInf) : hi_same);
}

struct Beam {
  float o_min[3], o_max[3], d_min[3], d_max[3];
  float inv_lo[3], inv_hi[3];  // slab reciprocals of d_min, d_max
  float wcap;  // entries at or beyond it are infeasible
  bool any;    // the tile has a finite ray
};

// kernels/fused.py::_entry_bounds for column j of the (6, n) box and
// (5, n) plane tables; PLANE=false: the slab interval alone.
template <bool PLANE>
__device__ float entry_bound(const float* aabb, const float* plane, int n,
                             int j, const Beam& b) {
  float t_lo = 0.f, t_hi = kInf;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float d_lo = b.d_min[k], d_hi = b.d_max[k];
    float lo, hi;
    interval(aabb[k * n + j] - b.o_max[k], aabb[(3 + k) * n + j] - b.o_min[k],
             b.inv_lo[k], b.inv_hi[k], d_lo > 0.f, d_hi > 0.f, d_lo < 0.f,
             d_hi < 0.f, lo, hi);
    t_lo = max_nan(t_lo, lo);
    t_hi = min_nan(t_hi, hi);
  }
  if (PLANE) {
    float g_lo = 0.f, g_hi = 0.f, o_dlo = 0.f, o_dhi = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float nk = plane[k * n + j];
      const float p = nk * b.d_min[k], q = nk * b.d_max[k];
      g_lo = g_lo + min_nan(p, q);
      g_hi = g_hi + max_nan(p, q);
      const float c1 = nk * b.o_min[k], c2 = nk * b.o_max[k];
      o_dlo = o_dlo + min_nan(c1, c2);
      o_dhi = o_dhi + max_nan(c1, c2);
    }
    const float d0 = plane[3 * n + j], eps = plane[4 * n + j];
    const float A = (d0 - o_dhi) - eps;
    const float B = (d0 - o_dlo) + eps;
    const float inv_ghi = 1.0f / (g_hi == 0.f ? 1.f : g_hi);
    const float inv_glo = 1.0f / (g_lo == 0.f ? 1.f : g_lo);
    float lo, hi;
    interval(A, B, inv_glo, inv_ghi, g_lo > 0.f, g_hi > 0.f, g_lo < 0.f,
             g_hi < 0.f, lo, hi);
    t_lo = max_nan(t_lo, lo);
    t_hi = min_nan(t_hi, hi);
  }
  const bool feasible = t_lo <= t_hi && t_lo < kInf && t_lo < b.wcap;
  return (feasible && b.any) ? t_lo : kInf;
}

// The entry bound with the fitted plane when the table has one.
__device__ __forceinline__ float entry_of(const float* aabb,
                                          const float* plane, int n, int j,
                                          const Beam& b) {
  return plane ? entry_bound<true>(aabb, plane, n, j, b)
               : entry_bound<false>(aabb, plane, n, j, b);
}

// Block-wide reductions; blockDim.x is a multiple of 32 and every thread
// calls them.  min/max of non-NaN values do not depend on the order.
struct MinOp {
  __device__ float operator()(float a, float b) const { return a < b ? a : b; }
};
struct MaxOp {
  __device__ float operator()(float a, float b) const { return a > b ? a : b; }
};
struct MaxNanOp {
  __device__ float operator()(float a, float b) const { return max_nan(a, b); }
};

template <typename Op>
__device__ float block_reduce(float v, Op op, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  v = scratch[0];
  const int nw = blockDim.x >> 5;
  for (int w = 1; w < nw; ++w) v = op(v, scratch[w]);
  return v;
}

// The beam of the rays with m set (fused.py::_tile_bounds_lm); every thread
// calls it.
__device__ Beam make_beam(const float o[3], const float d[3], bool m,
                          float wcap, float* red_f) {
  Beam b;
  b.wcap = wcap;
  b.any = __syncthreads_or(m);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float omn = block_reduce(m ? o[k] : kInf, MinOp(), red_f);
    const float omx = block_reduce(m ? o[k] : -kInf, MaxOp(), red_f);
    const float dmn = block_reduce(m ? d[k] : kInf, MinOp(), red_f);
    const float dmx = block_reduce(m ? d[k] : -kInf, MaxOp(), red_f);
    b.o_min[k] = b.any ? omn : 0.f;
    b.o_max[k] = b.any ? omx : 0.f;
    b.d_min[k] = b.any ? dmn : 1.f;
    b.d_max[k] = b.any ? dmx : 1.f;
    b.inv_lo[k] = 1.0f / (b.d_min[k] == 0.f ? 1.f : b.d_min[k]);
    b.inv_hi[k] = 1.0f / (b.d_max[k] == 0.f ? 1.f : b.d_max[k]);
  }
  return b;
}

struct Pick {
  float v;  // entry bound, kInf once the entries run out
  int k;    // cluster id
};

// Nearest remaining entry, lowest cluster id on equal entries; consumes it.
// The caller puts a barrier between two calls with nothing else between.
__device__ Pick pick_next(float* ent, int ncg, float* red_f, int* red_i) {
  float v = kInf;
  int k = INT_MAX;
  for (int j = threadIdx.x; j < ncg; j += blockDim.x) {
    const float e = ent[j];
    if (e < v) {
      v = e;
      k = j;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int ok = __shfl_xor_sync(0xffffffffu, k, off);
    if (ov < v || (ov == v && ok < k)) {
      v = ov;
      k = ok;
    }
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    red_f[threadIdx.x >> 5] = v;
    red_i[threadIdx.x >> 5] = k;
  }
  __syncthreads();
  v = red_f[0];
  k = red_i[0];
  const int nw = blockDim.x >> 5;
  for (int w = 1; w < nw; ++w) {
    if (red_f[w] < v || (red_f[w] == v && red_i[w] < k)) {
      v = red_f[w];
      k = red_i[w];
    }
  }
  if (threadIdx.x == 0 && v < kInf) ent[k] = consumed();
  return {v, k};
}

// The steps of the prepick and group walks.  walk_kernel carries the same
// steps inline, in the form that keeps it within its register budget (see
// its note).

// One thread's ray (fused.py::_walk_tiles prologue).
struct Ray {
  float o[3], d[3];
  float tmax0;  // t bound capped at the root box's exit
  int itri, imesh;
  bool finite;
};

__device__ Ray load_ray(const WalkArgs& a, size_t r, bool active) {
  const float qnan = __int_as_float(0x7fc00000);
  Ray ray;
  float tmax_in = 0.f;
  ray.itri = -1;
  ray.imesh = -1;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ray.o[k] = active ? a.origin[3 * r + k] : qnan;
    ray.d[k] = active ? a.direction[3 * r + k] : qnan;
  }
  if (active) {
    tmax_in = a.tmax[r];
    ray.itri = a.ignore_tri[r];
    ray.imesh = a.ignore_mesh[r];
  }
  bool finite = active;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    finite = finite && isfinite(ray.o[k]) && isfinite(ray.d[k]);
  }
  ray.finite = finite;

  // Root-box t cap (fused.py::_finite_and_cap_lm).
  const float margin = a.root[6];
  float t_en = -kInf, t_ex = kInf;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float safe_d = ray.d[k] == 0.f ? kTinyDir : ray.d[k];
    const float t1 = (a.root[k] - margin - ray.o[k]) / safe_d;
    const float t2 = (a.root[3 + k] + margin - ray.o[k]) / safe_d;
    t_en = max_nan(t_en, min_nan(t1, t2));
    t_ex = min_nan(t_ex, max_nan(t1, t2));
  }
  const bool root_hit = t_en <= t_ex && t_ex >= 0.f;
  float cap = root_hit ? t_ex * kCapScale + margin : 0.f;
  cap = isfinite(cap) ? cap : 0.f;
  ray.tmax0 = min_nan(tmax_in, cap);
  return ray;
}

// The entry table of the tile's beam over its finite rays
// (fused.py::_tile_bounds_lm), pruned at the largest bound of the
// unresolved rays, so a dead ray's NaN bound cannot poison its tile.  Every
// thread calls it; it ends in a barrier.
template <bool PLANE>
__device__ void fill_entries(const WalkArgs& a, const Ray& ray, bool res,
                             float* ent, float* red_f) {
  const float wcap = block_reduce(res ? -kInf : ray.tmax0, MaxNanOp(), red_f);
  const Beam b = make_beam(ray.o, ray.d, ray.finite, wcap, red_f);
  for (int j = threadIdx.x; j < a.ncg; j += blockDim.x) {
    ent[j] = entry_bound<PLANE>(a.aabb, a.plane, a.ncg, j, b);
  }
  __syncthreads();
}

// Per-ray best (fused.py::_walk_tiles state).
struct Best {
  float t;
  int code;
  float u, v, det;
  int tri;
};

// Stage cluster k's geometry rows into shared memory; every thread calls
// it.  Returns the tile's unresolved rays (the barrier after the staging).
__device__ int stage(const WalkArgs& a, int k, float* geo, bool res) {
  const int C = a.csize;
  const float* src = a.block + static_cast<size_t>(k) * kBlockRows * C;
  for (int e = threadIdx.x; e < kGeoRows * C; e += blockDim.x) geo[e] = src[e];
  return __syncthreads_count(!res);
}

// Test the ray against lanes lo to hi - 1 of the staged cluster k, in lane
// order (fused.py::_test_cluster).
template <bool ANY_HIT, int CULL>
__device__ __forceinline__ void test_staged(const float* geo, int C, int lo,
                                            int hi, int k, const Ray& ray,
                                            const float w[3], Best& best) {
  const float* o = ray.o;
  const float* d = ray.d;
  for (int j = lo; j < hi; ++j) {
    const float nx = geo[j], ny = geo[C + j], nz = geo[2 * C + j];
    const float det = d[0] * nx + d[1] * ny + d[2] * nz;
    const float udet = w[0] * geo[6 * C + j] + w[1] * geo[7 * C + j] +
                       w[2] * geo[8 * C + j] + d[0] * geo[3 * C + j] +
                       d[1] * geo[4 * C + j] + d[2] * geo[5 * C + j];
    const float vdet = w[0] * geo[12 * C + j] + w[1] * geo[13 * C + j] +
                       w[2] * geo[14 * C + j] + d[0] * geo[9 * C + j] +
                       d[1] * geo[10 * C + j] + d[2] * geo[11 * C + j];
    const float tdet = geo[15 * C + j] - (o[0] * nx + o[1] * ny + o[2] * nz);
    const int tri_id = __float_as_int(geo[16 * C + j]);
    const int mesh_id = __float_as_int(geo[17 * C + j]);
    const bool keep = tri_id != ray.itri && mesh_id != ray.imesh;
    if (ANY_HIT) {
      if (keep && accept_within<CULL>(det, udet, vdet, tdet, ray.tmax0)) {
        best.code = 0;
      }
    } else {
      const float dist =
          (keep && accept<CULL>(det, udet, vdet, tdet)) ? tdet / det : kInf;
      if (dist < best.t) {
        best.t = dist;
        best.code = k * C + j;
        best.u = udet;
        best.v = vdet;
        best.det = det;
        best.tri = tri_id;
      }
    }
  }
}

// Thread 0 writes the tile's counters; every active thread its ray's
// outputs.
template <bool ANY_HIT>
__device__ void write_out(const WalkArgs& a, size_t r, bool active,
                          const Best& best, bool res, int trips, int tests,
                          int ray_tests) {
  if (threadIdx.x == 0) {
    a.out_iters[blockIdx.x] = trips;
    a.out_tests[blockIdx.x] = tests;
    a.out_ray_tests[blockIdx.x] = ray_tests;
  }
  if (!active) return;
  a.out_res[r] = res ? 1 : 0;
  if (ANY_HIT) {
    a.out_t[r] = best.code >= 0 ? 0.f : best.t;
    a.out_code[r] = best.code;
    return;
  }
  const bool hit = best.code >= 0;
  const float safe_det = hit ? best.det : 1.f;
  a.out_t[r] = best.t;
  a.out_code[r] = best.code;
  a.out_u[r] = best.u / safe_det;
  a.out_v[r] = best.v / safe_det;
  a.out_tri[r] = best.tri;
  if (a.out_rows == nullptr) return;
  // The winner's shade row straight from tri_shade, channel 31 (mesh id
  // stored as int32 bits) written as a float value; misses get zeros.
  float* row = a.out_rows + r * kShadeCols;
  if (hit) {
    const float* srow = a.tri_shade + static_cast<size_t>(best.tri) * kShadeCols;
    for (int c = 0; c < kShadeCols - 1; ++c) row[c] = srow[c];
    row[kShadeCols - 1] =
        static_cast<float>(__float_as_int(srow[kShadeCols - 1]));
  } else {
    for (int c = 0; c < kShadeCols; ++c) row[c] = 0.f;
  }
}

// Launch ``kernel`` over R / ts tiles with ``smem`` bytes of dynamic
// shared memory; 0 or the launch's error.
template <typename Kernel>
cudaError_t launch(Kernel kernel, const WalkArgs& a, int n_rays, size_t smem,
                   cudaStream_t stream) {
  // Past the default 48 KB the kernel must opt in to more dynamic shared
  // memory (scenes of more than ~10k clusters, many picks, or chunks).
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = (a.ts + 31) / 32 * 32;
  kernel<<<n_rays / a.ts, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The arguments every entry point shares.
WalkArgs walk_args(const float* origin, const float* direction,
                   const float* tmax, const int* ignore_tri,
                   const int* ignore_mesh, int ts, const float* root,
                   const float* aabb, const float* block, int ncg,
                   int csize) {
  WalkArgs a{};
  a.origin = origin;
  a.direction = direction;
  a.tmax = tmax;
  a.ignore_tri = ignore_tri;
  a.ignore_mesh = ignore_mesh;
  a.ts = ts;
  a.root = root;
  a.aabb = aabb;
  a.block = block;
  a.ncg = ncg;
  a.csize = csize;
  return a;
}

void set_outputs(WalkArgs& a, float* out_t, int* out_code, int* out_res,
                 int* out_iters, int* out_tests, int* out_ray_tests) {
  a.out_t = out_t;
  a.out_code = out_code;
  a.out_res = out_res;
  a.out_iters = out_iters;
  a.out_tests = out_tests;
  a.out_ray_tests = out_ray_tests;
}

}  // namespace
