// Cluster walk kernels for the forward render path: nearest-hit and any-hit
// ray queries against the cluster tables of raytpu_torch/accel/clusters.py.
//
// walk_kernel<false, CULL, false> replaces raytpu/kernels/fused.py::
// _tlane_kernel as the render path runs it (nearest hit with the winner's u,
// v, triangle id and shade row); walk_kernel<true, CULL, false> replaces
// _fused_kernel with any_hit=True (shadow occlusion).  PRETEST=true with a
// runtime recull_every replaces _fused_kernel's two walk opt-ins, ``pretest``
// (fused.py:547-570, :598-606, :644-645) and ``recull_every``
// (fused.py:668-681), for nearest (the instanced render's default) and
// any-hit queries.  CULL is 0 (no culling), 1 (backface culling) or 2 (the
// mirrored "reverse" culling of shadow rays cast from the light).
//
// One thread block walks one tile of rays, one ray per thread:
//   1. prologue: per-ray finite mask and root-box t cap; the tile's beam
//      (origin box and direction box over its finite rays); a conservative
//      entry bound for every cluster (slab interval intersected with the
//      fitted-plane interval) into shared memory;
//   2. walk: a block-wide argmin picks the nearest remaining cluster (lowest
//      id on equal entries), its geometry block is staged into shared memory
//      with coalesced loads, and every thread tests its ray against the
//      cluster's triangles in det-multiplied space;
//   3. settle: a nearest query resolves a ray once its best hit is at or
//      before the next entry bound; an any-hit query at its first accepted
//      hit or once its t bound is at or before the next entry.  The block
//      stops when every ray is resolved or the entries run out.
//
// PRETEST: before staging a picked cluster, each thread slab-tests its ray
// against the cluster's box (the aabb table, equal to block rows 18-23,
// widened by the root margin) up to its cap min(best_t, t_max), -inf once
// resolved; a block vote (__syncthreads_or) skips both the staging and the
// triangle tests when no ray can reach the box.  recull_every > 0: every that
// many trips, after the settle check and while the block walks on, the entry
// bounds of the clusters not yet consumed are rebuilt from the beam of the
// unresolved rays only, pruned at the largest of their caps.  A consumed
// cluster's entry is +inf (above every bound, FLOAT_MAX included), so the
// re-cull needs no shared memory of its own.  A sub-beam's bounds are never
// below the beam's in IEEE arithmetic, so picks stay non-decreasing.
//
// Thread 0 writes per tile the trips (clusters picked: the reference's
// ``iters``), the clusters whose triangles were tested, and the ray tests
// the function needs: the unresolved rays of each tested cluster, summed
// (every thread tests its ray, but a resolved ray's tests change nothing).
//
// What bounds it on an H100: per tested cluster each thread does ~45 FP32
// operations and 18 shared-memory loads per triangle, with the same
// address across the warp (broadcast); the argmin pick scans the entry table
// (ncg floats in shared memory) once per trip, and a re-cull recomputes it.
// The design keeps everything a tile touches more than once on chip: the
// entry table and the staged block live in shared memory, and device memory
// is read once per tested cluster (18 of its 24 * C floats are staged) and
// per ray.  No asynchronous copies or double buffering yet.
//
// Bitwise agreement with the plain PyTorch walk (kernels/fused.py::
// walk_plain) rests on the same operations in the same order, IEEE division,
// NaN-propagating min/max where PyTorch's minimum/maximum propagate NaN, and
// building with -fmad=false so no a*b+c contracts to an FMA.

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
  const float* aabb;       // (6, ncg)
  const float* plane;      // (5, ncg)
  const float* block;      // (ncg, 24, csize)
  int ncg;
  int csize;
  int recull_every;        // 0: never
  const float* tri_shade;  // (N, 32), nearest only
  float* out_t;
  int* out_code;
  float* out_u;     // nearest only
  float* out_v;     // nearest only
  int* out_tri;     // nearest only
  float* out_rows;  // (R, 32), nearest only; null: no rows
  int* out_iters;   // (R / ts,) trips per tile
  int* out_tests;   // (R / ts,) clusters tested per tile
  int* out_ray_tests;  // (R / ts,) unresolved rays per tested cluster, summed
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

// kernels/fused.py::_entry_bounds for cluster j.
__device__ float entry_bound(const WalkArgs& a, int j, const Beam& b) {
  const int n = a.ncg;
  float t_lo = 0.f, t_hi = kInf;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float d_lo = b.d_min[k], d_hi = b.d_max[k];
    float lo, hi;
    interval(a.aabb[k * n + j] - b.o_max[k], a.aabb[(3 + k) * n + j] - b.o_min[k],
             b.inv_lo[k], b.inv_hi[k], d_lo > 0.f, d_hi > 0.f, d_lo < 0.f,
             d_hi < 0.f, lo, hi);
    t_lo = max_nan(t_lo, lo);
    t_hi = min_nan(t_hi, hi);
  }
  float g_lo = 0.f, g_hi = 0.f, o_dlo = 0.f, o_dhi = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float nk = a.plane[k * n + j];
    const float p = nk * b.d_min[k], q = nk * b.d_max[k];
    g_lo = g_lo + min_nan(p, q);
    g_hi = g_hi + max_nan(p, q);
    const float c1 = nk * b.o_min[k], c2 = nk * b.o_max[k];
    o_dlo = o_dlo + min_nan(c1, c2);
    o_dhi = o_dhi + max_nan(c1, c2);
  }
  const float d0 = a.plane[3 * n + j], eps = a.plane[4 * n + j];
  const float A = (d0 - o_dhi) - eps;
  const float B = (d0 - o_dlo) + eps;
  const float inv_ghi = 1.0f / (g_hi == 0.f ? 1.f : g_hi);
  const float inv_glo = 1.0f / (g_lo == 0.f ? 1.f : g_lo);
  float lo, hi;
  interval(A, B, inv_glo, inv_ghi, g_lo > 0.f, g_hi > 0.f, g_lo < 0.f,
           g_hi < 0.f, lo, hi);
  t_lo = max_nan(t_lo, lo);
  t_hi = min_nan(t_hi, hi);
  const bool feasible = t_lo <= t_hi && t_lo < kInf && t_lo < b.wcap;
  return (feasible && b.any) ? t_lo : kInf;
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

template <bool ANY_HIT, int CULL, bool PRETEST>
__global__ void walk_kernel(WalkArgs a) {
  extern __shared__ float smem[];
  float* ent = smem;           // (ncg,) remaining entry bounds
  float* geo = smem + a.ncg;   // (18, csize) staged cluster block
  __shared__ float red_f[32];
  __shared__ int red_i[32];

  const int tid = threadIdx.x;
  const bool active = tid < a.ts;
  const size_t r = static_cast<size_t>(blockIdx.x) * a.ts + tid;
  const float qnan = __int_as_float(0x7fc00000);

  float o[3], d[3];
  float tmax_in = 0.f;
  int itri = -1, imesh = -1;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = active ? a.origin[3 * r + k] : qnan;
    d[k] = active ? a.direction[3 * r + k] : qnan;
  }
  if (active) {
    tmax_in = a.tmax[r];
    itri = a.ignore_tri[r];
    imesh = a.ignore_mesh[r];
  }
  bool finite = active;
#pragma unroll
  for (int k = 0; k < 3; ++k) finite = finite && isfinite(o[k]) && isfinite(d[k]);

  // Root-box t cap (fused.py::_finite_and_cap_lm).
  const float margin = a.root[6];
  float t_en = -kInf, t_ex = kInf;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float safe_d = d[k] == 0.f ? kTinyDir : d[k];
    const float t1 = (a.root[k] - margin - o[k]) / safe_d;
    const float t2 = (a.root[3 + k] + margin - o[k]) / safe_d;
    t_en = max_nan(t_en, min_nan(t1, t2));
    t_ex = min_nan(t_ex, max_nan(t1, t2));
  }
  const bool root_hit = t_en <= t_ex && t_ex >= 0.f;
  float cap = root_hit ? t_ex * kCapScale + margin : 0.f;
  cap = isfinite(cap) ? cap : 0.f;
  const float tmax0 = min_nan(tmax_in, cap);

  // Rays that cannot hit (non-finite, or t bound not above 0, NaN
  // included) start resolved.
  bool res = !finite || !(tmax0 > 0.f);

  // The tile's beam over its finite rays (fused.py::_tile_bounds_lm),
  // pruned at the largest bound of the unresolved rays, so a dead ray's NaN
  // bound cannot poison its tile.
  {
    const float wcap = block_reduce(res ? -kInf : tmax0, MaxNanOp(), red_f);
    const Beam b = make_beam(o, d, finite, wcap, red_f);
    for (int j = tid; j < a.ncg; j += blockDim.x) {
      ent[j] = entry_bound(a, j, b);
    }
  }
  __syncthreads();

  // Per-ray state (fused.py::_walk_tiles).
  float bt = tmax0;
  int bc = -1;
  float bu = 0.f, bv = 0.f, bd = 1.f;
  int bi = -1;
  const float wx = d[1] * o[2] - d[2] * o[1];
  const float wy = d[2] * o[0] - d[0] * o[2];
  const float wz = d[0] * o[1] - d[1] * o[0];
  const int C = a.csize;
  // Slab reciprocals of the pretest (fused.py:543-544).
  float inv_d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    inv_d[k] = PRETEST ? 1.0f / (d[k] == 0.f ? kTinyDir : d[k]) : 0.f;
  }
  int trips = 0, tests = 0, ray_tests = 0;

  Pick cur = pick_next(ent, a.ncg, red_f, red_i);
  while (cur.v < kInf) {
    ++trips;
    bool viable = true;
    if (PRETEST) {
      // Can this ray reach the cluster's box before its cap (slab_viable)?
      const float cap_r = res ? -kInf : min_nan(bt, tmax0);
      float s_en = -kInf, s_ex = kInf;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float mn = a.aabb[k * a.ncg + cur.k] - margin;
        const float mx = a.aabb[(3 + k) * a.ncg + cur.k] + margin;
        const float t1 = (mn - o[k]) * inv_d[k];
        const float t2 = (mx - o[k]) * inv_d[k];
        s_en = max_nan(s_en, min_nan(t1, t2));
        s_ex = min_nan(s_ex, max_nan(t1, t2));
      }
      viable = __syncthreads_or(s_en <= s_ex && s_ex >= 0.f && s_en < cap_r);
    }
    if (viable) {
      ++tests;
      const float* src =
          a.block + static_cast<size_t>(cur.k) * kBlockRows * C;
      for (int e = tid; e < kGeoRows * C; e += blockDim.x) geo[e] = src[e];
      ray_tests += __syncthreads_count(!res);
      for (int j = 0; j < C; ++j) {
        const float nx = geo[j], ny = geo[C + j], nz = geo[2 * C + j];
        const float det = d[0] * nx + d[1] * ny + d[2] * nz;
        const float udet = wx * geo[6 * C + j] + wy * geo[7 * C + j] +
                           wz * geo[8 * C + j] + d[0] * geo[3 * C + j] +
                           d[1] * geo[4 * C + j] + d[2] * geo[5 * C + j];
        const float vdet = wx * geo[12 * C + j] + wy * geo[13 * C + j] +
                           wz * geo[14 * C + j] + d[0] * geo[9 * C + j] +
                           d[1] * geo[10 * C + j] + d[2] * geo[11 * C + j];
        const float tdet =
            geo[15 * C + j] - (o[0] * nx + o[1] * ny + o[2] * nz);
        const int tri_id = __float_as_int(geo[16 * C + j]);
        const int mesh_id = __float_as_int(geo[17 * C + j]);
        const bool keep = tri_id != itri && mesh_id != imesh;
        if (ANY_HIT) {
          if (keep && accept_within<CULL>(det, udet, vdet, tdet, tmax0)) {
            bc = 0;
          }
        } else {
          const float dist = (keep && accept<CULL>(det, udet, vdet, tdet))
                                 ? tdet / det
                                 : kInf;
          if (dist < bt) {
            bt = dist;
            bc = cur.k * C + j;
            bu = udet;
            bv = vdet;
            bd = det;
            bi = tri_id;
          }
        }
      }
    }
    const Pick nxt = pick_next(ent, a.ncg, red_f, red_i);
    res = res || (ANY_HIT ? (bc >= 0 || tmax0 <= nxt.v) : (bt <= nxt.v));
    if (__syncthreads_and(res)) break;
    if (a.recull_every > 0 && trips % a.recull_every == 0 && nxt.v < kInf) {
      // Re-cull from the unresolved rays' beam (fused.py:668-681).
      const float wcap =
          block_reduce(res ? -kInf : min_nan(bt, tmax0), MaxNanOp(), red_f);
      const Beam b = make_beam(o, d, finite && !res, wcap, red_f);
      for (int j = tid; j < a.ncg; j += blockDim.x) {
        if (ent[j] != consumed()) ent[j] = entry_bound(a, j, b);
      }
      __syncthreads();
    }
    cur = nxt;
  }

  if (tid == 0) {
    a.out_iters[blockIdx.x] = trips;
    a.out_tests[blockIdx.x] = tests;
    a.out_ray_tests[blockIdx.x] = ray_tests;
  }
  if (!active) return;
  if (ANY_HIT) {
    a.out_t[r] = bc >= 0 ? 0.f : bt;
    a.out_code[r] = bc;
    return;
  }
  const bool hit = bc >= 0;
  const float safe_det = hit ? bd : 1.f;
  a.out_t[r] = bt;
  a.out_code[r] = bc;
  a.out_u[r] = bu / safe_det;
  a.out_v[r] = bv / safe_det;
  a.out_tri[r] = bi;
  if (a.out_rows == nullptr) return;
  // The winner's shade row straight from tri_shade, channel 31 (mesh id
  // stored as int32 bits) written as a float value; misses get zeros.
  float* row = a.out_rows + r * kShadeCols;
  if (hit) {
    const float* srow = a.tri_shade + static_cast<size_t>(bi) * kShadeCols;
    for (int c = 0; c < kShadeCols - 1; ++c) row[c] = srow[c];
    row[kShadeCols - 1] =
        static_cast<float>(__float_as_int(srow[kShadeCols - 1]));
  } else {
    for (int c = 0; c < kShadeCols; ++c) row[c] = 0.f;
  }
}

template <bool ANY_HIT, int CULL, bool PRETEST>
cudaError_t launch(const WalkArgs& a, int n_rays, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(a.ncg) +
                       static_cast<size_t>(kGeoRows) * a.csize);
  // Past the default 48 KB the kernel must opt in to more dynamic shared
  // memory (scenes of more than ~10k clusters).
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        walk_kernel<ANY_HIT, CULL, PRETEST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = (a.ts + 31) / 32 * 32;
  walk_kernel<ANY_HIT, CULL, PRETEST>
      <<<n_rays / a.ts, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool ANY_HIT, bool PRETEST>
cudaError_t dispatch_cull(const WalkArgs& a, int n_rays, int cull,
                          cudaStream_t stream) {
  switch (cull) {
    case 0: return launch<ANY_HIT, 0, PRETEST>(a, n_rays, stream);
    case 1: return launch<ANY_HIT, 1, PRETEST>(a, n_rays, stream);
    case 2: return launch<ANY_HIT, 2, PRETEST>(a, n_rays, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool ANY_HIT>
cudaError_t dispatch(const WalkArgs& a, int n_rays, int cull, int pretest,
                     cudaStream_t stream) {
  if (a.recull_every < 0) return cudaErrorInvalidValue;
  return pretest ? dispatch_cull<ANY_HIT, true>(a, n_rays, cull, stream)
                 : dispatch_cull<ANY_HIT, false>(a, n_rays, cull, stream);
}

}  // namespace

extern "C" int rt_nearest_hit(
    const float* origin, const float* direction, const float* tmax,
    const int* ignore_tri, const int* ignore_mesh, int n_rays, int ts,
    const float* root, const float* aabb, const float* plane,
    const float* block, int ncg, int csize, const float* tri_shade, int cull,
    int pretest, int recull_every, float* out_t, int* out_code, float* out_u,
    float* out_v, int* out_tri, float* out_rows, int* out_iters,
    int* out_tests, int* out_ray_tests, void* stream) {
  const WalkArgs a{origin, direction, tmax,     ignore_tri, ignore_mesh,
                   ts,     root,      aabb,     plane,      block,
                   ncg,    csize,     recull_every, tri_shade, out_t,
                   out_code, out_u,   out_v,    out_tri,    out_rows,
                   out_iters, out_tests, out_ray_tests};
  return static_cast<int>(dispatch<false>(
      a, n_rays, cull, pretest, static_cast<cudaStream_t>(stream)));
}

extern "C" int rt_any_hit(
    const float* origin, const float* direction, const float* tmax,
    const int* ignore_tri, const int* ignore_mesh, int n_rays, int ts,
    const float* root, const float* aabb, const float* plane,
    const float* block, int ncg, int csize, int cull, int pretest,
    int recull_every, float* out_t, int* out_code, int* out_iters,
    int* out_tests, int* out_ray_tests, void* stream) {
  const WalkArgs a{origin, direction, tmax,     ignore_tri, ignore_mesh,
                   ts,     root,      aabb,     plane,      block,
                   ncg,    csize,     recull_every, nullptr, out_t,
                   out_code, nullptr, nullptr,  nullptr,    nullptr,
                   out_iters, out_tests, out_ray_tests};
  return static_cast<int>(dispatch<true>(
      a, n_rays, cull, pretest, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
