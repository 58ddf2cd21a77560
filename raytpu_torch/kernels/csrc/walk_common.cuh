// Shared parts of the cluster walk kernels (walk.cu, subwalk.cu,
// mxuwalk.cu): the launch arguments, the entry bounds, the block-wide
// reductions and picks, the per-ray prologue, the ray-triangle tests and
// the tests of few unresolved rays.
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
  const float* group_aabb; // walk_kernel and subwalk_kernel: (6,
                           // ceil(ncg / 32)) boxes of 32 consecutive
                           // clusters (of their cull boxes)
  const float* cull_aabb;  // subwalk_kernel only: (6, ncg) boxes, each
                           // holding its block's sibling boxes
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

// Per-ray best (fused.py::_walk_tiles state).
struct Best {
  float t;
  int code;
  float u, v, det;
  int tri;
};

// ---- Asynchronous copies, picks from per-thread least entries, the
// prologue's culled entry table, the float4 pair tests ----------------------

__device__ __forceinline__ bool lex_less(float v, int k, float w, int l) {
  return v < w || (v == w && k < l);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying cluster k's 18 geometry rows into ``geo``; every thread
// issues its share (16-byte pieces when ``vec``).
__device__ __forceinline__ void stage_async(const WalkArgs& a, int k,
                                            float* geo, bool vec) {
  const int C = a.csize;
  const float* src = a.block + static_cast<size_t>(k) * kBlockRows * C;
  if (vec) {
    for (int e = threadIdx.x; e < kGeoRows * C / 4; e += blockDim.x) {
      cp_async16(geo + 4 * e, src + 4 * e);
    }
  } else {
    for (int e = threadIdx.x; e < kGeoRows * C; e += blockDim.x) {
      cp_async4(geo + e, src + e);
    }
  }
}

// A float's bits as an unsigned key in the order of its value (-0 below
// +0), and back.
__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float unordered(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The beam of the rays with m set, pruned at ``cap``'s block maximum, into
// shared memory (fused.py::_tile_bounds_lm): the least and greatest origin
// and direction of those rays per axis, by warp reductions of the values'
// ordered keys.  Their zeros' signs may differ from a sequential min/max's;
// no entry bound depends on them.  The caps are never NaN.  Every thread
// calls it; it ends in a barrier.
__device__ void beam_to_smem(const float o[3], const float d[3], bool m,
                             float cap, Beam& beam, unsigned* red) {
  unsigned v[13];
  v[0] = __reduce_max_sync(0xffffffffu, ordered(cap));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v[1 + k] = __reduce_min_sync(0xffffffffu, ordered(m ? o[k] : kInf));
    v[4 + k] = __reduce_max_sync(0xffffffffu, ordered(m ? o[k] : -kInf));
    v[7 + k] = __reduce_min_sync(0xffffffffu, ordered(m ? d[k] : kInf));
    v[10 + k] = __reduce_max_sync(0xffffffffu, ordered(m ? d[k] : -kInf));
  }
  const int lane = threadIdx.x & 31;
  __syncthreads();  // the previous reader of ``red`` and ``beam`` is done
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 13; ++i) red[i * 32 + (threadIdx.x >> 5)] = v[i];
  }
  const bool any = __syncthreads_or(m);
  if (threadIdx.x < 32) {
    const bool in = lane < static_cast<int>(blockDim.x >> 5);
#pragma unroll
    for (int i = 0; i < 13; ++i) {
      const bool is_min = (i >= 1 && i < 4) || (i >= 7 && i < 10);
      const unsigned x = in ? red[i * 32 + lane] : (is_min ? ~0u : 0u);
      v[i] = is_min ? __reduce_min_sync(0xffffffffu, x)
                    : __reduce_max_sync(0xffffffffu, x);
    }
    if (lane == 0) {
      beam.wcap = unordered(v[0]);
      beam.any = any;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        beam.o_min[k] = any ? unordered(v[1 + k]) : 0.f;
        beam.o_max[k] = any ? unordered(v[4 + k]) : 0.f;
        const float dmn = any ? unordered(v[7 + k]) : 1.f;
        const float dmx = any ? unordered(v[10 + k]) : 1.f;
        beam.d_min[k] = dmn;
        beam.d_max[k] = dmx;
        beam.inv_lo[k] = 1.0f / (dmn == 0.f ? 1.f : dmn);
        beam.inv_hi[k] = 1.0f / (dmx == 0.f ? 1.f : dmx);
      }
    }
  }
  __syncthreads();
}

// The warp's least (v, k) by entry, then id, in every lane.  Entries are
// in [0, +inf] (a -0 entry equals +0), so with -0 made +0 their bits order
// as their values: two warp reductions.
__device__ __forceinline__ void warp_lexmin(float& v, int& k) {
  const unsigned key = __float_as_uint(v + 0.f);
  const unsigned m = __reduce_min_sync(0xffffffffu, key);
  k = static_cast<int>(__reduce_min_sync(
      0xffffffffu, key == m ? static_cast<unsigned>(k) : 0x7fffffffu));
  v = __uint_as_float(m);
}

// Block-wide least (v, k) by entry, then id.  Every thread calls it, with
// the other of two scratch buffers each call: a thread reads a buffer
// before the barrier of the next call, which the next writer of the buffer
// must pass first.
__device__ Pick block_lexmin(float v, int k, float* red_f, int* red_i) {
  warp_lexmin(v, k);
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    red_f[threadIdx.x >> 5] = v;
    red_i[threadIdx.x >> 5] = k;
  }
  __syncthreads();
  const bool in = lane < static_cast<int>(blockDim.x >> 5);
  v = in ? red_f[lane] : kInf;
  k = in ? red_i[lane] : INT_MAX;
  warp_lexmin(v, k);
  return {v, k};
}

// The owner of the consumed entry k marks it and its warp refreshes the
// owner's least entry (cv, ck): the owner's entries one a lane, reduced by
// entry, then id (the order of a scan).  Entries change only here, so each
// thread's least entry stays its least one.
__device__ __forceinline__ void consume(float* ent, int ncg, int k,
                                        float& cv, int& ck) {
  const int nt = blockDim.x, t = k % nt, tid = threadIdx.x;
  if ((tid >> 5) != (t >> 5)) return;
  if (tid == t) ent[k] = consumed();
  __syncwarp();
  float v = kInf;
  int m = INT_MAX;
  for (int j = t + nt * (tid & 31); j < ncg; j += 32 * nt) {
    const float e = ent[j];
    if (e < v) {
      v = e;
      m = j;
    }
  }
  warp_lexmin(v, m);
  if (tid == t) {
    cv = v;
    ck = m;
  }
}

// The prologue's entry table: ``ent[j] = key(j)`` for every cluster (or
// block) j, owned by thread j mod blockDim.x, and each thread's least entry
// (cv, ck).  A warp takes a group of 32 consecutive clusters (its lanes are
// their owners), two groups an iteration, so that their loads overlap; a
// group whose box (``a.group_aabb``, kernels/fused.py::group_boxes) the
// beam cannot reach gets kInf entries without a look at its clusters:
// their slab intervals lie inside the group's, so each is infeasible too.
// ``mark(j)`` runs for every entry written.
template <typename Key, typename Mark>
__device__ __forceinline__ void cull_entries(const WalkArgs& a,
                                             const Beam& bm, float* ent,
                                             Key key, Mark mark, float& cv,
                                             int& ck) {
  cv = kInf;
  ck = INT_MAX;
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int ng = (a.ncg + 31) >> 5;
  for (int g = threadIdx.x >> 5; g < ng; g += 2 * nw) {
    const int g1 = g + nw < ng ? g + nw : g;
    const bool r0 = entry_bound<false>(a.group_aabb, nullptr, ng, g, bm) < kInf;
    const bool r1 =
        entry_bound<false>(a.group_aabb, nullptr, ng, g1, bm) < kInf;
    const int j0 = 32 * g + lane;
    const int j1 = g1 == g ? a.ncg : 32 * g1 + lane;
    const float e0 = r0 && j0 < a.ncg ? key(j0) : kInf;
    const float e1 = r1 && j1 < a.ncg ? key(j1) : kInf;
    if (j0 < a.ncg) {
      ent[j0] = e0;
      mark(j0);
      if (e0 < cv) {
        cv = e0;
        ck = j0;
      }
    }
    if (j1 < a.ncg) {
      ent[j1] = e1;
      mark(j1);
      if (e1 < cv) {
        cv = e1;
        ck = j1;
      }
    }
  }
}

// A re-cull: every entry not consumed anew (``key(j)``) and each thread's
// least entry (cv, ck).  Each thread rewrites the entries it owns.
template <typename Key>
__device__ __forceinline__ void recull_entries(const WalkArgs& a, float* ent,
                                               Key key, float& cv, int& ck) {
  cv = kInf;
  ck = INT_MAX;
  for (int j = threadIdx.x; j < a.ncg; j += blockDim.x) {
    float e = ent[j];
    if (e != consumed()) {
      e = key(j);
      ent[j] = e;
    }
    if (e < cv) {
      cv = e;
      ck = j;
    }
  }
}

// Can a ray reach the box ``bx`` (min xyz, max xyz, ``stride`` floats
// apart; widened by the root margin) before its cap?  The classic walk's
// pretest (fused.py::_slab_viable) for one ray: every pair it skips would
// hit, if at all, at or beyond the ray's best (or t bound), where the
// strict-min update takes nothing.
__device__ __forceinline__ bool reaches(const float* bx, float margin,
                                        const float o[3],
                                        const float inv_d[3], float cap,
                                        int stride = 1) {
  float s_en = -kInf, s_ex = kInf;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float t1 = (bx[c * stride] - margin - o[c]) * inv_d[c];
    const float t2 = (bx[(3 + c) * stride] + margin - o[c]) * inv_d[c];
    s_en = max_nan(s_en, min_nan(t1, t2));
    s_ex = min_nan(s_ex, max_nan(t1, t2));
  }
  return s_en <= s_ex && s_ex >= 0.f && s_en < cap;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// s * a, a + b, a - b per component, as the scalar walk rounds them.
__device__ __forceinline__ float4 mul4(float s, float4 a) {
  return make_float4(s * a.x, s * a.y, s * a.z, s * a.w);
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// One pair's acceptance and, if it wins, the best's update (the scalar
// walk's test, lane j of the staged block, code base + j).
template <bool ANY_HIT, int CULL>
__device__ __forceinline__ void take(const float* geo, int C, int j,
                                     float det, float udet, float vdet,
                                     float tdet, float tmax0, int itri,
                                     int imesh, int base, Best& h) {
  const bool ok = ANY_HIT ? accept_within<CULL>(det, udet, vdet, tdet, tmax0)
                          : accept<CULL>(det, udet, vdet, tdet);
  if (!ok) return;
  const int tri_id = __float_as_int(geo[16 * C + j]);
  const int mesh_id = __float_as_int(geo[17 * C + j]);
  if (tri_id == itri || mesh_id == imesh) return;
  if (ANY_HIT) {
    h.code = 0;
    return;
  }
  const float dist = tdet / det;
  if (dist < h.t) {
    h.t = dist;
    h.code = base + j;
    h.u = udet;
    h.v = vdet;
    h.det = det;
    h.tri = tri_id;
  }
}

// Whether a pair with these det and u*det can pass its cull's sign tests
// (the first conjuncts of accept<CULL>).
template <int CULL>
__device__ __forceinline__ bool u_ok(float det, float udet) {
  if (CULL == 2) return udet >= 0.f && det > 0.f;
  if (CULL == 1) return udet <= 0.f && det < 0.f;
  const float s = det < 0.f ? -1.f : 1.f;
  return udet * s >= 0.f && det * s > 0.f;
}

// Whether a pair with this det can pass its cull's sign test on det (the
// last conjunct of accept<CULL>; every det passes without culling).
template <int CULL>
__device__ __forceinline__ bool det_ok(float det) {
  return CULL == 2 ? det > 0.f : CULL == 1 ? det < 0.f : true;
}

// Lanes j0 to j0 + 3 of the staged block, in lane order; rows read as float4.
// EARLY (every lane of the warp calls it): 1, when no pair of the warp can
// pass the u test, v, t and the acceptance are skipped; 2, with culling,
// first the same on det alone, and o.n (for t) only after the u test, from
// the normal rows read again.  A lane that is not ``live`` tests nothing
// and only votes.
template <bool ANY_HIT, int CULL, int EARLY>
__device__ __forceinline__ void test4(const float* geo, int C, int j0,
                                      const float o[3], const float d[3],
                                      const float w[3], float tmax0, int itri,
                                      int imesh, int base, Best& h,
                                      bool live = true) {
  const float* g = geo + j0;
  float4 det, on;
  {
    const float4 nx = ld4(g), ny = ld4(g + C), nz = ld4(g + 2 * C);
    det = add4(add4(mul4(d[0], nx), mul4(d[1], ny)), mul4(d[2], nz));
    if (EARLY == 2 && CULL != 0) {
      const bool need = live && (det_ok<CULL>(det.x) || det_ok<CULL>(det.y) ||
                                 det_ok<CULL>(det.z) || det_ok<CULL>(det.w));
      if (!__any_sync(0xffffffffu, need)) return;
    }
    if (EARLY != 2) {
      on = add4(add4(mul4(o[0], nx), mul4(o[1], ny)), mul4(o[2], nz));
    }
  }
  float4 u = mul4(w[0], ld4(g + 6 * C));
  u = add4(u, mul4(w[1], ld4(g + 7 * C)));
  u = add4(u, mul4(w[2], ld4(g + 8 * C)));
  u = add4(u, mul4(d[0], ld4(g + 3 * C)));
  u = add4(u, mul4(d[1], ld4(g + 4 * C)));
  u = add4(u, mul4(d[2], ld4(g + 5 * C)));
  if (EARLY) {
    const bool need =
        live && (u_ok<CULL>(det.x, u.x) || u_ok<CULL>(det.y, u.y) ||
                 u_ok<CULL>(det.z, u.z) || u_ok<CULL>(det.w, u.w));
    if (!__any_sync(0xffffffffu, need)) return;
  }
  if (!live) return;
  if (EARLY == 2) {
    on = add4(add4(mul4(o[0], ld4(g)), mul4(o[1], ld4(g + C))),
              mul4(o[2], ld4(g + 2 * C)));
  }
  const float4 tdet = sub4(ld4(g + 15 * C), on);
  float4 v = mul4(w[0], ld4(g + 12 * C));
  v = add4(v, mul4(w[1], ld4(g + 13 * C)));
  v = add4(v, mul4(w[2], ld4(g + 14 * C)));
  v = add4(v, mul4(d[0], ld4(g + 9 * C)));
  v = add4(v, mul4(d[1], ld4(g + 10 * C)));
  v = add4(v, mul4(d[2], ld4(g + 11 * C)));
  take<ANY_HIT, CULL>(geo, C, j0, det.x, u.x, v.x, tdet.x, tmax0, itri, imesh,
                      base, h);
  take<ANY_HIT, CULL>(geo, C, j0 + 1, det.y, u.y, v.y, tdet.y, tmax0, itri,
                      imesh, base, h);
  take<ANY_HIT, CULL>(geo, C, j0 + 2, det.z, u.z, v.z, tdet.z, tmax0, itri,
                      imesh, base, h);
  take<ANY_HIT, CULL>(geo, C, j0 + 3, det.w, u.w, v.w, tdet.w, tmax0, itri,
                      imesh, base, h);
}

// Lane j of the staged block, scalar rows.
template <bool ANY_HIT, int CULL>
__device__ __forceinline__ void test1(const float* geo, int C, int j,
                                      const float o[3], const float d[3],
                                      const float w[3], float tmax0, int itri,
                                      int imesh, int base, Best& h) {
  const float nx = geo[j], ny = geo[C + j], nz = geo[2 * C + j];
  const float det = d[0] * nx + d[1] * ny + d[2] * nz;
  const float udet = w[0] * geo[6 * C + j] + w[1] * geo[7 * C + j] +
                     w[2] * geo[8 * C + j] + d[0] * geo[3 * C + j] +
                     d[1] * geo[4 * C + j] + d[2] * geo[5 * C + j];
  const float vdet = w[0] * geo[12 * C + j] + w[1] * geo[13 * C + j] +
                     w[2] * geo[14 * C + j] + d[0] * geo[9 * C + j] +
                     d[1] * geo[10 * C + j] + d[2] * geo[11 * C + j];
  const float tdet = geo[15 * C + j] - (o[0] * nx + o[1] * ny + o[2] * nz);
  take<ANY_HIT, CULL>(geo, C, j, det, udet, vdet, tdet, tmax0, itri, imesh,
                      base, h);
}

// Lanes lo + first, lo + first + step, ... below hi of the staged block
// (in 4-lane groups when ``vec``: groups lo / 4 + first, ... below hi / 4;
// lo and hi multiples of 4), in ascending order.  EARLY: test4's early-out
// (every lane of the warp runs the same lanes).
template <bool ANY_HIT, int CULL, int EARLY>
__device__ __forceinline__ void test_lanes(const float* geo, int C, bool vec,
                                           int lo, int hi, int first,
                                           int step, const float o[3],
                                           const float d[3], float tmax0,
                                           int itri, int imesh, int base,
                                           Best& h) {
  const float w[3] = {d[1] * o[2] - d[2] * o[1], d[2] * o[0] - d[0] * o[2],
                      d[0] * o[1] - d[1] * o[0]};
  if (vec) {
#pragma unroll 1
    for (int q = lo / 4 + first; q < hi / 4; q += step) {
      test4<ANY_HIT, CULL, EARLY>(geo, C, 4 * q, o, d, w, tmax0, itri, imesh,
                                  base, h);
    }
  } else {
#pragma unroll 1
    for (int j = lo + first; j < hi; j += step) {
      test1<ANY_HIT, CULL>(geo, C, j, o, d, w, tmax0, itri, imesh, base, h);
    }
  }
}

constexpr int kSlotWords = 9;  // a spread ray: o, d, t bound, ignore ids

// Few unresolved rays (U of them, at most half the block): their tests of
// the staged block spread over the idle threads, G threads a ray (G a power
// of two, at most 32, within a warp), each on its share of the lanes; the
// group reduces (t, lane) lexicographically and the ray takes the result
// only if its t is strictly below its best: exactly what the ascending loop
// with ``dist < best`` computes.  Resolved rays are not tested (their tests
// change nothing: every later entry is at or beyond their best).  ``slots``
// holds blockDim.x / 2 rays of kSlotWords, ``red_i`` a word a warp.  Every
// thread calls it; three barriers.
template <bool ANY_HIT, int CULL>
__device__ void spread_tests(const float* geo, int C, bool vec, int U,
                             bool res, float* slots, int* red_i,
                             const float o[3], const float d[3], float tmax0,
                             int itri, int imesh, int base, Best& best) {
  const int nt = blockDim.x, tid = threadIdx.x;
  int G = 32;
  while (U * G > nt) G >>= 1;
  const unsigned bal = __ballot_sync(0xffffffffu, !res);
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) red_i[warp] = __popc(bal);
  __syncthreads();
  int slot = __popc(bal & ((1u << lane) - 1));
  for (int w = 0; w < warp; ++w) slot += red_i[w];
  if (!res) {
    float* sl = slots + slot * kSlotWords;
    sl[0] = o[0];
    sl[1] = o[1];
    sl[2] = o[2];
    sl[3] = d[0];
    sl[4] = d[1];
    sl[5] = d[2];
    sl[6] = tmax0;
    sl[7] = __int_as_float(itri);
    sl[8] = __int_as_float(imesh);
  }
  __syncthreads();
  const int s = tid / G, g = tid % G;
  Best lb{kInf, -1, 0.f, 0.f, 1.f, -1};
  float* sl = slots + s * kSlotWords;
  if (s < U) {
    const float so[3] = {sl[0], sl[1], sl[2]};
    const float sd[3] = {sl[3], sl[4], sl[5]};
    test_lanes<ANY_HIT, CULL, 0>(geo, C, vec, 0, C, g, G, so, sd, sl[6],
                                 __float_as_int(sl[7]),
                                 __float_as_int(sl[8]), 0, lb);
  }
  // The group's least (t, lane); any-hit: whether any lane hit.
  for (int off = G >> 1; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(0xffffffffu, lb.t, off);
    const int oc = __shfl_xor_sync(0xffffffffu, lb.code, off);
    if (ANY_HIT) {
      lb.code = lb.code > oc ? lb.code : oc;
    } else {
      const float ou = __shfl_xor_sync(0xffffffffu, lb.u, off);
      const float ov = __shfl_xor_sync(0xffffffffu, lb.v, off);
      const float odet = __shfl_xor_sync(0xffffffffu, lb.det, off);
      const int otri = __shfl_xor_sync(0xffffffffu, lb.tri, off);
      // Lanes that hit nothing carry code -1: rank them last.
      const unsigned mine = static_cast<unsigned>(lb.code);
      const unsigned theirs = static_cast<unsigned>(oc);
      if (ot < lb.t || (ot == lb.t && theirs < mine)) {
        lb = {ot, oc, ou, ov, odet, otri};
      }
    }
  }
  if (g == 0 && s < U) {
    sl[0] = lb.t;
    sl[1] = __int_as_float(lb.code);
    sl[2] = lb.u;
    sl[3] = lb.v;
    sl[4] = lb.det;
    sl[5] = __int_as_float(lb.tri);
  }
  __syncthreads();
  if (!res) {
    const float* mine = slots + slot * kSlotWords;
    const int code = __float_as_int(mine[1]);
    if (ANY_HIT) {
      if (code >= 0) best.code = 0;
    } else if (mine[0] < best.t) {
      best = {mine[0], base + code, mine[2], mine[3], mine[4],
              __float_as_int(mine[5])};
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
