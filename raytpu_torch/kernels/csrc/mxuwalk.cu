// The classic cluster walk with the matmul form of the pair test, on the
// tensor cores.
//
// mxu_walk_kernel<ANY_HIT, CULL, PRETEST> replaces
// raytpu/kernels/fused.py::_fused_kernel with ``mxu=True`` (fused.py:316-317,
// :335, :434-476, :503-532): the walk of walk.cu and subwalk.cu (the entry
// bounds, the block-wide pick, the slab pretest with PRETEST, the re-cull
// every ``recull_every`` trips, the trip budget ``max_trips``, ``chunk_k``
// picks a trip; all runtime), but each picked block's det-space values come
// from one product R @ G per block on the ``gblock`` bake
// (raytpu/accel/clusters.py:196-225): R is (rays, 16), each ray's row
// [d, w = d x o, o, 1, 0 x 6], and G the block's (16, 4C) coefficients, so
// that the product's four C-wide column blocks are det, u*det, v*det and
// t*det of every (ray, triangle) pair.  Only 19 of G's 64 rows across the
// four blocks are nonzero: det reads R's entries 0-2, u*det and v*det 0-5,
// t*det 6-9.  So each column block needs one k8 step of the product: the
// first three take R's entries 0-7 against G's rows 0-7, the fourth R's
// entries 6-13 against G's rows 6-13.
//
// The product runs as mma.sync.m16n8k8 in TF32 (10 explicit mantissa bits,
// float32 accumulation).  Both operands are rounded to TF32 by
// cvt.rna.tf32.f32 (to nearest, ties away from zero).  ``highest`` (runtime)
// is 3xTF32: each operand also gets its rounding error as a TF32 lo part,
// and a_hi b_lo + a_lo b_hi + a_hi b_hi are accumulated (the counterpart of
// the reference's 6-pass bf16 HIGHEST); otherwise one pass a_hi b_hi (the
// counterpart of its one bf16 pass).  Neither is the exact walk bit for bit,
// and the tensor core's float32 sums have no IEEE order, so the kernel
// agrees with its plain version (kernels/fused.py::mxu_values) up to the
// order of the sums: a pair whose det-space margin is within that rounding
// may be accepted by one and not the other.
//
// One thread block walks one tile, one ray per thread for the walk's
// state; the pair test is per warp:
//   - each warp holds the TF32 A fragments of its 32 rays' R rows (two
//     m16 tiles; the two k8 steps, entries 0-7 and 6-13; hi and lo parts)
//     in registers for the whole walk, gathered once by shuffles from the
//     rays' threads;
//   - a trip stages each picked block's 8 coefficient rows of each column
//     block (rounded to TF32 hi and, for ``highest``, lo parts; rows padded
//     by 8 floats so a warp's B-fragment loads hit 32 banks) and its id row
//     into shared memory;
//   - for each group of 8 triangles the warp issues, per m16 tile, one k8
//     product (three with ``highest``) of each column block, at columns j,
//     C + j, 2C + j and 3C + j.  The m16n8 accumulator layout is the same
//     for all four, so a
//     thread holds det, udet, vdet and tdet of the same 4 (ray, triangle)
//     pairs and applies the accept rules (walk_common.cuh) and, nearest,
//     the strict-min over its own triangles in lane order;
//   - at the block's end a quad shuffle reduces each ray's candidates (the
//     lower lane on an exact tie, as the exact walk's strict-min in lane
//     order keeps) and the ray's thread takes the winner if it is strictly
//     below its best.  The winner's (u, v) are udet/det and vdet/det of the
//     product, as the reference kernel extracts them in the walk.
// Triangle and mesh ids never pass through the tensor cores: they are read
// as int32 bits from row 16 (column block 0 the triangle, 1 the mesh).
// Zero padding columns give det = 0 and are rejected; a dead ray's NaN row
// of R makes only its own row NaN, never accepted, and it starts resolved,
// so no NaN reaches the trip's caps.
//
// What bounds it on an H100: per tested block and ray, the 19C nonzero
// multiply-adds of the product on the tensor cores (x3 for ``highest``; it
// issues 32C, k8 steps) at 495 TFLOP/s (TF32, dense), and C pairs'
// acceptance and min on the FP32 units; a staged block is 34C floats (68C
// with ``highest``), against the exact walk's 24C.  No wgmma, TMA or
// persistent blocks yet.

#include <cstdint>

#include "walk_common.cuh"

namespace {

constexpr int kGRows = 8;   // staged coefficient rows of a column block
constexpr int kTRow = 6;    // the first gblock row of t*det's k8 step
constexpr int kIdRow = 16;  // the gblock row of the triangle and mesh ids
constexpr int kGPad = 8;    // row padding of the staged coefficients
constexpr int kMaxChunk = 8;

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Floats of one staged block: the hi (and, highest, lo) coefficient rows
// and the 2C ids (kernels/fused.py::_smem_bytes).
__device__ __host__ inline int staged_floats(int C, int highest) {
  return kGRows * (4 * C + kGPad) * (highest ? 2 : 1) + 2 * C;
}

// The next K picks into gv/gk (kInf and INT_MAX past the end); every
// thread calls it; it ends in a barrier (subwalk.cu's pick_group at SUBK 1).
__device__ void pick_group(const WalkArgs& a, float* ent, float* gv, int* gk,
                           float* red_f, int* red_i) {
  bool drained = false;
  for (int j = 0; j < a.chunk_k; ++j) {
    Pick p{kInf, INT_MAX};
    if (!drained) {
      p = pick_next(ent, a.ncg, red_f, red_i);
      __syncthreads();  // thread 0's consumed mark before the next scan
    }
    drained = !(p.v < kInf);
    if (threadIdx.x == 0) {
      gv[j] = p.v;
      gk[j] = p.k;
    }
  }
  __syncthreads();
}

// A warp's candidate of one ray from one block: the least accepted
// distance (lowest lane on ties) and its det-space values.
struct Cand {
  float t, u, v, det;
  int lane, tri;
};

__device__ __forceinline__ void take_lower(Cand& c, const Cand& o) {
  if (o.t < c.t || (o.t == c.t && o.lane < c.lane)) c = o;
}

__device__ __forceinline__ Cand shfl_cand(const Cand& c, int src, bool xr) {
  const unsigned full = 0xffffffffu;
  Cand o;
  o.t = xr ? __shfl_xor_sync(full, c.t, src) : __shfl_sync(full, c.t, src);
  o.u = xr ? __shfl_xor_sync(full, c.u, src) : __shfl_sync(full, c.u, src);
  o.v = xr ? __shfl_xor_sync(full, c.v, src) : __shfl_sync(full, c.v, src);
  o.det = xr ? __shfl_xor_sync(full, c.det, src)
             : __shfl_sync(full, c.det, src);
  o.lane = xr ? __shfl_xor_sync(full, c.lane, src)
              : __shfl_sync(full, c.lane, src);
  o.tri = xr ? __shfl_xor_sync(full, c.tri, src)
             : __shfl_sync(full, c.tri, src);
  return o;
}

template <bool ANY_HIT, int CULL, bool PRETEST>
__global__ void mxu_walk_kernel(WalkArgs a) {
  extern __shared__ float smem[];
  const int C = a.csize, K = a.chunk_k, highest = a.highest;
  const int LD = 4 * C + kGPad;
  const int per_pick = staged_floats(C, highest);
  float* ent = smem;                         // (ncg,) entry bounds
  float* geo = ent + a.ncg;                  // (K, per_pick) staged blocks
  float* gv = geo + K * per_pick;            // (K,) the group's entries
  int* gk = reinterpret_cast<int*>(gv + K);  // (K,) the group's blocks
  __shared__ float red_f[32];
  __shared__ int red_i[32];

  const int tid = threadIdx.x;
  const bool active = tid < a.ts;
  const size_t r = static_cast<size_t>(blockIdx.x) * a.ts + tid;
  const Ray ray = load_ray(a, r, active);
  const float tmax0 = ray.tmax0;
  bool res = !ray.finite || !(tmax0 > 0.f);
  if (a.plane) {
    fill_entries<true>(a, ray, res, ent, red_f);
  } else {
    fill_entries<false>(a, ray, res, ent, red_f);
  }

  Best best{tmax0, -1, 0.f, 0.f, 1.f, -1};
  const float* o = ray.o;
  const float* d = ray.d;
  const float w[3] = {d[1] * o[2] - d[2] * o[1], d[2] * o[0] - d[0] * o[2],
                      d[0] * o[1] - d[1] * o[0]};

  // The warp's A fragments: rows are its 32 rays (m16 tiles mt = 0, 1),
  // columns 8 entries of R (k-steps ks = 0: entries 0-7, for det, u*det
  // and v*det; ks = 1: entries 6-13, for t*det).  Lane l holds rows g =
  // l / 4 and g + 8 of each tile, columns tig = l % 4 and tig + 4.
  const unsigned full = 0xffffffffu;
  const int lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const float rk[10] = {d[0], d[1], d[2], w[0], w[1], w[2],
                        o[0], o[1], o[2], 1.f};
  uint32_t ahi[2][2][4], alo[2][2][4];
  // Per slot s = 0..3, the ray g + 8s of the warp: its ignore ids and t
  // bound.
  int s_itri[4], s_imesh[4];
  float s_tmax[4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    float av[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int src = 16 * mt + 8 * half + g;
#pragma unroll
      for (int kk = 0; kk < 10; ++kk) {
        const float v = __shfl_sync(full, rk[kk], src);
        if (kk == tig) av[0][half] = v;
        if (kk == tig + 4) av[0][2 + half] = v;
        if (kk == tig + kTRow) av[1][half] = v;  // entries 10-13 are 0
      }
      const int s = 2 * mt + half;
      s_itri[s] = __shfl_sync(full, ray.itri, src);
      s_imesh[s] = __shfl_sync(full, ray.imesh, src);
      s_tmax[s] = __shfl_sync(full, tmax0, src);
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t h = tf32_bits(av[ks][i]);
        ahi[mt][ks][i] = h;
        alo[mt][ks][i] = tf32_bits(av[ks][i] - __uint_as_float(h));
      }
    }
  }

  // Slab reciprocals of the pretest (fused.py:543-544).
  float inv_d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    inv_d[k] = PRETEST ? 1.0f / (d[k] == 0.f ? kTinyDir : d[k]) : 0.f;
  }
  const float margin = a.root[6];
  int trips = 0, tests = 0, ray_tests = 0;

  pick_group(a, ent, gv, gk, red_f, red_i);
  // No feasible block: nothing to hit, every ray is proven.
  if (!(gv[0] < kInf)) res = true;
  while (gv[0] < kInf) {
    ++trips;
    const int unres = __syncthreads_count(!res);
    const float cap_r = res ? -kInf : min_nan(best.t, tmax0);
    // Which picks are tested: bit j, the same in every thread.
    unsigned run = 0;
    for (int j = 0; j < K && gv[j] < kInf; ++j) {
      if (PRETEST) {
        const int k = gk[j];
        float s_en = -kInf, s_ex = kInf;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float mn = a.aabb[c * a.ncg + k] - margin;
          const float mx = a.aabb[(3 + c) * a.ncg + k] + margin;
          const float t1 = (mn - o[c]) * inv_d[c];
          const float t2 = (mx - o[c]) * inv_d[c];
          s_en = max_nan(s_en, min_nan(t1, t2));
          s_ex = min_nan(s_ex, max_nan(t1, t2));
        }
        if (!__syncthreads_or(s_en <= s_ex && s_ex >= 0.f && s_en < cap_r)) {
          continue;
        }
      }
      run |= 1u << j;
    }
    // Stage the tested blocks: TF32 hi (and lo) coefficients, rows 0-7 of
    // the first three column blocks and rows 6-13 of the fourth; ids.
    for (int j = 0; j < K; ++j) {
      if (!((run >> j) & 1u)) continue;
      ++tests;
      const float* src = a.block + static_cast<size_t>(gk[j]) * kBlockRows *
                                       4 * C;
      float* hi = geo + j * per_pick;
      float* lo = hi + kGRows * LD;
      int* ids = reinterpret_cast<int*>(hi + kGRows * LD * (highest ? 2 : 1));
      for (int e = tid; e < kGRows * 4 * C; e += blockDim.x) {
        const int row = e / (4 * C), c = e - row * 4 * C;
        const float x = src[(c < 3 * C ? row : row + kTRow) * 4 * C + c];
        const uint32_t h = tf32_bits(x);
        hi[row * LD + c] = __uint_as_float(h);
        if (highest) lo[row * LD + c] = __uint_as_float(
            tf32_bits(x - __uint_as_float(h)));
      }
      for (int e = tid; e < 2 * C; e += blockDim.x) {
        ids[e] = __float_as_int(src[kIdRow * 4 * C + e]);
      }
    }
    __syncthreads();
    for (int j = 0; j < K; ++j) {
      if (!((run >> j) & 1u)) continue;
      ray_tests += unres;
      const float* hi = geo + j * per_pick;
      const float* lo = hi + kGRows * LD;
      const int* ids =
          reinterpret_cast<const int*>(hi + kGRows * LD * (highest ? 2 : 1));
      Cand cand[4];
      bool found[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        cand[s] = {kInf, 0.f, 0.f, 1.f, INT_MAX, -1};
        found[s] = false;
      }
      for (int j8 = 0; j8 < C; j8 += 8) {
        // B fragments of the four column blocks: staged rows tig (+4),
        // column q*C + j8 + g.
        uint32_t bhi[4][2], blo[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = (tig + 4 * i) * LD + q * C + j8 + g;
            bhi[q][i] = __float_as_uint(hi[e]);
            blo[q][i] = highest ? __float_as_uint(lo[e]) : 0u;
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float acc[4][4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int ks = q == 3 ? 1 : 0;
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[q][i] = 0.f;
            if (highest) {
              mma_tf32(acc[q], ahi[mt][ks], blo[q][0], blo[q][1]);
              mma_tf32(acc[q], alo[mt][ks], bhi[q][0], bhi[q][1]);
            }
            mma_tf32(acc[q], ahi[mt][ks], bhi[q][0], bhi[q][1]);
          }
          // Accumulator i: ray g (+8 for i >= 2) of tile mt, triangle
          // j8 + 2 tig + (i & 1).
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int s = 2 * mt + (i >> 1);
            const int jl = j8 + 2 * tig + (i & 1);
            const float det = acc[0][i], udet = acc[1][i];
            const float vdet = acc[2][i], tdet = acc[3][i];
            const int tri_id = ids[jl];
            const bool keep = tri_id != s_itri[s] && ids[C + jl] != s_imesh[s];
            if (ANY_HIT) {
              if (keep &&
                  accept_within<CULL>(det, udet, vdet, tdet, s_tmax[s])) {
                found[s] = true;
              }
            } else {
              const float dist =
                  (keep && accept<CULL>(det, udet, vdet, tdet)) ? tdet / det
                                                                : kInf;
              if (dist < cand[s].t) cand[s] = {dist, udet, vdet, det, jl, tri_id};
            }
          }
        }
      }
      // Reduce each slot over the quad (the lanes holding the same rays),
      // then hand each ray its block winner from lane 4 * (ray % 8).
      const int own = lane >> 3, from = 4 * (lane & 7);
      if (ANY_HIT) {
        bool hit = false;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          int f = found[s] ? 1 : 0;
          f |= __shfl_xor_sync(full, f, 1);
          f |= __shfl_xor_sync(full, f, 2);
          const int got = __shfl_sync(full, f, from);
          if (s == own) hit = got != 0;
        }
        if (hit) best.code = 0;
      } else {
        Cand mine = {kInf, 0.f, 0.f, 1.f, INT_MAX, -1};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          Cand c = cand[s];
          take_lower(c, shfl_cand(c, 1, true));
          take_lower(c, shfl_cand(c, 2, true));
          const Cand got = shfl_cand(c, from, false);
          if (s == own) mine = got;
        }
        if (mine.t < best.t) {
          best.t = mine.t;
          best.code = gk[j] * C + mine.lane;
          best.u = mine.u;
          best.v = mine.v;
          best.det = mine.det;
          best.tri = mine.tri;
        }
      }
    }
    __syncthreads();  // the staged blocks and picks are read: refill them
    pick_group(a, ent, gv, gk, red_f, red_i);
    const float nv = gv[0];
    res = res || (ANY_HIT ? (best.code >= 0 || tmax0 <= nv) : (best.t <= nv));
    if (__syncthreads_and(res)) break;
    // The trip budget (fused.py:690-697).
    if (a.max_trips > 0 && trips >= a.max_trips) break;
    if (a.recull_every > 0 && trips % a.recull_every == 0 && nv < kInf) {
      // Re-cull from the unresolved rays' beam (fused.py:668-681).
      const float wcap =
          block_reduce(res ? -kInf : min_nan(best.t, tmax0), MaxNanOp(), red_f);
      const Beam b = make_beam(o, d, ray.finite && !res, wcap, red_f);
      for (int j = tid; j < a.ncg; j += blockDim.x) {
        if (ent[j] != consumed()) ent[j] = entry_of(a.aabb, a.plane, a.ncg, j, b);
      }
      __syncthreads();
    }
  }
  write_out<ANY_HIT>(a, r, active, best, res, trips, tests, ray_tests);
}

// Dynamic shared memory of a block: the entry table, K staged blocks, the
// group's entries and ids (kernels/fused.py::_smem_bytes).
size_t mxu_smem_bytes(const WalkArgs& a) {
  const size_t k = a.chunk_k;
  return sizeof(float) * (a.ncg + k * staged_floats(a.csize, a.highest)) +
         8 * k;
}

template <bool ANY_HIT, bool PRETEST>
cudaError_t dispatch_cull(const WalkArgs& a, int n_rays, int cull,
                          cudaStream_t stream) {
  const size_t smem = mxu_smem_bytes(a);
  switch (cull) {
    case 0: return launch(mxu_walk_kernel<ANY_HIT, 0, PRETEST>, a, n_rays, smem, stream);
    case 1: return launch(mxu_walk_kernel<ANY_HIT, 1, PRETEST>, a, n_rays, smem, stream);
    case 2: return launch(mxu_walk_kernel<ANY_HIT, 2, PRETEST>, a, n_rays, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool ANY_HIT>
cudaError_t dispatch(const WalkArgs& a, int n_rays, int cull, int pretest,
                     cudaStream_t stream) {
  if (a.chunk_k < 1 || a.chunk_k > kMaxChunk || a.max_trips < 0 ||
      a.recull_every < 0 || a.csize % 8) {
    return cudaErrorInvalidValue;
  }
  return pretest ? dispatch_cull<ANY_HIT, true>(a, n_rays, cull, stream)
                 : dispatch_cull<ANY_HIT, false>(a, n_rays, cull, stream);
}

WalkArgs mxu_args(const float* origin, const float* direction,
                  const float* tmax, const int* ignore_tri,
                  const int* ignore_mesh, int ts, const float* root,
                  const float* aabb, const float* plane, const float* gblock,
                  int ncg, int csize, int recull_every, int max_trips,
                  int chunk_k, int highest) {
  WalkArgs a = walk_args(origin, direction, tmax, ignore_tri, ignore_mesh,
                         ts, root, aabb, gblock, ncg, csize);
  a.plane = plane;
  a.recull_every = recull_every;
  a.max_trips = max_trips;
  a.chunk_k = chunk_k;
  a.highest = highest;
  return a;
}

}  // namespace

extern "C" int rt_mxu_nearest(
    const float* origin, const float* direction, const float* tmax,
    const int* ignore_tri, const int* ignore_mesh, int n_rays, int ts,
    const float* root, const float* aabb, const float* plane,
    const float* gblock, int ncg, int csize, const float* tri_shade,
    int cull, int pretest, int recull_every, int max_trips, int chunk_k,
    int highest, float* out_t, int* out_code, float* out_u, float* out_v,
    int* out_tri, float* out_rows, int* out_res, int* out_iters,
    int* out_tests, int* out_ray_tests, void* stream) {
  WalkArgs a = mxu_args(origin, direction, tmax, ignore_tri, ignore_mesh, ts,
                        root, aabb, plane, gblock, ncg, csize, recull_every,
                        max_trips, chunk_k, highest);
  a.tri_shade = tri_shade;
  set_outputs(a, out_t, out_code, out_res, out_iters, out_tests,
              out_ray_tests);
  a.out_u = out_u;
  a.out_v = out_v;
  a.out_tri = out_tri;
  a.out_rows = out_rows;
  return static_cast<int>(dispatch<false>(
      a, n_rays, cull, pretest, static_cast<cudaStream_t>(stream)));
}

extern "C" int rt_mxu_any_hit(
    const float* origin, const float* direction, const float* tmax,
    const int* ignore_tri, const int* ignore_mesh, int n_rays, int ts,
    const float* root, const float* aabb, const float* plane,
    const float* gblock, int ncg, int csize, int cull, int pretest,
    int recull_every, int max_trips, int chunk_k, int highest, float* out_t,
    int* out_code, int* out_res, int* out_iters, int* out_tests,
    int* out_ray_tests, void* stream) {
  WalkArgs a = mxu_args(origin, direction, tmax, ignore_tri, ignore_mesh, ts,
                        root, aabb, plane, gblock, ncg, csize, recull_every,
                        max_trips, chunk_k, highest);
  set_outputs(a, out_t, out_code, out_res, out_iters, out_tests,
              out_ray_tests);
  return static_cast<int>(dispatch<true>(
      a, n_rays, cull, pretest, static_cast<cudaStream_t>(stream)));
}
