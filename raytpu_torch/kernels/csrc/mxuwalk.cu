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
// float32 accumulation).  Both operands are rounded to TF32 to nearest, ties
// away from zero (cvt.rna.tf32.f32).  ``highest`` (runtime) is 3xTF32: each
// operand also gets its rounding error as a TF32 lo part, and a_hi b_lo +
// a_lo b_hi + a_hi b_hi are accumulated (the counterpart of the reference's
// 6-pass bf16 HIGHEST); otherwise one pass a_hi b_hi (the counterpart of its
// one bf16 pass).  Neither is the exact walk bit for bit, and the tensor
// core's float32 sums have no IEEE order, so the kernel agrees with its
// plain version (kernels/fused.py::mxu_values) up to the order of the sums:
// a pair whose det-space margin is within that rounding may be accepted by
// one and not the other.
//
// G's side comes from ``gsplit`` (kernels/fused.py::mxu_table), derived once
// per bake: per block the triangle and mesh ids, then G's nonzero rows
// rounded to TF32 hi and lo parts, each in the order of the m16n8k8 B
// fragments: per group of 8 triangles, per lane, (det, t*det) of the first
// k half, then u*det's and v*det's two k halves, a float2 each.  A block is
// staged with one contiguous asynchronous copy (the ids and hi parts alone
// for one pass).
//
// One thread block walks one tile, one ray per thread for the walk's state:
//   1. prologue: each ray's R row (d, w, o) and its ignore ids and t bound
//      into shared memory; the entry bounds of the tile's beam (slab
//      interval intersected with the block's fitted plane, as the classic
//      walk), a group of 32 blocks whose box the beam cannot reach without a
//      look at its blocks (cull_entries);
//   2. a trip takes the next K picks, each the least entry left (lowest id
//      on equal entries), and tests the tile's rays against the picks that
//      pass the pretest (which asks the rays unresolved at the trip's
//      start), in pick order; the rays then settle against the next
//      group's first pick.  As in the reference, a resolved ray takes part
//      too: in exact arithmetic it can take nothing more (every later entry
//      is at or beyond its best), but the rounded product can put a later
//      block's hit below its best, and then it takes it.
//
// What bounds it on an H100, and what the design does about it.  Measured
// per trip with clock64 stamps (walk_split.py --kernel mxu, PERF.md) before
// this design, on the bench frame: the tests took 48-54% of the blocks'
// clocks, the synchronous staging with the TF32 rounding 21-23%, the
// prologue 15-18% and the pick scans 8-9%; the kernel held 124-187
// registers a thread, one block an SM, and its products waited on ~33
// clocks a product, behind the acceptance of every pair on the CUDA cores.
// So:
//   - Rows for the rays that can still take a candidate: at a trip's start
//     the rays that are not dead (any-hit: without a hit yet), resolved or
//     not, are listed in order, and the product's rows are those slots, 16
//     to an m16 tile.  The tiles times the 8-triangle columns of the trip's
//     tested picks are cut into one contiguous run of units a warp, so the
//     warps share the work evenly and a warp passes through at most 4
//     tiles; the A fragments of a tile are built from the listed rays' rows
//     in shared memory.  Listing the resolved rays last, their tiles voting
//     on det and t*det first (t below the row's cap), cost more than it
//     saved (PERF.md).
//   - No wgmma, and no skip of an 8-triangle group whose box a tile's
//     rays miss: one more product a column block moved the kernel by under
//     1%, the acceptance computed twice by 8-15% (PERF.md), and the box
//     test cost more than the products it skipped (and with one pass
//     skipped pairs whose rounded product accepts them).
//   - The acceptance first: any-hit queries take the products of v*det and
//     t*det only where a pair of the warp passes the signs of det and u*det
//     (shadow rays: ~12% faster; nearest queries ~9% slower, so they take
//     all four at once); a lane tests its 4 pairs' signs (accept<CULL>)
//     and, where a pair of the warp passes, reads ids, divides and compares
//     only for the pairs that pass; a pair enters the lane's candidate only
//     if its t is strictly below the ray's best at the trip's start.  Each
//     lane keeps its 2 rows' least (t, item) in registers over its columns
//     (item = pick * C + lane of the block: pick order, then lane order),
//     the quad reduces them when the warp leaves the tile, and lane 0 of
//     each quad writes one record a row; after one barrier each ray reduces
//     the records of the warps that covered its tile by (t, item) and takes
//     the least if it is strictly below its best: exactly the pick-order
//     loop with ``dist < best``.  The winner's (u, v) are udet/det and
//     vdet/det of the product, as the reference kernel extracts them in
//     the walk.
//   - Pick ahead, copy asynchronously: picks come from each thread's least
//     entry (two REDUX warp reductions and a barrier a pick, walk_common.cuh
//     block_lexmin and consume); the next group is picked at the trip's
//     start and its G rows go into a second buffer with cp.async while this
//     group is tested.  The TF32 rounding is the bake's, not each trip's.
//   - At most 128 registers a thread (__launch_bounds__): two blocks of 256
//     threads an SM.
// Triangle and mesh ids never pass through the tensor cores: they are read
// as int32 bits.  Zero padding columns give det = 0 and are rejected; dead
// rays (non-finite, t bound not above 0) start resolved, can accept no pair
// and are never listed.  Rows of a tile beyond the listed rays are zero
// (det = 0) and not read.
//
// What the function needs on an H100: per tested block and listed ray,
// the 19C nonzero multiply-adds of the product on the tensor cores (x3 for
// ``highest``; it issues 32C, k8 steps) at 495 TFLOP/s (TF32, dense), and C
// pairs' acceptance on the FP32 units; a staged block is 26C floats (50C
// with ``highest``), against the exact walk's 18C.

#include <cstdint>

#include "walk_common.cuh"

namespace {

constexpr int kMaxChunk = 8;
constexpr int kRayWords = 12;  // a ray's R entries 0-8, t bound, ignore ids
constexpr int kCandWords = 6;  // a record: t, item, u*det, v*det, det, tri
// Records a thread: a warp writes 16 a tile it passes through, at most 4.
constexpr int kCandRecs = 2;

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

// One pass of q's product into c: with ``highest`` a_hi b_lo + a_lo b_hi
// first, then a_hi b_hi.
__device__ __forceinline__ void product(float c[4], const uint32_t ahi[4],
                                        const uint32_t alo[4], float2 bhi,
                                        float2 blo, bool bsecond,
                                        int highest) {
  const uint32_t h0 = __float_as_uint(bhi.x);
  const uint32_t h1 = bsecond ? __float_as_uint(bhi.y) : 0u;
  if (highest) {
    mma_tf32(c, ahi, __float_as_uint(blo.x),
             bsecond ? __float_as_uint(blo.y) : 0u);
    mma_tf32(c, alo, h0, h1);
  }
  mma_tf32(c, ahi, h0, h1);
}

// Floats of one block in ``gsplit``: 2C ids, 24C hi and 24C lo parts; one
// pass stages the first 26C.
__device__ __host__ inline int split_floats(int C) { return 50 * C; }
__device__ __host__ inline int staged_floats(int C, int highest) {
  return (highest ? 50 : 26) * C;
}

// A lane's candidate for one row: the least accepted t below the ray's
// best, the first item on equal t, and its det-space values.
struct Cand {
  float t, u, v, det;
  int item, tri;
};

__device__ __forceinline__ bool lower(const Cand& o, const Cand& c) {
  return o.t < c.t || (o.t == c.t && o.item < c.item);
}

__device__ __forceinline__ Cand shfl_xor_cand(const Cand& c, int m) {
  const unsigned full = 0xffffffffu;
  return {__shfl_xor_sync(full, c.t, m), __shfl_xor_sync(full, c.u, m),
          __shfl_xor_sync(full, c.v, m), __shfl_xor_sync(full, c.det, m),
          __shfl_xor_sync(full, c.item, m), __shfl_xor_sync(full, c.tri, m)};
}

template <bool ANY_HIT, int CULL, bool PRETEST>
__global__ void __launch_bounds__(256, 2) mxu_walk_kernel(WalkArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int C = a.csize, K = a.chunk_k, highest = a.highest;
  const int nt = blockDim.x, nw = nt >> 5;
  const int per_pick = staged_floats(C, highest);
  float* ent = smem;                               // (ncg,) entry bounds
  float* stage = smem + (a.ncg + 3) / 4 * 4;       // 2 x (K, per_pick)
  float* rays = stage + 2 * K * per_pick;          // (nt, 12) ray rows
  float* cand = rays + nt * kRayWords;             // (2 nt, 6) records
  float* bt = cand + nt * kCandRecs * kCandWords;  // (nt,) bests at start
  int* list = reinterpret_cast<int*>(bt + nt);     // (nt,) slot -> ray
  float* gv = reinterpret_cast<float*>(list + nt);  // 2 x K: the groups'
  int* gk = reinterpret_cast<int*>(gv + 2 * K);     // entries and blocks
  __shared__ float red_f[13 * 32];
  __shared__ int red_c[32];         // the warps' listed rays
  __shared__ float pick_f[2 * 32];  // the picks' two scratch buffers
  __shared__ int pick_i[2 * 32];
  __shared__ Beam beam;
  unsigned parity = 0;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool active = tid < a.ts;
  const size_t r = static_cast<size_t>(blockIdx.x) * a.ts + tid;
  const Ray ray = load_ray(a, r, active);
  const float tmax0 = ray.tmax0;
  // Rays that cannot hit (non-finite, or t bound not above 0, NaN
  // included) start resolved.
  const bool alive = ray.finite && tmax0 > 0.f;
  bool res = !alive;
  const float* o = ray.o;
  const float* d = ray.d;
  {
    float* row = rays + tid * kRayWords;
    row[0] = d[0];
    row[1] = d[1];
    row[2] = d[2];
    row[3] = d[1] * o[2] - d[2] * o[1];
    row[4] = d[2] * o[0] - d[0] * o[2];
    row[5] = d[0] * o[1] - d[1] * o[0];
    row[6] = o[0];
    row[7] = o[1];
    row[8] = o[2];
    row[9] = tmax0;
    row[10] = __int_as_float(ray.itri);
    row[11] = __int_as_float(ray.imesh);
  }
  // The entry bounds of the tile's beam over its finite rays, pruned at the
  // largest bound of the unresolved rays, and each thread's least one.
  beam_to_smem(o, d, ray.finite, res ? -kInf : tmax0, beam,
               reinterpret_cast<unsigned*>(red_f));
  float cv;
  int ck;
  {
    const Beam bm = beam;
    cull_entries(
        a, bm, ent,
        [&](int j) { return entry_of(a.aabb, a.plane, a.ncg, j, bm); },
        [](int) {}, cv, ck);
  }

  Best best{tmax0, -1, 0.f, 0.f, 1.f, -1};
  // Slab reciprocals of the pretest (fused.py:543-544).
  float inv_d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    inv_d[k] = PRETEST ? 1.0f / (d[k] == 0.f ? kTinyDir : d[k]) : 0.f;
  }
  const float margin = a.root[6];
  const bool vstage = (reinterpret_cast<uintptr_t>(a.block) & 15) == 0;
  int trips = 0, tests = 0, ray_tests = 0;

  // The next group into buffer nb: K picks (kInf and INT_MAX past the end),
  // each consumed and its staged floats copied as soon as it is taken; one
  // copy group a call.  Returns the first pick's entry; a barrier a pick.
  auto pick_group = [&](int nb) {
    float first = kInf;
    bool drained = false;
    for (int j = 0; j < K; ++j) {
      Pick p{kInf, INT_MAX};
      if (!drained) {
        p = block_lexmin(cv, ck, pick_f + 32 * parity, pick_i + 32 * parity);
        parity ^= 1u;
        drained = !(p.v < kInf);
        if (!drained) {
          consume(ent, a.ncg, p.k, cv, ck);
          float* dst = stage + (nb * K + j) * per_pick;
          const float* src =
              a.block + static_cast<size_t>(p.k) * split_floats(C);
          if (vstage) {
            for (int e = tid; e < per_pick / 4; e += nt) {
              cp_async16(dst + 4 * e, src + 4 * e);
            }
          } else {
            for (int e = tid; e < per_pick; e += nt) {
              cp_async4(dst + e, src + e);
            }
          }
        }
      }
      if (j == 0) first = p.v;
      if (tid == 0) {
        gv[nb * K + j] = p.v;
        gk[nb * K + j] = p.k;
      }
    }
    cp_async_commit();
    return first;
  };
  // Whether the ray takes part in the tests: every ray that is not dead,
  // resolved or not, but for any-hit queries only until its first hit.
  auto listed_ray = [&]() { return alive && (!ANY_HIT || best.code < 0); };
  // What a trip starts with, settled before the barrier that ends the trip
  // before it: this thread's copies of the group have landed (the barrier
  // shows every thread's), its best at the start, each warp's listed rays
  // and the tile's unresolved rays.
  auto ready = [&]() {
    cp_async_wait<0>();
    bt[tid] = best.t;
    const unsigned bal = __ballot_sync(0xffffffffu, listed_ray());
    if (lane == 0) red_c[warp] = __popc(bal);
    return __syncthreads_count(!res);
  };
  // The list of the rays tested this trip, in thread order; published by
  // the next pick's barrier.  Returns this ray's slot (-1: not listed) and
  // sets ``listed``, their number.
  int listed = 0;
  auto list_rays = [&]() {
    const bool l = listed_ray();
    const unsigned bal = __ballot_sync(0xffffffffu, l);
    int slot = __popc(bal & ((1u << lane) - 1));
    listed = 0;
    for (int w = 0; w < nw; ++w) {
      if (w < warp) slot += red_c[w];
      listed += red_c[w];
    }
    if (!l) return -1;
    list[slot] = tid;
    return slot;
  };

  int b = 0;  // the buffer of the group under test
  float cur = pick_group(0);
  // No feasible block: nothing to hit, every ray is proven.
  if (!(cur < kInf)) res = true;
  int unres = ready();
  int slot = list_rays();
  const int g = lane >> 2, tig = lane & 3;
  while (cur < kInf) {
    ++trips;
    // Pick ahead: the next group, its floats copied while this one is
    // tested.
    const int nb = b ^ 1;
    const float nv = pick_group(nb);
    const float* g_v = gv + b * K;
    const int* g_k = gk + b * K;
    const float cap_r = res ? -kInf : min_nan(best.t, tmax0);
    // Which picks are tested: bit j, the same in every thread.
    unsigned run = 0;
    for (int j = 0; j < K && g_v[j] < kInf; ++j) {
      // Can any ray reach the block's box before its cap?
      if (PRETEST && !__syncthreads_or(reaches(a.aabb + g_k[j], margin, o,
                                                inv_d, cap_r, a.ncg))) {
        continue;
      }
      run |= 1u << j;
    }
    const int J = __popc(run);
    tests += J;
    ray_tests += unres * J;
    if (J > 0) {
      // T m16 tiles of listed rays times the tested picks' 8-triangle
      // columns: units u = tile * cols + column, a contiguous run of P
      // units a warp, so a warp passes through at most RM tiles.
      const int T = (listed + 15) >> 4;
      const int ng = C >> 3, cols = J * ng, total = T * cols;
      const int P = (total + nw - 1) / nw;
      const int RM = (P + cols - 1) / cols + 1;
      const int u1 = min(total, (warp + 1) * P);
      const int mt0 = warp * P / cols;
      for (int u = warp * P; u < u1;) {
        const int mt = u / cols, c1 = min(cols, u1 - mt * cols);
        // Rows g and g + 8 of the tile: slots s0 and s1.
        const int s0 = 16 * mt + g, s1 = s0 + 8;
        const bool v0 = s0 < listed, v1 = s1 < listed;
        const float* r0 = rays + (v0 ? list[s0] : 0) * kRayWords;
        const float* r1 = rays + (v1 ? list[s1] : 0) * kRayWords;
        // A fragments: k step 0 takes R's entries 0-7 (columns tig and tig
        // + 4), step 1 entries 6-13 (6 + tig; 10-13 are 0; entry 9 is 1).
        float av[2][4];
        av[0][0] = v0 ? r0[tig] : 0.f;
        av[0][1] = v1 ? r1[tig] : 0.f;
        av[0][2] = v0 ? r0[tig + 4] : 0.f;
        av[0][3] = v1 ? r1[tig + 4] : 0.f;
        av[1][0] = v0 ? (tig == 3 ? 1.f : r0[6 + tig]) : 0.f;
        av[1][1] = v1 ? (tig == 3 ? 1.f : r1[6 + tig]) : 0.f;
        av[1][2] = 0.f;
        av[1][3] = 0.f;
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t h = tf32_bits(av[ks][i]);
            ahi[ks][i] = h;
            alo[ks][i] = tf32_bits(av[ks][i] - __uint_as_float(h));
          }
        }
        // The rows' ignore ids and caps: the t bound (any-hit) or the best
        // at the trip's start (nearest; -inf for a row beyond the list, so
        // nothing enters its candidate).
        int itri[2], imesh[2];
        float capr[2];
        itri[0] = __float_as_int(r0[10]);
        itri[1] = __float_as_int(r1[10]);
        imesh[0] = __float_as_int(r0[11]);
        imesh[1] = __float_as_int(r1[11]);
        capr[0] = v0 ? (ANY_HIT ? r0[9] : bt[list[s0]]) : -kInf;
        capr[1] = v1 ? (ANY_HIT ? r1[9] : bt[list[s1]]) : -kInf;
        Cand cd[2];
        bool found[2] = {false, false};
#pragma unroll
        for (int h = 0; h < 2; ++h) cd[h] = {kInf, 0.f, 0.f, 1.f, INT_MAX, -1};
        // The first column's pick j (the jj-th tested one) and group.
        int col = u - mt * cols, jj = col / ng, grp = col - jj * ng;
        unsigned bits = run;
        for (; jj > 0; --jj) bits &= bits - 1;
        for (; col < c1; ++col) {
          const int j = __ffs(bits) - 1, gr = grp;
          if (++grp == ng) {
            grp = 0;
            bits &= bits - 1;
          }
          const float* buf = stage + (b * K + j) * per_pick;
          const float2* hi = reinterpret_cast<const float2*>(buf + 2 * C) +
                             gr * 96 + lane;
          const float2* lo = reinterpret_cast<const float2*>(buf + 26 * C) +
                             gr * 96 + lane;
          const float2 z = make_float2(0.f, 0.f);
          const float2 h0 = hi[0], h1 = hi[32], h2 = hi[64];
          const float2 l0 = highest ? lo[0] : z, l1 = highest ? lo[32] : z,
                       l2 = highest ? lo[64] : z;
          float cdet[4] = {0.f, 0.f, 0.f, 0.f}, cu[4] = {0.f, 0.f, 0.f, 0.f};
          float cvv[4] = {0.f, 0.f, 0.f, 0.f}, ct[4] = {0.f, 0.f, 0.f, 0.f};
          product(cdet, ahi[0], alo[0], h0, l0, false, highest);
          product(cu, ahi[0], alo[0], h1, l1, true, highest);
          // Any-hit: the rest only where a pair of the warp can pass the
          // sign tests of det and u*det (walk_common.cuh test4's early-out).
          if (ANY_HIT &&
              !__any_sync(0xffffffffu, u_ok<CULL>(cdet[0], cu[0]) ||
                                           u_ok<CULL>(cdet[1], cu[1]) ||
                                           u_ok<CULL>(cdet[2], cu[2]) ||
                                           u_ok<CULL>(cdet[3], cu[3]))) {
            continue;
          }
          product(cvv, ahi[0], alo[0], h2, l2, true, highest);
          product(ct, ahi[1], alo[1],
                  make_float2(h0.y, 0.f), make_float2(l0.y, 0.f), false,
                  highest);
          // Accumulator i: row g (+8 for i >= 2), triangle 2 tig + (i & 1)
          // of the group.  The signs first, the rest only where a pair of
          // the warp passes them.
          bool ok[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ok[i] = ANY_HIT ? accept_within<CULL>(cdet[i], cu[i], cvv[i],
                                                  ct[i], capr[i >> 1])
                            : accept<CULL>(cdet[i], cu[i], cvv[i], ct[i]);
          }
          if (__any_sync(0xffffffffu, ok[0] || ok[1] || ok[2] || ok[3])) {
            const int* ids = reinterpret_cast<const int*>(buf);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (!ok[i]) continue;
              const int h = i >> 1;
              const int jl = 8 * gr + 2 * tig + (i & 1);
              const int tri_id = ids[jl];
              if (tri_id == itri[h] || ids[C + jl] == imesh[h]) continue;
              if (ANY_HIT) {
                found[h] = true;
              } else {
                const float dist = ct[i] / cdet[i];
                if (dist < capr[h] && dist < cd[h].t) {
                  cd[h] = {dist, cu[i], cvv[i], cdet[i], j * C + jl, tri_id};
                }
              }
            }
          }
        }
        // The quad's least (t, item) of each row; lane 0 of the quad
        // writes the row's record of this warp's part of the tile.
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* rec = cand + ((warp * RM + mt - mt0) * 16 + g + 8 * h) *
                                  kCandWords;
          if (ANY_HIT) {
            const unsigned f =
                __ballot_sync(0xffffffffu, found[h]) >> (4 * g);
            if (tig == 0) rec[0] = (f & 15u) ? 1.f : 0.f;
          } else {
#pragma unroll
            for (int m = 1; m <= 2; m <<= 1) {
              const Cand oc = shfl_xor_cand(cd[h], m);
              if (lower(oc, cd[h])) cd[h] = oc;
            }
            if (tig == 0) {
              rec[0] = cd[h].t;
              rec[1] = __int_as_float(cd[h].item);
              rec[2] = cd[h].u;
              rec[3] = cd[h].v;
              rec[4] = cd[h].det;
              rec[5] = __int_as_float(cd[h].tri);
            }
          }
        }
        u = (mt + 1) * cols;
      }
      __syncthreads();
      if (slot >= 0) {
        // This ray's records, one from each warp whose units cover its
        // tile: the least (t, item), taken if strictly below the best.
        const int mt = slot >> 4, row = slot & 15;
        const int w1 = min(nw - 1, ((mt + 1) * cols - 1) / P);
        if (ANY_HIT) {
          bool hit = false;
          for (int w = mt * cols / P; w <= w1; ++w) {
            const int m0 = w * P / cols;
            hit = hit || cand[((w * RM + mt - m0) * 16 + row) * kCandWords] !=
                             0.f;
          }
          if (hit) best.code = 0;
        } else {
          Cand c{kInf, 0.f, 0.f, 1.f, INT_MAX, -1};
          for (int w = mt * cols / P; w <= w1; ++w) {
            const int m0 = w * P / cols;
            const float* rec =
                cand + ((w * RM + mt - m0) * 16 + row) * kCandWords;
            const Cand o2{rec[0], rec[2], rec[3], rec[4],
                          __float_as_int(rec[1]), __float_as_int(rec[5])};
            if (lower(o2, c)) c = o2;
          }
          if (c.item != INT_MAX && c.t < best.t) {
            const int j = c.item / C;
            best = {c.t, g_k[j] * C + (c.item - j * C), c.u, c.v, c.det,
                    c.tri};
          }
        }
      }
    }
    res = res || (ANY_HIT ? (best.code >= 0 || tmax0 <= nv) : (best.t <= nv));
    unres = ready();
    if (unres == 0) break;
    // The trip budget (fused.py:690-697): the rays not yet resolved keep
    // their best as a candidate.
    if (a.max_trips > 0 && trips >= a.max_trips) break;
    if (a.recull_every > 0 && trips % a.recull_every == 0 && nv < kInf) {
      // Re-cull from the unresolved rays' beam (fused.py:668-681), after
      // the next group's picks as in the reference; each thread then
      // recomputes its least entry.
      const float wcap =
          block_reduce(res ? -kInf : min_nan(best.t, tmax0), MaxNanOp(), red_f);
      const Beam bm = make_beam(o, d, ray.finite && !res, wcap, red_f);
      recull_entries(
          a, ent, [&](int j) { return entry_of(a.aabb, a.plane, a.ncg, j, bm); },
          cv, ck);
    }
    slot = list_rays();
    cur = nv;
    b = nb;
  }
  cp_async_wait<0>();
  write_out<ANY_HIT>(a, r, active, best, res, trips, tests, ray_tests);
}

// Dynamic shared memory of a block (kernels/fused.py::_smem_bytes): the
// entry table (padded to 4 floats), two groups of K staged blocks, the
// rays' rows, the records, the bests, the list and the two groups' entries
// and ids.
size_t mxu_smem_bytes(const WalkArgs& a) {
  const size_t nt = (a.ts + 31) / 32 * 32;
  const size_t k = a.chunk_k;
  return sizeof(float) *
         ((static_cast<size_t>(a.ncg) + 3) / 4 * 4 +
          2 * k * staged_floats(a.csize, a.highest) +
          nt * (kRayWords + kCandRecs * kCandWords + 2) + 4 * k);
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
      a.recull_every < 0 || a.csize % 8 || a.ts > 256) {
    return cudaErrorInvalidValue;
  }
  return pretest ? dispatch_cull<ANY_HIT, true>(a, n_rays, cull, stream)
                 : dispatch_cull<ANY_HIT, false>(a, n_rays, cull, stream);
}

WalkArgs mxu_args(const float* origin, const float* direction,
                  const float* tmax, const int* ignore_tri,
                  const int* ignore_mesh, int ts, const float* root,
                  const float* aabb, const float* plane,
                  const float* group_aabb, const float* gsplit, int ncg,
                  int csize, int recull_every, int max_trips, int chunk_k,
                  int highest) {
  WalkArgs a = walk_args(origin, direction, tmax, ignore_tri, ignore_mesh,
                         ts, root, aabb, gsplit, ncg, csize);
  a.plane = plane;
  a.group_aabb = group_aabb;
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
    const float* group_aabb, const float* gsplit, int ncg, int csize,
    const float* tri_shade, int cull, int pretest, int recull_every,
    int max_trips, int chunk_k, int highest, float* out_t, int* out_code,
    float* out_u, float* out_v, int* out_tri, float* out_rows, int* out_res,
    int* out_iters, int* out_tests, int* out_ray_tests, void* stream) {
  WalkArgs a = mxu_args(origin, direction, tmax, ignore_tri, ignore_mesh, ts,
                        root, aabb, plane, group_aabb, gsplit, ncg, csize,
                        recull_every, max_trips, chunk_k, highest);
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
    const float* group_aabb, const float* gsplit, int ncg, int csize,
    int cull, int pretest, int recull_every, int max_trips, int chunk_k,
    int highest, float* out_t, int* out_code, int* out_res, int* out_iters,
    int* out_tests, int* out_ray_tests, void* stream) {
  WalkArgs a = mxu_args(origin, direction, tmax, ignore_tri, ignore_mesh, ts,
                        root, aabb, plane, group_aabb, gsplit, ncg, csize,
                        recull_every, max_trips, chunk_k, highest);
  set_outputs(a, out_t, out_code, out_res, out_iters, out_tests,
              out_ray_tests);
  return static_cast<int>(dispatch<true>(
      a, n_rays, cull, pretest, static_cast<cudaStream_t>(stream)));
}
