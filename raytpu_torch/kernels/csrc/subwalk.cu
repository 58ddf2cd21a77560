// The group walk: several picks per trip and the subcluster walk.
//
// subwalk_kernel<ANY_HIT, CULL, SUBK, PRETEST> replaces
// raytpu/kernels/fused.py::_tlane_kernel with subk = SUBK in {2, 4}
// (fused.py:959-1300: blocks of a cluster_size 64 or 32 bake, each packing
// SUBK leaves of csub = C / SUBK triangles) with its per-sibling ``gate``
// (fused.py:1140-1152, :1211-1219), and ``chunk_k`` > 1, the K picks per
// trip of both reference walks (_fused_kernel fused.py:407-422,
// _tlane_kernel's ``kc``).  SUBK = 1 is the classic walk (the block is its
// own sibling) with K picks per trip, the slab pretest (PRETEST) and the
// re-cull; SUBK > 1 has neither (the reference's tlane walk does not).
// Runtime: chunk_k (K), gate, max_trips and, SUBK = 1, recull_every.
//
// One thread block walks one tile of rays, one ray per thread:
//   1. prologue (walk.cu's): each sibling's entry bound (slab interval,
//      intersected with the leaf's fitted-plane interval when the bake has
//      planes) for the tile's beam; a block's key, the least of its
//      siblings' entries, goes into shared memory;
//   2. a trip picks the next K blocks (block-wide argmins of the keys,
//      lowest id on equal keys) and, SUBK > 1, recomputes each picked
//      block's sibling entries from the same beam and tables (the same
//      function on the same inputs: the same bits as the keys were made
//      of), so that only the keys live in shared memory;
//   3. it stages the lanes of the sibling passes that run (all of them, or
//      with ``gate`` those whose own entry is below the trip's cap: the
//      largest min(best, t bound) of the tile's unresolved rays, taken once
//      at the trip's start) and tests them in pick order, each block's
//      siblings in order h = 0..SUBK-1, with the strict-min update: equal-t
//      ties between siblings go to the lower sibling, within one to the
//      lower lane.  The gate is a block-uniform branch: every thread skips
//      a pass together.  With PRETEST, each pick's tests are skipped when
//      no unresolved ray reaches its box before its trip-start cap;
//   4. settle against the next group's first key; the tile stops when
//      every ray is resolved, the keys run out or after max_trips trips.
//      SUBK = 1 may re-cull every recull_every trips, as walk.cu does.
// Results are the same with and without the gate; only the counters and
// the time differ.
//
// Counters per tile: trips, blocks with a sibling pass tested, and ray
// tests: the unresolved rays of each sibling pass run (each pass tests
// csub triangles), summed.
//
// What bounds it on an H100: the same per-pair arithmetic as walk.cu
// (~43 FP32 operations and 18 shared-memory loads per ray-triangle pair),
// over csub-triangle passes; per trip K block-wide argmin scans of the key
// table and, SUBK > 1, K * SUBK entry bounds.  The design keeps the key
// table, the K staged blocks and the picks on chip (the sibling entries of
// the bench terrain at 32 would take 125 KB of shared memory beside the
// 31 KB key table; recomputing them for the K picks costs K * SUBK entry
// bounds a trip), and stages only the lanes of the passes that run.

#include "walk_common.cuh"

namespace {

// Room for the beam in shared memory (SUBK > 1), in bytes.
constexpr int kBeamBytes = 128;
static_assert(sizeof(Beam) <= kBeamBytes, "the beam outgrew its room");

// Sibling h's entry bound of block j.
__device__ __forceinline__ float sib_entry(const WalkArgs& a, int h, int j,
                                           const Beam& b) {
  const size_t n = a.ncg;
  return entry_of(a.sub_aabb + 6 * n * h,
                  a.sub_plane ? a.sub_plane + 5 * n * h : nullptr, a.ncg, j,
                  b);
}

// The next K picks into gv/gk (kInf and INT_MAX past the end) and, SUBK >
// 1, their sibling entries.  Every thread calls it; it ends in a barrier.
template <int SUBK>
__device__ void pick_group(const WalkArgs& a, float* ent, float* gv, int* gk,
                           float* esub, const Beam* beam, float* red_f,
                           int* red_i) {
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
    if (SUBK > 1 && !drained && threadIdx.x < SUBK) {
      esub[j * SUBK + threadIdx.x] = sib_entry(a, threadIdx.x, p.k, *beam);
    }
  }
  __syncthreads();
}

template <bool ANY_HIT, int CULL, int SUBK, bool PRETEST>
__global__ void subwalk_kernel(WalkArgs a) {
  static_assert(SUBK == 1 || !PRETEST, "the pretest is the classic walk's");
  extern __shared__ float smem[];
  const int C = a.csize, K = a.chunk_k, csub = a.csize / SUBK;
  float* ent = smem;                           // (ncg,) block keys
  float* geo = ent + a.ncg;                    // (K, 18, C) staged blocks
  float* gv = geo + K * kGeoRows * C;          // (K,) the group's keys
  int* gk = reinterpret_cast<int*>(gv + K);    // (K,) the group's blocks
  float* esub = reinterpret_cast<float*>(gk + K);  // (K, SUBK), SUBK > 1
  Beam* beam = reinterpret_cast<Beam*>(esub + K * SUBK);
  __shared__ float red_f[32];
  __shared__ int red_i[32];

  const int tid = threadIdx.x;
  const bool active = tid < a.ts;
  const size_t r = static_cast<size_t>(blockIdx.x) * a.ts + tid;
  const Ray ray = load_ray(a, r, active);
  const float tmax0 = ray.tmax0;
  // Rays that cannot hit (non-finite, or t bound not above 0, NaN
  // included) start resolved.
  bool res = !ray.finite || !(tmax0 > 0.f);
  {
    // The block keys for the tile's beam, pruned at the largest bound of
    // the unresolved rays.
    const float wcap = block_reduce(res ? -kInf : tmax0, MaxNanOp(), red_f);
    const Beam b = make_beam(ray.o, ray.d, ray.finite, wcap, red_f);
    for (int j = tid; j < a.ncg; j += blockDim.x) {
      float e = sib_entry(a, 0, j, b);
      for (int h = 1; h < SUBK; ++h) e = min_nan(e, sib_entry(a, h, j, b));
      ent[j] = e;
    }
    if (SUBK > 1 && tid == 0) *beam = b;
  }
  __syncthreads();

  Best best{tmax0, -1, 0.f, 0.f, 1.f, -1};
  const float* o = ray.o;
  const float* d = ray.d;
  const float w[3] = {d[1] * o[2] - d[2] * o[1], d[2] * o[0] - d[0] * o[2],
                      d[0] * o[1] - d[1] * o[0]};
  // Slab reciprocals of the pretest (fused.py:543-544).
  float inv_d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    inv_d[k] = PRETEST ? 1.0f / (d[k] == 0.f ? kTinyDir : d[k]) : 0.f;
  }
  const float margin = a.root[6];
  const unsigned all_sibs = (1u << SUBK) - 1;
  int trips = 0, tests = 0, ray_tests = 0;

  pick_group<SUBK>(a, ent, gv, gk, esub, beam, red_f, red_i);
  // No feasible block: nothing to hit, every ray is proven.
  if (!(gv[0] < kInf)) res = true;
  while (gv[0] < kInf) {
    ++trips;
    const int unres = __syncthreads_count(!res);
    // The trip's caps, taken once at its start.
    const float cap_r = res ? -kInf : min_nan(best.t, tmax0);
    float capmax = kInf;
    if (a.gate) capmax = block_reduce(cap_r, MaxNanOp(), red_f);
    // Which sibling passes run: bit j * SUBK + h, the same in every thread.
    unsigned run = 0;
    for (int j = 0; j < K && gv[j] < kInf; ++j) {
      if (PRETEST) {
        // Can this ray reach the block's box before its cap?
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
      for (int h = 0; h < SUBK; ++h) {
        const float e = SUBK == 1 ? gv[j] : esub[j * SUBK + h];
        if (!a.gate || e < capmax) run |= 1u << (j * SUBK + h);
      }
    }
    // Stage the lanes of the passes that run.
    for (int j = 0; j < K; ++j) {
      const unsigned m = (run >> (j * SUBK)) & all_sibs;
      if (!m) continue;
      ++tests;
      const float* src = a.block + static_cast<size_t>(gk[j]) * kBlockRows * C;
      float* dst = geo + j * kGeoRows * C;
      for (int e = tid; e < kGeoRows * C; e += blockDim.x) {
        if (m == all_sibs || ((m >> ((e % C) / csub)) & 1u)) dst[e] = src[e];
      }
    }
    __syncthreads();
    for (int j = 0; j < K; ++j) {
      const int k = gk[j];
      const float* g = geo + j * kGeoRows * C;
      for (int h = 0; h < SUBK; ++h) {
        if (!((run >> (j * SUBK + h)) & 1u)) continue;
        ray_tests += unres;
        test_staged<ANY_HIT, CULL>(g, C, h * csub, (h + 1) * csub, k, ray, w,
                                   best);
      }
    }
    __syncthreads();  // the staged blocks and picks are read: refill them
    pick_group<SUBK>(a, ent, gv, gk, esub, beam, red_f, red_i);
    const float nv = gv[0];
    res = res || (ANY_HIT ? (best.code >= 0 || tmax0 <= nv) : (best.t <= nv));
    if (__syncthreads_and(res)) break;
    // The trip budget (fused.py:690-697): the rays not yet resolved keep
    // their best as a candidate.
    if (a.max_trips > 0 && trips >= a.max_trips) break;
    if (SUBK == 1 && a.recull_every > 0 && trips % a.recull_every == 0 &&
        nv < kInf) {
      // Re-cull from the unresolved rays' beam (fused.py:668-681).
      const float wcap =
          block_reduce(res ? -kInf : min_nan(best.t, tmax0), MaxNanOp(), red_f);
      const Beam b = make_beam(o, d, ray.finite && !res, wcap, red_f);
      for (int j = tid; j < a.ncg; j += blockDim.x) {
        if (ent[j] != consumed()) ent[j] = sib_entry(a, 0, j, b);
      }
      __syncthreads();
    }
  }
  write_out<ANY_HIT>(a, r, active, best, res, trips, tests, ray_tests);
}

// Dynamic shared memory of a block: the key table, K staged blocks, the
// group's keys and ids and, SUBK > 1, its sibling entries and the beam
// (kernels/fused.py::_smem_bytes).
size_t group_smem_bytes(const WalkArgs& a) {
  const size_t k = a.chunk_k;
  size_t n = sizeof(float) * (a.ncg + k * kGeoRows * a.csize) + 8 * k;
  if (a.subk > 1) n += sizeof(float) * k * a.subk + kBeamBytes;
  return n;
}

template <bool ANY_HIT, int SUBK, bool PRETEST>
cudaError_t dispatch_cull(const WalkArgs& a, int n_rays, int cull,
                          cudaStream_t stream) {
  const size_t smem = group_smem_bytes(a);
  switch (cull) {
    case 0: return launch(subwalk_kernel<ANY_HIT, 0, SUBK, PRETEST>, a, n_rays, smem, stream);
    case 1: return launch(subwalk_kernel<ANY_HIT, 1, SUBK, PRETEST>, a, n_rays, smem, stream);
    case 2: return launch(subwalk_kernel<ANY_HIT, 2, SUBK, PRETEST>, a, n_rays, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The largest K: the pass bits of a trip fit one 32-bit word.
constexpr int kMaxChunk = 8;

template <bool ANY_HIT>
cudaError_t dispatch(const WalkArgs& a, int n_rays, int cull, int pretest,
                     cudaStream_t stream) {
  if (a.chunk_k < 1 || a.chunk_k > kMaxChunk || a.max_trips < 0 ||
      a.recull_every < 0 || a.csize % a.subk) {
    return cudaErrorInvalidValue;
  }
  if (a.subk != 1 && (pretest || a.recull_every)) return cudaErrorInvalidValue;
  switch (a.subk) {
    case 1:
      return pretest ? dispatch_cull<ANY_HIT, 1, true>(a, n_rays, cull, stream)
                     : dispatch_cull<ANY_HIT, 1, false>(a, n_rays, cull, stream);
    case 2: return dispatch_cull<ANY_HIT, 2, false>(a, n_rays, cull, stream);
    case 4: return dispatch_cull<ANY_HIT, 4, false>(a, n_rays, cull, stream);
    default: return cudaErrorInvalidValue;
  }
}

WalkArgs group_args(const float* origin, const float* direction,
                    const float* tmax, const int* ignore_tri,
                    const int* ignore_mesh, int ts, const float* root,
                    const float* aabb, const float* block, int ncg, int csize,
                    const float* sub_aabb, const float* sub_plane, int subk,
                    int recull_every, int max_trips, int chunk_k, int gate) {
  WalkArgs a = walk_args(origin, direction, tmax, ignore_tri, ignore_mesh,
                         ts, root, aabb, block, ncg, csize);
  a.sub_aabb = sub_aabb;
  a.sub_plane = sub_plane;
  a.subk = subk;
  a.recull_every = recull_every;
  a.max_trips = max_trips;
  a.chunk_k = chunk_k;
  a.gate = gate;
  return a;
}

}  // namespace

extern "C" int rt_subwalk_nearest(
    const float* origin, const float* direction, const float* tmax,
    const int* ignore_tri, const int* ignore_mesh, int n_rays, int ts,
    const float* root, const float* aabb, const float* block, int ncg,
    int csize, const float* sub_aabb, const float* sub_plane, int subk,
    const float* tri_shade, int cull, int pretest, int recull_every,
    int max_trips, int chunk_k, int gate, float* out_t, int* out_code,
    float* out_u, float* out_v, int* out_tri, float* out_rows, int* out_res,
    int* out_iters, int* out_tests, int* out_ray_tests, void* stream) {
  WalkArgs a = group_args(origin, direction, tmax, ignore_tri, ignore_mesh,
                          ts, root, aabb, block, ncg, csize, sub_aabb,
                          sub_plane, subk, recull_every, max_trips, chunk_k,
                          gate);
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

extern "C" int rt_subwalk_any_hit(
    const float* origin, const float* direction, const float* tmax,
    const int* ignore_tri, const int* ignore_mesh, int n_rays, int ts,
    const float* root, const float* aabb, const float* block, int ncg,
    int csize, const float* sub_aabb, const float* sub_plane, int subk,
    int cull, int pretest, int recull_every, int max_trips, int chunk_k,
    int gate, float* out_t, int* out_code, int* out_res, int* out_iters,
    int* out_tests, int* out_ray_tests, void* stream) {
  WalkArgs a = group_args(origin, direction, tmax, ignore_tri, ignore_mesh,
                          ts, root, aabb, block, ncg, csize, sub_aabb,
                          sub_plane, subk, recull_every, max_trips, chunk_k,
                          gate);
  set_outputs(a, out_t, out_code, out_res, out_iters, out_tests,
              out_ray_tests);
  return static_cast<int>(dispatch<true>(
      a, n_rays, cull, pretest, static_cast<cudaStream_t>(stream)));
}
