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
//   1. prologue: each sibling's entry bound (slab interval, intersected
//      with the leaf's fitted-plane interval when the bake has planes) for
//      the tile's beam; a block's key, the least of its siblings' entries,
//      goes into shared memory, and each thread keeps the least key (and
//      its id) of the blocks it owns, ids tid, tid + threads, ...;
//   2. a trip takes the next K picks, each the least key left (lowest id
//      on equal keys), and tests the lanes of the sibling passes that run
//      (all of them, or with ``gate`` those whose own entry is below the
//      trip's cap: the largest min(best, t bound) of the tile's unresolved
//      rays, taken once at the trip's start) in pick order, each block's
//      siblings in order h = 0..SUBK-1, with the strict-min update: equal-t
//      ties between siblings go to the lower sibling, within one to the
//      lower lane.  The gate is a block-uniform branch: every thread skips
//      a pass together.  With PRETEST, each pick's tests are skipped when
//      no unresolved ray reaches its box before its trip-start cap;
//   3. settle against the next group's first key; the tile stops when
//      every ray is resolved, the keys run out or after max_trips trips.
//      SUBK = 1 may re-cull every recull_every trips, as walk.cu does.
// Results are the same with and without the gate; only the counters and
// the time differ.
//
// Counters per tile: trips, blocks with a sibling pass tested, and ray
// tests: the unresolved rays of each sibling pass run (each pass tests
// csub triangles), summed.
//
// What bounds it on an H100, and what the design does about it.  The pair
// tests are the work the function needs (~43 FP32 operations a pair, over
// csub-triangle passes); everything else is the walk's own overhead, a
// serial chain per trip.  Measured per trip with clock64 stamps
// (walk_split.py --kernel subwalk, PERF.md) before this design, the bench
// frame's blocks spent most of their clocks in scalar pair tests (18
// shared loads a pair, for every thread), and the instanced frame's
// reflection tiles, a handful of unresolved rays walking thousands of
// trips, in the tests of all 256 threads and a full scan of the key table
// for every pick.  So:
//   - The prologue computes the keys of a group of 32 consecutive blocks
//     only when the beam reaches the group's box, and a block's sibling
//     entries only when it reaches the box holding them
//     (kernels/fused.py::cull_boxes, group_boxes), two groups a warp at a
//     time so that their loads overlap.
//   - Pick without a scan.  SUBK > 1 never changes a key after the
//     prologue, and SUBK = 1 only at a re-cull, after which each thread
//     recomputes its least key.  A pick is two warp reductions (REDUX of
//     the keys' bits, -0 made +0) of the threads' least keys, one barrier
//     and two more; the owner of the pick marks it consumed and its warp
//     refreshes the owner's least key, a key a lane.
//   - Pick ahead, copy asynchronously.  Nothing that decides a pick
//     changes between the picks of this group and those of the next, so
//     the next group is picked at the trip's start and its 18 rows a block
//     go into a second buffer with cp.async (16-byte pieces) while this
//     group is tested, and so do the next picks' sibling boxes and planes,
//     from which, with the gate, the threads that copied them compute the
//     sibling entries (the same function of the same values as the
//     prologue's).  What a trip starts with (its copies landed, its
//     sibling entries, the caps, the unresolved rays of each warp and of
//     the tile) is settled before the barrier that ends the trip before
//     it, so a trip has one barrier a pick and one at its end (two more
//     when few rays are unresolved, below).
//   - float4 pair tests over each pass's lanes [h * csub, (h + 1) * csub)
//     (4 LDS.128 broadcasts a pair group instead of 16 LDS.32 a pair), with
//     the warp early-outs (walk_common.cuh's test4): on the u test and, for
//     any-hit queries, first on det alone (a warp whose pairs all face away
//     reads 3 rows); passes whose lanes are not a multiple of 4 keep the
//     scalar loop.
//   - A ray tests a sibling pass only if it reaches the sibling's box
//     (copied with the pick, widened by the root margin) before its best:
//     the classic walk's slab pretest, one ray at a time, which skips only
//     pairs whose strict-min update could take nothing.  The counters still
//     count every pass the trip runs.
//   - Few unresolved rays (at most half the block): each one's pair tests
//     go to one warp, the rays dealt round-robin to the warps, its lanes
//     on the ray's 4-lane groups of the trip's passes in pick order, so
//     that the early-outs vote on one ray's pairs; REDUX reductions of
//     (t, item) give the first least t, which the ray takes only if it is
//     strictly below its best: exactly what the ascending loop with
//     ``dist < best`` computes.  Resolved rays are not tested there (every
//     later key is at or beyond their best, so their tests change
//     nothing).

#include "walk_common.cuh"

#include <cstdint>

namespace {

// The largest K: the pass bits of a trip fit one 32-bit word.
constexpr int kMaxChunk = 8;
constexpr int kSibWords = 11;   // a sibling's copied box (6) and plane (5)
constexpr int kTailWords = 10;  // a spread ray: o, d, t bound, ignore ids,
                                // best t; then its result: t, code, u, v,
                                // det, tri
constexpr int kBeamBytes = 128;  // room for the beam
static_assert(sizeof(Beam) <= kBeamBytes, "the beam outgrew its room");

// Sibling h's entry bound of block j.
__device__ __forceinline__ float sib_entry(const WalkArgs& a, int h, int j,
                                           const Beam& b) {
  const size_t n = a.ncg;
  return entry_of(a.sub_aabb + 6 * n * h,
                  a.sub_plane ? a.sub_plane + 5 * n * h : nullptr, a.ncg, j,
                  b);
}

// Block j's key: the least of its siblings' entries (kInf, without a look
// at them, when the beam cannot reach the box that holds them all: their
// slab intervals lie inside its interval, so each is infeasible too).
template <int SUBK>
__device__ __forceinline__ float block_key(const WalkArgs& a, int j,
                                           const Beam& b) {
  if (SUBK > 1 &&
      !(entry_bound<false>(a.cull_aabb, nullptr, a.ncg, j, b) < kInf)) {
    return kInf;
  }
  float e = sib_entry(a, 0, j, b);
  for (int h = 1; h < SUBK; ++h) e = min_nan(e, sib_entry(a, h, j, b));
  return e;
}

// Start copying sibling h of block j's box and plane into ``dst``.
__device__ __forceinline__ void fetch_sib(const WalkArgs& a, int h, int j,
                                          float* dst) {
  const size_t n = a.ncg;
  const float* box = a.sub_aabb + 6 * n * h + j;
#pragma unroll
  for (int c = 0; c < 6; ++c) cp_async4(dst + c, box + c * n);
  if (a.sub_plane) {
    const float* plane = a.sub_plane + 5 * n * h + j;
#pragma unroll
    for (int c = 0; c < 5; ++c) cp_async4(dst + 6 + c, plane + c * n);
  }
}

// The entry bound of a copied sibling: sib_entry's function of the same
// values, as a table of one column.
__device__ __forceinline__ float copied_entry(const WalkArgs& a,
                                              const float* s, const Beam& b) {
  return a.sub_plane ? entry_bound<true>(s, s + 6, 1, 0, b)
                     : entry_bound<false>(s, nullptr, 1, 0, b);
}

// The next group: K picks into gv/gk (kInf and INT_MAX past the end), each
// the least key left (lowest id on equal keys), consumed.  As soon as a
// block is picked every thread starts copying its share of the block's 18
// rows into ``geo`` and thread j * SUBK + h sibling h's box and plane into
// its slot of ``sib``; one copy group a call.  Returns the first pick's
// key.  Every thread calls it; a barrier a pick.
template <int SUBK>
__device__ float pick_group(const WalkArgs& a, float* ent, float& cv,
                            int& ck, float* gv, int* gk, float* geo,
                            float* sib, bool vstage, float* pick_f,
                            int* pick_i, unsigned& parity) {
  const int tid = threadIdx.x;
  float first = kInf;
  bool drained = false;
  for (int j = 0; j < a.chunk_k; ++j) {
    Pick p{kInf, INT_MAX};
    if (!drained) {
      p = block_lexmin(cv, ck, pick_f + 32 * parity, pick_i + 32 * parity);
      parity ^= 1u;
      drained = !(p.v < kInf);
      if (!drained) {
        consume(ent, a.ncg, p.k, cv, ck);
        stage_async(a, p.k, geo + j * kGeoRows * a.csize, vstage);
        if (tid >= j * SUBK && tid < (j + 1) * SUBK) {
          fetch_sib(a, tid - j * SUBK, p.k, sib + tid * kSibWords);
        }
      }
    }
    if (j == 0) first = p.v;
    if (tid == 0) {
      gv[j] = p.v;
      gk[j] = p.k;
    }
  }
  cp_async_commit();
  return first;
}

// At most 80 registers a thread (__maxnreg__): three blocks of 256 threads
// an SM, as the classic walk.
template <bool ANY_HIT, int CULL, int SUBK, bool PRETEST>
__global__ void __maxnreg__(80) subwalk_kernel(WalkArgs a) {
  static_assert(SUBK == 1 || !PRETEST, "the pretest is the classic walk's");
  // The pair tests' early-outs (walk_common.cuh's test4): the det vote pays
  // where many pairs face away, as for shadow rays (walk_ab.py).
  constexpr int kEarly = ANY_HIT ? 2 : 1;
  extern __shared__ __align__(16) float smem[];
  const int C = a.csize, K = a.chunk_k, csub = a.csize / SUBK;
  const int nt = blockDim.x;
  float* ent = smem;                          // (ncg,) block keys
  float* geo0 = smem + (a.ncg + 3) / 4 * 4;   // 2 x (K, 18, C) groups
  float* tail = geo0 + 2 * K * kGeoRows * C;  // (nt / 2, 10) spread rays
  Beam& beam = *reinterpret_cast<Beam*>(tail + nt / 2 * kTailWords);
  float* pick_f = tail + nt / 2 * kTailWords + kBeamBytes / 4;  // 2 x 32
  int* pick_i = reinterpret_cast<int*>(pick_f + 64);  // the picks' scratch
  float* gv = reinterpret_cast<float*>(pick_i + 64);  // 2 x K: the groups'
  int* gk = reinterpret_cast<int*>(gv + 2 * K);       // keys and blocks
  float* esub = reinterpret_cast<float*>(gk + 2 * K);  // 2 x (K, SUBK)
  float* sib = esub + 2 * K * SUBK;  // 2 x (K, SUBK, 11) sibling tables
  __shared__ float red_f[32];     // block reductions
  __shared__ unsigned red_u[32];  // the warps' largest caps (ordered)
  __shared__ int red_c[32];       // the warps' unresolved rays
  unsigned parity = 0;

  const int tid = threadIdx.x;
  const bool active = tid < a.ts;
  const size_t r = static_cast<size_t>(blockIdx.x) * a.ts + tid;
  const Ray ray = load_ray(a, r, active);
  const float tmax0 = ray.tmax0;
  // Rays that cannot hit (non-finite, or t bound not above 0, NaN
  // included) start resolved.
  bool res = !ray.finite || !(tmax0 > 0.f);
  // The least key of the blocks this thread owns (kInf, INT_MAX: none).
  float cv = kInf;
  int ck = INT_MAX;
  {
    // The block keys for the tile's beam, pruned at the largest bound of
    // the unresolved rays (cull_entries).
    const float wcap = block_reduce(res ? -kInf : tmax0, MaxNanOp(), red_f);
    const Beam bm = make_beam(ray.o, ray.d, ray.finite, wcap, red_f);
    cull_entries(
        a, bm, ent, [&](int j) { return block_key<SUBK>(a, j, bm); },
        [](int) {}, cv, ck);
    if (SUBK > 1 && tid == 0) beam = bm;
  }

  Best best{tmax0, -1, 0.f, 0.f, 1.f, -1};
  const float* o = ray.o;
  const float* d = ray.d;
  // Slab reciprocals of the pretest (fused.py:543-544).
  float inv_d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) inv_d[k] = 1.0f / (d[k] == 0.f ? kTinyDir : d[k]);
  const float margin = a.root[6];
  const unsigned all_sibs = (1u << SUBK) - 1;
  const bool vstage = C % 4 == 0 &&
                      (reinterpret_cast<uintptr_t>(a.block) & 15) == 0;
  const bool vtest = csub % 4 == 0;
  int trips = 0, tests = 0, ray_tests = 0;

  int b = 0;  // the buffer of the group under test
  float cur = pick_group<SUBK>(a, ent, cv, ck, gv, gk, geo0, sib, vstage,
                               pick_f, pick_i, parity);
  // No feasible block: nothing to hit, every ray is proven.
  if (!(cur < kInf)) res = true;
  // What a trip starts with, settled before the barrier that ends the trip
  // before it: this thread's copies of the group have landed (the barrier
  // shows every thread's), the group's sibling entries (gate), each warp's
  // largest cap (gate) and unresolved rays, and the tile's unresolved rays.
  auto ready = [&](int g) {
    cp_async_wait<0>();
    if (SUBK > 1 && a.gate && tid < K * SUBK && gv[g * K + tid / SUBK] < kInf) {
      esub[g * K * SUBK + tid] = copied_entry(
          a, sib + (g * K * SUBK + tid) * kSibWords, beam);
    }
    if (a.gate) {
      const float cap_r = res ? -kInf : min_nan(best.t, tmax0);
      const unsigned m = __reduce_max_sync(0xffffffffu, ordered(cap_r));
      if ((tid & 31) == 0) red_u[tid >> 5] = m;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, !res);
    if ((tid & 31) == 0) red_c[tid >> 5] = __popc(bal);
    return __syncthreads_count(!res);
  };
  int unres = ready(0);
  while (cur < kInf) {
    ++trips;
    // The trip's caps, taken once at its start (before the next pick's
    // barrier, after which red_u is written again).
    float capmax = kInf;
    if (a.gate) {
      unsigned m = red_u[0];
      for (int w = 1; w < (nt >> 5); ++w) m = m > red_u[w] ? m : red_u[w];
      capmax = unordered(m);
    }
    // Pick ahead: the next group, its rows copied while this one is tested.
    const int nb = b ^ 1;
    const float nv = pick_group<SUBK>(
        a, ent, cv, ck, gv + nb * K, gk + nb * K, geo0 + nb * K * kGeoRows * C,
        sib + nb * K * SUBK * kSibWords, vstage, pick_f, pick_i, parity);
    const float* geo = geo0 + b * K * kGeoRows * C;
    const float* g_v = gv + b * K;
    const int* g_k = gk + b * K;
    const float* e_s = esub + b * K * SUBK;
    const float cap_r = res ? -kInf : min_nan(best.t, tmax0);
    // Which sibling passes run: bit j * SUBK + h, the same in every thread.
    unsigned run = 0;
    for (int j = 0; j < K && g_v[j] < kInf; ++j) {
      // Can any ray reach the block's box before its cap?
      if (PRETEST && !__syncthreads_or(reaches(a.aabb + g_k[j], margin, o,
                                                inv_d, cap_r, a.ncg))) {
        continue;
      }
      for (int h = 0; h < SUBK; ++h) {
        if (!a.gate || (SUBK == 1 ? g_v[j] : e_s[j * SUBK + h]) < capmax) {
          run |= 1u << (j * SUBK + h);
        }
      }
    }
    for (int j = 0; j < K; ++j) tests += ((run >> (j * SUBK)) & all_sibs) != 0;
    ray_tests += unres * __popc(run);
    // This group's copied sibling boxes, slot j * SUBK + h.
    const float* boxes = sib + b * K * SUBK * kSibWords;
    if (run && (2 * unres > nt || !vtest)) {
      // Every thread tests its own ray against the passes' lanes; a warp
      // skips a pass that none of its rays reaches before its best.
      for (int j = 0; j < K; ++j) {
        const unsigned m = (run >> (j * SUBK)) & all_sibs;
        if (!m) continue;
        const float* g = geo + j * kGeoRows * C;
        for (int h = 0; h < SUBK; ++h) {
          if (!((m >> h) & 1u)) continue;
          const float cap = res || (ANY_HIT && best.code >= 0)
                                ? -kInf
                                : min_nan(best.t, tmax0);
          if (!__any_sync(0xffffffffu,
                          reaches(boxes + (j * SUBK + h) * kSibWords, margin,
                                  o, inv_d, cap))) {
            continue;
          }
          test_lanes<ANY_HIT, CULL, kEarly>(
              g, C, vtest, h * csub, (h + 1) * csub, 0, 1, o, d, tmax0,
              ray.itri, ray.imesh, g_k[j] * C, best);
        }
      }
    } else if (run && unres > 0) {
      // Few unresolved rays: each one's tests go to one warp, the rays
      // dealt round-robin to the warps.  The ray's 4-lane groups of the
      // passes that run, in pick order, are items 0..n-1; lane l tests
      // items l, l + 32, ... (every lane of the warp in every round, so the
      // early-outs vote on the ray's own pairs), and the warp reduces
      // (t, item): the pick-order loop's first least t.
      const unsigned bal = __ballot_sync(0xffffffffu, !res);
      const int lane = tid & 31;
      int slot = __popc(bal & ((1u << lane) - 1));
      for (int w = 0; w < (tid >> 5); ++w) slot += red_c[w];
      float* mine = tail + slot * kTailWords;
      if (!res) {
        mine[0] = o[0];
        mine[1] = o[1];
        mine[2] = o[2];
        mine[3] = d[0];
        mine[4] = d[1];
        mine[5] = d[2];
        mine[6] = tmax0;
        mine[7] = __int_as_float(ray.itri);
        mine[8] = __int_as_float(ray.imesh);
        mine[9] = best.t;
      }
      __syncthreads();
      const int per = csub / 4;  // groups a pass
      for (int s = tid >> 5; s < unres; s += nt >> 5) {
        float* sl = tail + s * kTailWords;
        const float so[3] = {sl[0], sl[1], sl[2]};
        const float sd[3] = {sl[3], sl[4], sl[5]};
        const float sw[3] = {sd[1] * so[2] - sd[2] * so[1],
                             sd[2] * so[0] - sd[0] * so[2],
                             sd[0] * so[1] - sd[1] * so[0]};
        float sinv[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          sinv[c] = 1.0f / (sd[c] == 0.f ? kTinyDir : sd[c]);
        }
        const float stm = sl[6];
        const int sit = __float_as_int(sl[7]), sim = __float_as_int(sl[8]);
        // The passes whose sibling box the ray reaches before its best:
        // lane p looks at pass p.
        const unsigned ray_run = __ballot_sync(
            0xffffffffu,
            ((run >> lane) & 1u) &&
                reaches(boxes + lane * kSibWords, margin, so, sinv,
                        ANY_HIT ? stm : min_nan(sl[9], stm)));
        const int items = __popc(ray_run) * per;
        Best lb{kInf, -1, 0.f, 0.f, 1.f, -1};
        int first = INT_MAX;  // the item of lb
        for (int i0 = 0; i0 < items; i0 += 32) {
          const int i = i0 + lane;
          const bool live = i < items;
          // Item i: group i % per of the (i / per)-th pass the ray reaches.
          unsigned bits = ray_run;
          for (int p = live ? i / per : 0; p > 0; --p) bits &= bits - 1;
          const int pass = __ffs(bits) - 1, j = pass / SUBK;
          const int code = lb.code;
          test4<ANY_HIT, CULL, kEarly>(
              geo + j * kGeoRows * C, C,
              4 * ((pass - j * SUBK) * per + (live ? i % per : 0)), so, sd,
              sw, stm, sit, sim, g_k[j] * C, lb, live);
          if (lb.code != code) first = i;
        }
        if (ANY_HIT) {
          if (__any_sync(0xffffffffu, lb.code >= 0)) lb.code = 0;
        } else {
          // Least t (-0 made +0), then least item; the winner's fields.
          const unsigned key = __float_as_uint(lb.t + 0.f);
          const unsigned m = __reduce_min_sync(0xffffffffu, key);
          const unsigned f = __reduce_min_sync(
              0xffffffffu, key == m ? static_cast<unsigned>(first) : ~0u);
          const int src = __ffs(__ballot_sync(
              0xffffffffu, key == m && static_cast<unsigned>(first) == f)) - 1;
          lb = {__shfl_sync(0xffffffffu, lb.t, src),
                __shfl_sync(0xffffffffu, lb.code, src),
                __shfl_sync(0xffffffffu, lb.u, src),
                __shfl_sync(0xffffffffu, lb.v, src),
                __shfl_sync(0xffffffffu, lb.det, src),
                __shfl_sync(0xffffffffu, lb.tri, src)};
          if (!(lb.t < sl[9])) lb.code = -1;
        }
        __syncwarp();  // the warp has read its ray: the result goes there
        if (lane == 0) {
          sl[0] = lb.t;
          sl[1] = __int_as_float(lb.code);
          sl[2] = lb.u;
          sl[3] = lb.v;
          sl[4] = lb.det;
          sl[5] = __int_as_float(lb.tri);
        }
      }
      __syncthreads();
      if (!res) {
        const int code = __float_as_int(mine[1]);
        if (code >= 0) {
          if (ANY_HIT) {
            best.code = 0;
          } else {
            best = {mine[0], code, mine[2], mine[3], mine[4],
                    __float_as_int(mine[5])};
          }
        }
      }
    }
    res = res || (ANY_HIT ? (best.code >= 0 || tmax0 <= nv) : (best.t <= nv));
    unres = ready(nb);
    if (unres == 0) break;
    // The trip budget (fused.py:690-697): the rays not yet resolved keep
    // their best as a candidate.
    if (a.max_trips > 0 && trips >= a.max_trips) break;
    if (SUBK == 1 && a.recull_every > 0 && trips % a.recull_every == 0 &&
        nv < kInf) {
      // Re-cull from the unresolved rays' beam (fused.py:668-681), after
      // the next group's picks as in the reference; each thread then
      // recomputes its least key.
      const float wcap =
          block_reduce(res ? -kInf : min_nan(best.t, tmax0), MaxNanOp(), red_f);
      const Beam bm = make_beam(o, d, ray.finite && !res, wcap, red_f);
      recull_entries(a, ent, [&](int j) { return sib_entry(a, 0, j, bm); },
                     cv, ck);
    }
    cur = nv;
    b ^= 1;
  }
  write_out<ANY_HIT>(a, r, active, best, res, trips, tests, ray_tests);
}

// Dynamic shared memory of a block (kernels/fused.py::_smem_bytes): the
// key table (padded to 4 floats), two groups of K staged blocks, the
// spread rays of half the block, the beam, the picks' scratch, and the two
// groups' keys, ids, sibling entries and copied sibling tables.
size_t group_smem_bytes(const WalkArgs& a) {
  const size_t nt = (a.ts + 31) / 32 * 32;
  const size_t k = a.chunk_k;
  const size_t words = (static_cast<size_t>(a.ncg) + 3) / 4 * 4 +
                       2 * k * kGeoRows * a.csize + nt / 2 * kTailWords +
                       2 * 64 + 4 * k + 2 * k * a.subk * (1 + kSibWords);
  return sizeof(float) * words + kBeamBytes;
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
                    const float* aabb, const float* cull_aabb,
                    const float* group_aabb, const float* block, int ncg,
                    int csize, const float* sub_aabb, const float* sub_plane,
                    int subk, int recull_every, int max_trips, int chunk_k,
                    int gate) {
  WalkArgs a = walk_args(origin, direction, tmax, ignore_tri, ignore_mesh,
                         ts, root, aabb, block, ncg, csize);
  a.cull_aabb = cull_aabb;
  a.group_aabb = group_aabb;
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
    const float* root, const float* aabb, const float* cull_aabb,
    const float* group_aabb, const float* block, int ncg, int csize,
    const float* sub_aabb, const float* sub_plane, int subk,
    const float* tri_shade, int cull, int pretest, int recull_every,
    int max_trips, int chunk_k, int gate, float* out_t, int* out_code,
    float* out_u, float* out_v, int* out_tri, float* out_rows, int* out_res,
    int* out_iters, int* out_tests, int* out_ray_tests, void* stream) {
  WalkArgs a = group_args(origin, direction, tmax, ignore_tri, ignore_mesh,
                          ts, root, aabb, cull_aabb, group_aabb, block, ncg,
                          csize, sub_aabb, sub_plane, subk, recull_every,
                          max_trips, chunk_k, gate);
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
    const float* root, const float* aabb, const float* cull_aabb,
    const float* group_aabb, const float* block, int ncg, int csize,
    const float* sub_aabb, const float* sub_plane, int subk,
    int cull, int pretest, int recull_every, int max_trips, int chunk_k,
    int gate, float* out_t, int* out_code, int* out_res, int* out_iters,
    int* out_tests, int* out_ray_tests, void* stream) {
  WalkArgs a = group_args(origin, direction, tmax, ignore_tri, ignore_mesh,
                          ts, root, aabb, cull_aabb, group_aabb, block, ncg,
                          csize, sub_aabb, sub_plane, subk, recull_every,
                          max_trips, chunk_k, gate);
  set_outputs(a, out_t, out_code, out_res, out_iters, out_tests,
              out_ray_tests);
  return static_cast<int>(dispatch<true>(
      a, n_rays, cull, pretest, static_cast<cudaStream_t>(stream)));
}
