// Cluster walk kernels: nearest-hit and any-hit ray queries against the
// cluster tables of raytpu_torch/accel/clusters.py.
//
// walk_kernel<false, CULL, false> replaces raytpu/kernels/fused.py::
// _tlane_kernel as the render path runs it (nearest hit with the winner's u,
// v, triangle id and shade row); walk_kernel<true, CULL, false> replaces
// _fused_kernel with any_hit=True (shadow occlusion).  PRETEST=true with a
// runtime recull_every replaces _fused_kernel's two walk opt-ins, ``pretest``
// (fused.py:547-570, :598-606, :644-645) and ``recull_every``
// (fused.py:668-681), for nearest (the instanced render's default) and
// any-hit queries.  A runtime ``max_trips`` replaces _fused_kernel's trip
// budget (fused.py:690-697), the first phase of the two-phase compaction.
// prepick_kernel<ANY_HIT, CULL> replaces _prepick_kernel
// (fused.py:732-956).  CULL is 0 (no culling), 1 (backface culling) or 2
// (the mirrored "reverse" culling of shadow rays cast from the light).
// subwalk.cu holds the walk with several picks per trip and the subcluster
// walk; walk_common.cuh the parts they share.
//
// walk_kernel: one thread block walks one tile of rays, one ray per thread:
//   1. prologue: per-ray finite mask and root-box t cap; the tile's beam
//      (origin box and direction box over its finite rays); a conservative
//      entry bound for every cluster (slab interval intersected with the
//      fitted-plane interval, or the slab interval alone when the table has
//      no planes) into shared memory;
//   2. walk: a block-wide argmin picks the nearest remaining cluster (lowest
//      id on equal entries), its geometry block is staged into shared memory
//      and the cluster's triangles are tested in det-multiplied space;
//   3. settle: a nearest query resolves a ray once its best hit is at or
//      before the next entry bound; an any-hit query at its first accepted
//      hit or once its t bound is at or before the next entry.  The block
//      stops when every ray is resolved, the entries run out or, with
//      max_trips > 0, after that many trips.
//
// PRETEST: before a picked cluster is tested, each thread slab-tests its ray
// against the cluster's box (the aabb table, equal to block rows 18-23,
// widened by the root margin) up to its cap min(best_t, t_max), -inf once
// resolved; a block vote skips both the staging and the triangle tests when
// no ray can reach the box.  recull_every > 0: every that many trips, after
// the settle check and while the block walks on, the entry bounds of the
// clusters not yet consumed are rebuilt from the beam of the unresolved rays
// only, pruned at the largest of their caps.  A consumed cluster's entry is
// +inf (above every bound, FLOAT_MAX included).  A sub-beam's bounds are
// never below the beam's in IEEE arithmetic, so picks stay non-decreasing.
//
// prepick_kernel: the same prologue with slab-only entry bounds (the
// reference gives the fitted-plane rows only to its classic walk, and the
// plane changes the visiting order, so exact-t ties would resolve
// differently), then a walk over the first ``picks`` (F) clusters front to
// back (lowest id on equal entries), with no re-cull: each ray settles
// against the next pick's entry, or the tail bound (the least entry left
// unpicked; FLOAT_MAX once drained) after the last pick.  Rays of a tile
// with more than F feasible clusters may come back unresolved, holding a
// true candidate; kernels/fused.py finishes them with an unbudgeted classic
// walk (the rescue pass).  No shade rows.  The reference drains the F picks
// before its walk; measured per trip with clock64 stamps (walk_split.py
// --kernel prepick) that drain, a full scan of the entry table a pick, took
// 14-17% of the bench frame's block clocks, the prologue 19-23% and scalar
// pair tests 57-59%, while a tile walks 7.5 of its 64 picks on average.
// Entries never change after the prologue, so pick s + 1 (or the tail bound)
// is the same whether it is drained up front or taken just before trip s
// settles: the kernel takes it then, from the threads' least entries (two
// REDUX reductions and a barrier, walk_common.cuh block_lexmin and consume),
// and copies its rows with cp.async while pick s is tested.  The tests are
// the classic walk's: float4 rows with the warp early-outs, spread over the
// idle threads when few rays are unresolved; the prologue is the classic
// walk's group pre-cull (cull_entries).
//
// Every walk writes the per-ray resolved flag: 1 once the ray is proven
// (settled, dead from the start, or its tile's entries ran out), 0 for a ray
// that a trip or pick budget left holding a candidate.
//
// Thread 0 writes per tile the trips (clusters picked and walked: the
// reference's ``iters``), the clusters whose triangles were tested, and the
// ray tests the function needs: the unresolved rays of each tested cluster,
// summed.
//
// What bounds walk_kernel on an H100, and what its design does about it.
// A trip is a serial chain: pick, pretest, stage, test, settle, re-cull;
// the tiles of a call run in parallel, three blocks of 256 threads an SM.
// Measured per trip with clock64 stamps (walk_split.py on an H100) before
// this design: on the bench frame the pair tests took 68% of the block
// time and the entry-table prologue 21%; on the instanced frame's
// reflection walks a call lasted as long as its longest tile (7,201 trips
// at ~16k clocks a trip, 74 of them tested), whose trip was 66% re-cull,
// 23% pick scan and 7% pretest.  With it, that tile's trip is ~7.9k
// clocks: four barrier-separated phases of 0.4k-2.8k each.
//   - Pair tests: each staged geometry row is read as float4 across 4
//     adjacent lanes (4 LDS.128 broadcasts a pair instead of 16 LDS.32), the
//     4 pairs tested in lane order; when no pair of the warp can pass the u
//     test (the first of its cull's sign tests), v, t and the acceptance
//     are skipped; the ids rows and the division only for accepted pairs.
//     Clusters whose size is not a multiple of 4 keep the scalar loop.
//   - Few unresolved rays (at most half the block): their pair tests are
//     spread over the idle threads, G threads a ray (G a power of two, at
//     most 32, within a warp), each on its share of the lanes; the group
//     reduces (t, lane) lexicographically and the ray takes the result only
//     if its t is strictly below its best: exactly what the ascending loop
//     with ``dist < best`` computes.  Resolved rays are not tested (their
//     tests change nothing: every later entry is at or beyond their best).
//   - Pick: each thread keeps the least (entry, id) of the entries it owns
//     (ids = tid mod threads); a pick is two warp reductions (REDUX) of
//     those, a barrier and two more.  After the trip's vote the owner's warp
//     refreshes the owner's record, a lane an entry.
//   - Re-cull, lazily: a re-cull stores the new beam (warp reductions of
//     ordered keys) and starts a new epoch; every entry keeps the epoch that
//     computed it, and each thread recomputes its least entry at once.  A
//     pick takes the least entry of the newest epoch unless an older entry
//     is at or below it (by entry, then id); then each thread with such an
//     entry recomputes its least one under the newest beam and the pick is
//     repeated.  Older entries are lower bounds of their newest values (and
//     an infeasible one stays infeasible), so the picks and their entries
//     are the eager re-cull's, with a few entry bounds computed a trip
//     instead of every entry every re-cull.  Every 256 epochs all entries
//     are recomputed, so an epoch byte never aliases.
//   - Pick ahead, stage asynchronously: entries do not change between the
//     pick of the cluster under test and the next pick, so the next cluster
//     is picked first and its 18 rows go into a second buffer with cp.async
//     while this one is tested.  With PRETEST each thread keeps the box of
//     its least entry in a slot, fetched with cp.async when that entry
//     changes, so the picked cluster's box is usually there; the vote is
//     taken after the settle, with the caps the next trip starts with, and
//     only a viable cluster is staged.
//   - The prologue tests a group of 32 consecutive clusters first (a box
//     holding theirs, kernels/fused.py::group_boxes) and computes the
//     entry bounds of a reachable group only, two groups an iteration, so
//     that their device-memory loads overlap.

// Each kernel agrees bit for bit with its plain PyTorch walk
// (kernels/fused.py::walk_plain, prepick_plain; walk_common.cuh says how).

#include "walk_common.cuh"

#include <cstdint>

namespace {

// ---- walk_kernel's parts ---------------------------------------------------

struct Own {  // the entries a thread owns: ids tid, tid + threads, ...
  float cv;   // least entry of the newest epoch (kInf: none)
  int ck;     // its id (INT_MAX: none)
  float sv;   // least entry of an older epoch
  int sk;
};

// Block-wide least (v, k) and least (u, l), each by entry, then id; the
// second comes back in ``second``.  Every thread calls it, with scratch as
// block_lexmin's.
__device__ Pick block_lexmin2(float v, int k, float u, int l, Pick& second,
                              float* red_f, int* red_i) {
  warp_lexmin(v, k);
  warp_lexmin(u, l);
  const int lane = threadIdx.x & 31, w0 = threadIdx.x >> 5;
  if (lane == 0) {
    red_f[w0] = v;
    red_i[w0] = k;
    red_f[32 + w0] = u;
    red_i[32 + w0] = l;
  }
  __syncthreads();
  const bool in = lane < static_cast<int>(blockDim.x >> 5);
  v = in ? red_f[lane] : kInf;
  k = in ? red_i[lane] : INT_MAX;
  u = in ? red_f[32 + lane] : kInf;
  l = in ? red_i[32 + lane] : INT_MAX;
  warp_lexmin(v, k);
  warp_lexmin(u, l);
  second = {u, l};
  return {v, k};
}

// Rescan the thread's own entries: the least of the newest epoch and the
// least older one (consumed and infeasible entries are neither).
__device__ __forceinline__ Own rescan(const float* ent,
                                      const unsigned char* ep, int ncg,
                                      bool lazy, unsigned char epoch) {
  Own w{kInf, INT_MAX, kInf, INT_MAX};
#pragma unroll 4
  for (int j = threadIdx.x; j < ncg; j += blockDim.x) {
    const float e = ent[j];
    if (!lazy || ep[j] == epoch) {
      if (e < w.cv) {
        w.cv = e;
        w.ck = j;
      }
    } else if (e < w.sv) {
      w.sv = e;
      w.sk = j;
    }
  }
  return w;
}

// Start copying cluster k's box (aabb rows 0-5) into ``bx``.
__device__ __forceinline__ void fetch_box(const WalkArgs& a, int k,
                                          float* bx) {
#pragma unroll
  for (int c = 0; c < 6; ++c) cp_async4(bx + c, a.aabb + c * a.ncg + k);
}

// The next pick: the least remaining entry (lowest id on equal entries),
// consumed; every thread calls it.  Lazily re-culled entries at or below
// the least entry of the newest epoch are recomputed under the newest beam
// first, the least one of each thread a round.  The owner of the pick
// refreshes its record later (refresh_owner).  PRETEST: a thread whose
// least entry changes starts fetching that cluster's box into its slot.
template <bool PRETEST>
__device__ Pick pick_lazy(const WalkArgs& a, float* ent, unsigned char* ep,
                          Own* own, float* boxes, bool lazy,
                          unsigned char epoch, const Beam& beam,
                          float* pick_f, int* pick_i, unsigned& parity) {
  const int tid = threadIdx.x;
  Pick p;
  while (true) {
    const Own w = own[tid];
    float* red_f = pick_f + 64 * parity;
    int* red_i = pick_i + 64 * parity;
    parity ^= 1u;
    if (!lazy) {
      p = block_lexmin(w.cv, w.ck, red_f, red_i);
      break;
    }
    Pick older;
    p = block_lexmin2(w.cv, w.ck, w.sv, w.sk, older, red_f, red_i);
    if (!lex_less(older.v, older.k, p.v, p.k)) break;
    if (lex_less(w.sv, w.sk, p.v, p.k)) {
      ent[w.sk] = entry_of(a.aabb, a.plane, a.ncg, w.sk, beam);
      ep[w.sk] = epoch;
      const Own n = rescan(ent, ep, a.ncg, true, epoch);
      own[tid] = n;
      if (PRETEST) {
        if (n.ck != w.ck && n.ck != INT_MAX) {
          // An earlier copy into the slot must land first.
          cp_async_wait<0>();
          fetch_box(a, n.ck, boxes + 6 * tid);
        }
        cp_async_commit();
      }
    }
  }
  if (p.v < kInf && p.k % static_cast<int>(blockDim.x) == tid) {
    ent[p.k] = consumed();
  }
  return p;
}

// The owner of the consumed cluster k refreshes its record: its warp reads
// the owner's entries one a lane and reduces them by entry, then id (the
// order of the serial rescan).  PRETEST: the owner starts fetching its new
// least entry's box, and every thread closes a copy group.
template <bool PRETEST>
__device__ __forceinline__ void refresh_owner(const WalkArgs& a, int k,
                                              const float* ent,
                                              const unsigned char* ep,
                                              Own* own, float* boxes,
                                              bool lazy,
                                              unsigned char epoch) {
  const int nt = blockDim.x;
  const int t = k % nt;
  if ((static_cast<int>(threadIdx.x) >> 5) == (t >> 5)) {
    const int lane = threadIdx.x & 31;
    Own w{kInf, INT_MAX, kInf, INT_MAX};
    for (int j = t + nt * lane; j < a.ncg; j += 32 * nt) {
      const float e = ent[j];
      if (!lazy || ep[j] == epoch) {
        if (e < w.cv) {
          w.cv = e;
          w.ck = j;
        }
      } else if (e < w.sv) {
        w.sv = e;
        w.sk = j;
      }
    }
    warp_lexmin(w.cv, w.ck);
    warp_lexmin(w.sv, w.sk);
    if (lane == (t & 31)) {
      own[t] = w;
      if (PRETEST && w.ck != INT_MAX) fetch_box(a, w.ck, boxes + 6 * t);
    }
  }
  if (PRETEST) cp_async_commit();
}

// The pretest vote on the box in ``box`` (fused.py::_slab_viable).
__device__ __forceinline__ bool pretest_vote(const float* box, float margin,
                                             const float o[3],
                                             const float d[3], float cap_r) {
  float s_en = -kInf, s_ex = kInf;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float inv = 1.0f / (d[k] == 0.f ? kTinyDir : d[k]);
    const float t1 = (box[k] - margin - o[k]) * inv;
    const float t2 = (box[3 + k] + margin - o[k]) * inv;
    s_en = max_nan(s_en, min_nan(t1, t2));
    s_ex = min_nan(s_ex, max_nan(t1, t2));
  }
  return __syncthreads_or(s_en <= s_ex && s_ex >= 0.f && s_en < cap_r);
}

// Dynamic shared memory of walk_kernel, in bytes (kernels/fused.py::
// _smem_bytes): the entry table (padded to 4 floats), two staged blocks,
// the tail-mode slots of half the block, each thread's Own record and box
// slot; with the re-cull, an epoch byte per entry.
size_t walk_smem_bytes(const WalkArgs& a) {
  const size_t nt = (a.ts + 31) / 32 * 32;
  const size_t ncg_pad = (static_cast<size_t>(a.ncg) + 3) / 4 * 4;
  return sizeof(float) * (ncg_pad + 2 * static_cast<size_t>(kGeoRows) * a.csize +
                          nt / 2 * kSlotWords + 10 * nt) +
         (a.recull_every > 0 ? static_cast<size_t>(a.ncg) : 0);
}

// ---- walk_kernel -----------------------------------------------------------

// At most 80 registers a thread (__maxnreg__, CUDA 12.4 and later): three
// blocks of 256 threads then fit on an SM (at 86 the walk ran 16-25%
// slower, walk_ab.py on an H100).
template <bool ANY_HIT, int CULL, bool PRETEST>
__global__ void __maxnreg__(80) walk_kernel(WalkArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int C = a.csize;
  const int nt = blockDim.x;
  float* ent = smem;                                   // (ncg,) entries
  float* geo0 = smem + (a.ncg + 3) / 4 * 4;            // 2 x (18, C) blocks
  float* slots = geo0 + 2 * kGeoRows * C;              // (nt / 2, 9)
  Own* own = reinterpret_cast<Own*>(slots + nt / 2 * kSlotWords);  // (nt,)
  float* boxes = reinterpret_cast<float*>(own + nt);   // (nt, 6) box slots
  unsigned char* ep = reinterpret_cast<unsigned char*>(boxes + 6 * nt);
  __shared__ float red_f[13 * 32];
  __shared__ int red_i[32];
  __shared__ float pick_f[2 * 64];  // the picks' two scratch buffers
  __shared__ int pick_i[2 * 64];
  __shared__ Beam beam;
  unsigned parity = 0;

  const int tid = threadIdx.x;
  const bool active = tid < a.ts;
  const size_t r = static_cast<size_t>(blockIdx.x) * a.ts + tid;
  const bool lazy = a.recull_every > 0;
  const bool vec = C % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(a.block) & 15) == 0;
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
  // bound cannot poison its tile; then every entry and the thread's least
  // one, a group of 32 clusters whose box the beam cannot reach without a
  // look at its clusters (cull_entries).
  beam_to_smem(o, d, finite, res ? -kInf : tmax0, beam,
               reinterpret_cast<unsigned*>(red_f));
  {
    // The beam in registers: the bounds below would otherwise read it
    // from shared memory, behind the other blocks' pair-test loads.
    const Beam bm = beam;
    float cv;
    int ck;
    cull_entries(
        a, bm, ent,
        [&](int j) { return entry_of(a.aabb, a.plane, a.ncg, j, bm); },
        [&](int j) {
          if (lazy) ep[j] = 0;
        },
        cv, ck);
    own[tid] = {cv, ck, kInf, INT_MAX};
  }
  unsigned epoch = 0;

  // Per-ray state (fused.py::_walk_tiles).
  Best best{tmax0, -1, 0.f, 0.f, 1.f, -1};
  // Tested clusters and ray tests, kept by thread 0.
  __shared__ int counts[2];
  if (tid == 0) counts[0] = counts[1] = 0;
  int trips = 0;

  if (PRETEST) {
    if (own[tid].ck != INT_MAX) fetch_box(a, own[tid].ck, boxes + 6 * tid);
    cp_async_commit();
  }
  Pick cur = pick_lazy<PRETEST>(a, ent, ep, own, boxes, lazy, 0, beam,
                                pick_f, pick_i, parity);
  // No feasible cluster: nothing to hit, every ray is proven.
  if (!(cur.v < kInf)) res = true;
  bool viable = cur.v < kInf;
  if (PRETEST && viable) {
    cp_async_wait<0>();
    __syncthreads();
    viable = pretest_vote(boxes + 6 * (cur.k % nt), margin, o, d,
                          res ? -kInf : min_nan(best.t, tmax0));
  }
  int b = 0;  // the buffer of the cluster under test
  if (viable) stage_async(a, cur.k, geo0, vec);
  cp_async_commit();
  if (cur.v < kInf) {
    refresh_owner<PRETEST>(a, cur.k, ent, ep, own, boxes, lazy, 0);
  }
  while (cur.v < kInf) {
    ++trips;
    // Pick ahead; without the pretest, stage the next cluster's rows now.
    const Pick nxt = pick_lazy<PRETEST>(
        a, ent, ep, own, boxes, lazy, static_cast<unsigned char>(epoch), beam,
        pick_f, pick_i, parity);
    float* geo = geo0 + b * kGeoRows * C;
    float* geo_next = geo0 + (b ^ 1) * kGeoRows * C;
    if (!PRETEST) {
      if (nxt.v < kInf) stage_async(a, nxt.k, geo_next, vec);
      cp_async_commit();
    }
    if (viable) {
      cp_async_wait<1>();
      const int U = __syncthreads_count(!res);
      if (tid == 0) {
        ++counts[0];
        counts[1] += U;
      }
      const int base = cur.k * C;
      if (2 * U > nt) {
        // Every thread tests its own ray against every lane.
        test_lanes<ANY_HIT, CULL, 1>(geo, C, vec, 0, C, 0, 1, o, d, tmax0,
                                     itri, imesh, base, best);
      } else if (U > 0) {
        // Tail: the U unresolved rays' tests spread over G threads each.
        spread_tests<ANY_HIT, CULL>(geo, C, vec, U, res, slots, red_i, o, d,
                                    tmax0, itri, imesh, base, best);
      }
    }
    res = res || (ANY_HIT ? (best.code >= 0 || tmax0 <= nxt.v)
                          : (best.t <= nxt.v));
    // The next cluster's box, in its owner's slot, lands before the vote.
    if (PRETEST && nxt.v < kInf && nxt.k % nt == tid) cp_async_wait<0>();
    if (__syncthreads_and(res)) break;
    // The trip budget (fused.py:690-697): the rays not yet resolved keep
    // their best as a candidate.
    if (a.max_trips > 0 && trips >= a.max_trips) break;
    bool nviable = nxt.v < kInf;
    if (PRETEST && nviable) {
      // The vote, with the caps the next trip starts with.
      nviable = pretest_vote(boxes + 6 * (nxt.k % nt), margin, o, d,
                             res ? -kInf : min_nan(best.t, tmax0));
      if (nviable) stage_async(a, nxt.k, geo_next, vec);
      cp_async_commit();
    }
    if (nxt.v < kInf) {
      refresh_owner<PRETEST>(a, nxt.k, ent, ep, own, boxes, lazy,
                             static_cast<unsigned char>(epoch));
    }
    if (lazy && trips % a.recull_every == 0 && nxt.v < kInf) {
      // Re-cull from the unresolved rays' beam (fused.py:668-681): a new
      // epoch; the entries are recomputed when they reach the front.
      beam_to_smem(o, d, finite && !res, res ? -kInf : min_nan(best.t, tmax0),
                   beam, reinterpret_cast<unsigned*>(red_f));
      ++epoch;
      const unsigned char e8 = static_cast<unsigned char>(epoch);
      Own w = own[tid];
      if (e8 == 0) {
        // Every 256 epochs, every live entry anew.
        w = {kInf, INT_MAX, kInf, INT_MAX};
        for (int j = tid; j < a.ncg; j += nt) {
          float e = ent[j];
          if (e < kInf) {
            e = entry_of(a.aabb, a.plane, a.ncg, j, beam);
            ent[j] = e;
          }
          ep[j] = 0;
          if (e < w.cv) {
            w.cv = e;
            w.ck = j;
          }
        }
        if (PRETEST) {
          cp_async_wait<0>();
          if (w.ck != INT_MAX) fetch_box(a, w.ck, boxes + 6 * tid);
          cp_async_commit();
        }
      } else {
        if (lex_less(w.cv, w.ck, w.sv, w.sk)) {
          w.sv = w.cv;
          w.sk = w.ck;
        }
        // Every entry is older now: each thread's least one is recomputed
        // at once, as the next pick's first round would.
        if (w.sv < kInf) {
          const int k = w.sk;
          ent[k] = entry_of(a.aabb, a.plane, a.ncg, k, beam);
          ep[k] = e8;
          w = rescan(ent, ep, a.ncg, true, e8);
          if (PRETEST) {
            cp_async_wait<0>();
            if (w.ck != INT_MAX) fetch_box(a, w.ck, boxes + 6 * tid);
          }
        } else {
          w.cv = kInf;
          w.ck = INT_MAX;
        }
        if (PRETEST) cp_async_commit();
      }
      own[tid] = w;
    }
    cur = nxt;
    viable = nviable;
    b ^= 1;
  }
  cp_async_wait<0>();

  if (tid == 0) {
    a.out_iters[blockIdx.x] = trips;
    a.out_tests[blockIdx.x] = counts[0];
    a.out_ray_tests[blockIdx.x] = counts[1];
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

// At most 80 registers a thread: three blocks of 256 threads an SM, as the
// classic walk.
template <bool ANY_HIT, int CULL>
__global__ void __maxnreg__(80) prepick_kernel(WalkArgs a) {
  // The pair tests' early-outs (test4): the det vote pays where many pairs
  // face away, as for shadow rays.
  constexpr int kEarly = ANY_HIT ? 2 : 1;
  extern __shared__ __align__(16) float smem[];
  const int C = a.csize, F = a.picks;
  float* ent = smem;                         // (ncg,) entry bounds
  float* geo0 = smem + (a.ncg + 3) / 4 * 4;  // 2 x (18, C) staged clusters
  float* slots = geo0 + 2 * kGeoRows * C;    // (nt / 2, 9) spread rays
  __shared__ float red_f[13 * 32];
  __shared__ int red_i[32];
  __shared__ float pick_f[2 * 32];  // the picks' two scratch buffers
  __shared__ int pick_i[2 * 32];
  __shared__ Beam beam;
  unsigned parity = 0;

  const int tid = threadIdx.x;
  const bool active = tid < a.ts;
  const size_t r = static_cast<size_t>(blockIdx.x) * a.ts + tid;
  const Ray ray = load_ray(a, r, active);
  const float tmax0 = ray.tmax0;
  bool res = !ray.finite || !(tmax0 > 0.f);
  const bool vec = C % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(a.block) & 15) == 0;
  // Slab-only entries of the tile's beam, pruned at the largest bound of
  // the unresolved rays, and each thread's least one.
  beam_to_smem(ray.o, ray.d, ray.finite, res ? -kInf : tmax0, beam,
               reinterpret_cast<unsigned*>(red_f));
  float cv;
  int ck;
  {
    const Beam bm = beam;
    cull_entries(
        a, bm, ent,
        [&](int j) { return entry_bound<false>(a.aabb, nullptr, a.ncg, j, bm); },
        [](int) {}, cv, ck);
  }

  Best best{tmax0, -1, 0.f, 0.f, 1.f, -1};
  // Pick s: the least entry left (lowest id on equal entries), consumed;
  // its rows go into buffer s % 2.
  auto pick = [&](float* geo, bool take) {
    const Pick p = block_lexmin(cv, ck, pick_f + 32 * parity,
                                pick_i + 32 * parity);
    parity ^= 1u;
    if (take && p.v < kInf) {
      consume(ent, a.ncg, p.k, cv, ck);
      stage_async(a, p.k, geo, vec);
    }
    cp_async_commit();
    return p;
  };
  Pick cur = pick(geo0, true);
  // No feasible cluster: nothing to hit, every ray is proven.
  if (!(cur.v < kInf)) res = true;
  int trips = 0, ray_tests = 0, b = 0;
  bool walk = cur.v < kInf && !__syncthreads_and(res);
  // Walk exactly the first F picks (fused.py:862-933).
  for (int s = 0; walk; ++s) {
    ++trips;
    // Pick ahead: pick s + 1 (the tail bound once s + 1 = F), its rows
    // copied while pick s is tested.
    const bool more = s + 1 < F;
    const Pick nxt = pick(geo0 + (b ^ 1) * kGeoRows * C, more);
    cp_async_wait<1>();
    const int U = __syncthreads_count(!res);
    ray_tests += U;
    const float* geo = geo0 + b * kGeoRows * C;
    const int base = cur.k * C;
    if (2 * U > static_cast<int>(blockDim.x)) {
      test_lanes<ANY_HIT, CULL, kEarly>(geo, C, vec, 0, C, 0, 1, ray.o,
                                        ray.d, tmax0, ray.itri, ray.imesh,
                                        base, best);
    } else {
      spread_tests<ANY_HIT, CULL>(geo, C, vec, U, res, slots, red_i, ray.o,
                                  ray.d, tmax0, ray.itri, ray.imesh, base,
                                  best);
    }
    const float vn = nxt.v < kInf ? nxt.v : kInf;
    res = res || (ANY_HIT ? (best.code >= 0 || tmax0 <= vn) : (best.t <= vn));
    walk = more && nxt.v < kInf && !__syncthreads_and(res);
    cur = nxt;
    b ^= 1;
  }
  cp_async_wait<0>();
  write_out<ANY_HIT>(a, r, active, best, res, trips, trips, ray_tests);
}

// Dynamic shared memory of a prepick block (kernels/fused.py::
// _smem_bytes): the entry table (padded to 4 floats), two staged clusters
// and the spread rays of half the block.
size_t prepick_smem_bytes(const WalkArgs& a) {
  const size_t nt = (a.ts + 31) / 32 * 32;
  return sizeof(float) * ((static_cast<size_t>(a.ncg) + 3) / 4 * 4 +
                          2 * static_cast<size_t>(kGeoRows) * a.csize +
                          nt / 2 * kSlotWords);
}

template <typename Kernel>
cudaError_t launch_walk(Kernel kernel, const WalkArgs& a, int n_rays,
                        bool prepick, cudaStream_t stream) {
  return launch(kernel, a, n_rays,
                prepick ? prepick_smem_bytes(a) : walk_smem_bytes(a), stream);
}

template <bool ANY_HIT, bool PRETEST>
cudaError_t dispatch_cull(const WalkArgs& a, int n_rays, int cull,
                          cudaStream_t stream) {
  switch (cull) {
    case 0: return launch_walk(walk_kernel<ANY_HIT, 0, PRETEST>, a, n_rays, false, stream);
    case 1: return launch_walk(walk_kernel<ANY_HIT, 1, PRETEST>, a, n_rays, false, stream);
    case 2: return launch_walk(walk_kernel<ANY_HIT, 2, PRETEST>, a, n_rays, false, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool ANY_HIT>
cudaError_t dispatch(const WalkArgs& a, int n_rays, int cull, int pretest,
                     cudaStream_t stream) {
  if (a.recull_every < 0 || a.max_trips < 0) return cudaErrorInvalidValue;
  return pretest ? dispatch_cull<ANY_HIT, true>(a, n_rays, cull, stream)
                 : dispatch_cull<ANY_HIT, false>(a, n_rays, cull, stream);
}

template <bool ANY_HIT>
cudaError_t dispatch_prepick(const WalkArgs& a, int n_rays, int cull,
                             cudaStream_t stream) {
  if (a.picks < 1) return cudaErrorInvalidValue;
  switch (cull) {
    case 0: return launch_walk(prepick_kernel<ANY_HIT, 0>, a, n_rays, true, stream);
    case 1: return launch_walk(prepick_kernel<ANY_HIT, 1>, a, n_rays, true, stream);
    case 2: return launch_walk(prepick_kernel<ANY_HIT, 2>, a, n_rays, true, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rt_nearest_hit(
    const float* origin, const float* direction, const float* tmax,
    const int* ignore_tri, const int* ignore_mesh, int n_rays, int ts,
    const float* root, const float* aabb, const float* plane,
    const float* group_aabb, const float* block, int ncg, int csize,
    const float* tri_shade, int cull,
    int pretest, int recull_every, int max_trips, float* out_t, int* out_code,
    float* out_u, float* out_v, int* out_tri, float* out_rows, int* out_res,
    int* out_iters, int* out_tests, int* out_ray_tests, void* stream) {
  WalkArgs a = walk_args(origin, direction, tmax, ignore_tri, ignore_mesh,
                         ts, root, aabb, block, ncg, csize);
  a.plane = plane;
  a.group_aabb = group_aabb;
  a.recull_every = recull_every;
  a.max_trips = max_trips;
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

extern "C" int rt_any_hit(
    const float* origin, const float* direction, const float* tmax,
    const int* ignore_tri, const int* ignore_mesh, int n_rays, int ts,
    const float* root, const float* aabb, const float* plane,
    const float* group_aabb, const float* block, int ncg, int csize,
    int cull, int pretest,
    int recull_every, int max_trips, float* out_t, int* out_code,
    int* out_res, int* out_iters, int* out_tests, int* out_ray_tests,
    void* stream) {
  WalkArgs a = walk_args(origin, direction, tmax, ignore_tri, ignore_mesh,
                         ts, root, aabb, block, ncg, csize);
  a.plane = plane;
  a.group_aabb = group_aabb;
  a.recull_every = recull_every;
  a.max_trips = max_trips;
  set_outputs(a, out_t, out_code, out_res, out_iters, out_tests,
              out_ray_tests);
  return static_cast<int>(dispatch<true>(
      a, n_rays, cull, pretest, static_cast<cudaStream_t>(stream)));
}

extern "C" int rt_prepick_nearest(
    const float* origin, const float* direction, const float* tmax,
    const int* ignore_tri, const int* ignore_mesh, int n_rays, int ts,
    const float* root, const float* aabb, const float* group_aabb,
    const float* block, int ncg, int csize, int cull, int picks,
    float* out_t, int* out_code, float* out_u, float* out_v, int* out_tri,
    int* out_res, int* out_iters, int* out_tests, int* out_ray_tests,
    void* stream) {
  WalkArgs a = walk_args(origin, direction, tmax, ignore_tri, ignore_mesh,
                         ts, root, aabb, block, ncg, csize);
  a.group_aabb = group_aabb;
  a.picks = picks;
  set_outputs(a, out_t, out_code, out_res, out_iters, out_tests,
              out_ray_tests);
  a.out_u = out_u;
  a.out_v = out_v;
  a.out_tri = out_tri;
  return static_cast<int>(dispatch_prepick<false>(
      a, n_rays, cull, static_cast<cudaStream_t>(stream)));
}

extern "C" int rt_prepick_any_hit(
    const float* origin, const float* direction, const float* tmax,
    const int* ignore_tri, const int* ignore_mesh, int n_rays, int ts,
    const float* root, const float* aabb, const float* group_aabb,
    const float* block, int ncg, int csize, int cull, int picks,
    float* out_t, int* out_code, int* out_res, int* out_iters,
    int* out_tests, int* out_ray_tests, void* stream) {
  WalkArgs a = walk_args(origin, direction, tmax, ignore_tri, ignore_mesh,
                         ts, root, aabb, block, ncg, csize);
  a.group_aabb = group_aabb;
  a.picks = picks;
  set_outputs(a, out_t, out_code, out_res, out_iters, out_tests,
              out_ray_tests);
  return static_cast<int>(dispatch_prepick<true>(
      a, n_rays, cull, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
