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
//      with coalesced loads, and every thread tests its ray against the
//      cluster's triangles in det-multiplied space;
//   3. settle: a nearest query resolves a ray once its best hit is at or
//      before the next entry bound; an any-hit query at its first accepted
//      hit or once its t bound is at or before the next entry.  The block
//      stops when every ray is resolved, the entries run out or, with
//      max_trips > 0, after that many trips.
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
// prepick_kernel: the same prologue with slab-only entry bounds (the
// reference gives the fitted-plane rows only to its classic walk, and the
// plane changes the visiting order, so exact-t ties would resolve
// differently), then a pick phase that drains up to ``picks`` (F) clusters
// front to back into shared memory (F block-wide argmins, lowest id on
// equal entries) and the tail bound (the least entry left unpicked; FLOAT_MAX
// once drained), then a walk over exactly those picks with no pick per trip.
// Each ray settles against the next pick's entry, or the tail bound after
// the last pick.  Rays of a tile with more than F feasible clusters may come
// back unresolved, holding a true candidate; kernels/fused.py finishes them
// with an unbudgeted classic walk (the rescue pass).  No shade rows.
//
// Every walk writes the per-ray resolved flag: 1 once the ray is proven
// (settled, dead from the start, or its tile's entries ran out), 0 for a ray
// that a trip or pick budget left holding a candidate.
//
// Thread 0 writes per tile the trips (clusters picked and walked: the
// reference's ``iters``), the clusters whose triangles were tested, and the
// ray tests the function needs: the unresolved rays of each tested cluster,
// summed (every thread tests its ray, but a resolved ray's tests change
// nothing).
//
// What bounds it on an H100: per tested cluster each thread does ~45 FP32
// operations and 18 shared-memory loads per triangle, with the same
// address across the warp (broadcast); the classic walk's argmin pick scans
// the entry table (ncg floats in shared memory) once per trip, and a re-cull
// recomputes it; the prepick walk pays up to F such scans before its walk
// and none during it.  The design keeps everything a tile touches more than
// once on chip: the entry table, the picks and the staged block live in
// shared memory, and device memory is read once per tested cluster (18 of
// its 24 * C floats are staged) and per ray.  No asynchronous copies or
// double buffering yet (the reference's ``nbuf``-deep DMA ring has no
// counterpart here).
//
// Each kernel agrees bit for bit with its plain PyTorch walk
// (kernels/fused.py::walk_plain, prepick_plain; walk_common.cuh says how).

#include "walk_common.cuh"

namespace {

// At most 80 registers a thread (__maxnreg__, CUDA 12.4 and later): three
// blocks of 256 threads then fit on an SM.  Uncapped, the nearest
// instantiation takes 86 and only two fit, 8% slower on the bench frame;
// capped it spills 12 bytes and times like the uncapped walk before the trip
// budget and the resolved flag were added (walk_ab.py, H100).
template <bool ANY_HIT, int CULL, bool PRETEST>
__global__ void __maxnreg__(80) walk_kernel(WalkArgs a) {
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
      ent[j] = entry_of(a.aabb, a.plane, a.ncg, j, b);
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
  // No feasible cluster: nothing to hit, every ray is proven.
  if (!(cur.v < kInf)) res = true;
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
    // The trip budget (fused.py:690-697): the rays not yet resolved keep
    // their best as a candidate.
    if (a.max_trips > 0 && trips >= a.max_trips) break;
    if (a.recull_every > 0 && trips % a.recull_every == 0 && nxt.v < kInf) {
      // Re-cull from the unresolved rays' beam (fused.py:668-681).
      const float wcap =
          block_reduce(res ? -kInf : min_nan(bt, tmax0), MaxNanOp(), red_f);
      const Beam b = make_beam(o, d, finite && !res, wcap, red_f);
      for (int j = tid; j < a.ncg; j += blockDim.x) {
        if (ent[j] != consumed()) {
          ent[j] = entry_of(a.aabb, a.plane, a.ncg, j, b);
        }
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
  a.out_res[r] = res ? 1 : 0;
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

template <bool ANY_HIT, int CULL>
__global__ void prepick_kernel(WalkArgs a) {
  extern __shared__ float smem[];
  const int C = a.csize, F = a.picks;
  float* ent = smem;                  // (ncg,) entry bounds
  float* geo = ent + a.ncg;           // (18, csize) staged cluster block
  float* qv = geo + kGeoRows * C;     // (F,) picked entries, non-decreasing
  int* qk = reinterpret_cast<int*>(qv + F);  // (F,) picked cluster ids
  __shared__ float red_f[32];
  __shared__ int red_i[32];

  const int tid = threadIdx.x;
  const bool active = tid < a.ts;
  const size_t r = static_cast<size_t>(blockIdx.x) * a.ts + tid;
  const Ray ray = load_ray(a, r, active);
  const float tmax0 = ray.tmax0;
  bool res = !ray.finite || !(tmax0 > 0.f);
  fill_entries<false>(a, ray, res, ent, red_f);

  // Pick phase (fused.py:810-826): up to F picks front to back, then the
  // tail bound, the least entry left (kInf once drained).
  int m = 0;
  float tail = kInf;
  while (true) {
    const Pick p = pick_next(ent, a.ncg, red_f, red_i);
    __syncthreads();  // thread 0's consumed mark before the next scan
    if (!(p.v < kInf)) break;
    if (m == F) {
      tail = p.v;
      break;
    }
    if (tid == 0) {
      qv[m] = p.v;
      qk[m] = p.k;
    }
    ++m;
  }
  __syncthreads();

  Best best{tmax0, -1, 0.f, 0.f, 1.f, -1};
  const float* o = ray.o;
  const float* d = ray.d;
  const float w[3] = {d[1] * o[2] - d[2] * o[1], d[2] * o[0] - d[0] * o[2],
                      d[0] * o[1] - d[1] * o[0]};
  // No feasible cluster: nothing to hit, every ray is proven.
  if (m == 0) res = true;
  int trips = 0, ray_tests = 0;
  bool settled = __syncthreads_and(res);
  // Walk exactly the picks (fused.py:862-933).
  for (int s = 0; s < m && !settled; ++s) {
    ++trips;
    const int k = qk[s];
    ray_tests += stage(a, k, geo, res);
    test_staged<ANY_HIT, CULL>(geo, C, 0, C, k, ray, w, best);
    const float vn = s + 1 < m ? qv[s + 1] : tail;
    res = res || (ANY_HIT ? (best.code >= 0 || tmax0 <= vn) : (best.t <= vn));
    settled = __syncthreads_and(res);
  }
  write_out<ANY_HIT>(a, r, active, best, res, trips, trips, ray_tests);
}

// Dynamic shared memory of a block: the entry table and one staged cluster
// block, and for the prepick walk F picks (entry and id).
size_t smem_bytes(const WalkArgs& a, bool prepick) {
  return sizeof(float) * (static_cast<size_t>(a.ncg) +
                          static_cast<size_t>(kGeoRows) * a.csize) +
         (prepick ? 8 * static_cast<size_t>(a.picks) : 0);
}

template <typename Kernel>
cudaError_t launch_walk(Kernel kernel, const WalkArgs& a, int n_rays,
                        bool prepick, cudaStream_t stream) {
  return launch(kernel, a, n_rays, smem_bytes(a, prepick), stream);
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
    const float* block, int ncg, int csize, const float* tri_shade, int cull,
    int pretest, int recull_every, int max_trips, float* out_t, int* out_code,
    float* out_u, float* out_v, int* out_tri, float* out_rows, int* out_res,
    int* out_iters, int* out_tests, int* out_ray_tests, void* stream) {
  WalkArgs a = walk_args(origin, direction, tmax, ignore_tri, ignore_mesh,
                         ts, root, aabb, block, ncg, csize);
  a.plane = plane;
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
    const float* block, int ncg, int csize, int cull, int pretest,
    int recull_every, int max_trips, float* out_t, int* out_code,
    int* out_res, int* out_iters, int* out_tests, int* out_ray_tests,
    void* stream) {
  WalkArgs a = walk_args(origin, direction, tmax, ignore_tri, ignore_mesh,
                         ts, root, aabb, block, ncg, csize);
  a.plane = plane;
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
    const float* root, const float* aabb, const float* block, int ncg,
    int csize, int cull, int picks, float* out_t, int* out_code,
    float* out_u, float* out_v, int* out_tri, int* out_res, int* out_iters,
    int* out_tests, int* out_ray_tests, void* stream) {
  WalkArgs a = walk_args(origin, direction, tmax, ignore_tri, ignore_mesh,
                         ts, root, aabb, block, ncg, csize);
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
    const float* root, const float* aabb, const float* block, int ncg,
    int csize, int cull, int picks, float* out_t, int* out_code,
    int* out_res, int* out_iters, int* out_tests, int* out_ray_tests,
    void* stream) {
  WalkArgs a = walk_args(origin, direction, tmax, ignore_tri, ignore_mesh,
                         ts, root, aabb, block, ncg, csize);
  a.picks = picks;
  set_outputs(a, out_t, out_code, out_res, out_iters, out_tests,
              out_ray_tests);
  return static_cast<int>(dispatch_prepick<true>(
      a, n_rays, cull, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
