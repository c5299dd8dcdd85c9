// K6: one bounce of the sorted per-bounce mesh engine, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel raytracer_tpu/ops/pallas/wavefront_sorted.py
// _bounce_call / _make_bounce_kernel (the pl.pallas_call at :689).  One
// launch is one bounce of the ray slots the host loop hands it: every slot of
// the frame on the primary bounce, after it only the live prefix of the
// sorted rays (ops/cuda/wavefront_sorted.py):
//   * ray identity: the ray's index (the thread index on the primary bounce,
//     int32 bits in state plane 13 after a sort) gives the Morton pixel
//     (compact1by1 of index / spp) and the sample (index % spp), so random
//     streams and the image assembly do not depend on where a sort put the
//     ray, and no id passes through a float;
//   * PRIMARY generates the camera ray; the Morton padding lanes (outside
//     the frame, or past side^2 pixels) are dead from the start.  Later
//     bounces read the 14 state planes plane-major (plane k of ray i at
//     k * n + i, in 64-bit offsets: coalesced);
//   * closest hit: the sphere stage, then a front-to-back walk over runs of
//     8 top nodes (a run's union bounding sphere gates them), top bounding
//     spheres, 128-column groups and 32-triangle sub-leaves.  The culling
//     distance is min(t_best, root-exit cap).  The walk stops when the
//     warp's largest culling distance is below the next run's entry key
//     (>= walks on through exact ties): the camera's keys on the primary
//     bounce; after it (node_exit) the keys of the reference point nearest
//     the warp's centroid of live origins, less the warp's largest origin
//     distance from that point;
//   * shade (the scatter at bounce b, the bookkeeping), then, except after
//     the last bounce, the next sort key [coarse origin cell | 6-bit
//     direction class | fine origin cell]; dead rays get 0x7FFFFFFF and sort
//     last.  The key is _sort_keys fused into the kernel.
//
// What bounds it on the card: not arithmetic.  At the OBJ-10k frame of
// 512x512, 256 spp, depth 4 the warps' union of node and triangle tests is
// about 3.8e11 operations, some 6 ms at the float32 peak, against ~60 ms of
// bounces: the walk waits on dependent loads (each triangle test read 16
// plane-strided words from the table) and on divergence; and every slot,
// dead or alive, read and wrote its 56-byte state each bounce.  The warp
// of 32 consecutive sorted rays is the culling unit that the TPU's
// (16 x 128)-lane block was: the sort by [cell | direction | cell] fills
// each warp with rays of one neighbourhood and one direction cone, which is
// what its __any_sync votes need.
//
// The design for this card:
//   * a launch covers only the live prefix (dead rays sort last and stay
//     dead), so the later bounces touch a fraction of the slots;
//   * warp-staged sub-leaves (top_staged_walk in path_common.cuh, shared
//     with K3, whose votes test AABBs where K6's test bounding spheres): a
//     top's passing groups and sub-leaves are voted once at its start; each
//     passing sub-leaf's test rows are copied with cp.async into one of the
//     warp's two shared tiles while the previous one is tested, and tested
//     from there as four broadcast 16-byte loads a triangle.  Each sub-leaf
//     votes again just before its test, so the warp tests exactly the
//     sub-leaves, in exactly the order, of the unstaged walk, and ties
//     resolve as before;
//   * PRIMARY is a template parameter (it changes what is read); node_exit
//     and the key output are uniform over a launch, so they are flags.
//
// Numerics: -fmad=false and the Pallas body's operation order, so the plain
// version sorted_bounce_ref gives the same floats; the warp reductions are
// butterflies whose order the plain version repeats.

#include "path_common.cuh"

namespace {

using namespace rt_path;

constexpr int WARP = 32;
constexpr int SUB = 32, GROUP_SUBS = 4, RUN = 8;
constexpr int ST_OX = 0, ST_OY = 1, ST_OZ = 2, ST_DX = 3, ST_DY = 4,
              ST_DZ = 5, ST_TPR = 6, ST_TPG = 7, ST_TPB = 8, ST_RR = 9,
              ST_RG = 10, ST_RB = 11, ST_ALIVE = 12, ST_RIDX = 13;

struct Params {
  const float *sph;
  const float *sphc_b;
  const int *sphc_r;
  const float *tri;
  const float *subb;
  const int *subn;
  const float *grpb;
  const float *topb;
  const int *topr;
  const int *order;
  const float *keys;
  const float *crunb;
  const float *refp;
  const int *norder;
  const float *nkeys;
  const float *nrunb;
  const float *root;
  const float *klo;
  const float *khi;
  const float *cam;
  const float *state_in;
  float *state_out;
  int *keys_out;  // null after the last bounce
  int n_sph, n_sphc, n_subs, n_tops, n_refs, n;
  int width, height, spp, npix_m;
  unsigned seed_word;
  int bounce, node_exit;
};

// _part1by2: the low 10 bits of x spread over every 3rd bit
__device__ __forceinline__ int part1by2(int x) {
  x = x & 0x3FF;
  x = (x | (x << 16)) & 0x030000FF;
  x = (x | (x << 8)) & 0x0300F00F;
  x = (x | (x << 4)) & 0x030C30C3;
  return (x | (x << 2)) & 0x09249249;
}

// _compact1by1: the even bits of x (x >= 0)
__device__ __forceinline__ int compact1by1(int x) {
  x = x & 0x55555555;
  x = (x | (x >> 1)) & 0x33333333;
  x = (x | (x >> 2)) & 0x0F0F0F0F;
  x = (x | (x >> 4)) & 0x00FF00FF;
  return (x | (x >> 8)) & 0x0000FFFF;
}

// the culled front-to-back walk over runs -> tops -> groups -> sub-leaves,
// a top's passing sub-leaves staged through the warp's tiles
template <bool PRIMARY>
__device__ __forceinline__ void sorted_walk(const Params &p, const Ray &r,
                                            bool alive, float t_cap,
                                            bool use_node, int ref_i,
                                            float dmax, Hit &h, float *tiles,
                                            int lane) {
  const int C = p.n_tops;
  const int R8 = (C + RUN - 1) / RUN;
  const int G = p.n_subs / GROUP_SUBS;
  const int n_cols = p.n_subs * SUB;
  auto group_ok = [&](int g) {
    return __any_sync(FULL_MASK, alive && bound_test(p.grpb, G, g, r,
                                                     fminf(h.t, t_cap)));
  };
  auto sub_ok = [&](int li) {
    return __any_sync(FULL_MASK, alive && bound_test(p.subb, p.n_subs, li, r,
                                                     fminf(h.t, t_cap)));
  };
  for (int ri = 0; ri < R8; ++ri) {
    const int ki = min(ri * RUN, C - 1);
    const float exit_key = PRIMARY    ? p.keys[ki]
                           : use_node ? p.nkeys[ref_i * C + ki] - dmax
                                      : -1.0f;
    if (!(warp_max(fminf(h.t, t_cap)) >= exit_key)) break;
    if (PRIMARY || use_node) {
      const bool run_p =
          PRIMARY ? bound_test(p.crunb, R8, ri, r, fminf(h.t, t_cap))
                  : bound_test(p.nrunb, p.n_refs * R8, ref_i * R8 + ri, r,
                               fminf(h.t, t_cap));
      if (!__any_sync(FULL_MASK, alive && run_p)) continue;
    }
    const int hi = min(ri * RUN + RUN, C);
    for (int oi = ri * RUN; oi < hi; ++oi) {
      const int ci = use_node ? p.norder[ref_i * C + oi] : p.order[oi];
      if (!__any_sync(FULL_MASK,
                      alive && bound_test(p.topb, C, ci, r,
                                          fminf(h.t, t_cap))))
        continue;
      // the top's passing sub-leaves, staged (the host side checks that a
      // top spans at most 8 groups: 32 bits)
      top_staged_walk(p.topr[ci], p.topr[C + ci], p.tri, n_cols, p.subn, r,
                      h, tiles, lane, group_ok, sub_ok);
    }
  }
}

template <bool PRIMARY>
__global__ void __launch_bounds__(THREADS)
    sorted_bounce_kernel(const Params p) {
  __shared__ __align__(16) float tiles[THREADS / WARP][2 * STAGE_FLOATS];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if ((i & ~(WARP - 1)) >= p.n) return;  // n is whole warps: warp-uniform
  const size_t n = (size_t)p.n;
  const float *st = p.state_in;

  // ---- ray identity from the ray index ----
  const int ridx = PRIMARY ? i : __float_as_int(st[ST_RIDX * n + i]);
  const int m = ridx / p.spp;
  const int s = ridx - m * p.spp;
  const int col = compact1by1(m);
  const int row = compact1by1(m >> 1);
  const int prow_c = min(row, p.height - 1);
  const int pcol_c = min(col, p.width - 1);
  const unsigned pix_u = (unsigned)(prow_c * p.width + pcol_c) + p.seed_word;

  // ---- ray state ----
  Ray r;
  PathColor c;
  float alive_f;
  if (PRIMARY) {
    const bool active0 = (row < p.height) && (col < p.width) && (m < p.npix_m);
    unsigned ju = pix_u, jv = (unsigned)s, jw = 0u;
    pcg3d(ju, jv, jw);
    const float w1 = (float)(p.width - 1);
    const float h1 = (float)(p.height - 1);
    r = camera_ray(p.cam, ((float)pcol_c + u01(ju)) / w1,
                   ((float)prow_c + u01(jv)) / h1);
    c = PathColor{1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f};
    alive_f = active0 ? 1.0f : 0.0f;
  } else {
    r.ox = st[ST_OX * n + i];
    r.oy = st[ST_OY * n + i];
    r.oz = st[ST_OZ * n + i];
    r.dx = st[ST_DX * n + i];
    r.dy = st[ST_DY * n + i];
    r.dz = st[ST_DZ * n + i];
    c.tpr = st[ST_TPR * n + i];
    c.tpg = st[ST_TPG * n + i];
    c.tpb = st[ST_TPB * n + i];
    c.rr = st[ST_RR * n + i];
    c.rg = st[ST_RG * n + i];
    c.rb = st[ST_RB * n + i];
    alive_f = st[ST_ALIVE * n + i];
  }
  const bool alive = alive_f > 0.5f;

  // ---- closest hit: spheres, then the triangle walk ----
  Hit h = no_hit();
  sphere_hits(p.sph, p.n_sph, p.sphc_b, p.sphc_r, p.n_sphc, r, alive, h);

  const float t_cap = root_exit_cap(p.root, r, alive);

  // secondary exit: the reference point nearest the warp's live centroid
  const bool use_node = !PRIMARY && p.node_exit;
  int ref_i = 0;
  float dmax = 0.0f;
  if (use_node) nearest_ref(p.refp, p.n_refs, r, alive, alive_f, ref_i, dmax);
  sorted_walk<PRIMARY>(p, r, alive, t_cap, use_node, ref_i, dmax, h,
                       tiles[threadIdx.x / WARP], threadIdx.x & (WARP - 1));
  resolve_tri_normals(h);
  const bool cont = shade(pix_u, s, p.bounce, r, h, alive, c);

  float *out = p.state_out;
  out[ST_OX * n + i] = r.ox;
  out[ST_OY * n + i] = r.oy;
  out[ST_OZ * n + i] = r.oz;
  out[ST_DX * n + i] = r.dx;
  out[ST_DY * n + i] = r.dy;
  out[ST_DZ * n + i] = r.dz;
  out[ST_TPR * n + i] = c.tpr;
  out[ST_TPG * n + i] = c.tpg;
  out[ST_TPB * n + i] = c.tpb;
  out[ST_RR * n + i] = c.rr;
  out[ST_RG * n + i] = c.rg;
  out[ST_RB * n + i] = c.rb;
  out[ST_ALIVE * n + i] = cont ? 1.0f : 0.0f;
  out[ST_RIDX * n + i] = __int_as_float(ridx);
  if (p.keys_out == nullptr) return;

  // ---- the next sort key (_sort_keys) ----
  const float spx = fmaxf(p.khi[0] - p.klo[0], KEY_SPAN_MIN);
  const float spy = fmaxf(p.khi[1] - p.klo[1], KEY_SPAN_MIN);
  const float spz = fmaxf(p.khi[2] - p.klo[2], KEY_SPAN_MIN);
  const int mort = (part1by2(key_cell<128>(r.ox, p.klo[0], spx)) << 2) |
                   (part1by2(key_cell<128>(r.oy, p.klo[1], spy)) << 1) |
                   part1by2(key_cell<128>(r.oz, p.klo[2], spz));
  const int dir6 = (key_dir(r.dx) << 4) | (key_dir(r.dy) << 2) | key_dir(r.dz);
  const int key = ((mort >> 12) << 18) | (dir6 << 12) | (mort & 0xFFF);
  p.keys_out[i] = cont ? key : KEY_DEAD;
}

}  // namespace

// Launch one K6 bounce over n ray slots (whole warps) on `stream`: on the
// primary bounce every slot of the frame (n >= side^2 * spp), after it the
// live prefix of the sorted state (any whole warps).  Tables
// are the row-major device arrays of ops/cuda/wavefront_sorted.py's
// SortedTables: sph (11, n_sph), sphere clusters (may be null, n_sphc 0),
// tri (24, n_subs * 32), sub bounds (4, n_subs), sub counts (n_subs), group
// bounds (4, n_subs / 4), top bounds (4, n_tops), top ranges (2, n_tops),
// camera order / keys (n_tops), camera run bounds (4, R8), refp
// (4, n_refs), node orders / keys (n_refs, n_tops), node run bounds
// (4, n_refs * R8), root (4), klo / khi (3), cam (12).  state_in (14, n) is
// null on the primary bounce; writes state_out (14, n) and, unless keys_out
// is null, keys_out (n).  side is the Morton square's power-of-two side.
// Returns cudaGetLastError() after the launch.
extern "C" int rt_sorted_bounce(
    const float *sph, int n_sph, const float *sphc_b, const int *sphc_r,
    int n_sphc, const float *tri, const float *subb, const int *subn,
    int n_subs, const float *grpb, const float *topb, const int *topr,
    int n_tops, const int *order, const float *keys, const float *crunb,
    const float *refp, int n_refs, const int *norder, const float *nkeys,
    const float *nrunb, const float *root, const float *klo,
    const float *khi, const float *cam, const float *state_in,
    float *state_out, int *keys_out, int n, int width, int height, int spp,
    int side, unsigned int seed_word, int bounce, int primary, int node_exit,
    void *stream) {
  if (n < WARP || n % WARP || width < 1 || height < 1 || spp < 1 ||
      n_sph < 1 || n_subs < 1 || n_subs % GROUP_SUBS || n_tops < 1 ||
      n_refs < 1 || side < 2 || (side & (side - 1)) || side > 32768 ||
      side < width || side < height ||
      (primary && (long long)side * side * spp > (long long)n) ||
      (!primary && state_in == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.sph = sph;
  p.sphc_b = sphc_b;
  p.sphc_r = sphc_r;
  p.tri = tri;
  p.subb = subb;
  p.subn = subn;
  p.grpb = grpb;
  p.topb = topb;
  p.topr = topr;
  p.order = order;
  p.keys = keys;
  p.crunb = crunb;
  p.refp = refp;
  p.norder = norder;
  p.nkeys = nkeys;
  p.nrunb = nrunb;
  p.root = root;
  p.klo = klo;
  p.khi = khi;
  p.cam = cam;
  p.state_in = state_in;
  p.state_out = state_out;
  p.keys_out = keys_out;
  p.n_sph = n_sph;
  p.n_sphc = n_sphc;
  p.n_subs = n_subs;
  p.n_tops = n_tops;
  p.n_refs = n_refs;
  p.n = n;
  p.width = width;
  p.height = height;
  p.spp = spp;
  p.npix_m = side * side;
  p.seed_word = seed_word;
  p.bounce = bounce;
  p.node_exit = node_exit;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (primary)
    sorted_bounce_kernel<true><<<blocks, THREADS, 0, s>>>(p);
  else
    sorted_bounce_kernel<false><<<blocks, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}
