// K3: one pass of the binned per-bounce engine, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel raytracer_tpu/ops/pallas/wavefront_binned.py
// _pass_call / _make_pass_kernel (the pl.pallas_call at :818).  One launch
// is one bounce of every ray slot:
//   * ray identity: the slot id (the thread index on the primary pass, state
//     plane 13 after a regroup) decodes through the tile geometry into the
//     pixel and the global sample index, so random streams and the image
//     assembly do not depend on where the regroup put the ray;
//   * PRIMARY generates the camera ray; later passes read the 15 state
//     planes plane-major (plane k of slot i at k * n + i: coalesced);
//   * closest hit: the sphere stage, then a front-to-back walk over runs of
//     8 top nodes (a run bound gates them), top AABBs, 128-column groups and
//     32-triangle sub-leaves; the culling distance is min(t_best, t_cap),
//     t_cap being the root-sphere exit and, after the primary pass, the
//     previous selection's walk-exit bound.  The walk stops when the warp's
//     largest culling distance is below the next run's entry key: the
//     camera's keys on the primary pass; after it (node_exit) the keys of
//     the reference point nearest the warp's centroid of live origins,
//     less the warp's largest origin distance from that point;
//   * shade (the scatter at the bounce index b, the bookkeeping);
//   * next-top selection: the nearest top AABB the new ray enters (scanned
//     flat, or through supertops of 16 with a warp vote deciding each
//     descent; both give the same keys for live rays) and the farthest exit
//     over what it overlaps; the key is [top | 6-bit direction class |
//     9-bit origin cell], live rays with no candidate get KEY_NOMESH and dead
//     rays KEY_DEAD, so they sort last and the caps stay exact.
//
// What bounds it on the card: not arithmetic (the rays' own node and
// triangle tests are a few microseconds at the float32 peak) but the walk's
// dependent loads and divergence; the state costs 2 x 60 bytes per live ray
// and pass (read and written once).  A warp of 32 consecutive regrouped
// slots is the culling unit that the TPU's (block_rows x 128)-lane block
// was: the regroup by next-top key fills each warp with rays bound for the
// same top, which is what its __any_sync votes need.  The design for this
// card (the TPU kernel's group DMA ring has no counterpart):
//   * K6's walk (top_staged_walk in path_common.cuh): a passing top's
//     groups and sub-leaves voted once into a 32-bit mask, each masked
//     sub-leaf's 16 test rows copied with cp.async into one of the warp's
//     two shared tiles while the one before it is tested, each re-voted
//     before its test; bound tests are monotone in t_best, so the warp tests
//     the sub-leaves, in the order, of the sequential walk and ties go as
//     before;
//   * a warp with no live lane (the capped tail's dead slots, the padding
//     outside the image) skips the closest hit and writes what the full
//     pass writes.
// PRIMARY is a template parameter (it changes what is read); is_last,
// node_exit and the supertop scan are uniform over a launch, so they are
// plain flags and cost a predicate, not another instantiation.
//
// Numerics: -fmad=false and the Pallas body's operation order, so the plain
// version binned_pass_ref gives the same floats; the warp reductions are
// butterflies whose order the plain version repeats.

#include "path_common.cuh"

namespace {

using namespace rt_path;

constexpr int WARP = 32;
constexpr int TILE_SLOTS = 16 * 128;    // slots of one image tile
constexpr int LG_TILE = 11;
constexpr int SUB = 32, GROUP_SUBS = 4, RUN = 8, SUPER = 16;
constexpr int ST_OX = 0, ST_OY = 1, ST_OZ = 2, ST_DX = 3, ST_DY = 4,
              ST_DZ = 5, ST_TPR = 6, ST_TPG = 7, ST_TPB = 8, ST_RR = 9,
              ST_RG = 10, ST_RB = 11, ST_ALIVE = 12, ST_SLOT = 13,
              ST_EXITB = 14;
constexpr int KEY_SUB_BITS = 15;
constexpr int KEY_NOMESH = 0x7FFE0000;

struct Params {
  const float *sph;
  const float *sphc_b;
  const int *sphc_r;
  const float *tri;
  const int *subn;
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
  const float *suba;
  const float *grpa;
  const float *topa;
  const float *supa;
  const float *topap;
  const float *cam;
  const float *state_in;
  float *state_out;
  int *keys_out;
  int n_sph, n_sphc, n_subs, n_tops, n_refs, n_super, n;
  int width, height;
  unsigned seed_word;
  int bounce, samp_off;
  int lg_spp, tw, lg_tw, th, ntx;
  int ty_off, ty_stride;  // this render's tile rows: ty_off + k * ty_stride
  int is_last, node_exit, use_super;
};

// slab test of box ci of a (nc columns): entry and exit distance, and
// whether the ray overlaps the box ahead of it
__device__ __forceinline__ bool box_entry(const float *__restrict__ a, int nc,
                                          int ci, const Ray &r, float ivx,
                                          float ivy, float ivz, float &tnear,
                                          float &tfar) {
  const float tx0 = (a[0 * nc + ci] - r.ox) * ivx;
  const float tx1 = (a[3 * nc + ci] - r.ox) * ivx;
  const float ty0 = (a[1 * nc + ci] - r.oy) * ivy;
  const float ty1 = (a[4 * nc + ci] - r.oy) * ivy;
  const float tz0 = (a[2 * nc + ci] - r.oz) * ivz;
  const float tz1 = (a[5 * nc + ci] - r.oz) * ivz;
  tnear = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                fmaxf(fminf(tz0, tz1), 0.0f));
  tfar = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return (tnear <= tfar) && (tfar > T_MIN);
}

// the culled front-to-back walk over the sorted tables: runs of tops, each
// passing top's groups and sub-leaves through top_staged_walk (K6's walk
// with AABB votes), its sub-leaves staged through the warp's tiles
template <bool PRIMARY>
__device__ __forceinline__ void binned_walk(const Params &p, const Ray &r,
                                            bool alive, float t_cap,
                                            bool use_node, int ref_i,
                                            float dmax, Hit &h, float *tiles,
                                            int lane) {
  const int C = p.n_tops;
  const int R8 = (C + RUN - 1) / RUN;
  const int G = p.n_subs / GROUP_SUBS;
  const int n_cols = p.n_subs * SUB;
  const float ivx = inv_dir(r.dx), ivy = inv_dir(r.dy), ivz = inv_dir(r.dz);
  auto group_ok = [&](int g) {
    return __any_sync(FULL_MASK, alive && aabb_test(p.grpa, G, g, r, ivx, ivy,
                                                    ivz, fminf(h.t, t_cap)));
  };
  auto sub_ok = [&](int li) {
    return __any_sync(FULL_MASK,
                      alive && aabb_test(p.suba, p.n_subs, li, r, ivx, ivy,
                                         ivz, fminf(h.t, t_cap)));
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
                      alive && aabb_test(p.topa, C, ci, r, ivx, ivy, ivz,
                                         fminf(h.t, t_cap))))
        continue;
      top_staged_walk(p.topr[ci], p.topr[C + ci], p.tri, n_cols, p.subn, r,
                      h, tiles, lane, group_ok, sub_ok);
    }
  }
}

template <bool PRIMARY>
__global__ void __launch_bounds__(THREADS) binned_pass_kernel(const Params p) {
  __shared__ __align__(16) float tiles[THREADS / WARP][2 * STAGE_FLOATS];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if ((i & ~(WARP - 1)) >= p.n) return;  // n is whole warps: warp-uniform
  const int n = p.n;

  // ---- ray identity from the slot id ----
  const int slot = PRIMARY ? i : (int)p.state_in[ST_SLOT * n + i];
  const int t_idx = (int)((unsigned)slot >> LG_TILE);
  const int sl = slot & (TILE_SLOTS - 1);
  const int pix = (int)((unsigned)sl >> p.lg_spp);
  const int s = sl & ((1 << p.lg_spp) - 1);
  const int ty_l = t_idx / p.ntx;
  const int tx = t_idx - ty_l * p.ntx;
  // a sharded render owns the interleaved tile rows ty_off + k * ty_stride;
  // pixel ids depend only on the global (row, col)
  const int ty = ty_l * p.ty_stride + p.ty_off;
  const int prow = ty * p.th + (int)((unsigned)pix >> p.lg_tw);
  const int pcol = tx * p.tw + (pix & (p.tw - 1));
  const bool active0 = (prow < p.height) && (pcol < p.width);
  const int prow_c = min(prow, p.height - 1);
  const int pcol_c = min(pcol, p.width - 1);
  const unsigned pix_u = (unsigned)(prow_c * p.width + pcol_c) + p.seed_word;
  const int s_u = s + p.samp_off;

  // ---- ray state ----
  Ray r;
  PathColor c;
  float alive_f;
  if (PRIMARY) {
    unsigned ju = pix_u, jv = (unsigned)s_u, jw = 0u;
    pcg3d(ju, jv, jw);
    const float w1 = (float)max(p.width - 1, 1);
    const float h1 = (float)max(p.height - 1, 1);
    r = camera_ray(p.cam, ((float)pcol_c + u01(ju)) / w1,
                   ((float)prow_c + u01(jv)) / h1);
    c = PathColor{1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f};
    alive_f = active0 ? 1.0f : 0.0f;
  } else {
    const float *st = p.state_in;
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
  // A warp with no live lane (the dead slots a regroup sorts last, the
  // padding outside the image) skips it: a dead lane's shade changes
  // neither its ray nor its colour whatever its hit, and its key and exit
  // bound below depend on its ray alone, so it writes what the full pass
  // writes.
  Hit h = no_hit();
  if (__any_sync(FULL_MASK, alive)) {
    sphere_hits(p.sph, p.n_sph, p.sphc_b, p.sphc_r, p.n_sphc, r, alive, h);

    float t_cap = root_exit_cap(p.root, r, alive);
    if (!PRIMARY) t_cap = fminf(t_cap, p.state_in[ST_EXITB * n + i]);

    // secondary exit: the reference point nearest the warp's live centroid
    const bool use_node = !PRIMARY && p.node_exit;
    int ref_i = 0;
    float dmax = 0.0f;
    if (use_node)
      nearest_ref(p.refp, p.n_refs, r, alive, alive_f, ref_i, dmax);
    binned_walk<PRIMARY>(p, r, alive, t_cap, use_node, ref_i, dmax, h,
                         tiles[threadIdx.x / WARP], threadIdx.x & (WARP - 1));
  }
  resolve_tri_normals(h);
  const bool cont = shade(pix_u, s_u, p.bounce, r, h, alive, c);

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
  out[ST_SLOT * n + i] = (float)slot;
  if (p.is_last) {
    out[ST_EXITB * n + i] = 0.0f;
    p.keys_out[i] = KEY_DEAD;
    return;
  }

  // ---- next-top selection: sort key and walk-exit bound ----
  const float nvx = inv_dir(r.dx), nvy = inv_dir(r.dy), nvz = inv_dir(r.dz);
  float exit_e = -BIG;
  int best_c = -1;
  float tn, tf;
  if (p.use_super) {
    float be = BIG, bc = -1.0f;
    const int n_pad = p.n_super * SUPER;
    for (int si = 0; si < p.n_super; ++si) {
      const bool ok_s = box_entry(p.supa, p.n_super, si, r, nvx, nvy, nvz,
                                  tn, tf);
      exit_e = fmaxf(exit_e, ok_s ? tf : -BIG);
      const float guard = cont ? be : -BIG;
      if (__any_sync(FULL_MASK, ok_s && (tn < guard))) {
        for (int k = 0; k < SUPER; ++k) {
          const int ci = si * SUPER + k;
          const bool ok = box_entry(p.topap, n_pad, ci, r, nvx, nvy, nvz,
                                    tn, tf);
          const float e = ok ? tn : BIG;
          if (e < be) {
            be = e;
            bc = (float)ci;
          }
        }
      }
    }
    best_c = (int)bc;
  } else {
    float best_e = BIG;
    for (int ci = 0; ci < p.n_tops; ++ci) {
      const bool ok = box_entry(p.topa, p.n_tops, ci, r, nvx, nvy, nvz, tn,
                                tf);
      exit_e = fmaxf(exit_e, ok ? tf : -BIG);
      const float e = ok ? tn : BIG;
      if (e < best_e) {
        best_e = e;
        best_c = ci;
      }
    }
  }
  const bool found = best_c >= 0;
  out[ST_EXITB * n + i] = found ? exit_e * EXIT_MUL + EXIT_ADD : -BIG;

  const float spx = fmaxf(p.khi[0] - p.klo[0], KEY_SPAN_MIN);
  const float spy = fmaxf(p.khi[1] - p.klo[1], KEY_SPAN_MIN);
  const float spz = fmaxf(p.khi[2] - p.klo[2], KEY_SPAN_MIN);
  const int cell = key_cell<8>(r.ox, p.klo[0], spx) * 64 +
                   key_cell<8>(r.oy, p.klo[1], spy) * 8 +
                   key_cell<8>(r.oz, p.klo[2], spz);
  const int sub_key =
      (key_dir(r.dx) * 16 + key_dir(r.dy) * 4 + key_dir(r.dz)) * 512 + cell;
  const int key =
      found ? best_c * (1 << KEY_SUB_BITS) + sub_key : KEY_NOMESH + sub_key;
  p.keys_out[i] = cont ? key : KEY_DEAD;
}

}  // namespace

// Launch one K3 pass over n slots (whole warps) on `stream`.  Tables are
// the row-major device arrays of ops/cuda/wavefront_binned.py's
// PassTables: sph (11, n_sph), sphere clusters (may be null, n_sphc 0), tri
// (24, n_subs * 32), subn (n_subs), topr (2, n_tops; at most 8 groups a
// top: the wrapper checks the ranges), order / keys
// (n_tops), crunb (4, R8), refp (4, n_refs), norder / nkeys
// (n_refs, n_tops), nrunb (4, n_refs * R8), root (4), klo / khi (3), the
// sub / group / top / supertop / padded-top AABBs (6, .), cam (12).
// state_in (15, n) is null on the primary pass; writes state_out (15, n)
// and keys_out (n).  spp and tw are powers of two.  Slot tile row k is the
// global tile row ty_off + k * ty_stride (0 and 1 for a whole frame).  Returns
// cudaGetLastError() after the launch.
extern "C" int rt_binned_pass(
    const float *sph, int n_sph, const float *sphc_b, const int *sphc_r,
    int n_sphc, const float *tri, const int *subn, int n_subs,
    const int *topr, int n_tops, const int *order, const float *keys,
    const float *crunb, const float *refp, int n_refs, const int *norder,
    const float *nkeys, const float *nrunb, const float *root,
    const float *klo, const float *khi, const float *suba, const float *grpa,
    const float *topa, const float *supa, const float *topap, int n_super,
    const float *cam, const float *state_in, float *state_out, int *keys_out,
    int n, int width, int height, unsigned int seed_word, int bounce,
    int samp_off, int spp, int tw, int th, int ntx, int ty_off, int ty_stride,
    int primary, int is_last, int node_exit, int use_super, void *stream) {
  if (n < WARP || n % WARP || width < 1 || height < 1 || n_sph < 1 ||
      n_subs < 1 || n_subs % GROUP_SUBS || n_tops < 1 || n_refs < 1 ||
      (use_super && n_super * SUPER < n_tops) || ntx < 1 ||
      spp < 1 || (spp & (spp - 1)) || tw < 1 || (tw & (tw - 1)) ||
      ty_off < 0 || ty_stride < 1 ||
      (!primary && state_in == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.sph = sph;
  p.sphc_b = sphc_b;
  p.sphc_r = sphc_r;
  p.tri = tri;
  p.subn = subn;
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
  p.suba = suba;
  p.grpa = grpa;
  p.topa = topa;
  p.supa = supa;
  p.topap = topap;
  p.cam = cam;
  p.state_in = state_in;
  p.state_out = state_out;
  p.keys_out = keys_out;
  p.n_sph = n_sph;
  p.n_sphc = n_sphc;
  p.n_subs = n_subs;
  p.n_tops = n_tops;
  p.n_refs = n_refs;
  p.n_super = n_super;
  p.n = n;
  p.width = width;
  p.height = height;
  p.seed_word = seed_word;
  p.bounce = bounce;
  p.samp_off = samp_off;
  p.lg_spp = __builtin_ctz((unsigned)spp);
  p.tw = tw;
  p.lg_tw = __builtin_ctz((unsigned)tw);
  p.th = th;
  p.ntx = ntx;
  p.ty_off = ty_off;
  p.ty_stride = ty_stride;
  p.is_last = is_last;
  p.node_exit = node_exit;
  p.use_super = use_super;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (primary)
    binned_pass_kernel<true><<<blocks, THREADS, 0, s>>>(p);
  else
    binned_pass_kernel<false><<<blocks, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}
