// Per-ray device code shared by the path-tracing kernels: K1, K2 and
// K1-lowp (wavefront.cu), K5 and K5s (wavefront_bwd.cu), K4
// (wavefront_stream.cu), K3 (wavefront_binned.cu) and K6
// (wavefront_sorted.cu).
//
// K5 re-traces K1's paths before it sweeps them backward, and K3 and K4
// must trace the paths K1 traces, so every kernel takes the same hit, draws
// the same random numbers and scatters the same way for every lane.
// Everything that decides a path therefore lives here once: the table
// layouts, the constants (written as the hex of their float32 values),
// pcg3d, the cluster slab test and the bounding-sphere test, the mesh
// engines' root-exit cap, reference point and key cells, the sphere and
// triangle steps with their tie rules (spheres need a strictly smaller t,
// triangles win ties), the sphere stage, the normal fix-ups, the
// unit-sphere draw, the material scatter and the bounce bookkeeping; and
// for K4, K3, K6, K2 and K5s the warp-staged sub-leaf walk (K3 and K6 one
// top at a time through top_staged_walk), for K1 and K5 its one-level form
// over leaf chunks, K1-lowp's packed bfloat16 sphere stage, and for K1,
// K4, K2, K5 and K5s the (pixel, sample) thread layout, its
// persistent-warp tile loop and the sample-order pixel sum across a warp of
// such lanes.  All files are built with -fmad=false, so each expression
// rounds as written.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt_path {

constexpr unsigned FULL_MASK = 0xffffffffu;

// table rows (ops/tables.py)
constexpr int SPH_CX = 0, SPH_CY = 1, SPH_CZ = 2, SPH_R = 3, SPH_R2 = 4,
              SPH_KIND = 5, SPH_AR = 6, SPH_AG = 7, SPH_AB = 8, SPH_FUZZ = 9,
              SPH_IR = 10;
// edge k's constants g_k xyz and w_k sit at rows TRI_G0X + 4k .. + 3
constexpr int TRI_NX = 0, TRI_NY = 1, TRI_NZ = 2, TRI_D = 3, TRI_G0X = 4,
              TRI_KIND = 16, TRI_EXTRA = 17, TRI_AR = 18, TRI_AG = 19,
              TRI_AB = 20;

// float32 values of the Python constants, bit for bit
constexpr float T_MIN = 0x1.0624dep-10f;        // f32(0.001)
constexpr float BIG = 0x1.c363ccp+127f;         // f32(3.0e38)
constexpr float EPS8 = 0x1.5798eep-27f;         // f32(1e-8)
constexpr float TINY = 0x1.79ca1p-67f;          // f32(1e-20)
constexpr float INV_2_24_M1 = 0x1.000002p-24f;  // f32(1 / (2^24 - 1))
constexpr float SKY_G = 0x1.333334p-2f;         // f32(0.3)

// threads a block (four warps)
constexpr int THREADS = 128;

__device__ __forceinline__ void pcg3d(unsigned &x, unsigned &y, unsigned &z) {
  const unsigned mul = 1664525u, add = 1013904223u;
  x = x * mul + add;
  y = y * mul + add;
  z = z * mul + add;
  x = x + y * z;
  y = y + z * x;
  z = z + x * y;
  x = x ^ (x >> 16);
  y = y ^ (y >> 16);
  z = z ^ (z >> 16);
  x = x + y * z;
  y = y + z * x;
  z = z + x * y;
}

__device__ __forceinline__ float u01(unsigned bits) {
  return (float)(int)(bits >> 8) * INV_2_24_M1;
}

// pcg3d's draw at site 1 + b, mapped to [-1, 1]^3 and normalised onto the
// unit sphere (common.rs:32-38)
__device__ __forceinline__ void unit_sphere_draw(unsigned pix_u, int s, int b,
                                                 float &rx, float &ry,
                                                 float &rz) {
  unsigned bx = pix_u, by = (unsigned)s, bz = 1u + (unsigned)b;
  pcg3d(bx, by, bz);
  rx = u01(bx) * 2.0f - 1.0f;
  ry = u01(by) * 2.0f - 1.0f;
  rz = u01(bz) * 2.0f - 1.0f;
  const float rl = sqrtf(rx * rx + ry * ry + rz * rz);
  rx = rx / rl;
  ry = ry / rl;
  rz = rz / rl;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// closest-hit state: t, normal (or winning centre / raw plane normal before
// the fix-ups), kind (+4 negative radius, +8 triangle), albedo, fuzz, ir;
// with TRACK also the winner's id (sphere si, triangle S + ti) and its
// radius (sphere) or plane d (triangle)
struct Hit {
  float t, nx, ny, nz, kind, ar, ag, ab, fz, ir, win, rr;
};

__device__ __forceinline__ float inv_dir(float v) {
  const float mag = fmaxf(fabsf(v), TINY);
  return v >= 0.0f ? 1.0f / mag : -1.0f / mag;
}

// _aabb_test: could this ray hit something in box ci closer than t_best?
__device__ __forceinline__ bool aabb_test(const float *__restrict__ b, int nc,
                                          int ci, const Ray &r, float ivx,
                                          float ivy, float ivz, float t_best) {
  const float tx0 = (b[0 * nc + ci] - r.ox) * ivx;
  const float tx1 = (b[3 * nc + ci] - r.ox) * ivx;
  const float ty0 = (b[1 * nc + ci] - r.oy) * ivy;
  const float ty1 = (b[4 * nc + ci] - r.oy) * ivy;
  const float tz0 = (b[2 * nc + ci] - r.oz) * ivz;
  const float tz1 = (b[5 * nc + ci] - r.oz) * ivz;
  const float tnear = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                            fmaxf(fminf(tz0, tz1), 0.0f));
  const float tfar = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                           fmaxf(tz0, tz1));
  return (tnear <= tfar) && (tfar > T_MIN) && (tnear <= t_best);
}

// _bound_test: could this ray hit something inside bounding sphere ci
// (columns [cx, cy, cz, r^2]) no farther than t_best?
__device__ __forceinline__ bool bound_test(const float *__restrict__ b, int nc,
                                           int ci, const Ray &r,
                                           float t_best) {
  const float ocx = r.ox - b[0 * nc + ci];
  const float ocy = r.oy - b[1 * nc + ci];
  const float ocz = r.oz - b[2 * nc + ci];
  const float hb = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float cc = ocx * ocx + ocy * ocy + ocz * ocz - b[3 * nc + ci];
  const float disc = hb * hb - cc;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float entry = fmaxf(-hb - sq, 0.0f);
  return (disc >= 0.0f) && (-hb + sq > T_MIN) && (entry <= t_best);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

// butterfly sum: lane i adds lane i ^ off, so every lane ends with the
// same float (the plain versions repeat this order)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = v + __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

// ---- the per-bounce mesh engines' walk and sort keys (K3 and K6) ----
constexpr int KEY_DEAD = 0x7FFFFFFF;             // dead rays sort last
constexpr float EXIT_MUL = 0x1.0020c4p+0f;       // f32(1.0005)
constexpr float EXIT_ADD = 0x1.a36e2ep-14f;      // f32(1e-4)
constexpr float KEY_SPAN_MIN = 0x1.0c6f7ap-20f;  // f32(1e-6)

// the culling cap of the root bounding sphere (columns [cx, cy, cz, r^2]):
// the ray's padded exit distance from it; rays that miss it get -BIG and
// never hold a walk open
__device__ __forceinline__ float root_exit_cap(const float *__restrict__ root,
                                               const Ray &r, bool alive) {
  const float rr2 = root[3];
  const float ocx = r.ox - root[0];
  const float ocy = r.oy - root[1];
  const float ocz = r.oz - root[2];
  const float rhb = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float rcc = ocx * ocx + ocy * ocy + ocz * ocz - rr2;
  const float rdisc = rhb * rhb - rcc;
  const float rexit = -rhb + sqrtf(fmaxf(rdisc, 0.0f));
  const bool root_p =
      (rdisc >= 0.0f) && (rexit > T_MIN) && alive && (rr2 > 0.0f);
  return root_p ? rexit * EXIT_MUL + EXIT_ADD : -BIG;
}

// node_exit's reference point: of the valid points of refp (4, nr: x, y,
// z, valid), the one nearest the warp's centroid of live origins (the
// first of equals), and the warp's largest live origin distance from it
__device__ __forceinline__ void nearest_ref(const float *__restrict__ refp,
                                            int nr, const Ray &r, bool alive,
                                            float alive_f, int &ref_i,
                                            float &dmax) {
  const float live = fmaxf(warp_sum(alive_f), 1.0f);
  const float ccx = warp_sum(r.ox * alive_f) / live;
  const float ccy = warp_sum(r.oy * alive_f) / live;
  const float ccz = warp_sum(r.oz * alive_f) / live;
  float best_d2 = BIG;
  ref_i = 0;
  for (int k = 0; k < nr; ++k) {
    const float ddx = refp[k] - ccx;
    const float ddy = refp[nr + k] - ccy;
    const float ddz = refp[2 * nr + k] - ccz;
    float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
    d2 = refp[3 * nr + k] > 0.0f ? d2 : BIG;
    if (d2 < best_d2) {
      best_d2 = d2;
      ref_i = k;
    }
  }
  const float rdx = r.ox - refp[ref_i];
  const float rdy = r.oy - refp[nr + ref_i];
  const float rdz = r.oz - refp[2 * nr + ref_i];
  const float d2o = rdx * rdx + rdy * rdy + rdz * rdz;
  dmax = sqrtf(warp_max(alive ? d2o : 0.0f));
}

// a sort key's origin cell on one axis: CELLS cells a side of the key box,
// origins outside it clamped to the edge cells
template <int CELLS>
__device__ __forceinline__ int key_cell(float v, float lo, float span) {
  const float cell = (v - lo) / span * (float)CELLS;
  return (int)fminf(fmaxf(cell, 0.0f), (float)(CELLS - 1));
}

// a direction component's 2-bit class
__device__ __forceinline__ int key_dir(float v) {
  return (int)fminf(fmaxf((v + 1.0f) * 2.0f, 0.0f), 3.0f);
}

// one step of _sphere_loop's body; the normal slots carry the centre
template <bool TRACK>
__device__ __forceinline__ void sphere_step(const float *__restrict__ sph,
                                            int ns, int si, const Ray &r,
                                            Hit &h) {
  const float cx = sph[SPH_CX * ns + si];
  const float cy = sph[SPH_CY * ns + si];
  const float cz = sph[SPH_CZ * ns + si];
  const float r2 = sph[SPH_R2 * ns + si];
  const float ocx = r.ox - cx;
  const float ocy = r.oy - cy;
  const float ocz = r.oz - cz;
  const float half_b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float cc = ocx * ocx + ocy * ocy + ocz * ocz - r2;
  const float disc = half_b * half_b - cc;
  const bool ok = (disc >= 0.0f) && (r2 > 0.0f);
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float root1 = -half_b - sq;
  const float root2 = -half_b + sq;
  float t = root1 > T_MIN ? root1 : (root2 > T_MIN ? root2 : BIG);
  t = ok ? t : BIG;
  if (t < h.t) {
    h.t = t;
    h.nx = cx;
    h.ny = cy;
    h.nz = cz;
    h.kind = sph[SPH_KIND * ns + si];
    h.ar = sph[SPH_AR * ns + si];
    h.ag = sph[SPH_AG * ns + si];
    h.ab = sph[SPH_AB * ns + si];
    h.fz = sph[SPH_FUZZ * ns + si];
    h.ir = sph[SPH_IR * ns + si];
    if (TRACK) {
      h.win = (float)si;
      h.rr = sph[SPH_R * ns + si];
    }
  }
}

// one step of _make_tri_body on column ti of a table with nt columns; the
// normal slots carry the raw plane normal.  With TRACK a winner records
// `win`, its id (S + its column of the packed table)
template <bool PARITY, bool TRACK>
__device__ __forceinline__ void tri_step(const float *__restrict__ tri, int nt,
                                         int ti, const Ray &r, Hit &h,
                                         float win) {
  const float tnx = tri[TRI_NX * nt + ti];
  const float tny = tri[TRI_NY * nt + ti];
  const float tnz = tri[TRI_NZ * nt + ti];
  const float td = tri[TRI_D * nt + ti];
  const float nd = tnx * r.dx + tny * r.dy + tnz * r.dz;
  const float no = tnx * r.ox + tny * r.oy + tnz * r.oz;
  const bool par = fabsf(nd) < EPS8;
  const float nd_safe = par ? 1.0f : nd;
  // PARITY: the reference's wrong-sign plane equation (common.rs:140-141)
  const float t = PARITY ? (no + td) / nd_safe : (td - no) / nd_safe;
  bool ok = (!par) && (t >= T_MIN);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int g = TRI_G0X + 4 * k;
    const float gx = tri[g * nt + ti];
    const float gy = tri[(g + 1) * nt + ti];
    const float gz = tri[(g + 2) * nt + ti];
    const float e = r.ox * gx + r.oy * gy + r.oz * gz +
                    t * (r.dx * gx + r.dy * gy + r.dz * gz) -
                    tri[(g + 3) * nt + ti];
    ok = ok && (e >= 0.0f);
  }
  // triangles win ties (<=): common.rs:142 vs World::hit
  if (ok && t <= h.t) {
    const float tkind = tri[TRI_KIND * nt + ti];
    const float textra = tri[TRI_EXTRA * nt + ti];
    const bool t_met = (tkind >= 0.5f) && (tkind < 1.5f);
    const bool t_die = (tkind >= 1.5f) && (tkind < 2.5f);
    h.t = t;
    h.nx = tnx;
    h.ny = tny;
    h.nz = tnz;
    h.kind = tkind + 8.0f;
    h.ar = tri[TRI_AR * nt + ti];
    h.ag = tri[TRI_AG * nt + ti];
    h.ab = tri[TRI_AB * nt + ti];
    h.fz = t_met ? textra : 0.0f;
    h.ir = t_die ? textra : 1.0f;
    if (TRACK) {
      h.win = win;
      h.rr = td;
    }
  }
}

// ---- warp-staged sub-leaves (K4, K3, K6, K2, K5s; chunks of K1 and K5) ----
// A warp whose vote passes a 32-column sub-leaf copies the sub-leaf's 16
// test rows (TRI_NX .. edge 2's w: 2 KB) into a shared-memory tile with
// cp.async, transposed: triangle j's rows sit at tile[j * STAGE_STRIDE ..],
// so a test reads them as four broadcast 16-byte loads.  The 4 padding
// floats make the fill conflict-free: at copy step i, lane k writes row
// (i + k / 8) % 16 of column k, so the 32 lanes hit 32 distinct banks, and
// each group of 8 lanes reads 32 consecutive bytes of one row.
constexpr int STAGE_ROWS = 16;
constexpr int STAGE_COLS = 32;
constexpr int STAGE_STRIDE = 20;
constexpr int STAGE_FLOATS = STAGE_COLS * STAGE_STRIDE;

// start copying columns [col0, col0 + 32) of tri (nt columns, 16 B-aligned
// rows) into tile; every lane of the warp calls, lane k copying column k
__device__ __forceinline__ void stage_sub_leaf(float *tile,
                                               const float *__restrict__ tri,
                                               int nt, int col0, int lane) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(tile) +
                       4u * (unsigned)(lane * STAGE_STRIDE);
  const float *src = tri + col0 + lane;
#pragma unroll
  for (int i = 0; i < STAGE_ROWS; ++i) {
    const int row = (i + (lane >> 3)) & (STAGE_ROWS - 1);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     dst + 4u * (unsigned)row),
                 "l"(src + (size_t)row * nt)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this lane's staged copies are in flight
template <int N>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// tri_step on staged triangle j of tile (column ti of tri for a winner's
// material rows): the same operations in the same order, on the test rows
// read as four 16-byte loads.  tri_step itself stays as it is, so the
// kernels that read the table directly (the flat scans of K1 and K5)
// compile as before.
template <bool PARITY, bool TRACK>
__device__ __forceinline__ void tri_step_staged(const float *tile, int j,
                                                const float *__restrict__ tri,
                                                int nt, int ti, const Ray &r,
                                                Hit &h, float win) {
  const float4 *q = reinterpret_cast<const float4 *>(tile + j * STAGE_STRIDE);
  const float4 n = q[0];
  const float4 e4[3] = {q[1], q[2], q[3]};
  const float tnx = n.x, tny = n.y, tnz = n.z, td = n.w;
  const float nd = tnx * r.dx + tny * r.dy + tnz * r.dz;
  const float no = tnx * r.ox + tny * r.oy + tnz * r.oz;
  const bool par = fabsf(nd) < EPS8;
  const float nd_safe = par ? 1.0f : nd;
  const float t = PARITY ? (no + td) / nd_safe : (td - no) / nd_safe;
  bool ok = (!par) && (t >= T_MIN);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float gx = e4[k].x, gy = e4[k].y, gz = e4[k].z;
    const float e = r.ox * gx + r.oy * gy + r.oz * gz +
                    t * (r.dx * gx + r.dy * gy + r.dz * gz) - e4[k].w;
    ok = ok && (e >= 0.0f);
  }
  if (ok && t <= h.t) {
    const float tkind = tri[TRI_KIND * nt + ti];
    const float textra = tri[TRI_EXTRA * nt + ti];
    const bool t_met = (tkind >= 0.5f) && (tkind < 1.5f);
    const bool t_die = (tkind >= 1.5f) && (tkind < 2.5f);
    h.t = t;
    h.nx = tnx;
    h.ny = tny;
    h.nz = tnz;
    h.kind = tkind + 8.0f;
    h.ar = tri[TRI_AR * nt + ti];
    h.ag = tri[TRI_AG * nt + ti];
    h.ab = tri[TRI_AB * nt + ti];
    h.fz = t_met ? textra : 0.0f;
    h.ir = t_die ? textra : 1.0f;
    if (TRACK) {
      h.win = win;
      h.rr = td;
    }
  }
}

// the index of the lowest set bit of a nonzero mask
__device__ __forceinline__ int lowest_bit(unsigned m) { return __ffs(m) - 1; }
__device__ __forceinline__ int lowest_bit(unsigned long long m) {
  return __ffsll(m) - 1;
}

// The warp-staged walk over the sub-leaves of one node.  Bit s of `mask`
// marks sub-leaf s (up to 32 in visit order with an unsigned mask, 64 with
// an unsigned long long; sub-leaf s lies under parent s / per_parent)
// whose parent and own bound a live lane passed at the
// node's start.  The walk tests them in order exactly as the sequential
// walk would: bound tests are monotone in t_best, so a sub-leaf outside the
// mask fails later too, and one inside it votes again before its test
// (sub_ok(s), and parent_ok(p) at the first sub-leaf of each later
// parent), since the warp's hits may have moved closer.  While one
// sub-leaf is tested from its tile (test(s, tile)), the copy of the next
// one in the mask is in flight into the other (stage(s, tile)).  `tiles`
// holds the warp's two tiles; `mask` is warp-uniform and every lane calls.
template <class Mask, class ParentOk, class SubOk, class Stage, class Test>
__device__ __forceinline__ void staged_sub_walk(Mask mask, int per_parent,
                                                float *tiles,
                                                ParentOk parent_ok,
                                                SubOk sub_ok, Stage stage,
                                                Test test) {
  if (mask == 0u) return;
  int cur = lowest_bit(mask);
  mask &= mask - 1u;
  stage(cur, tiles);
  int buf = 0, parent = cur / per_parent;
  bool parent_pass = true, first = true;
  while (true) {
    const int nxt = mask ? lowest_bit(mask) : -1;
    if (nxt >= 0) {
      mask &= mask - 1u;
      stage(nxt, tiles + (buf ^ 1) * STAGE_FLOATS);
      stage_wait<1>();
    } else {
      stage_wait<0>();
    }
    __syncwarp();
    if (cur / per_parent != parent) {
      parent = cur / per_parent;
      parent_pass = parent_ok(parent);
    }
    if (parent_pass && (first || sub_ok(cur)))
      test(cur, tiles + buf * STAGE_FLOATS);
    first = false;
    __syncwarp();  // the tile just read is refilled next
    if (nxt < 0) break;
    cur = nxt;
    buf ^= 1;
  }
}

// ---- the per-bounce mesh engines' top node (K3 and K6) ----
// ops/tables.py build_tri_sorted_tables: a top spans at most
// MESH_TOP_GROUPS 128-column groups of MESH_GROUP_SUBS 32-column sub-leaves
// (sub-leaf li in columns [32 li, 32 li + 32)), so its sub-leaves fit one
// 32-bit mask (the wrappers check the ranges)
constexpr int MESH_GROUP_SUBS = 4;
constexpr int MESH_TOP_GROUPS = 8;
static_assert(MESH_TOP_GROUPS * MESH_GROUP_SUBS <= 32,
              "a top's sub-leaves fit top_staged_walk's 32-bit mask");

// One passing top of K3's or K6's walk: its groups [g0, g1) voted
// (group_ok(g)) and each passing group's sub-leaves voted (sub_ok(li)) once
// into a mask, then staged_sub_walk tests the masked sub-leaves in order,
// each re-voted (and each later group at its first masked sub-leaf), from
// the warp's `tiles`: the triangles, sub-leaves and their order of the
// sequential walk (group by group, sub-leaf by sub-leaf, each vote at the
// warp's hits so far), so the hits and ties are its own.  The two engines
// differ only in the bound test the votes make (K3: AABBs, aabb_test; K6:
// bounding spheres, bound_test).  tri (24, n_cols) is the sub-leaf-aligned
// table, subn each sub-leaf's triangle count; every lane calls.
template <class GroupOk, class SubOk>
__device__ __forceinline__ void top_staged_walk(
    int g0, int g1, const float *__restrict__ tri, int n_cols,
    const int *__restrict__ subn, const Ray &r, Hit &h, float *tiles,
    int lane, GroupOk group_ok, SubOk sub_ok) {
  const int s0 = g0 * MESH_GROUP_SUBS;
  unsigned mask = 0u;
  for (int g = g0; g < g1; ++g) {
    if (!group_ok(g)) continue;
    for (int k = 0; k < MESH_GROUP_SUBS; ++k)
      if (sub_ok(g * MESH_GROUP_SUBS + k))
        mask |= 1u << ((g - g0) * MESH_GROUP_SUBS + k);
  }
  staged_sub_walk(
      mask, MESH_GROUP_SUBS, tiles, [&](int q) { return group_ok(g0 + q); },
      [&](int s) { return sub_ok(s0 + s); },
      [&](int s, float *tile) {
        stage_sub_leaf(tile, tri, n_cols, (s0 + s) * STAGE_COLS, lane);
      },
      [&](int s, const float *tile) {
        const int li = s0 + s, n = subn[li];
        for (int j = 0; j < n; ++j)
          tri_step_staged<false, false>(tile, j, tri, n_cols,
                                        li * STAGE_COLS + j, r, h, 0.0f);
      });
}

// K1's sample-order pixel sum (acc = acc + c over samples 0 .. spp - 1,
// from 0.0f) across a warp of (pixel, sample) lanes: the `run` lanes
// [p * run, (p + 1) * run) hold samples base .. base + run - 1 of one
// pixel; their values v below spp are added to acc in sample order, every
// lane of the pixel computing the same sum.  run is warp-uniform.
__device__ __forceinline__ float pixel_sum_run(float acc, float v, int run,
                                               int base, int spp, int lane) {
  const int first = lane & ~(run - 1);
  for (int j = 0; j < run; ++j) {
    const float x = __shfl_sync(FULL_MASK, v, first + j);
    if (base + j < spp) acc = acc + x;
  }
  return acc;
}

// ---- the leaf-aligned table of the two-level walk ----
// leaf slot width of the leaf-aligned table: leaf li's triangles sit in
// columns [128 li, 128 li + n) (ops/diff.py), its sub-leaf k in columns
// [128 li + 32 k, 128 li + 32 k + 32); a top holds at most 16 leaves, so
// its sub-leaves fit one 64-bit mask
constexpr int STREAM_LEAF_PAD = 128;
constexpr int LEAF_SUBS = STREAM_LEAF_PAD / STAGE_COLS;
constexpr int TOP_LEAVES_MAX = 16;

// ---- the triangle stage of K1 and K5 ----
// the walk an instance compiles: none (the table is one padding column,
// which never hits: the wrappers check), the flat scan, or the one-level
// walk over leaves (the correct plane sign only)
enum TriWalk { WALK_NONE = 0, WALK_FLAT = 1, WALK_LEAVES = 2 };

// the one-level walk's tables (row-major, device memory): the packed
// triangle table (n_tri columns), leaf AABBs (6, n_leaves) and their column
// ranges (2, n_leaves); `chunks`: the most 32-column chunks a leaf holds
// (1 .. 64)
struct OneLevel {
  const float *tri;
  const float *leafb;
  const int *leafr;
  int n_tri, n_leaves, chunks;
};

// stage_sub_leaf for a chunk of n <= 32 columns that may end the table:
// lanes past n copy nothing (each still commits a group)
__device__ __forceinline__ void stage_chunk(float *tile,
                                            const float *__restrict__ tri,
                                            int nt, int col0, int n,
                                            int lane) {
  if (lane < n)
    stage_sub_leaf(tile, tri, nt, col0, lane);
  else
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// _make_tri_body over the leaves of the packed table (K1 and K5): leaves in
// index order, each one's columns in order, ties to the last visited,
// winners n_sph + the packed column, as the sequential walk takes them.
// Leaves are voted 64 / chunks at a time into a mask of their 32-column
// chunks; staged_sub_walk copies each masked chunk into one of the warp's
// two tiles while the one before it is tested, and votes its leaf again
// before the leaf's first chunk and before each later one, since the
// warp's hits may have moved closer.  A leaf box that no live lane passes
// holds no hit at t <= t_best (the boxes are conservative: the sequential
// walk already culls on them), so the hits are the sequential walk's bit
// for bit.  `tiles`: the warp's two staging tiles; every lane calls.
template <bool PARITY, bool TRACK>
__device__ __forceinline__ void leaf_staged_walk(const OneLevel &w, int n_sph,
                                                 const Ray &r, bool alive,
                                                 Hit &h, float *tiles,
                                                 int lane) {
  const float ivx = inv_dir(r.dx), ivy = inv_dir(r.dy), ivz = inv_dir(r.dz);
  auto leaf_ok = [&](int li) {
    return __any_sync(FULL_MASK, alive && aabb_test(w.leafb, w.n_leaves, li,
                                                    r, ivx, ivy, ivz, h.t));
  };
  // chunk s of a group: its leaf's first column and its own
  auto chunk = [&](int l0, int s, int &li, int &c0) {
    li = l0 + s / w.chunks;
    c0 = w.leafr[li] + (s % w.chunks) * STAGE_COLS;
  };
  const int group = 64 / w.chunks;
  for (int l0 = 0; l0 < w.n_leaves; l0 += group) {
    const int l1 = min(l0 + group, w.n_leaves);
    unsigned long long mask = 0ull;
    for (int li = l0; li < l1; ++li) {
      if (!leaf_ok(li)) continue;
      const int n = w.leafr[w.n_leaves + li] - w.leafr[li];
      for (int k = 0; k * STAGE_COLS < n; ++k)
        mask |= 1ull << ((li - l0) * w.chunks + k);
    }
    staged_sub_walk(
        mask, w.chunks, tiles, [&](int q) { return leaf_ok(l0 + q); },
        [&](int s) { return s % w.chunks == 0 || leaf_ok(l0 + s / w.chunks); },
        [&](int s, float *tile) {
          int li, c0;
          chunk(l0, s, li, c0);
          stage_chunk(tile, w.tri, w.n_tri, c0,
                      min(w.leafr[w.n_leaves + li] - c0, STAGE_COLS), lane);
        },
        [&](int s, const float *tile) {
          int li, c0;
          chunk(l0, s, li, c0);
          const int n = min(w.leafr[w.n_leaves + li] - c0, STAGE_COLS);
          for (int j = 0; j < n; ++j)
            tri_step_staged<PARITY, TRACK>(tile, j, w.tri, w.n_tri, c0 + j, r,
                                           h, (float)n_sph + (float)(c0 + j));
        });
  }
}

// closest hit over the triangles by the walk WALK; winner ids are n_sph +
// the column.  `tiles` and `lane` serve the leaf walk only.
template <bool PARITY, bool TRACK, int WALK>
__device__ __forceinline__ void triangle_hits(const OneLevel &w, int n_sph,
                                              const Ray &r, bool alive,
                                              Hit &h, float *tiles,
                                              int lane) {
  if constexpr (WALK == WALK_LEAVES) {
    leaf_staged_walk<PARITY, TRACK>(w, n_sph, r, alive, h, tiles, lane);
  } else if constexpr (WALK == WALK_FLAT) {
    for (int ti = 0; ti < w.n_tri; ++ti)
      tri_step<PARITY, TRACK>(w.tri, w.n_tri, ti, r, h,
                              (float)n_sph + (float)ti);
  }
}

// ---- the two-level walk of the differentiable path (K2 and K5s) ----
// the walk's tables (row-major, device memory): the leaf-aligned triangle
// table (24, 128 n_leaves), leaf AABBs (6, n_leaves) and their PACKED
// column ranges (2, n_leaves), sub-leaf AABBs (6, 4 n_leaves), top AABBs
// (6, n_tops) and leaf ranges (2, n_tops)
struct TwoLevel {
  const float *tri;
  const float *leafb;
  const int *leafr;
  const float *subb;
  const float *topb;
  const int *topr;
  int n_leaves, n_tops;
};

// _streamed_tri_walk (the correct plane equation) with sub-leaf boxes and
// warp-staged sub-leaves: tops in index order, each voted with the warp's
// hits so far; a passing top's leaves and their 32-column sub-leaves voted
// at once into a mask; then staged_sub_walk tests the masked sub-leaves in
// index order, re-voting each (and each later leaf) before its test.
// Culling a box no lane can reach changes no hit, and each ray meets its
// triangles in the sequential walk's order (leaf by leaf, column by
// column; ties go to the last visited), so the hits are K1's over the same
// leaves bit for bit.  Winner ids are n_sph + the packed column.  `tiles`:
// the warp's two staging tiles; every lane calls.
template <bool TRACK>
__device__ __forceinline__ void two_level_staged_walk(const TwoLevel &w,
                                                      int n_sph, const Ray &r,
                                                      bool alive, Hit &h,
                                                      float *tiles, int lane) {
  const int n_cols = w.n_leaves * STREAM_LEAF_PAD;
  const int n_subs = w.n_leaves * LEAF_SUBS;
  const float ivx = inv_dir(r.dx), ivy = inv_dir(r.dy), ivz = inv_dir(r.dz);
  auto leaf_ok = [&](int li) {
    return __any_sync(FULL_MASK, alive && aabb_test(w.leafb, w.n_leaves, li,
                                                    r, ivx, ivy, ivz, h.t));
  };
  auto sub_ok = [&](int si) {
    return __any_sync(FULL_MASK, alive && aabb_test(w.subb, n_subs, si, r,
                                                    ivx, ivy, ivz, h.t));
  };
  for (int tci = 0; tci < w.n_tops; ++tci) {
    if (!__any_sync(FULL_MASK, alive && aabb_test(w.topb, w.n_tops, tci, r,
                                                  ivx, ivy, ivz, h.t)))
      continue;
    const int l0 = w.topr[tci], l1 = w.topr[w.n_tops + tci];
    unsigned long long mask = 0ull;
    for (int li = l0; li < l1; ++li) {
      if (!leaf_ok(li)) continue;
      const int n = w.leafr[w.n_leaves + li] - w.leafr[li];
      for (int k = 0; k * STAGE_COLS < n; ++k)
        if (sub_ok(li * LEAF_SUBS + k))
          mask |= 1ull << ((li - l0) * LEAF_SUBS + k);
    }
    staged_sub_walk(
        mask, LEAF_SUBS, tiles, [&](int q) { return leaf_ok(l0 + q); },
        [&](int s) { return sub_ok(l0 * LEAF_SUBS + s); },
        [&](int s, float *tile) {
          stage_sub_leaf(tile, w.tri, n_cols,
                         l0 * STREAM_LEAF_PAD + s * STAGE_COLS, lane);
        },
        [&](int s, const float *tile) {
          const int li = l0 + s / LEAF_SUBS;
          const int k0 = (s % LEAF_SUBS) * STAGE_COLS;
          const int p0 = w.leafr[li] + k0;
          const int n = min(w.leafr[w.n_leaves + li] - p0, STAGE_COLS);
          const int col0 = li * STREAM_LEAF_PAD + k0;
          for (int j = 0; j < n; ++j)
            tri_step_staged<false, TRACK>(tile, j, w.tri, n_cols, col0 + j,
                                          r, h, (float)n_sph + (float)(p0 + j));
        });
  }
}

// ---- the (pixel, sample) thread layout (K1, K2, K5 and K5s) ----
// ops/cuda/wavefront_stream.py thread_layout: a warp holds a tile_w x
// tile_h tile of pixels x `run` consecutive samples of each (lane = pixel *
// run + sample % run, pixels row-major in the tile); a spp above the run
// loops over runs in the thread; warp tile w sits at (w % tiles_x, w /
// tiles_x) of the band
struct TileLayout {
  int run, tile_w, tile_h, tiles_x, n_tiles;
};

// what a lane of warp tile w traces: its pixel (band row, column, clamped
// global row and column, the RNG word) and its sample offset j in the run
struct LanePixel {
  int band_row, pcol, j;
  bool in_band, active0;
  unsigned pix_u;
  float prow_f, pcol_f;
};

__device__ __forceinline__ LanePixel lane_pixel(const TileLayout &lay, int w,
                                                int lane, int width,
                                                int height, int shard_rows,
                                                int row_offset, int row_stride,
                                                unsigned seed_word) {
  LanePixel q;
  const int pix = lane / lay.run;
  q.j = lane % lay.run;
  q.pcol = (w % lay.tiles_x) * lay.tile_w + pix % lay.tile_w;
  q.band_row = (w / lay.tiles_x) * lay.tile_h + pix / lay.tile_w;
  const int prow = row_offset + q.band_row * row_stride;
  q.in_band = (q.band_row < shard_rows) && (q.pcol < width);
  q.active0 = (prow < height) && q.in_band;
  const int prow_c = min(prow, height - 1);
  const int pcol_c = min(q.pcol, width - 1);
  q.pix_u = (unsigned)(prow_c * width + pcol_c) + seed_word;
  q.prow_f = (float)prow_c;
  q.pcol_f = (float)pcol_c;
  return q;
}

// Persistent warps: the grid holds only as many blocks as the card keeps
// resident, and each warp takes the next tile from `next_tile` (0 at
// launch) until none is left, so no launch ends in a part-empty wave of
// whole blocks.  body(w) traces tile w; every lane calls.
template <class Body>
__device__ __forceinline__ void for_each_tile(int *next_tile, int n_tiles,
                                              int lane, Body body) {
  for (;;) {
    int w = 0;
    if (lane == 0) w = atomicAdd(next_tile, 1);
    w = __shfl_sync(FULL_MASK, w, 0);
    if (w >= n_tiles) return;  // warp-uniform
    body(w);
  }
}

// whether the kernels take a thread layout with `blocks` blocks of THREADS
inline bool layout_ok(const TileLayout &lay, int width, int blocks) {
  return lay.run >= 1 && lay.run <= 32 && !(lay.run & (lay.run - 1)) &&
         lay.tile_w * lay.tile_h * lay.run == 32 &&
         lay.tiles_x * lay.tile_w >= width && lay.n_tiles >= 1 &&
         (long long)blocks * (THREADS / 32) >= lay.n_tiles;
}

// a persistent launch's grid: as many blocks of THREADS as the card keeps
// resident, at most `blocks`
template <class Kernel>
inline cudaError_t resident_grid(Kernel kernel, int blocks, int &grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, 0);
  grid = min(blocks, max(per_sm * sms, 1));
  return e;
}

// a persistent launch of `kernel` on `s` (resident_grid's grid); returns
// cudaGetLastError() after it
template <class Kernel, class P>
inline cudaError_t launch_persistent(Kernel kernel, const P &p, int blocks,
                                     cudaStream_t s) {
  int grid = 0;
  const cudaError_t e = resident_grid(kernel, blocks, grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, 0, s>>>(p);
  return cudaGetLastError();
}

// the camera ray through (u, v): cam is [origin, lower-left corner,
// horizontal, vertical]
__device__ __forceinline__ Ray camera_ray(const float *__restrict__ cam,
                                          float u, float v) {
  Ray r;
  r.dx = cam[3] + u * cam[6] + v * cam[9] - cam[0];
  r.dy = cam[4] + u * cam[7] + v * cam[10] - cam[1];
  r.dz = cam[5] + u * cam[8] + v * cam[11] - cam[2];
  const float dlen = sqrtf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz);
  r.dx = r.dx / dlen;
  r.dy = r.dy / dlen;
  r.dz = r.dz / dlen;
  r.ox = cam[0];
  r.oy = cam[1];
  r.oz = cam[2];
  return r;
}

// a fresh closest-hit record (no primitive yet)
__device__ __forceinline__ Hit no_hit() {
  Hit h = {BIG, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f,
           0.0f, 0.0f, 0.0f, 1.0f, -1.0f, 1.0f};
  return h;
}

// ---- K1-lowp's packed bfloat16 sphere stage ----
// The packed table (ops/cuda/wavefront.py lowp_sphere_table): for each pair
// of spheres (2k, 2k + 1) one 16-byte uint4 of four bfloat16x2 words, cx,
// cy, cz and r^2, sphere 2k in each word's low half, every value the
// float32 table's rounded once to bfloat16 (ties to even); r^2 is -1 for a
// sphere whose float32 r^2 is not > 0 and for the padding sphere of an odd
// count, so its `ok` fails and it never wins.
//
// Each packed operation is one add / sub / mul.rn.bf16x2 instruction: a
// correctly rounded bfloat16 result in each half, never contracted into an
// FMA.  Its operands are bfloat16 values, and float32's 24-bit significand
// is >= 2 x 8 + 2 bits, so the float32 operation rounded to bfloat16 (the
// plain version's torch bf16 op) is the same value: no double-rounding
// error.
__device__ __forceinline__ unsigned bf2_add(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned bf2_sub(unsigned a, unsigned b) {
  unsigned d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned bf2_mul(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// x rounded to bfloat16 (ties to even), in both halves of a word
__device__ __forceinline__ unsigned bf2_splat(float x) {
  const unsigned b = __bfloat16_as_ushort(__float2bfloat16_rn(x));
  return (b << 16) | b;
}

// the low / high half of a bfloat16x2 word as float32 (exact)
__device__ __forceinline__ float bf2_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf2_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// the root selection and the closest-hit compare of _sphere_loop_lowp in
// float32, as sphere_step: sphere si with half_b, c and the packed r^2
// upcast; a winner's centre and material from the float32 table
__device__ __forceinline__ void sphere_root_lowp(const float *__restrict__ sph,
                                                 int ns, int si, float half_b,
                                                 float cc, float r2,
                                                 Hit &h) {
  const float disc = half_b * half_b - cc;
  const bool ok = (disc >= 0.0f) && (r2 >= 0.0f);
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float root1 = -half_b - sq;
  const float root2 = -half_b + sq;
  float t = root1 > T_MIN ? root1 : (root2 > T_MIN ? root2 : BIG);
  t = ok ? t : BIG;
  if (t < h.t) {
    h.t = t;
    h.nx = sph[SPH_CX * ns + si];
    h.ny = sph[SPH_CY * ns + si];
    h.nz = sph[SPH_CZ * ns + si];
    h.kind = sph[SPH_KIND * ns + si];
    h.ar = sph[SPH_AR * ns + si];
    h.ag = sph[SPH_AG * ns + si];
    h.ab = sph[SPH_AB * ns + si];
    h.fz = sph[SPH_FUZZ * ns + si];
    h.ir = sph[SPH_IR * ns + si];
  }
}

// two steps of _sphere_loop_lowp's body (K1-lowp), spheres 2k and 2k + 1 of
// the packed table at once: oc = o - c, half_b = (ocx dx + ocy dy) + ocz dz
// and c = ((ocx^2 + ocy^2) + ocz^2) - r^2 as packed bfloat16 operations in
// the Pallas order (o2, d2: the ray rounded to bfloat16, splat), then each
// sphere's roots in float32, 2k before 2k + 1, as the flat scan takes them
__device__ __forceinline__ void sphere_pair_lowp(const uint4 *__restrict__ spl,
                                                 const float *__restrict__ sph,
                                                 int ns, int k,
                                                 const unsigned o2[3],
                                                 const unsigned d2[3],
                                                 Hit &h) {
  const uint4 c = spl[k];
  const unsigned ocx = bf2_sub(o2[0], c.x);
  const unsigned ocy = bf2_sub(o2[1], c.y);
  const unsigned ocz = bf2_sub(o2[2], c.z);
  const unsigned hb = bf2_add(bf2_add(bf2_mul(ocx, d2[0]),
                                      bf2_mul(ocy, d2[1])),
                              bf2_mul(ocz, d2[2]));
  const unsigned cc = bf2_sub(bf2_add(bf2_add(bf2_mul(ocx, ocx),
                                              bf2_mul(ocy, ocy)),
                                      bf2_mul(ocz, ocz)),
                              c.w);
  sphere_root_lowp(sph, ns, 2 * k, bf2_lo(hb), bf2_lo(cc), bf2_lo(c.w), h);
  sphere_root_lowp(sph, ns, 2 * k + 1, bf2_hi(hb), bf2_hi(cc), bf2_hi(c.w),
                   h);
}

// closest sphere hit (common.rs:60-98): the flat table, or culled warp by
// warp through cluster AABBs; with LOWP (K1-lowp) the packed bfloat16
// table `spl` a pair at a time (sphere_pair_lowp), clusters ignored as
// _sphere_loop_lowp ignores them; then _sphere_normals: normalize(p - c),
// flipped for r < 0.  Loop bounds are warp-uniform.
template <bool LOWP = false>
__device__ __forceinline__ void sphere_hits(const float *__restrict__ sph,
                                            int n_sph,
                                            const float *__restrict__ sphc_b,
                                            const int *__restrict__ sphc_r,
                                            int n_sphc, const Ray &r,
                                            bool alive, Hit &h,
                                            const uint4 *__restrict__ spl =
                                                nullptr) {
  if constexpr (LOWP) {
    const unsigned o2[3] = {bf2_splat(r.ox), bf2_splat(r.oy),
                            bf2_splat(r.oz)};
    const unsigned d2[3] = {bf2_splat(r.dx), bf2_splat(r.dy),
                            bf2_splat(r.dz)};
    const int pairs = (n_sph + 1) >> 1;
    for (int k = 0; k < pairs; ++k)
      sphere_pair_lowp(spl, sph, n_sph, k, o2, d2, h);
  } else if (n_sphc > 0) {
    const float ivx = inv_dir(r.dx), ivy = inv_dir(r.dy), ivz = inv_dir(r.dz);
    for (int ci = 0; ci < n_sphc; ++ci) {
      const bool possible =
          alive && aabb_test(sphc_b, n_sphc, ci, r, ivx, ivy, ivz, h.t);
      if (__any_sync(FULL_MASK, possible)) {
        const int s1 = sphc_r[n_sphc + ci];
        for (int si = sphc_r[ci]; si < s1; ++si)
          sphere_step<false>(sph, n_sph, si, r, h);
      }
    }
  } else {
    for (int si = 0; si < n_sph; ++si) sphere_step<false>(sph, n_sph, si, r, h);
  }
  const float hpx = r.ox + h.t * r.dx;
  const float hpy = r.oy + h.t * r.dy;
  const float hpz = r.oz + h.t * r.dz;
  const float snx = hpx - h.nx;
  const float sny = hpy - h.ny;
  const float snz = hpz - h.nz;
  float slen = sqrtf(snx * snx + sny * sny + snz * snz);
  slen = slen == 0.0f ? 1.0f : slen;
  const bool neg_r = h.kind >= 3.5f;
  slen = neg_r ? -slen : slen;
  h.kind = neg_r ? h.kind - 4.0f : h.kind;
  h.nx = snx / slen;
  h.ny = sny / slen;
  h.nz = snz / slen;
}

// _resolve_tri_normals: a triangle winner carries its raw plane normal and
// kind + 8; normalise the one and strip the other
__device__ __forceinline__ void resolve_tri_normals(Hit &h) {
  const bool is_tri = h.kind >= 7.5f;
  float ln = sqrtf(h.nx * h.nx + h.ny * h.ny + h.nz * h.nz);
  ln = ln == 0.0f ? 1.0f : ln;
  h.nx = is_tri ? h.nx / ln : h.nx;
  h.ny = is_tri ? h.ny / ln : h.ny;
  h.nz = is_tri ? h.nz / ln : h.nz;
  h.kind = is_tri ? h.kind - 8.0f : h.kind;
}

// MaterialType::scatter at a hit with unit normal n and material (kind
// 0..3, albedo, fuzz, ir), for draw (rx, ry, rz): the next direction, the
// colour the throughput takes and whether the path ends here
struct Scatter {
  float dx, dy, dz, cr, cg, cb;
  bool term;
};

__device__ __forceinline__ Scatter scatter(const Ray &r, float nx, float ny,
                                           float nz, float kind, float ar,
                                           float ag, float ab, float fz,
                                           float ir, float rx, float ry,
                                           float rz) {
  // diffuse: normal + rand (degenerate -> normal)
  const float sdx = nx + rx;
  const float sdy = ny + ry;
  const float sdz = nz + rz;
  const bool deg =
      (fabsf(sdx) < EPS8) && (fabsf(sdy) < EPS8) && (fabsf(sdz) < EPS8);
  float sl = sqrtf(sdx * sdx + sdy * sdy + sdz * sdz);
  sl = sl == 0.0f ? 1.0f : sl;
  const float difx = deg ? nx : sdx / sl;
  const float dify = deg ? ny : sdy / sl;
  const float difz = deg ? nz : sdz / sl;

  // metal: reflect + fuzz * rand; absorbed below the surface
  const float dn = r.dx * nx + r.dy * ny + r.dz * nz;
  const float rfx = r.dx - 2.0f * dn * nx;
  const float rfy = r.dy - 2.0f * dn * ny;
  const float rfz = r.dz - 2.0f * dn * nz;
  const float mx = rfx + fz * rx;
  const float my = rfy + fz * ry;
  const float mz = rfz + fz * rz;
  const bool met_keep = (mx * nx + my * ny + mz * nz) >= 0.0f;
  float ml = sqrtf(mx * mx + my * my + mz * mz);
  ml = ml == 0.0f ? 1.0f : ml;
  const float metx = mx / ml;
  const float mety = my / ml;
  const float metz = mz / ml;

  // dielectric: the reference's inverted front-face rule, always refract
  const bool inside = dn >= 0.0f;
  const float sgn = inside ? -1.0f : 1.0f;
  const float nex = sgn * nx;
  const float ney = sgn * ny;
  const float nez = sgn * nz;
  const float ratio = inside ? 1.0f / ir : ir;
  const float cos_t = -(r.dx * nex + r.dy * ney + r.dz * nez);
  const float px = ratio * (r.dx + cos_t * nex);
  const float py = ratio * (r.dy + cos_t * ney);
  const float pz = ratio * (r.dz + cos_t * nez);
  const float pl2 = px * px + py * py + pz * pz;
  const float para = -sqrtf(fabsf(1.0f - pl2));
  const float qx = px + para * nex;
  const float qy = py + para * ney;
  const float qz = pz + para * nez;
  float ql = sqrtf(qx * qx + qy * qy + qz * qz);
  ql = ql == 0.0f ? 1.0f : ql;
  const float diex = qx / ql;
  const float diey = qy / ql;
  const float diez = qz / ql;

  const bool is_dif = kind < 0.5f;
  const bool is_met = (kind >= 0.5f) && (kind < 1.5f);
  const bool is_die = (kind >= 1.5f) && (kind < 2.5f);
  const bool is_emi = kind >= 2.5f;
  Scatter out;
  out.cr = is_die ? 1.0f : ar;
  out.cg = is_die ? 1.0f : ag;
  out.cb = is_die ? 1.0f : ab;
  out.dx = is_dif ? difx : (is_met ? metx : (is_die ? diex : nx));
  out.dy = is_dif ? dify : (is_met ? mety : (is_die ? diey : ny));
  out.dz = is_dif ? difz : (is_met ? metz : (is_die ? diez : nz));
  out.term = is_emi || (is_met && !met_keep);
  return out;
}

// throughput and radiance of one path
struct PathColor {
  float tpr, tpg, tpb, rr, rg, rb;
};

// _scatter_bookkeep after the closest hit h (normals resolved): the draw at
// site 1 + b of sample s, the scatter, and the bounce bookkeeping
// (common.rs:263-285).  Moves r to the scattered ray when the path goes
// on; returns whether it does.
__device__ __forceinline__ bool shade(unsigned pix_u, int s, int b, Ray &r,
                                      const Hit &h, bool alive, PathColor &c) {
  const bool hit = h.t < BIG;
  const float hpx = hit ? r.ox + h.t * r.dx : r.ox;
  const float hpy = hit ? r.oy + h.t * r.dy : r.oy;
  const float hpz = hit ? r.oz + h.t * r.dz : r.oz;
  float rx, ry, rz;
  unit_sphere_draw(pix_u, s, b, rx, ry, rz);
  const Scatter sc = scatter(r, h.nx, h.ny, h.nz, h.kind, h.ar, h.ag, h.ab,
                             h.fz, h.ir, rx, ry, rz);
  const bool miss = alive && !hit;
  const bool terminal = alive && hit && sc.term;
  const bool cont = alive && hit && !sc.term;
  const float tsky = 0.5f * (r.dy + 1.0f);
  const float skyr = 1.0f - tsky * 0.5f;
  const float skyg = 1.0f - tsky * SKY_G;
  c.rr = c.rr + (miss ? c.tpr * skyr : (terminal ? c.tpr * sc.cr : 0.0f));
  c.rg = c.rg + (miss ? c.tpg * skyg : (terminal ? c.tpg * sc.cg : 0.0f));
  c.rb = c.rb + (miss ? c.tpb * 1.0f : (terminal ? c.tpb * sc.cb : 0.0f));
  if (cont) {
    c.tpr = c.tpr * sc.cr;
    c.tpg = c.tpg * sc.cg;
    c.tpb = c.tpb * sc.cb;
    r.ox = hpx;
    r.oy = hpy;
    r.oz = hpz;
    r.dx = sc.dx;
    r.dy = sc.dy;
    r.dz = sc.dz;
  }
  return cont;
}

}  // namespace rt_path
