// Per-ray device code shared by K1 (wavefront.cu) and K5 (wavefront_bwd.cu).
//
// K5 re-traces K1's paths before it sweeps them backward, so both kernels
// must take the same hit, draw the same random numbers and scatter the same
// way for every lane: the gradient of a path K1 did not trace belongs to
// another image.  Everything that decides a path therefore lives here once:
// the table layouts, the constants (written as the hex of their float32
// values), pcg3d, the cluster slab test, the sphere and triangle steps with
// their tie rules (spheres need a strictly smaller t, triangles win ties),
// the unit-sphere draw and the material scatter.  Both files are built with
// -fmad=false, so each expression rounds as written.

#pragma once

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

// warp tile 8x4, block tile 16x8 (2x2 warps)
constexpr int WARP_W = 8, WARP_H = 4, BLOCK_W = 16, BLOCK_H = 8;
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

// one step of _make_tri_body; the normal slots carry the raw plane normal
template <bool PARITY, bool TRACK>
__device__ __forceinline__ void tri_step(const float *__restrict__ tri, int nt,
                                         int ti, const Ray &r, Hit &h,
                                         int n_sph) {
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
      h.win = (float)n_sph + (float)ti;
      h.rr = td;
    }
  }
}

// closest hit over the flat sphere table, then the triangles (flat, or
// culled warp by warp through cluster AABBs).  Loop bounds are
// warp-uniform: every lane reaches every __any_sync.
template <bool PARITY, bool TRACK>
__device__ __forceinline__ void triangle_hits(
    const float *__restrict__ tri, int n_tri, const float *__restrict__ tric_b,
    const int *__restrict__ tric_r, int n_tric, int n_sph, const Ray &r,
    bool alive, Hit &h) {
  if (n_tric > 0) {
    const float ivx = inv_dir(r.dx), ivy = inv_dir(r.dy), ivz = inv_dir(r.dz);
    for (int ci = 0; ci < n_tric; ++ci) {
      const bool possible =
          alive && aabb_test(tric_b, n_tric, ci, r, ivx, ivy, ivz, h.t);
      if (__any_sync(FULL_MASK, possible)) {
        const int t1 = tric_r[n_tric + ci];
        for (int ti = tric_r[ci]; ti < t1; ++ti)
          tri_step<PARITY, TRACK>(tri, n_tri, ti, r, h, n_sph);
      }
    }
  } else {
    for (int ti = 0; ti < n_tri; ++ti)
      tri_step<PARITY, TRACK>(tri, n_tri, ti, r, h, n_sph);
  }
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

}  // namespace rt_path
