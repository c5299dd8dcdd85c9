// K5: the backward path-trace kernel (the adjoint of K1), hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel raytracer_tpu/ops/pallas/wavefront_bwd.py
// render_grad_pallas / _make_bwd_kernel (the pl.pallas_call at :964).  It
// computes the same thing: per pixel and sample, a forward sweep that
// re-traces K1's path and keeps 22 residual planes per bounce (ray,
// throughput, hit t, winner id, alive, the winner's centre or plane normal,
// radius or plane d, kind, albedo, fuzz, ir), then a backward sweep over
// the bounces in reverse that propagates the image cotangent by hand:
// implicit dt for spheres, direct dt for triangles under either plane sign,
// the normalize adjoint, the diffuse, metal, dielectric and sky adjoints,
// and at the end the camera adjoint.  Outputs: per bounce and lane the
// winner id (-1 where the lane did not hit) and 9 gradients (centre or
// plane normal xyz, radius or plane d, albedo rgb, fuzz, ir), and per lane
// the 12 camera cotangents summed over the samples.  The reduction from
// lanes to primitives is plain PyTorch (ops/cuda/wavefront_bwd.py).
//
// What bounds it on the card: FP32 ALU issue and divergence, as for K1 (it
// traces each path once and runs ~250 flops of adjoint per bounce), plus
// the residuals' traffic.  Device memory sees the image cotangent once and
// 40 bytes per lane and bounce of gradients.
//
// What the design does about it:
//  * K1's thread layout: one thread per pixel looping over samples, warps on
//    8x4 pixel tiles, blocks of 16x8;
//  * the same per-ray code as K1 (path_common.cuh: hit steps, tie rules,
//    pcg3d draws, scatter), so each lane re-traces exactly K1's path;
//  * spheres are scanned flat (the differentiable path packs them without a
//    permutation); triangles cull by cluster AABBs with K1's warp rule, every
//    lane reaching every __any_sync;
//  * residual storage: a per-thread array of MAX_DEPTH x 22 floats.  It
//    lives in local memory, which the hardware interleaves across the lanes
//    of a warp (coalesced like a plane-major scratch buffer, with no
//    allocation or indexing in the wrapper) and caches in L1.  The wrapper
//    raises on depth > MAX_DEPTH; nothing is ever cut short;
//  * the camera cotangents are summed per lane in registers over the samples
//    and written to a [12, lanes] buffer that the wrapper sums with
//    torch.sum: no atomics, so the result is the same from run to run;
//  * the forward sweep ends when no lane of the warp is alive, like K1's;
//    bounces it did not trace have winner id -1 and leave the adjoints
//    unchanged.
//
// Guards are the TPU kernel's: grazing sphere hits (|u.d| < 1e-12) and
// parallel triangle planes get a zero t adjoint, normalising a zero vector
// gives a zero cotangent, dead lanes write winner id -1.
//
// Numerics: -fmad=false and IEEE division and square root, the Pallas
// body's operation order, float32 constants in hex: the plain version
// (render_grad_ref) follows the same order.

#include "path_common.cuh"

namespace {

using namespace rt_path;

constexpr int MAX_DEPTH = 16;
constexpr int GRAD_PLANES = 10;
constexpr float EPS12 = 0x1.197998p-40f;  // f32(1e-12)
constexpr float HUGE_ = 0x1.93e594p+99f;  // f32(1e30)

// residual planes per bounce (wavefront_bwd.py:68-75)
enum {
  RS_OX, RS_OY, RS_OZ, RS_DX, RS_DY, RS_DZ, RS_TPR, RS_TPG, RS_TPB, RS_T,
  RS_WIN, RS_ALIVE, RS_CX, RS_CY, RS_CZ, RS_R, RS_KIND, RS_AR, RS_AG, RS_AB,
  RS_FZ, RS_IR, RES_PLANES
};

struct GradParams {
  const float *sph;
  const float *tri;
  const float *cam;
  const float *tric_b;
  const int *tric_r;
  const float *g;   // image cotangent [shard_rows, width, 3]
  float *slab;      // [spp, depth, GRAD_PLANES, shard_rows * width]
  float *cam_lanes; // [12, shard_rows * width]
  int n_sph, n_tri, n_tric;
  int width, height, shard_rows, row_offset, row_stride;
  unsigned seed_word;
  int spp, depth;
  float inv_spp;
};

// unit normal at a hit from the residuals (wavefront_bwd.py:343-362)
__device__ __forceinline__ void shading_normal(const float *rs, bool is_tri,
                                               float &nx, float &ny,
                                               float &nz, float &kind) {
  const bool hit = rs[RS_T] < BIG;
  const float hpx = hit ? rs[RS_OX] + rs[RS_T] * rs[RS_DX] : rs[RS_OX];
  const float hpy = hit ? rs[RS_OY] + rs[RS_T] * rs[RS_DY] : rs[RS_OY];
  const float hpz = hit ? rs[RS_OZ] + rs[RS_T] * rs[RS_DZ] : rs[RS_OZ];
  kind = rs[RS_KIND];
  const bool neg_r = kind >= 3.5f;
  const float sgn = neg_r ? -1.0f : 1.0f;
  kind = neg_r ? kind - 4.0f : kind;
  const float snx = hpx - rs[RS_CX];
  const float sny = hpy - rs[RS_CY];
  const float snz = hpz - rs[RS_CZ];
  float slen = sqrtf(snx * snx + sny * sny + snz * snz);
  slen = (slen == 0.0f ? 1.0f : slen) * sgn;
  const float cx = rs[RS_CX], cy = rs[RS_CY], cz = rs[RS_CZ];
  float tln = sqrtf(cx * cx + cy * cy + cz * cz);
  tln = tln == 0.0f ? 1.0f : tln;
  nx = is_tri ? cx / tln : snx / slen;
  ny = is_tri ? cy / tln : sny / slen;
  nz = is_tri ? cz / tln : snz / slen;
}

template <bool PARITY>
__global__ void __launch_bounds__(THREADS)
    wavefront_grad_kernel(const GradParams p) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pcol = blockIdx.x * BLOCK_W + (warp & 1) * WARP_W + (lane & 7);
  const int band_row = blockIdx.y * BLOCK_H + (warp >> 1) * WARP_H + (lane >> 3);
  const int prow = p.row_offset + band_row * p.row_stride;
  const bool in_band = (band_row < p.shard_rows) && (pcol < p.width);
  const bool active0 = (prow < p.height) && in_band;
  const int prow_c = min(prow, p.height - 1);
  const int pcol_c = min(pcol, p.width - 1);
  const unsigned pix_u = (unsigned)(prow_c * p.width + pcol_c) + p.seed_word;
  const float prow_f = (float)prow_c;
  const float pcol_f = (float)pcol_c;
  const float w1 = (float)(p.width - 1);
  const float h1 = (float)(p.height - 1);
  const long long npix = (long long)p.shard_rows * p.width;
  const long long o = in_band ? (long long)band_row * p.width + pcol : 0;
  const float S = (float)p.n_sph;

  const float *__restrict__ sph = p.sph;
  const float *__restrict__ tri = p.tri;
  const float ox0 = p.cam[0], oy0 = p.cam[1], oz0 = p.cam[2];
  const float llcx = p.cam[3], llcy = p.cam[4], llcz = p.cam[5];
  const float hx = p.cam[6], hy = p.cam[7], hz = p.cam[8];
  const float vx = p.cam[9], vy = p.cam[10], vz = p.cam[11];

  // image cotangent of this pixel, scaled by 1/spp (mean over samples)
  const float gr = in_band ? p.g[3 * o + 0] * p.inv_spp : 0.0f;
  const float gg = in_band ? p.g[3 * o + 1] * p.inv_spp : 0.0f;
  const float gb = in_band ? p.g[3 * o + 2] * p.inv_spp : 0.0f;

  float cam_acc[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) cam_acc[k] = 0.0f;
  float res[MAX_DEPTH][RES_PLANES];

  for (int s = 0; s < p.spp; ++s) {
    unsigned ju = pix_u, jv = (unsigned)s, jw = 0u;
    pcg3d(ju, jv, jw);
    const float u = (pcol_f + u01(ju)) / w1;
    const float v = (prow_f + u01(jv)) / h1;
    const float dvx = llcx + u * hx + v * vx - ox0;
    const float dvy = llcy + u * hy + v * vy - oy0;
    const float dvz = llcz + u * hz + v * vz - oz0;
    const float dlen = sqrtf(dvx * dvx + dvy * dvy + dvz * dvz);
    const float dx0 = dvx / dlen, dy0 = dvy / dlen, dz0 = dvz / dlen;
    Ray r = {ox0, oy0, oz0, dx0, dy0, dz0};
    float tpr = 1.0f, tpg = 1.0f, tpb = 1.0f;
    bool alive = active0;

    // ---------------- forward sweep, keeping the residuals ----------------
    int nb = 0;
    for (int b = 0; b < p.depth; ++b) {
      if (!__any_sync(FULL_MASK, alive)) break;  // warp-uniform early exit
      nb = b + 1;
      Hit h = {BIG,  0.0f, 0.0f, 1.0f, 0.0f, 0.0f,
               0.0f, 0.0f, 0.0f, 1.0f, -1.0f, 1.0f};
      for (int si = 0; si < p.n_sph; ++si)
        sphere_step<true>(sph, p.n_sph, si, r, h);
      triangle_hits<PARITY, true>(tri, p.n_tri, p.tric_b, p.tric_r, p.n_tric,
                                  p.n_sph, r, alive, h);
      const bool is_tri = h.win >= S - 0.5f;
      float *rs = res[b];
      rs[RS_OX] = r.ox;
      rs[RS_OY] = r.oy;
      rs[RS_OZ] = r.oz;
      rs[RS_DX] = r.dx;
      rs[RS_DY] = r.dy;
      rs[RS_DZ] = r.dz;
      rs[RS_TPR] = tpr;
      rs[RS_TPG] = tpg;
      rs[RS_TPB] = tpb;
      rs[RS_T] = h.t;
      rs[RS_WIN] = h.win;
      rs[RS_ALIVE] = alive ? 1.0f : 0.0f;
      rs[RS_CX] = h.nx;
      rs[RS_CY] = h.ny;
      rs[RS_CZ] = h.nz;
      rs[RS_R] = h.rr;
      rs[RS_KIND] = is_tri ? h.kind - 8.0f : h.kind;   // the raw kind
      rs[RS_AR] = h.ar;
      rs[RS_AG] = h.ag;
      rs[RS_AB] = h.ab;
      rs[RS_FZ] = h.fz;
      rs[RS_IR] = h.ir;

      float nx, ny, nz, kind;
      shading_normal(rs, is_tri, nx, ny, nz, kind);
      float rx, ry, rz;
      unit_sphere_draw(pix_u, s, b, rx, ry, rz);
      const Scatter sc = scatter(r, nx, ny, nz, kind, h.ar, h.ag, h.ab, h.fz,
                                 h.ir, rx, ry, rz);
      const bool hit = h.t < BIG;
      const bool cont = alive && hit && !sc.term;
      if (cont) {
        tpr = tpr * sc.cr;
        tpg = tpg * sc.cg;
        tpb = tpb * sc.cb;
        r.ox = r.ox + h.t * r.dx;
        r.oy = r.oy + h.t * r.dy;
        r.oz = r.oz + h.t * r.dz;
        r.dx = sc.dx;
        r.dy = sc.dy;
        r.dz = sc.dz;
      }
      alive = cont;
    }

    // ---------------- backward sweep ----------------------------------------
    float a_ox = 0.0f, a_oy = 0.0f, a_oz = 0.0f, a_dx = 0.0f, a_dy = 0.0f,
          a_dz = 0.0f, a_tr = 0.0f, a_tg = 0.0f, a_tb = 0.0f;
    float *slab_s = p.slab + (long long)s * p.depth * GRAD_PLANES * npix + o;
    for (int b = p.depth - 1; b >= nb; --b) {   // not traced: no winner
      if (in_band) {
        float *out = slab_s + (long long)b * GRAD_PLANES * npix;
        out[0] = -1.0f;
#pragma unroll
        for (int k = 1; k < GRAD_PLANES; ++k) out[k * npix] = 0.0f;
      }
    }
    for (int b = nb - 1; b >= 0; --b) {
      const float *rs = res[b];
      const float ox = rs[RS_OX], oy = rs[RS_OY], oz = rs[RS_OZ];
      const float dx = rs[RS_DX], dy = rs[RS_DY], dz = rs[RS_DZ];
      const float tpr_ = rs[RS_TPR], tpg_ = rs[RS_TPG], tpb_ = rs[RS_TPB];
      const float t_best = rs[RS_T], win = rs[RS_WIN];
      const bool alive_b = rs[RS_ALIVE] > 0.5f;
      const float cxw = rs[RS_CX], cyw = rs[RS_CY], czw = rs[RS_CZ];
      const float rw = rs[RS_R];
      float kind = rs[RS_KIND];
      const float ar = rs[RS_AR], ag = rs[RS_AG], ab = rs[RS_AB];
      const float fz = rs[RS_FZ], irx = rs[RS_IR];

      // --- recompute the forward shading primals ---
      const bool is_tri = win >= S - 0.5f;
      const float trif = is_tri ? 1.0f : 0.0f;
      const float sphfm = 1.0f - trif;
      const bool hit = t_best < BIG;
      const float t_s = hit ? t_best : 0.0f;
      const float hpx = ox + t_s * dx;
      const float hpy = oy + t_s * dy;
      const float hpz = oz + t_s * dz;
      const bool neg_r = kind >= 3.5f;
      const float sgn = neg_r ? -1.0f : 1.0f;
      kind = neg_r ? kind - 4.0f : kind;
      const float ux = hpx - cxw;
      const float uy = hpy - cyw;
      const float uz = hpz - czw;
      float ulen = sqrtf(ux * ux + uy * uy + uz * uz);
      ulen = ulen == 0.0f ? 1.0f : ulen;
      float tln = sqrtf(cxw * cxw + cyw * cyw + czw * czw);
      tln = tln == 0.0f ? 1.0f : tln;
      const float tnhx = cxw / tln;
      const float tnhy = cyw / tln;
      const float tnhz = czw / tln;
      const float nx = is_tri ? tnhx : (ux / ulen) * sgn;
      const float ny = is_tri ? tnhy : (uy / ulen) * sgn;
      const float nz = is_tri ? tnhz : (uz / ulen) * sgn;

      float rx, ry, rz;
      unit_sphere_draw(pix_u, s, b, rx, ry, rz);

      // diffuse
      const float sdx = nx + rx;
      const float sdy = ny + ry;
      const float sdz = nz + rz;
      const bool deg =
          (fabsf(sdx) < EPS8) && (fabsf(sdy) < EPS8) && (fabsf(sdz) < EPS8);
      float sl = sqrtf(sdx * sdx + sdy * sdy + sdz * sdz);
      sl = sl == 0.0f ? 1.0f : sl;
      // metal
      const float dn = dx * nx + dy * ny + dz * nz;
      const float mx = dx - 2.0f * dn * nx + fz * rx;
      const float my = dy - 2.0f * dn * ny + fz * ry;
      const float mz = dz - 2.0f * dn * nz + fz * rz;
      const bool met_keep = (mx * nx + my * ny + mz * nz) >= 0.0f;
      float ml = sqrtf(mx * mx + my * my + mz * mz);
      ml = ml == 0.0f ? 1.0f : ml;
      // dielectric
      const bool inside = dn >= 0.0f;
      const float sgn2 = inside ? -1.0f : 1.0f;
      const float nex = sgn2 * nx;
      const float ney = sgn2 * ny;
      const float nez = sgn2 * nz;
      const float ratio = inside ? 1.0f / irx : irx;
      const float cos_t = -(dx * nex + dy * ney + dz * nez);
      const float wx = dx + cos_t * nex;
      const float wy = dy + cos_t * ney;
      const float wz = dz + cos_t * nez;
      const float px = ratio * wx;
      const float py = ratio * wy;
      const float pz = ratio * wz;
      const float pl2 = px * px + py * py + pz * pz;
      const float amag = fabsf(1.0f - pl2);
      const float para = -sqrtf(amag);
      const float qx = px + para * nex;
      const float qy = py + para * ney;
      const float qz = pz + para * nez;
      float ql = sqrtf(qx * qx + qy * qy + qz * qz);
      ql = ql == 0.0f ? 1.0f : ql;

      const bool is_dif = kind < 0.5f;
      const bool is_met = (kind >= 0.5f) && (kind < 1.5f);
      const bool is_die = (kind >= 1.5f) && (kind < 2.5f);
      const bool is_emi = kind >= 2.5f;
      const float scr = is_die ? 1.0f : ar;
      const float scg = is_die ? 1.0f : ag;
      const float scb = is_die ? 1.0f : ab;
      const bool term = is_emi || (is_met && !met_keep);
      const float contf = (alive_b && hit && !term) ? 1.0f : 0.0f;
      const float missf = (alive_b && !hit) ? 1.0f : 0.0f;
      const float termf = (alive_b && hit && term) ? 1.0f : 0.0f;

      // --- throughput and radiance adjoints ---
      const float tsky = 0.5f * (dy + 1.0f);
      const float skyr = 1.0f - tsky * 0.5f;
      const float skyg = 1.0f - tsky * SKY_G;
      const float c_r = contf * a_tr * tpr_ + termf * gr * tpr_;
      const float c_g = contf * a_tg * tpg_ + termf * gg * tpg_;
      const float c_b = contf * a_tb * tpb_ + termf * gb * tpb_;
      const float n_tr = contf * a_tr * scr + (1.0f - contf) * a_tr +
                         missf * gr * skyr + termf * gr * scr;
      const float n_tg = contf * a_tg * scg + (1.0f - contf) * a_tg +
                         missf * gg * skyg + termf * gg * scg;
      const float n_tb = contf * a_tb * scb + (1.0f - contf) * a_tb +
                         missf * gb + termf * gb * scb;
      const float diecf = is_die ? 0.0f : 1.0f;  // dielectric colour is 1
      float g_ar = diecf * c_r;
      float g_ag = diecf * c_g;
      float g_ab = diecf * c_b;
      // sky: d_bar.y += -0.5 (0.5 skyr_bar + 0.3 skyg_bar)
      const float sky_r_bar = missf * gr * tpr_;
      const float sky_g_bar = missf * gg * tpg_;
      const float tsky_bar = -(0.5f * sky_r_bar + SKY_G * sky_g_bar);
      const float dy_sky = 0.5f * tsky_bar;

      // o' = where(cont, p, o); d' = where(cont, nd, d)
      float p_bx = contf * a_ox;
      float p_by = contf * a_oy;
      float p_bz = contf * a_oz;
      float n_ox = (1.0f - contf) * a_ox;
      float n_oy = (1.0f - contf) * a_oy;
      float n_oz = (1.0f - contf) * a_oz;
      const float nd_bx = contf * a_dx;
      const float nd_by = contf * a_dy;
      const float nd_bz = contf * a_dz;
      float n_dx = (1.0f - contf) * a_dx;
      float n_dy = (1.0f - contf) * a_dy + dy_sky;
      float n_dz = (1.0f - contf) * a_dz;

      // nd = select(kind: diffuse / metal / dielectric / normal)
      const float dif_f = is_dif ? 1.0f : 0.0f;
      const float met_f = is_met ? 1.0f : 0.0f;
      const float die_f = is_die ? 1.0f : 0.0f;
      const float emi_f = is_emi ? 1.0f : 0.0f;
      const float dd_bx = dif_f * nd_bx;
      const float dd_by = dif_f * nd_by;
      const float dd_bz = dif_f * nd_bz;
      const float md_bx = met_f * nd_bx;
      const float md_by = met_f * nd_by;
      const float md_bz = met_f * nd_bz;
      const float ed_bx = die_f * nd_bx;
      const float ed_by = die_f * nd_by;
      const float ed_bz = die_f * nd_bz;
      float n_nx = emi_f * nd_bx;
      float n_ny = emi_f * nd_by;
      float n_nz = emi_f * nd_bz;

      // diffuse: sd = where(deg, n, (n + r) / sl)
      const float degf = deg ? 1.0f : 0.0f;
      const float vhx = sdx / sl;
      const float vhy = sdy / sl;
      const float vhz = sdz / sl;
      const float dotg = vhx * dd_bx + vhy * dd_by + vhz * dd_bz;
      const float vb_x = (dd_bx - vhx * dotg) / sl;
      const float vb_y = (dd_by - vhy * dotg) / sl;
      const float vb_z = (dd_bz - vhz * dotg) / sl;
      n_nx = n_nx + (degf * dd_bx + (1.0f - degf) * vb_x);
      n_ny = n_ny + (degf * dd_by + (1.0f - degf) * vb_y);
      n_nz = n_nz + (degf * dd_bz + (1.0f - degf) * vb_z);

      // metal: md = m / ml
      const float mhx = mx / ml;
      const float mhy = my / ml;
      const float mhz = mz / ml;
      const float dotm = mhx * md_bx + mhy * md_by + mhz * md_bz;
      const float mb_x = (md_bx - mhx * dotm) / ml;
      const float mb_y = (md_by - mhy * dotm) / ml;
      const float mb_z = (md_bz - mhz * dotm) / ml;
      float g_fz = mb_x * rx + mb_y * ry + mb_z * rz;
      const float n_refl = nx * mb_x + ny * mb_y + nz * mb_z;
      n_dx = n_dx + (mb_x - 2.0f * nx * n_refl);
      n_dy = n_dy + (mb_y - 2.0f * ny * n_refl);
      n_dz = n_dz + (mb_z - 2.0f * nz * n_refl);
      n_nx = n_nx + -2.0f * (dx * n_refl + dn * mb_x);
      n_ny = n_ny + -2.0f * (dy * n_refl + dn * mb_y);
      n_nz = n_nz + -2.0f * (dz * n_refl + dn * mb_z);

      // dielectric: dd = q / ql
      const float qhx = qx / ql;
      const float qhy = qy / ql;
      const float qhz = qz / ql;
      const float dotq = qhx * ed_bx + qhy * ed_by + qhz * ed_bz;
      const float qb_x = (ed_bx - qhx * dotq) / ql;
      const float qb_y = (ed_by - qhy * dotq) / ql;
      const float qb_z = (ed_bz - qhz * dotq) / ql;
      const float para_bar = qb_x * nex + qb_y * ney + qb_z * nez;
      float ne_bx = para * qb_x;
      float ne_by = para * qb_y;
      float ne_bz = para * qb_z;
      const float amag_s = amag == 0.0f ? 1.0f : amag;
      const float sgn_a = pl2 <= 1.0f ? 1.0f : -1.0f;
      const float pl2_bar =
          amag == 0.0f ? 0.0f : para_bar * sgn_a / (2.0f * sqrtf(amag_s));
      const float pb_x = qb_x + 2.0f * pl2_bar * px;
      const float pb_y = qb_y + 2.0f * pl2_bar * py;
      const float pb_z = qb_z + 2.0f * pl2_bar * pz;
      const float ratio_bar = pb_x * wx + pb_y * wy + pb_z * wz;
      const float wb_x = ratio * pb_x;
      const float wb_y = ratio * pb_y;
      const float wb_z = ratio * pb_z;
      const float cos_bar = wb_x * nex + wb_y * ney + wb_z * nez;
      ne_bx = ne_bx + cos_t * wb_x;
      ne_by = ne_by + cos_t * wb_y;
      ne_bz = ne_bz + cos_t * wb_z;
      n_dx = n_dx + wb_x;
      n_dy = n_dy + wb_y;
      n_dz = n_dz + wb_z;
      n_dx = n_dx + -cos_bar * nex;
      n_dy = n_dy + -cos_bar * ney;
      n_dz = n_dz + -cos_bar * nez;
      ne_bx = ne_bx + -cos_bar * dx;
      ne_by = ne_by + -cos_bar * dy;
      ne_bz = ne_bz + -cos_bar * dz;
      n_nx = n_nx + sgn2 * ne_bx;
      n_ny = n_ny + sgn2 * ne_by;
      n_nz = n_nz + sgn2 * ne_bz;
      float g_ir = ratio_bar * (inside ? -1.0f / (irx * irx) : 1.0f);

      // --- the normal cotangent by winner type ---
      // triangle: n = nplane / |nplane|, the normalize adjoint into the
      // plane-normal cotangent
      const float dotn_t = tnhx * n_nx + tnhy * n_ny + tnhz * n_nz;
      const float gn_nx = trif * (n_nx - tnhx * dotn_t) / tln;
      const float gn_ny = trif * (n_ny - tnhy * dotn_t) / tln;
      const float gn_nz = trif * (n_nz - tnhz * dotn_t) / tln;
      // sphere: n = sgn u / |u|, then u = p - c
      const float n0x = ux / ulen;
      const float n0y = uy / ulen;
      const float n0z = uz / ulen;
      const float nb0x = sgn * n_nx;
      const float nb0y = sgn * n_ny;
      const float nb0z = sgn * n_nz;
      const float dotn = n0x * nb0x + n0y * nb0y + n0z * nb0z;
      const float ub_x = sphfm * (nb0x - n0x * dotn) / ulen;
      const float ub_y = sphfm * (nb0y - n0y * dotn) / ulen;
      const float ub_z = sphfm * (nb0z - n0z * dotn) / ulen;
      p_bx = p_bx + ub_x;
      p_by = p_by + ub_y;
      p_bz = p_bz + ub_z;
      float g_cx = -ub_x;
      float g_cy = -ub_y;
      float g_cz = -ub_z;

      // p = o + t d on hit lanes
      const float hitf = hit ? 1.0f : 0.0f;
      n_ox = n_ox + p_bx;
      n_oy = n_oy + p_by;
      n_oz = n_oz + p_bz;
      n_dx = n_dx + hitf * t_s * p_bx;
      n_dy = n_dy + hitf * t_s * p_by;
      n_dz = n_dz + hitf * t_s * p_bz;
      const float t_bar = hitf * (p_bx * dx + p_by * dy + p_bz * dz);

      // t cotangent, sphere winners: implicit differentiation; grazing hits
      // (u.d -> 0) are guard-zeroed
      float und = ux * dx + uy * dy + uz * dz;
      und = fabsf(und) < EPS12 ? HUGE_ : und;
      const float inv_und = sphfm * t_bar / und;
      g_cx = g_cx + ux * inv_und;
      g_cy = g_cy + uy * inv_und;
      g_cz = g_cz + uz * inv_und;
      const float g_r = rw * inv_und;
      n_ox = n_ox + -ux * inv_und;
      n_oy = n_oy + -uy * inv_und;
      n_oz = n_oz + -uz * inv_und;
      n_dx = n_dx + -t_s * ux * inv_und;
      n_dy = n_dy + -t_s * uy * inv_und;
      n_dz = n_dz + -t_s * uz * inv_und;

      // t cotangent, triangle winners: the plane equation (the residual's
      // CX..CZ hold the plane normal, R the plane d)
      float tnd = cxw * dx + cyw * dy + czw * dz;
      tnd = fabsf(tnd) < EPS12 ? HUGE_ : tnd;
      const float inv_tnd = trif * t_bar / tnd;
      const float g_dp = inv_tnd;
      // t = (n.o + d) / (n.d) under the parity sign, else (d - n.o) / (n.d)
      const float dno_bar = PARITY ? inv_tnd : -inv_tnd;
      const float dnd_bar = -t_s * inv_tnd;
      const float g_nx = dno_bar * ox + dnd_bar * dx + gn_nx;
      const float g_ny = dno_bar * oy + dnd_bar * dy + gn_ny;
      const float g_nz = dno_bar * oz + dnd_bar * dz + gn_nz;
      n_ox = n_ox + dno_bar * cxw;
      n_oy = n_oy + dno_bar * cyw;
      n_oz = n_oz + dno_bar * czw;
      n_dx = n_dx + dnd_bar * cxw;
      n_dy = n_dy + dnd_bar * cyw;
      n_dz = n_dz + dnd_bar * czw;

      // per-primitive gradients exist only on lanes that hit this bounce
      const bool live = alive_b && hit;
      const float hlive = live ? 1.0f : 0.0f;
      if (in_band) {
        float *out = slab_s + (long long)b * GRAD_PLANES * npix;
        out[0] = live ? win : -1.0f;
        out[1 * npix] = hlive * (is_tri ? g_nx : g_cx);
        out[2 * npix] = hlive * (is_tri ? g_ny : g_cy);
        out[3 * npix] = hlive * (is_tri ? g_nz : g_cz);
        out[4 * npix] = hlive * (is_tri ? g_dp : g_r);
        out[5 * npix] = g_ar * hlive;
        out[6 * npix] = g_ag * hlive;
        out[7 * npix] = g_ab * hlive;
        out[8 * npix] = g_fz * (hlive * met_f);
        out[9 * npix] = g_ir * (hlive * die_f);
      }

      // off hit lanes the ray cotangent is the pass-through plus the sky
      a_ox = live ? n_ox : (1.0f - contf) * a_ox;
      a_oy = live ? n_oy : (1.0f - contf) * a_oy;
      a_oz = live ? n_oz : (1.0f - contf) * a_oz;
      a_dx = live ? n_dx : (1.0f - contf) * a_dx;
      a_dy = live ? n_dy : (1.0f - contf) * a_dy + dy_sky;
      a_dz = live ? n_dz : (1.0f - contf) * a_dz;
      a_tr = n_tr;
      a_tg = n_tg;
      a_tb = n_tb;
    }

    // camera adjoint: d0 = dvec / |dvec|, o0 = origin
    const float dotd = dx0 * a_dx + dy0 * a_dy + dz0 * a_dz;
    const float db_x = (a_dx - dx0 * dotd) / dlen;
    const float db_y = (a_dy - dy0 * dotd) / dlen;
    const float db_z = (a_dz - dz0 * dotd) / dlen;
    cam_acc[0] = cam_acc[0] + (a_ox - db_x);
    cam_acc[1] = cam_acc[1] + (a_oy - db_y);
    cam_acc[2] = cam_acc[2] + (a_oz - db_z);
    cam_acc[3] = cam_acc[3] + db_x;
    cam_acc[4] = cam_acc[4] + db_y;
    cam_acc[5] = cam_acc[5] + db_z;
    cam_acc[6] = cam_acc[6] + u * db_x;
    cam_acc[7] = cam_acc[7] + u * db_y;
    cam_acc[8] = cam_acc[8] + u * db_z;
    cam_acc[9] = cam_acc[9] + v * db_x;
    cam_acc[10] = cam_acc[10] + v * db_y;
    cam_acc[11] = cam_acc[11] + v * db_z;
  }

  if (in_band) {
#pragma unroll
    for (int k = 0; k < 12; ++k) p.cam_lanes[k * npix + o] = cam_acc[k];
  }
}

}  // namespace

// Launch K5 on `stream`.  Tables as for K1 (spheres flat, triangle clusters
// optional: null with a count of 0); g is the image cotangent [shard_rows,
// width, 3].  Writes slab [spp, depth, 10, shard_rows * width] and cam_lanes
// [12, shard_rows * width] float32.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape it does not take (depth past
// MAX_DEPTH included).
extern "C" int rt_wavefront_grad(
    const float *sph, int n_sph, const float *tri, int n_tri, const float *cam,
    const float *tric_b, const int *tric_r, int n_tric, const float *g,
    float *slab, float *cam_lanes, int width, int height,
    unsigned int seed_word, int row_offset, int row_stride, int shard_rows,
    int spp, int depth, float inv_spp, int parity_plane_sign, void *stream) {
  if (width < 1 || height < 1 || shard_rows < 1 || n_sph < 1 || n_tri < 1 ||
      spp < 1 || depth < 0 || depth > MAX_DEPTH)
    return (int)cudaErrorInvalidValue;
  GradParams p;
  p.sph = sph;
  p.tri = tri;
  p.cam = cam;
  p.tric_b = tric_b;
  p.tric_r = tric_r;
  p.g = g;
  p.slab = slab;
  p.cam_lanes = cam_lanes;
  p.n_sph = n_sph;
  p.n_tri = n_tri;
  p.n_tric = n_tric;
  p.width = width;
  p.height = height;
  p.shard_rows = shard_rows;
  p.row_offset = row_offset;
  p.row_stride = row_stride;
  p.seed_word = seed_word;
  p.spp = spp;
  p.depth = depth;
  p.inv_spp = inv_spp;
  const dim3 grid((width + BLOCK_W - 1) / BLOCK_W,
                  (shard_rows + BLOCK_H - 1) / BLOCK_H);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (parity_plane_sign)
    wavefront_grad_kernel<true><<<grid, THREADS, 0, s>>>(p);
  else
    wavefront_grad_kernel<false><<<grid, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}
