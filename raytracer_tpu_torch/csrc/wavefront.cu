// K1: the fused forward path-trace kernel, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracer_tpu/ops/pallas/wavefront.py
// render_linear_pallas / _make_kernel (the pl.pallas_call at :1032), with
// its helpers _block_pixel_setup, _pcg3d/_u01, _sphere_loop + _aabb_test,
// _sphere_normals, _make_tri_body, _resolve_tri_normals and
// _scatter_bookkeep.  It computes the same thing: per pixel, spp camera
// samples with pcg3d jitter (site 0), a bounce loop with early exit, closest
// hit over spheres and triangles (flat, or culled by cluster AABBs), the
// material scatter with pcg3d draws at site 1+b, the sky, and the
// throughput/radiance bookkeeping; outputs are the mean RGB per pixel and a
// per-pixel count of traced segments.
//
// What bounds it on the card: FP32 ALU issue and branch divergence, not
// bytes.  Each ray segment costs ~25 flops per sphere and ~40 per triangle
// against a few KB of scene tables that stay in L1/L2; device memory sees one
// write of the image per launch.  Divergence comes from rays of one warp that
// die at different bounces and from cluster culling.
//
// What the design does about it:
//  * one thread per pixel, all ray state in registers (~15 floats of ray and
//    throughput plus the 10-float hit state), looping samples and bounces;
//  * each warp owns a compact 8x4 pixel tile (blocks are 16x8), so its rays
//    form a tight frustum and take the same cluster decisions;
//  * scene tables are read-only row-major (ROWS, N) arrays: every lane of a
//    warp reads the same column, one broadcast load through L1;
//  * culling has the TPU kernel's semantics one level down: each lane runs
//    the AABB slab test and the warp grinds a cluster's members if any live
//    lane might hit (__any_sync).  Loop bounds stay warp-uniform, so every
//    lane, live or not, reaches every __any_sync;
//  * the bounce loop ends when no lane of the warp is alive; dead lanes
//    change nothing, so this is the per-pixel result of the full loop.
//
// Numerics: built with -fmad=false and IEEE division and square root, so
// the operation order below (which follows the Pallas body) gives the same
// floats as the plain PyTorch version, render_linear_ref.  The per-ray code
// that decides a path (hit steps, draws, scatter) is in path_common.cuh,
// shared with K5, which must re-trace exactly these paths.

#include "path_common.cuh"

namespace {

using namespace rt_path;

struct Params {
  const float *sph;
  const float *tri;
  const float *cam;
  const float *sphc_b;
  const int *sphc_r;
  const float *tric_b;
  const int *tric_r;
  float *mean;
  int *segs;
  int n_sph, n_tri, n_sphc, n_tric;
  int width, height, shard_rows, row_offset, row_stride;
  unsigned seed_word;
  int spp, depth;
  float inv_spp;
};

template <bool PARITY>
__global__ void __launch_bounds__(THREADS)
    wavefront_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // _block_pixel_setup: global (row, col) -> pixel id and RNG counter
  const int pcol = blockIdx.x * BLOCK_W + (warp & 1) * WARP_W + (lane & 7);
  const int band_row = blockIdx.y * BLOCK_H + (warp >> 1) * WARP_H + (lane >> 3);
  const int prow = p.row_offset + band_row * p.row_stride;
  // lanes outside the image or the band are dead from the start, but stay in
  // the warp-uniform loops below
  const bool active0 =
      (prow < p.height) && (pcol < p.width) && (band_row < p.shard_rows);
  const int prow_c = min(prow, p.height - 1);
  const int pcol_c = min(pcol, p.width - 1);
  const unsigned pix_u = (unsigned)(prow_c * p.width + pcol_c) + p.seed_word;
  const float prow_f = (float)prow_c;
  const float pcol_f = (float)pcol_c;
  const float w1 = (float)(p.width - 1);
  const float h1 = (float)(p.height - 1);

  const float *__restrict__ sph = p.sph;
  const float *__restrict__ tri = p.tri;
  const float ox0 = p.cam[0], oy0 = p.cam[1], oz0 = p.cam[2];
  const float llcx = p.cam[3], llcy = p.cam[4], llcz = p.cam[5];
  const float hx = p.cam[6], hy = p.cam[7], hz = p.cam[8];
  const float vx = p.cam[9], vy = p.cam[10], vz = p.cam[11];

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int seg = 0;

  for (int s = 0; s < p.spp; ++s) {
    unsigned ju = pix_u, jv = (unsigned)s, jw = 0u;
    pcg3d(ju, jv, jw);
    const float u = (pcol_f + u01(ju)) / w1;
    const float v = (prow_f + u01(jv)) / h1;
    Ray r;
    r.dx = llcx + u * hx + v * vx - ox0;
    r.dy = llcy + u * hy + v * vy - oy0;
    r.dz = llcz + u * hz + v * vz - oz0;
    const float dlen = sqrtf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz);
    r.dx = r.dx / dlen;
    r.dy = r.dy / dlen;
    r.dz = r.dz / dlen;
    r.ox = ox0;
    r.oy = oy0;
    r.oz = oz0;

    float tpr = 1.0f, tpg = 1.0f, tpb = 1.0f;
    float rr = 0.0f, rg = 0.0f, rb = 0.0f;
    bool alive = active0;

    for (int b = 0; b < p.depth; ++b) {
      if (!__any_sync(FULL_MASK, alive)) break;  // warp-uniform early exit
      seg += alive ? 1 : 0;

      Hit h = {BIG,  0.0f, 0.0f, 1.0f, 0.0f, 0.0f,
               0.0f, 0.0f, 0.0f, 1.0f, -1.0f, 1.0f};

      // ---- spheres (common.rs:60-98) ----
      if (p.n_sphc > 0) {
        const float ivx = inv_dir(r.dx), ivy = inv_dir(r.dy),
                    ivz = inv_dir(r.dz);
        for (int ci = 0; ci < p.n_sphc; ++ci) {
          const bool possible =
              alive && aabb_test(p.sphc_b, p.n_sphc, ci, r, ivx, ivy, ivz, h.t);
          if (__any_sync(FULL_MASK, possible)) {
            const int s1 = p.sphc_r[p.n_sphc + ci];
            for (int si = p.sphc_r[ci]; si < s1; ++si)
              sphere_step<false>(sph, p.n_sph, si, r, h);
          }
        }
      } else {
        for (int si = 0; si < p.n_sph; ++si)
          sphere_step<false>(sph, p.n_sph, si, r, h);
      }

      // ---- _sphere_normals: normalize(p - c), flipped for r < 0 ----
      {
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

      // ---- triangles (common.rs:124-166 via edge constants) ----
      triangle_hits<PARITY, false>(tri, p.n_tri, p.tric_b, p.tric_r, p.n_tric,
                                   p.n_sph, r, alive, h);

      // ---- _resolve_tri_normals ----
      {
        const bool is_tri = h.kind >= 7.5f;
        float ln = sqrtf(h.nx * h.nx + h.ny * h.ny + h.nz * h.nz);
        ln = ln == 0.0f ? 1.0f : ln;
        h.nx = is_tri ? h.nx / ln : h.nx;
        h.ny = is_tri ? h.ny / ln : h.ny;
        h.nz = is_tri ? h.nz / ln : h.nz;
        h.kind = is_tri ? h.kind - 8.0f : h.kind;
      }
      const bool hit = h.t < BIG;
      const float hpx = hit ? r.ox + h.t * r.dx : r.ox;
      const float hpy = hit ? r.oy + h.t * r.dy : r.oy;
      const float hpz = hit ? r.oz + h.t * r.dz : r.oz;

      // ---- _scatter_bookkeep: draw at site 1+b, scatter, bookkeeping ----
      float rx, ry, rz;
      unit_sphere_draw(pix_u, s, b, rx, ry, rz);
      const Scatter sc = scatter(r, h.nx, h.ny, h.nz, h.kind, h.ar, h.ag, h.ab,
                                 h.fz, h.ir, rx, ry, rz);
      const float scr = sc.cr, scg = sc.cg, scb = sc.cb;
      const bool term = sc.term;

      // bounce bookkeeping (common.rs:263-285)
      const bool miss = alive && !hit;
      const bool terminal = alive && hit && term;
      const bool cont = alive && hit && !term;
      const float tsky = 0.5f * (r.dy + 1.0f);
      const float skyr = 1.0f - tsky * 0.5f;
      const float skyg = 1.0f - tsky * SKY_G;
      rr = rr + (miss ? tpr * skyr : (terminal ? tpr * scr : 0.0f));
      rg = rg + (miss ? tpg * skyg : (terminal ? tpg * scg : 0.0f));
      rb = rb + (miss ? tpb * 1.0f : (terminal ? tpb * scb : 0.0f));
      if (cont) {
        tpr = tpr * scr;
        tpg = tpg * scg;
        tpb = tpb * scb;
        r.ox = hpx;
        r.oy = hpy;
        r.oz = hpz;
        r.dx = sc.dx;
        r.dy = sc.dy;
        r.dz = sc.dz;
      }
      alive = cont;
    }
    acc_r = acc_r + rr;
    acc_g = acc_g + rg;
    acc_b = acc_b + rb;
  }

  if (band_row < p.shard_rows && pcol < p.width) {
    const long long o = (long long)band_row * p.width + pcol;
    p.mean[3 * o + 0] = acc_r * p.inv_spp;
    p.mean[3 * o + 1] = acc_g * p.inv_spp;
    p.mean[3 * o + 2] = acc_b * p.inv_spp;
    p.segs[o] = seg;
  }
}

}  // namespace

// Launch K1 on `stream`.  Tables are row-major (ROWS, N) float32 device
// arrays; cluster tables may be null with a count of 0.  Writes mean
// [shard_rows, width, 3] float32 and segs [shard_rows, width] int32.
// Returns cudaGetLastError() after the launch.
extern "C" int rt_wavefront_render(
    const float *sph, int n_sph, const float *tri, int n_tri, const float *cam,
    const float *sphc_b, const int *sphc_r, int n_sphc, const float *tric_b,
    const int *tric_r, int n_tric, float *mean, int *segs, int width,
    int height, unsigned int seed_word, int row_offset, int row_stride,
    int shard_rows, int spp, int depth, float inv_spp, int parity_plane_sign,
    void *stream) {
  if (width < 1 || height < 1 || shard_rows < 1 || n_sph < 1 || n_tri < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.sph = sph;
  p.tri = tri;
  p.cam = cam;
  p.sphc_b = sphc_b;
  p.sphc_r = sphc_r;
  p.tric_b = tric_b;
  p.tric_r = tric_r;
  p.mean = mean;
  p.segs = segs;
  p.n_sph = n_sph;
  p.n_tri = n_tri;
  p.n_sphc = n_sphc;
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
    wavefront_kernel<true><<<grid, THREADS, 0, s>>>(p);
  else
    wavefront_kernel<false><<<grid, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}
