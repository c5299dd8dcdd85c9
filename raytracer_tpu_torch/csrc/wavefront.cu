// K1, K2 and K1-lowp: the fused forward path-trace kernel, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel raytracer_tpu/ops/pallas/wavefront.py
// render_linear_pallas / _make_kernel: K1 is the pl.pallas_call at :1032,
// K2 the one at :1015 (stream_tops > 0: the two-level _streamed_tri_walk at
// :708 over a leaf-aligned triangle table), K1-lowp the same call with
// lowp=True (_sphere_loop_lowp at :374: the sphere quadratic in bfloat16,
// the LOWP template flag, sphere_step_lowp in path_common.cuh; it scans
// the sphere table flat).  All are this kernel, with the
// helpers _block_pixel_setup, _pcg3d/_u01, _sphere_loop + _aabb_test,
// _sphere_normals, _make_tri_body, _resolve_tri_normals and
// _scatter_bookkeep; K2 is a launch with n_tops > 0, a warp-uniform runtime
// branch of triangle_hits (path_common.cuh), not a second template.  It
// computes the same thing: per pixel, spp camera samples with pcg3d jitter
// (site 0), a bounce loop with early exit, closest hit over spheres and
// triangles (flat, culled by leaf AABBs, or in K2 culled by tops of 16
// leaves and then by the leaves), the material scatter with pcg3d draws at
// site 1+b, the sky, and the throughput/radiance bookkeeping; outputs are
// the mean RGB per pixel and a per-pixel count of traced segments.
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
//  * K2 reads a passing leaf's triangles straight from its slot of the
//    leaf-aligned table in device memory (the column is warp-uniform, so each
//    load is a broadcast; the 164k-triangle table's 25 MB stay in the 50 MB
//    L2) instead of the TPU's DMA into scalar memory.  Its winners are the
//    packed columns, so K2 over a topology takes K1's hits over the same
//    leaves bit for bit;
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
  const float *trit_b;
  const int *trit_r;
  float *mean;
  int *segs;
  int n_sph, n_tri, n_sphc, n_tric, n_tops;
  int width, height, shard_rows, row_offset, row_stride;
  unsigned seed_word;
  int spp, depth;
  float inv_spp;
};

template <bool PARITY, bool LOWP>
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
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int seg = 0;

  for (int s = 0; s < p.spp; ++s) {
    unsigned ju = pix_u, jv = (unsigned)s, jw = 0u;
    pcg3d(ju, jv, jw);
    Ray r = camera_ray(p.cam, (pcol_f + u01(ju)) / w1,
                       (prow_f + u01(jv)) / h1);

    PathColor c = {1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f};
    bool alive = active0;

    for (int b = 0; b < p.depth; ++b) {
      if (!__any_sync(FULL_MASK, alive)) break;  // warp-uniform early exit
      seg += alive ? 1 : 0;
      Hit h = no_hit();
      sphere_hits<LOWP>(sph, p.n_sph, p.sphc_b, p.sphc_r, p.n_sphc, r, alive,
                        h);
      // triangles (common.rs:124-166 via edge constants)
      triangle_hits<PARITY, false>(tri, p.n_tri, p.tric_b, p.tric_r, p.n_tric,
                                   p.trit_b, p.trit_r, p.n_tops, p.n_sph, r,
                                   alive, h);
      resolve_tri_normals(h);
      alive = shade(pix_u, s, b, r, h, alive, c);
    }
    acc_r = acc_r + c.rr;
    acc_g = acc_g + c.rg;
    acc_b = acc_b + c.rb;
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

// Launch K1, or K2 when n_tops > 0, on `stream`; lowp != 0 takes the
// bfloat16 sphere stage (K1-lowp).  Tables are row-major
// (ROWS, N) float32 device arrays; cluster tables may be null with a count
// of 0.  K2 takes the leaf-aligned triangle table (n_tri = 128 x leaves
// columns), the leaf bounds and PACKED ranges as triangle clusters, and the
// top bounds (6, n_tops) and leaf ranges (2, n_tops).  Writes mean
// [shard_rows, width, 3] float32 and segs [shard_rows, width] int32.
// Returns cudaGetLastError() after the launch.
extern "C" int rt_wavefront_render(
    const float *sph, int n_sph, const float *tri, int n_tri, const float *cam,
    const float *sphc_b, const int *sphc_r, int n_sphc, const float *tric_b,
    const int *tric_r, int n_tric, const float *trit_b, const int *trit_r,
    int n_tops, float *mean, int *segs, int width,
    int height, unsigned int seed_word, int row_offset, int row_stride,
    int shard_rows, int spp, int depth, float inv_spp, int parity_plane_sign,
    int lowp, void *stream) {
  if (width < 1 || height < 1 || shard_rows < 1 || n_sph < 1 || n_tri < 1 ||
      (n_tops > 0 && (n_tric < 1 || n_tri < n_tric * STREAM_LEAF_PAD)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.sph = sph;
  p.tri = tri;
  p.cam = cam;
  p.sphc_b = sphc_b;
  p.sphc_r = sphc_r;
  p.tric_b = tric_b;
  p.tric_r = tric_r;
  p.trit_b = trit_b;
  p.trit_r = trit_r;
  p.mean = mean;
  p.segs = segs;
  p.n_sph = n_sph;
  p.n_tri = n_tri;
  p.n_sphc = n_sphc;
  p.n_tric = n_tric;
  p.n_tops = n_tops;
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
  if (parity_plane_sign && lowp)
    wavefront_kernel<true, true><<<grid, THREADS, 0, s>>>(p);
  else if (parity_plane_sign)
    wavefront_kernel<true, false><<<grid, THREADS, 0, s>>>(p);
  else if (lowp)
    wavefront_kernel<false, true><<<grid, THREADS, 0, s>>>(p);
  else
    wavefront_kernel<false, false><<<grid, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}
