// K1, K2 and K1-lowp: the fused forward path-trace kernels, hand-written
// for Hopper (sm_90a).
//
// Replace the TPU kernel raytracer_tpu/ops/pallas/wavefront.py
// render_linear_pallas / _make_kernel: K1 is the pl.pallas_call at :1032,
// K2 the one at :1015 (stream_tops > 0: the two-level _streamed_tri_walk at
// :708 over a leaf-aligned triangle table), K1-lowp the same call with
// lowp=True (_sphere_loop_lowp at :374: the sphere quadratic in bfloat16,
// the LOWP template flag, sphere_step_lowp in path_common.cuh; it scans
// the sphere table flat).  K1 and K1-lowp are wavefront_kernel; K2 is a
// kernel of its own, two_level_kernel, so K1's instances compile without
// its walk.  With the helpers _block_pixel_setup, _pcg3d/_u01,
// _sphere_loop + _aabb_test, _sphere_normals, _make_tri_body,
// _resolve_tri_normals and _scatter_bookkeep they compute the same thing:
// per pixel, spp camera samples with pcg3d jitter (site 0), a bounce loop
// with early exit, closest hit over spheres and triangles (flat, culled by
// leaf AABBs, or in K2 culled by tops of 16 leaves, then by the leaves and
// their 32-column sub-leaves), the material scatter with pcg3d draws at
// site 1+b, the sky, and the throughput/radiance bookkeeping; outputs are
// the mean RGB per pixel and a per-pixel count of traced segments.
//
// What bounds K1 on the card: FP32 ALU throughput and branch divergence, not
// bytes.  Each ray segment costs ~25 flops per sphere and ~40 per triangle
// against a few KB of scene tables that stay in L1/L2; device memory sees one
// write of the image per launch.  Divergence comes from rays of one warp that
// die at different bounces and from cluster culling.  K1's design:
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
// What bounds K2 (the 164k-triangle gradient pass: 256x256, 4 spp, depth
// 4): not arithmetic (the rays' own walk is ~0.02 ms at the float32 peak
// against ~20 ms for K1's layout) but occupancy and the walk's waste.  One
// thread per pixel made 512 blocks of 128 threads, ~15 warps an SM, each
// thread tracing its samples one after another; a passing leaf was tested
// whole (~80 triangles, up to its 128-column slot), each test reading 16
// plane-strided words of the 25 MB leaf-aligned table, and the warps ran
// ~15x the tests their rays needed.  K2's design (K4's, without K4's
// camera-ordered tops and early exit, which would change the visit order):
//  * one thread per (pixel, sample) (TileLayout: 8 pixels x 4 samples a
//    warp at 4 spp) on persistent warps that take tiles from a counter;
//  * a pixel's samples are summed in sample order from 0.0f through warp
//    shuffles (pixel_sum_run) and scaled once by inv_spp, segments by an
//    integer sum: the image is bitwise what one thread per pixel gives;
//  * sub-leaf boxes (32 columns, from the live vertices: ops/diff.py) and
//    warp-staged sub-leaves (two_level_staged_walk): a passing sub-leaf's
//    16 test rows are copied with cp.async into one of the warp's two
//    shared tiles while the previous one is tested.  Its winners are the
//    packed columns, so K2 over a topology takes K1's hits over the same
//    leaves bit for bit.
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
  const float *trit_b;  // no tops: triangle_hits' two-level branch stays
  const int *trit_r;    // untaken (see there)
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

struct StreamParams {
  const float *sph;
  const float *cam;
  const float *sphc_b;
  const int *sphc_r;
  TwoLevel walk;
  float *mean;
  int *segs;
  int *next_tile;  // the work counter, 0 at launch
  int n_sph, n_sphc;
  int width, height, shard_rows, row_offset, row_stride;
  unsigned seed_word;
  int spp, depth;
  float inv_spp;
  TileLayout lay;
};

// K2: one warp tile of (pixel, sample) lanes at a time; per lane K1's
// sample loop body over the samples base + j, base = 0, run, ...
__global__ void __launch_bounds__(THREADS)
    two_level_kernel(const StreamParams p) {
  __shared__ __align__(16) float tiles[THREADS / 32][2 * STAGE_FLOATS];
  const int lane = threadIdx.x & 31;
  float *my_tiles = tiles[threadIdx.x >> 5];
  const float w1 = (float)(p.width - 1);
  const float h1 = (float)(p.height - 1);
  for_each_tile(p.next_tile, p.lay.n_tiles, lane, [&](int w) {
    const LanePixel q =
        lane_pixel(p.lay, w, lane, p.width, p.height, p.shard_rows,
                   p.row_offset, p.row_stride, p.seed_word);
    float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
    int seg = 0;
    for (int base = 0; base < p.spp; base += p.lay.run) {
      const int s = base + q.j;
      unsigned ju = q.pix_u, jv = (unsigned)s, jw = 0u;
      pcg3d(ju, jv, jw);
      Ray r = camera_ray(p.cam, (q.pcol_f + u01(ju)) / w1,
                         (q.prow_f + u01(jv)) / h1);
      PathColor c = {1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f};
      bool alive = q.active0 && s < p.spp;
      for (int b = 0; b < p.depth; ++b) {
        if (!__any_sync(FULL_MASK, alive)) break;  // warp-uniform early exit
        seg += alive ? 1 : 0;
        Hit h = no_hit();
        sphere_hits(p.sph, p.n_sph, p.sphc_b, p.sphc_r, p.n_sphc, r, alive,
                    h);
        two_level_staged_walk<false>(p.walk, p.n_sph, r, alive, h, my_tiles,
                                     lane);
        resolve_tri_normals(h);
        alive = shade(q.pix_u, s, b, r, h, alive, c);
      }
      acc_r = pixel_sum_run(acc_r, c.rr, p.lay.run, base, p.spp, lane);
      acc_g = pixel_sum_run(acc_g, c.rg, p.lay.run, base, p.spp, lane);
      acc_b = pixel_sum_run(acc_b, c.rb, p.lay.run, base, p.spp, lane);
    }
    for (int off = p.lay.run / 2; off > 0; off >>= 1)
      seg += __shfl_xor_sync(FULL_MASK, seg, off);
    if (q.j == 0 && q.in_band) {
      const long long o = (long long)q.band_row * p.width + q.pcol;
      p.mean[3 * o + 0] = acc_r * p.inv_spp;
      p.mean[3 * o + 1] = acc_g * p.inv_spp;
      p.mean[3 * o + 2] = acc_b * p.inv_spp;
      p.segs[o] = seg;
    }
  });
}

}  // namespace

// Launch K1 on `stream`; lowp != 0 takes the bfloat16 sphere stage
// (K1-lowp).  Tables are row-major (ROWS, N) float32 device arrays;
// cluster tables may be null with a count of 0.  Writes mean
// [shard_rows, width, 3] float32 and segs [shard_rows, width] int32.
// Returns cudaGetLastError() after the launch.
extern "C" int rt_wavefront_render(
    const float *sph, int n_sph, const float *tri, int n_tri, const float *cam,
    const float *sphc_b, const int *sphc_r, int n_sphc, const float *tric_b,
    const int *tric_r, int n_tric, float *mean, int *segs, int width,
    int height, unsigned int seed_word, int row_offset, int row_stride,
    int shard_rows, int spp, int depth, float inv_spp, int parity_plane_sign,
    int lowp, void *stream) {
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
  p.trit_b = nullptr;
  p.trit_r = nullptr;
  p.mean = mean;
  p.segs = segs;
  p.n_sph = n_sph;
  p.n_tri = n_tri;
  p.n_sphc = n_sphc;
  p.n_tric = n_tric;
  p.n_tops = 0;
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

// Launch K2 on `stream` (the correct plane equation).  sph (11, n_sph) and
// optional sphere clusters as for K1; tri the leaf-aligned table (24,
// 128 n_leaves); leaf AABBs (6, n_leaves) with their PACKED ranges
// (2, n_leaves; at most 128 columns a leaf); sub-leaf AABBs
// (6, 4 n_leaves); top AABBs (6, n_tops) and leaf ranges (2, n_tops; at
// most 16 leaves a top; the wrapper checks the ranges).  The thread
// layout (run .. n_tiles, blocks) is thread_layout's; next_tile is one
// int32, 0 at launch.  Writes mean [shard_rows, width, 3] and segs
// [shard_rows, width].  Returns cudaGetLastError() after the launch.
extern "C" int rt_wavefront_render_stream(
    const float *sph, int n_sph, const float *sphc_b, const int *sphc_r,
    int n_sphc, const float *tri, const float *leafb, const int *leafr,
    const float *subb, int n_leaves, const float *topb, const int *topr,
    int n_tops, const float *cam, float *mean, int *segs, int *next_tile,
    int width, int height, unsigned int seed_word, int row_offset,
    int row_stride, int shard_rows, int spp, int depth, float inv_spp,
    int run, int tile_w, int tile_h, int tiles_x, int n_tiles, int blocks,
    void *stream) {
  const TileLayout lay = {run, tile_w, tile_h, tiles_x, n_tiles};
  if (width < 1 || height < 1 || shard_rows < 1 || n_sph < 1 ||
      n_leaves < 1 || n_tops < 1 || spp < 1 || next_tile == nullptr ||
      !layout_ok(lay, width, blocks))
    return (int)cudaErrorInvalidValue;
  StreamParams p;
  p.sph = sph;
  p.cam = cam;
  p.sphc_b = sphc_b;
  p.sphc_r = sphc_r;
  p.walk = {tri, leafb, leafr, subb, topb, topr, n_leaves, n_tops};
  p.mean = mean;
  p.segs = segs;
  p.next_tile = next_tile;
  p.n_sph = n_sph;
  p.n_sphc = n_sphc;
  p.width = width;
  p.height = height;
  p.shard_rows = shard_rows;
  p.row_offset = row_offset;
  p.row_stride = row_stride;
  p.seed_word = seed_word;
  p.spp = spp;
  p.depth = depth;
  p.inv_spp = inv_spp;
  p.lay = lay;
  int grid = 0;
  const cudaError_t e = resident_grid(two_level_kernel, blocks, grid);
  if (e != cudaSuccess) return (int)e;
  two_level_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}
