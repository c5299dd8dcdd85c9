// K4: the streamed big-mesh kernel, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracer_tpu/ops/pallas/wavefront_stream.py
// render_linear_pallas_stream / _make_stream_kernel (the pl.pallas_call at
// :397).  It computes K1's fused path trace (per pixel, spp camera samples,
// a bounce loop with early exit, the sphere stage, the scatter and the
// bookkeeping; outputs the mean RGB and a segment count per pixel) with the
// triangles in device memory as 128-column leaves under a two-level
// bounding-sphere tree:
//   * top nodes are visited in the camera's front-to-back order; a top whose
//     bound no live lane of the warp can reach closer than its t_best is
//     skipped, and so is each leaf of a visited top, and each of a leaf's
//     four 32-column sub-leaves (their own bounding spheres, a table of the
//     port's built from the same packed columns);
//   * on the primary bounce the walk stops once the warp's largest
//     root-relevant t_best is below the next top's entry key (keys are
//     lower bounds of every primary ray's entry distance; >= keeps walking
//     through ties, so exact-tie winners resolve as in the full walk);
//     lanes that miss the root bound count as -BIG, so a warp of sky rays
//     skips the walk on every bounce.
//
// What bounds it on the card: not arithmetic (the rays' own node and
// triangle tests at the OBJ-10k 512x288, 4 spp, depth 4 frame are ~0.05 ms
// at the float32 peak, against ~11 ms) but occupancy and divergence.  With
// one thread per pixel a CLI band (512 x 18 pixels, 16 spp, depth 8) was 96
// blocks of 128 threads, 4.5% of the card's thread slots, each thread
// tracing its 16 samples one after another: 16 bands took 5x one launch of
// the frame.  The warps ran 9x the tests their rays needed, a passing leaf
// was tested whole (up to 128 triangles), and each triangle test read 16
// plane-strided words from the table.
//
// The design for this card:
//   * one thread per (pixel, sample): a warp holds a tile of pixels x a run
//     of consecutive samples of each (2 x 1 pixels x 16 samples at 16 spp;
//     ops/cuda/wavefront_stream.py thread_layout), a spp above the run
//     loops over runs in the thread.  A CLI band is 147,456 threads, and a
//     warp's primary rays start inside one or two pixel footprints;
//   * K1's sum: after each run the lanes of a pixel add their radiance in
//     sample order through warp shuffles (pixel_sum_run), from 0.0f, and
//     the pixel's first lane scales by inv_spp: acc = acc + c in sample
//     order, the plain version's order, so a frame is bitwise what one
//     thread per pixel gives.  Segments are an integer butterfly sum;
//   * sub-leaf culling and warp-staged sub-leaves (path_common.cuh): a
//     top's passing leaves and sub-leaves are voted once at its start, each
//     passing sub-leaf's test rows are copied with cp.async into one of the
//     warp's two shared tiles while the previous one is tested, and each
//     votes again just before its test, so the walk tests the sub-leaves
//     the sequential walk would, in its order;
//   * persistent warps: a band's 4,608 warp tiles (1,152 blocks' worth) are
//     2.2 waves of the card's resident blocks, so each launch holds only the
//     resident blocks and every warp takes the band's next tile from an
//     atomic counter: no band ends in a part-empty wave of whole blocks.
// Culling a bound no lane can pass cannot change a closest hit, and each
// ray's visit order (top order, leaf, sub-leaf, column) is unchanged, so
// K4 stays bitwise equal to render_linear_stream_ref and a band to the
// rows of a whole render.  Loop bounds are warp-uniform: every lane, live
// or dead, reaches every vote and shuffle.
//
// Numerics: -fmad=false and the Pallas body's operation order, so the
// plain version render_linear_stream_ref gives the same floats.

#include "path_common.cuh"

namespace {

using namespace rt_path;

constexpr int WARP = 32;
constexpr int LEAF = 128, SUB = STAGE_COLS, SUBS = LEAF / SUB;
constexpr int WARPS = THREADS / WARP;

struct Params {
  const float *sph;
  const float *sphc_b;
  const int *sphc_r;
  const float *tri;
  const float *leafb;
  const int *leafn;
  const float *subb;
  const float *topb;
  const int *topr;
  const int *order;
  const float *keys;
  const float *root;
  const float *cam;
  float *mean;
  int *segs;
  int *next_tile;  // the work counter, 0 at launch
  int n_sph, n_sphc, n_leaves, n_tops;
  int width, height, shard_rows, row_offset, row_stride;
  unsigned seed_word;
  int spp, depth;
  float inv_spp;
  int run, tile_w, tile_h, tiles_x, n_tiles;
};

// the streamed two-level triangle walk (the correct plane equation), a
// top's passing sub-leaves staged through the warp's tiles
__device__ __forceinline__ void stream_walk(const Params &p, const Ray &r,
                                            bool alive, bool primary, Hit &h,
                                            float *tiles, int lane) {
  const int n_cols = p.n_leaves * LEAF;
  const int n_subs = p.n_leaves * SUBS;
  // lanes whose ray misses the root bound can never hit a triangle
  const bool root_p = alive && bound_test(p.root, 1, 0, r, BIG);
  auto leaf_ok = [&](int li) {
    return __any_sync(FULL_MASK,
                      alive && bound_test(p.leafb, p.n_leaves, li, r, h.t));
  };
  auto sub_ok = [&](int si) {
    return __any_sync(FULL_MASK,
                      alive && bound_test(p.subb, n_subs, si, r, h.t));
  };
  for (int oi = 0; oi < p.n_tops; ++oi) {
    const float relevant = warp_max(root_p ? h.t : -BIG);
    const float exit_key = primary ? p.keys[oi] : -1.0f;
    if (!(relevant >= exit_key)) break;
    const int ci = p.order[oi];
    if (!__any_sync(FULL_MASK,
                    alive && bound_test(p.topb, p.n_tops, ci, r, h.t)))
      continue;
    // the top's passing sub-leaves: at most 8 leaves of 4, 32 bits (the
    // wrapper checks the ranges)
    const int l0 = p.topr[ci], l1 = p.topr[p.n_tops + ci];
    unsigned mask = 0u;
    for (int li = l0; li < l1; ++li) {
      if (!leaf_ok(li)) continue;
      const int n = p.leafn[li];
      for (int k = 0; k * SUB < n; ++k)
        if (sub_ok(li * SUBS + k)) mask |= 1u << ((li - l0) * SUBS + k);
    }
    staged_sub_walk(
        mask, SUBS, tiles, [&](int q) { return leaf_ok(l0 + q); },
        [&](int s) { return sub_ok(l0 * SUBS + s); },
        [&](int s, float *tile) {
          stage_sub_leaf(tile, p.tri, n_cols, l0 * LEAF + s * SUB, lane);
        },
        [&](int s, const float *tile) {
          const int li = l0 + s / SUBS, k = s % SUBS;
          const int n = min(p.leafn[li] - k * SUB, SUB);
          const int col0 = li * LEAF + k * SUB;
          for (int j = 0; j < n; ++j)
            tri_step_staged<false, false>(tile, j, p.tri, n_cols, col0 + j,
                                          r, h, 0.0f);
        });
  }
}

// one warp's work: tile w of the band.  thread_layout: lane = pixel * run
// + sample % run, pixels row-major in the warp's tile_w x tile_h tile, tile
// w at (w % tiles_x, w / tiles_x) of the band
__device__ __forceinline__ void trace_tile(const Params &p, int w, int lane,
                                           float *my_tiles) {
  const int pix = lane / p.run, j = lane % p.run;
  const int pcol = (w % p.tiles_x) * p.tile_w + pix % p.tile_w;
  const int band_row = (w / p.tiles_x) * p.tile_h + pix / p.tile_w;
  const int prow = p.row_offset + band_row * p.row_stride;
  const bool active0 =
      (prow < p.height) && (pcol < p.width) && (band_row < p.shard_rows);
  const int prow_c = min(prow, p.height - 1);
  const int pcol_c = min(pcol, p.width - 1);
  const unsigned pix_u = (unsigned)(prow_c * p.width + pcol_c) + p.seed_word;
  const float w1 = (float)(p.width - 1);
  const float h1 = (float)(p.height - 1);

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int seg = 0;
  for (int base = 0; base < p.spp; base += p.run) {
    const int s = base + j;
    unsigned ju = pix_u, jv = (unsigned)s, jw = 0u;
    pcg3d(ju, jv, jw);
    Ray r = camera_ray(p.cam, ((float)pcol_c + u01(ju)) / w1,
                       ((float)prow_c + u01(jv)) / h1);
    PathColor c = {1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f};
    bool alive = active0 && s < p.spp;
    for (int b = 0; b < p.depth; ++b) {
      if (!__any_sync(FULL_MASK, alive)) break;
      seg += alive ? 1 : 0;
      Hit h = no_hit();
      sphere_hits(p.sph, p.n_sph, p.sphc_b, p.sphc_r, p.n_sphc, r, alive, h);
      stream_walk(p, r, alive, b == 0, h, my_tiles, lane);
      resolve_tri_normals(h);
      alive = shade(pix_u, s, b, r, h, alive, c);
    }
    acc_r = pixel_sum_run(acc_r, c.rr, p.run, base, p.spp, lane);
    acc_g = pixel_sum_run(acc_g, c.rg, p.run, base, p.spp, lane);
    acc_b = pixel_sum_run(acc_b, c.rb, p.run, base, p.spp, lane);
  }
  for (int off = p.run / 2; off > 0; off >>= 1)
    seg += __shfl_xor_sync(FULL_MASK, seg, off);
  if (j == 0 && band_row < p.shard_rows && pcol < p.width) {
    const long long o = (long long)band_row * p.width + pcol;
    p.mean[3 * o + 0] = acc_r * p.inv_spp;
    p.mean[3 * o + 1] = acc_g * p.inv_spp;
    p.mean[3 * o + 2] = acc_b * p.inv_spp;
    p.segs[o] = seg;
  }
}

// Persistent warps: the grid holds only as many blocks as the card keeps
// resident, and each warp takes the band's next tile from a counter until
// none is left, so a band's last wave is no emptier than a warp's work.
__global__ void __launch_bounds__(THREADS) stream_kernel(const Params p) {
  __shared__ __align__(16) float tiles[WARPS][2 * STAGE_FLOATS];
  const int lane = threadIdx.x & (WARP - 1);
  float *my_tiles = tiles[threadIdx.x / WARP];
  for (;;) {
    int w = 0;
    if (lane == 0) w = atomicAdd(p.next_tile, 1);
    w = __shfl_sync(FULL_MASK, w, 0);
    if (w >= p.n_tiles) return;  // warp-uniform
    trace_tile(p, w, lane, my_tiles);
  }
}

}  // namespace

// Launch K4 on `stream`.  Tables are row-major float32 / int32 device
// arrays (ops/cuda/wavefront_stream.py): sph (11, n_sph), sphere clusters
// (may be null with n_sphc 0), tri (24, n_leaves * 128), leaf bounds
// (4, n_leaves), leaf counts (n_leaves), sub-leaf bounds (4, n_leaves * 4),
// top bounds (4, n_tops), top ranges (2, n_tops; at most 8 leaves a top),
// visit order and keys (n_tops), root (4, 1), cam (12).  The thread layout
// (run .. blocks) is thread_layout's; next_tile is one int32, 0 at launch.
// Writes mean [shard_rows, width, 3] and segs [shard_rows, width].
// Returns cudaGetLastError() after the launch.
extern "C" int rt_stream_render(
    const float *sph, int n_sph, const float *sphc_b, const int *sphc_r,
    int n_sphc, const float *tri, const float *leafb, const int *leafn,
    const float *subb, int n_leaves, const float *topb, const int *topr,
    const int *order, const float *keys, int n_tops, const float *root,
    const float *cam, float *mean, int *segs, int *next_tile, int width,
    int height, unsigned int seed_word, int row_offset, int row_stride,
    int shard_rows, int spp, int depth, float inv_spp, int run, int tile_w,
    int tile_h, int tiles_x, int n_tiles, int blocks, void *stream) {
  if (width < 1 || height < 1 || shard_rows < 1 || n_sph < 1 ||
      n_leaves < 1 || n_tops < 1 || spp < 1 || next_tile == nullptr ||
      run < 1 || run > 16 ||
      (run & (run - 1)) || tile_w * tile_h * run != WARP ||
      tiles_x * tile_w < width || n_tiles < 1 ||
      (long long)blocks * WARPS < n_tiles)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.sph = sph;
  p.sphc_b = sphc_b;
  p.sphc_r = sphc_r;
  p.tri = tri;
  p.leafb = leafb;
  p.leafn = leafn;
  p.subb = subb;
  p.topb = topb;
  p.topr = topr;
  p.order = order;
  p.keys = keys;
  p.root = root;
  p.cam = cam;
  p.mean = mean;
  p.segs = segs;
  p.next_tile = next_tile;
  p.n_sph = n_sph;
  p.n_sphc = n_sphc;
  p.n_leaves = n_leaves;
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
  p.run = run;
  p.tile_w = tile_w;
  p.tile_h = tile_h;
  p.tiles_x = tiles_x;
  p.n_tiles = n_tiles;
  // as many blocks as the card keeps resident, at most one per 4 tiles
  return (int)launch_persistent(stream_kernel, p, blocks,
                                static_cast<cudaStream_t>(stream));
}
