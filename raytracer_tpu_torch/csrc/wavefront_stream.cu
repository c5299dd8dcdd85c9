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
//     skipped, and so is each leaf of a visited top;
//   * on the primary bounce the walk stops once the warp's largest
//     root-relevant t_best is below the next top's entry key (keys are
//     lower bounds of every primary ray's entry distance; >= keeps walking
//     through ties, so exact-tie winners resolve as in the full walk);
//     lanes that miss the root bound count as -BIG, so a warp of sky rays
//     skips the walk on every bounce.
//
// What bounds it on the card: FP32 issue and divergence, as K1.  Triangle
// columns are read straight from device memory; the column is
// warp-uniform, so each load is one broadcast, and the 164k-triangle table
// (25 MB) stays in the 50 MB L2.  The TPU kernel's DMA of a passing leaf
// into scalar memory has no counterpart here; staging a leaf in shared
// memory is later performance work.
//
// Design: K1's thread layout (one thread per pixel, 8x4-pixel warp tiles,
// 16x8-pixel blocks of 128 threads), all ray state in registers, and the
// TPU block's "any lane" tests as __any_sync warp votes.  Loop bounds are
// warp-uniform: every lane, live or dead, reaches every vote.
//
// Numerics: -fmad=false and the Pallas body's operation order, so the
// plain version render_linear_stream_ref gives the same floats.

#include "path_common.cuh"

namespace {

using namespace rt_path;

constexpr int LEAF = 128;

struct Params {
  const float *sph;
  const float *sphc_b;
  const int *sphc_r;
  const float *tri;
  const float *leafb;
  const int *leafn;
  const float *topb;
  const int *topr;
  const int *order;
  const float *keys;
  const float *root;
  const float *cam;
  float *mean;
  int *segs;
  int n_sph, n_sphc, n_leaves, n_tops;
  int width, height, shard_rows, row_offset, row_stride;
  unsigned seed_word;
  int spp, depth;
  float inv_spp;
};

// the streamed two-level triangle walk (the correct plane equation)
__device__ __forceinline__ void stream_walk(const Params &p, const Ray &r,
                                            bool alive, bool primary,
                                            Hit &h) {
  const int n_cols = p.n_leaves * LEAF;
  // lanes whose ray misses the root bound can never hit a triangle
  const bool root_p = alive && bound_test(p.root, 1, 0, r, BIG);
  for (int oi = 0; oi < p.n_tops; ++oi) {
    const float relevant = warp_max(root_p ? h.t : -BIG);
    const float exit_key = primary ? p.keys[oi] : -1.0f;
    if (!(relevant >= exit_key)) break;
    const int ci = p.order[oi];
    if (!__any_sync(FULL_MASK,
                    alive && bound_test(p.topb, p.n_tops, ci, r, h.t)))
      continue;
    const int l1 = p.topr[p.n_tops + ci];
    for (int li = p.topr[ci]; li < l1; ++li) {
      if (!__any_sync(FULL_MASK,
                      alive && bound_test(p.leafb, p.n_leaves, li, r, h.t)))
        continue;
      const int base = li * LEAF, n = p.leafn[li];
      for (int ti = 0; ti < n; ++ti)
        tri_step<false, false>(p.tri, n_cols, base + ti, r, h, 0.0f);
    }
  }
}

__global__ void __launch_bounds__(THREADS) stream_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // _block_pixel_setup, with K1's tiles
  const int pcol = blockIdx.x * BLOCK_W + (warp & 1) * WARP_W + (lane & 7);
  const int band_row = blockIdx.y * BLOCK_H + (warp >> 1) * WARP_H + (lane >> 3);
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
  for (int s = 0; s < p.spp; ++s) {
    unsigned ju = pix_u, jv = (unsigned)s, jw = 0u;
    pcg3d(ju, jv, jw);
    Ray r = camera_ray(p.cam, ((float)pcol_c + u01(ju)) / w1,
                       ((float)prow_c + u01(jv)) / h1);
    PathColor c = {1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f};
    bool alive = active0;
    for (int b = 0; b < p.depth; ++b) {
      if (!__any_sync(FULL_MASK, alive)) break;
      seg += alive ? 1 : 0;
      Hit h = no_hit();
      sphere_hits(p.sph, p.n_sph, p.sphc_b, p.sphc_r, p.n_sphc, r, alive, h);
      stream_walk(p, r, alive, b == 0, h);
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

// Launch K4 on `stream`.  Tables are row-major float32 / int32 device
// arrays (ops/cuda/wavefront_stream.py): sph (11, n_sph), sphere clusters
// (may be null with n_sphc 0), tri (24, n_leaves * 128), leaf bounds
// (4, n_leaves), leaf counts (n_leaves), top bounds (4, n_tops), top ranges
// (2, n_tops), visit order and keys (n_tops), root (4, 1), cam (12).
// Writes mean [shard_rows, width, 3] and segs [shard_rows, width].
// Returns cudaGetLastError() after the launch.
extern "C" int rt_stream_render(
    const float *sph, int n_sph, const float *sphc_b, const int *sphc_r,
    int n_sphc, const float *tri, const float *leafb, const int *leafn,
    int n_leaves, const float *topb, const int *topr, const int *order,
    const float *keys, int n_tops, const float *root, const float *cam,
    float *mean, int *segs, int width, int height, unsigned int seed_word,
    int row_offset, int row_stride, int shard_rows, int spp, int depth,
    float inv_spp, void *stream) {
  if (width < 1 || height < 1 || shard_rows < 1 || n_sph < 1 ||
      n_leaves < 1 || n_tops < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.sph = sph;
  p.sphc_b = sphc_b;
  p.sphc_r = sphc_r;
  p.tri = tri;
  p.leafb = leafb;
  p.leafn = leafn;
  p.topb = topb;
  p.topr = topr;
  p.order = order;
  p.keys = keys;
  p.root = root;
  p.cam = cam;
  p.mean = mean;
  p.segs = segs;
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
  const dim3 grid((width + BLOCK_W - 1) / BLOCK_W,
                  (shard_rows + BLOCK_H - 1) / BLOCK_H);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  stream_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
