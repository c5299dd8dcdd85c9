// K1, K2 and K1-lowp: the fused forward path-trace kernels, hand-written
// for Hopper (sm_90a).
//
// Replace the TPU kernel raytracer_tpu/ops/pallas/wavefront.py
// render_linear_pallas / _make_kernel: K1 is the pl.pallas_call at :1032,
// K2 the one at :1015 (stream_tops > 0: the two-level _streamed_tri_walk at
// :708 over a leaf-aligned triangle table), K1-lowp the same call with
// lowp=True (_sphere_loop_lowp at :374: the sphere quadratic in bfloat16,
// the LOWP template flag; it scans the sphere table flat).  K1 and K1-lowp
// are wavefront_kernel; K2 is a kernel of its own, two_level_kernel, so
// K1's instances compile without its walk.  With the helpers _block_pixel_setup, _pcg3d/_u01,
// _sphere_loop + _aabb_test, _sphere_normals, _make_tri_body,
// _resolve_tri_normals and _scatter_bookkeep they compute the same thing:
// per pixel, spp camera samples with pcg3d jitter (site 0), a bounce loop
// with early exit, closest hit over spheres and triangles (flat, culled by
// leaf AABBs, or in K2 culled by tops of 16 leaves, then by the leaves and
// their 32-column sub-leaves), the material scatter with pcg3d draws at
// site 1+b, the sky, and the throughput/radiance bookkeeping; outputs are
// the mean RGB per pixel and a per-pixel count of traced segments.
//
// What bounds K1 on the card: FP32 ALU throughput, occupancy and branch
// divergence, not bytes.  Each ray segment costs ~25 flops per sphere and
// ~40 per triangle against a few KB of scene tables that stay in L1/L2;
// device memory sees one write of the image per launch.  One thread per
// pixel looping over its samples left the card idle at the main path's
// small launches: a CLI band (512 x 18 pixels, 64 spp) was 96 blocks of
// 128 threads, 384 warps on a card of 8,448 warp slots, each thread
// tracing 64 samples alone; the OBJ-10k gradient pass (256 x 256, 8 spp)
// was 512 blocks, and a warp ground each leaf a lane passed whole, with
// strided loads from the packed table.  K1's design (K2's, with the
// one-level walk):
//  * one thread per (pixel, sample) (TileLayout: runs of up to 16 samples
//    of one pixel a warp, wavefront_stream.thread_layout) on persistent
//    warps that take tiles from a counter, so a launch of any size fills
//    the card and ends without a part-empty wave;
//  * a pixel's samples are summed in sample order from 0.0f through warp
//    shuffles (pixel_sum_run) and scaled once by inv_spp, segments by an
//    integer sum: the image is bitwise what one thread per pixel gives;
//  * all ray state in registers; scene tables row-major (ROWS, N), every
//    lane of a warp reading the same column (a broadcast load through L1);
//  * the kernel is templated on the triangle walk (TriWalk): none (a table
//    of one padding column: the sphere-only scenes), the flat scan, or the
//    one-level leaf walk, so the sphere-only instance carries none of the
//    leaf walk's masks and tiles; the leaf walk (leaf_staged_walk) votes a
//    leaf per warp (__any_sync: the TPU kernel's culling one level down)
//    and copies a passing leaf's 32-column chunks of the packed table with
//    cp.async into the warp's two shared tiles, testing one while the next
//    is in flight;
//  * the bounce loop ends when no lane of the warp is alive; dead lanes
//    change nothing, so this is the per-lane result of the full loop.
//
// What bounds K1-lowp (the default world at 512 x 512, 64 spp, depth 8):
// its sphere stage, as K1's.  Emulating each bfloat16 operation as a
// float32 one rounded through a bfloat16 conversion and back costs 18
// conversions a sphere on top of K1's float32 work; K1-lowp's stage takes
// a packed bfloat16 table of sphere pairs (one 16-byte load a pair) and
// Hopper's native bf16x2 add, sub and mul instead: 14 packed instructions
// for the two spheres' centre differences, half_b and c, then each
// sphere's roots in float32 (sphere_pair_lowp in path_common.cuh), the
// same values bit for bit.
//
// What bounds K2 (the 164k-triangle gradient pass: 256x256, 4 spp, depth
// 4): not arithmetic (the rays' own walk is ~0.02 ms at the float32 peak)
// but occupancy and the walk's waste: one thread per pixel made ~15 warps
// an SM, and a passing leaf was tested whole, each test reading 16
// plane-strided words of the 25 MB leaf-aligned table.  K2 takes K1's
// layout and its own walk (K4's, without K4's camera-ordered tops and early
// exit, which would change the visit order): sub-leaf boxes (32 columns,
// from the live vertices: ops/diff.py) and warp-staged sub-leaves
// (two_level_staged_walk).  Its winners are the packed columns, so K2 over
// a topology takes K1's hits over the same leaves bit for bit.
//
// Numerics: built with -fmad=false and IEEE division and square root, so
// the operation order below (which follows the Pallas body) gives the same
// floats as the plain PyTorch version, render_linear_ref.  The per-ray code
// that decides a path (hit steps, draws, scatter) is in path_common.cuh,
// shared with K5, which must re-trace exactly these paths.

#include "path_common.cuh"

namespace {

using namespace rt_path;

// what K1 and K2 share: spheres, camera, outputs, the frame and the layout
struct Frame {
  const float *sph;
  const uint4 *sph_lp;  // K1-lowp's packed bfloat16 sphere pairs
  const float *cam;
  const float *sphc_b;
  const int *sphc_r;
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

struct Params {
  Frame f;
  OneLevel tris;
};

struct StreamParams {
  Frame f;
  TwoLevel walk;
};

// warp tile w of (pixel, sample) lanes: per lane K1's sample loop body over
// the samples base + j, base = 0, run, ..., the triangles through walk(r,
// alive, h); the pixel's samples summed in sample order and its segments,
// written by its first lane
template <bool LOWP, class Walk>
__device__ __forceinline__ void trace_tile(const Frame &p, int w, int lane,
                                           Walk walk) {
  const float w1 = (float)(p.width - 1);
  const float h1 = (float)(p.height - 1);
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
      sphere_hits<LOWP>(p.sph, p.n_sph, p.sphc_b, p.sphc_r, p.n_sphc, r,
                        alive, h, p.sph_lp);
      walk(r, alive, h);
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
}

// K1 (K1-lowp with LOWP): the triangles by the walk WALK (TriWalk)
template <bool PARITY, bool LOWP, int WALK>
__global__ void __launch_bounds__(THREADS) wavefront_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  float *my_tiles = nullptr;
  if constexpr (WALK == WALK_LEAVES) {
    __shared__ __align__(16) float tiles[THREADS / 32][2 * STAGE_FLOATS];
    my_tiles = tiles[threadIdx.x >> 5];
  }
  for_each_tile(p.f.next_tile, p.f.lay.n_tiles, lane, [&](int w) {
    trace_tile<LOWP>(p.f, w, lane, [&](const Ray &r, bool alive, Hit &h) {
      triangle_hits<PARITY, false, WALK>(p.tris, p.f.n_sph, r, alive, h,
                                         my_tiles, lane);
    });
  });
}

// K2: the two-level walk with staged sub-leaves
__global__ void __launch_bounds__(THREADS)
    two_level_kernel(const StreamParams p) {
  __shared__ __align__(16) float tiles[THREADS / 32][2 * STAGE_FLOATS];
  const int lane = threadIdx.x & 31;
  float *my_tiles = tiles[threadIdx.x >> 5];
  for_each_tile(p.f.next_tile, p.f.lay.n_tiles, lane, [&](int w) {
    trace_tile<false>(p.f, w, lane, [&](const Ray &r, bool alive, Hit &h) {
      two_level_staged_walk<false>(p.walk, p.f.n_sph, r, alive, h, my_tiles,
                                   lane);
    });
  });
}

template <bool PARITY, bool LOWP>
cudaError_t launch_k1(const Params &p, int walk, int blocks,
                      cudaStream_t s) {
  if (walk == WALK_NONE)
    return launch_persistent(wavefront_kernel<PARITY, LOWP, WALK_NONE>, p,
                             blocks, s);
  if (walk == WALK_FLAT)
    return launch_persistent(wavefront_kernel<PARITY, LOWP, WALK_FLAT>, p,
                             blocks, s);
  if constexpr (!PARITY)  // leaves cull only under the correct sign
    return launch_persistent(wavefront_kernel<false, LOWP, WALK_LEAVES>, p,
                             blocks, s);
  return cudaErrorInvalidValue;
}

// the frame fields of both entry points
Frame make_frame(const float *sph, const void *sph_lp, int n_sph,
                 const float *sphc_b, const int *sphc_r, int n_sphc,
                 const float *cam, float *mean, int *segs, int *next_tile,
                 int width, int height, unsigned seed_word, int row_offset,
                 int row_stride, int shard_rows, int spp, int depth,
                 float inv_spp, const TileLayout &lay) {
  Frame f;
  f.sph = sph;
  f.sph_lp = static_cast<const uint4 *>(sph_lp);
  f.cam = cam;
  f.sphc_b = sphc_b;
  f.sphc_r = sphc_r;
  f.mean = mean;
  f.segs = segs;
  f.next_tile = next_tile;
  f.n_sph = n_sph;
  f.n_sphc = n_sphc;
  f.width = width;
  f.height = height;
  f.shard_rows = shard_rows;
  f.row_offset = row_offset;
  f.row_stride = row_stride;
  f.seed_word = seed_word;
  f.spp = spp;
  f.depth = depth;
  f.inv_spp = inv_spp;
  f.lay = lay;
  return f;
}

}  // namespace

// Launch K1 on `stream`; lowp != 0 takes the bfloat16 sphere stage
// (K1-lowp) over sph_lp, the packed table of the ceil(n_sph / 2) sphere
// pairs (16 bytes each, 16-byte aligned; null without lowp).  Tables are
// row-major (ROWS, N) float32 device arrays; cluster tables may be null
// with a count of 0.  walk (TriWalk): 0 none
// (tri is one padding column), 1 the flat scan, 2 the one-level walk over
// the triangle clusters (the correct sign; chunks: the most 32-column
// chunks a cluster holds, 1 .. 64).  The thread layout (run .. n_tiles,
// blocks) is thread_layout's; next_tile is one int32, 0 at launch.  Writes
// mean [shard_rows, width, 3] float32 and segs [shard_rows, width] int32.
// Returns cudaGetLastError() after the launch.
extern "C" int rt_wavefront_render(
    const float *sph, int n_sph, const void *sph_lp, const float *tri,
    int n_tri, const float *cam, const float *sphc_b, const int *sphc_r,
    int n_sphc, const float *tric_b, const int *tric_r, int n_tric,
    int chunks, float *mean, int *segs,
    int *next_tile, int width, int height, unsigned int seed_word,
    int row_offset, int row_stride, int shard_rows, int spp, int depth,
    float inv_spp, int parity_plane_sign, int lowp, int walk, int run,
    int tile_w, int tile_h, int tiles_x, int n_tiles, int blocks,
    void *stream) {
  const TileLayout lay = {run, tile_w, tile_h, tiles_x, n_tiles};
  const bool leaves = walk == WALK_LEAVES;
  if (width < 1 || height < 1 || shard_rows < 1 || n_sph < 1 || n_tri < 1 ||
      spp < 1 || next_tile == nullptr || walk < WALK_NONE ||
      walk > WALK_LEAVES || !layout_ok(lay, width, blocks) ||
      (leaves && (parity_plane_sign || n_tric < 1 || chunks < 1 ||
                  chunks > 64)) ||
      (lowp &&
       (sph_lp == nullptr || (reinterpret_cast<size_t>(sph_lp) & 15))))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.f = make_frame(sph, lowp ? sph_lp : nullptr, n_sph, sphc_b, sphc_r,
                   n_sphc, cam, mean, segs, next_tile, width, height,
                   seed_word, row_offset, row_stride, shard_rows, spp, depth,
                   inv_spp, lay);
  p.tris = {tri, tric_b, tric_r, n_tri, n_tric, chunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (parity_plane_sign && lowp)
    e = launch_k1<true, true>(p, walk, blocks, s);
  else if (parity_plane_sign)
    e = launch_k1<true, false>(p, walk, blocks, s);
  else if (lowp)
    e = launch_k1<false, true>(p, walk, blocks, s);
  else
    e = launch_k1<false, false>(p, walk, blocks, s);
  return (int)e;
}

// Launch K2 on `stream` (the correct plane equation).  sph (11, n_sph) and
// optional sphere clusters as for K1; tri the leaf-aligned table (24,
// 128 n_leaves); leaf AABBs (6, n_leaves) with their PACKED ranges
// (2, n_leaves; at most 128 columns a leaf); sub-leaf AABBs
// (6, 4 n_leaves); top AABBs (6, n_tops) and leaf ranges (2, n_tops; at
// most 16 leaves a top; the wrapper checks the ranges).  The thread
// layout and next_tile as for K1.  Writes mean [shard_rows, width, 3] and
// segs [shard_rows, width].  Returns cudaGetLastError() after the launch.
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
  p.f = make_frame(sph, nullptr, n_sph, sphc_b, sphc_r, n_sphc, cam, mean,
                   segs, next_tile, width, height, seed_word, row_offset,
                   row_stride, shard_rows, spp, depth, inv_spp, lay);
  p.walk = {tri, leafb, leafr, subb, topb, topr, n_leaves, n_tops};
  return (int)launch_persistent(two_level_kernel, p, blocks,
                                static_cast<cudaStream_t>(stream));
}
