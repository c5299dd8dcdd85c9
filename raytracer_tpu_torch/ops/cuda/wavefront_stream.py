"""K4, the streamed big-mesh kernel: host tables, CUDA wrapper and plain
version.

``render_linear_stream_cuda`` launches the hand-written CUDA kernel in
``raytracer_tpu_torch/csrc/wavefront_stream.cu``, which replaces the TPU
kernel ``raytracer_tpu/ops/pallas/wavefront_stream.py``
``render_linear_pallas_stream`` / ``_make_stream_kernel``: K1's fused path
trace with the triangles in device memory as 128-column leaves under a
two-level bounding-sphere tree, walked top node by top node in the
camera's front-to-back order, with an early exit on the primary bounce and
a root-bound sky test.  It is the banded engine for meshes (the CLI's
``obj=`` and any render with a progress logger), since the binned engine
renders whole regrouped frames.  The kernel runs one thread per (pixel,
sample) in the layout ``thread_layout`` describes, culls each leaf's four
32-column sub-leaves by their own bounding spheres (``sub_bounds``) and
stages a passing sub-leaf in shared memory; each pixel's samples are summed
in sample order (``pixel_sum_ref``), so a frame is bitwise what one thread
per pixel gives.

``render_linear_stream_ref`` is the plain PyTorch version: K1's plain
per-pixel loop with the triangle stage taken a whole top node (up to 1024
columns) at a time for the rays its bound passes, and ties resolved as the
kernel's visit order resolves them (``wavefront.tri_block_hits``).  The
wrapper uses it only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises.  ``LAUNCHES`` counts kernel launches.

Tables (``build_tri_stream_tables``): tri (TRI_ROWS_PAD, L*LEAF) f32 with
each leaf's triangles at the start of its 128-column slot and zero columns
(never hit) after them; leaf_bounds (4, L) and top_bounds (4, C) f32
bounding spheres [cx, cy, cz, r^2] (r^2 < 0: empty); leaf_counts (1, L)
int32; top_ranges (2, C) int32 leaf ranges; root (4, 1) f32; with
``sub_bounds=True`` also the port's own sub_bounds (4, L*SUBS) f32, the
bounding sphere of each leaf's columns [32k, 32k + 32).
``sorted_top_order`` gives the camera's visit order and entry keys.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from .. import tables
from ... import rng
from . import wavefront as wf

__all__ = ["LAUNCHES", "LEAF", "SUB", "SUBS", "build_tri_stream_tables",
           "sorted_top_order", "thread_layout", "layout_samples",
           "pixel_sum_ref", "render_linear_stream_cuda",
           "render_linear_stream_ref"]

LAUNCHES = 0
LEAF = 128           # triangles per leaf slot
TOP_FANOUT = 8       # leaves per top node
SUB = 32             # columns per sub-leaf (the kernel's staged tile)
SUBS = LEAF // SUB   # sub-leaves per leaf
WARP = 32
WARPS_PER_BLOCK = 4
MAX_RUN = 16         # consecutive samples of one pixel in a warp
_F32 = torch.float32


def build_tri_stream_tables(scene, sub_bounds=False):
    """(tri, leaf_bounds, leaf_counts, top_bounds, top_ranges, root) as
    numpy arrays, equal to ``wavefront_stream.build_tri_stream_tables``:
    leaves are median-split clusters of <= LEAF valid triangles in
    depth-first order; top node k covers leaves [k*TOP_FANOUT,
    (k+1)*TOP_FANOUT); the root bounds every non-empty leaf.  With
    ``sub_bounds`` a seventh array: each leaf's SUBS sub-leaves of SUB
    columns bounded as the leaves are (r^2 < 0: empty).  ``scene``: a Scene
    or HostScene."""
    h = scene.numpy()
    v0 = np.asarray(h.tri_v0, np.float64)
    v1 = np.asarray(h.tri_v1, np.float64)
    v2 = np.asarray(h.tri_v2, np.float64)
    valid = np.asarray(h.tri_valid)
    vidx = np.nonzero(valid)[0]
    cen = (v0 + v1 + v2) / 3.0
    perm_v, slices = tables._median_split_order(cen[vidx], LEAF)
    perm_valid = vidx[perm_v]
    L = max(len(slices), 1)

    packed = tables.pack_triangles(h, perm=np.concatenate(
        [perm_valid, np.nonzero(~valid)[0]]).astype(np.int64))
    tri = np.zeros((tables.TRI_ROWS_PAD, L * LEAF), np.float32)
    leaf_bounds = np.zeros((4, L), np.float32)
    leaf_counts = np.zeros((1, L), np.int32)
    subb = np.zeros((4, L * SUBS), np.float32)
    subb[3] = -1.0

    def bound(mem):
        bc, br = tables._bounding_sphere(
            np.concatenate([v0[mem], v1[mem], v2[mem]], axis=0))
        return bc, br * br

    for k, (s, e) in enumerate(slices or [(0, 0)]):
        n = e - s
        tri[:tables.TRI_ROWS, k * LEAF:k * LEAF + n] = packed[:, s:e]
        leaf_counts[0, k] = n
        if n == 0:
            leaf_bounds[3, k] = -1.0
            continue
        leaf_bounds[0:3, k], leaf_bounds[3, k] = bound(perm_valid[s:e])
        if sub_bounds:
            for j in range(0, n, SUB):
                c = k * SUBS + j // SUB
                subb[0:3, c], subb[3, c] = bound(
                    perm_valid[s + j:min(s + j + SUB, e)])

    n_tops = max(-(-L // TOP_FANOUT), 1)
    top_bounds = np.zeros((4, n_tops), np.float32)
    top_ranges = np.zeros((2, n_tops), np.int32)
    for k in range(n_tops):
        l0, l1 = k * TOP_FANOUT, min((k + 1) * TOP_FANOUT, L)
        top_ranges[0, k], top_ranges[1, k] = l0, l1
        members = [m for m in range(l0, l1) if leaf_counts[0, m] > 0]
        if not members:
            top_bounds[3, k] = -1.0
            continue
        bc, br = tables.union_bound(leaf_bounds, members)
        top_bounds[0:3, k] = bc
        top_bounds[3, k] = br * br

    root = np.zeros((4, 1), np.float32)
    live = [k for k in range(L) if leaf_counts[0, k] > 0]
    if live:
        bc, br = tables.union_bound(leaf_bounds, live)
        root[0:3, 0] = bc
        root[3, 0] = br * br
    else:
        root[3, 0] = -1.0
    out = (tri, leaf_bounds, leaf_counts, top_bounds, top_ranges, root)
    return out + (subb,) if sub_bounds else out


def sorted_top_order(top_bounds, origin):
    """Front-to-back top visit order from ``origin``: (order (1, C) int32,
    keys (1, C) f32) sorted by dist(origin, centre) - radius, a lower bound
    on the entry distance of any ray from ``origin`` (nondecreasing along
    the order); empty nodes last with +inf keys.  numpy in and out."""
    b = np.asarray(top_bounds, np.float32)
    n = b.shape[1]
    d = np.linalg.norm(b[0:3].T - np.asarray(origin, np.float32), axis=1)
    keys = d - np.sqrt(np.maximum(b[3], 0.0))
    keys = np.where(b[3] < 0.0, np.inf, keys).astype(np.float32)
    order = np.argsort(keys, kind="stable").astype(np.int32)
    return order.reshape(1, n), keys[order].reshape(1, n)


class Layout(NamedTuple):
    """K4's thread layout over a band: each warp holds a tile_w x tile_h
    tile of pixels x ``run`` consecutive samples of each (lane = pixel *
    run + sample % run, the pixels row-major in the tile), ``chunks`` runs
    of samples one after another in each thread; warp tile w is tile (w %
    tiles_x, w // tiles_x) of the band.  The kernel's warps take the tiles
    from a counter, in blocks of WARPS_PER_BLOCK warps, at most ``blocks``
    of them (the card's resident blocks, if fewer)."""
    run: int
    tile_w: int
    tile_h: int
    tiles_x: int
    n_tiles: int
    chunks: int
    blocks: int


# pixels a warp holds -> its pixel tile (width, height)
_TILES = {2: (2, 1), 4: (2, 2), 8: (4, 2), 16: (4, 4),
          32: (8, 4)}


def thread_layout(width, shard_rows, spp) -> Layout:
    """One thread per (pixel, sample): runs of min(MAX_RUN, spp rounded up
    to a power of two) samples, so a CLI band (512 x 18 pixels, 16 spp)
    is 147,456 threads where one per pixel gave 9,216, and samples of one
    pixel, which start inside one pixel footprint, share a warp."""
    run = min(MAX_RUN, 1 << max(spp - 1, 0).bit_length())
    tile_w, tile_h = _TILES[WARP // run]
    tiles_x = -(-width // tile_w)
    n_tiles = tiles_x * -(-shard_rows // tile_h)
    return Layout(run, tile_w, tile_h, tiles_x, n_tiles, -(-spp // run),
                  -(-n_tiles // WARPS_PER_BLOCK))


def layout_samples(width, shard_rows, spp):
    """(band_row, col, sample, live) of every thread and chunk of the
    layout, numpy int [n_tiles, chunks, 32] each, as the kernel computes
    them; ``live``: inside the band and the frame, below spp."""
    lay = thread_layout(width, shard_rows, spp)
    w = np.arange(lay.n_tiles)[:, None, None]
    c = np.arange(lay.chunks)[None, :, None]
    lane = np.arange(WARP)[None, None, :]
    pix, j = lane // lay.run, lane % lay.run
    col = (w % lay.tiles_x) * lay.tile_w + pix % lay.tile_w
    row = (w // lay.tiles_x) * lay.tile_h + pix // lay.tile_w
    sample = c * lay.run + j
    live = (row < shard_rows) & (col < width) & (sample < spp)
    shape = (lay.n_tiles, lay.chunks, WARP)
    return tuple(np.broadcast_to(a, shape) for a in (row, col, sample, live))


def pixel_sum_ref(lane_values, width, shard_rows, spp):
    """The kernel's sample-order pixel sum (``pixel_sum_run``) on each
    lane's value per chunk, float32 [n_tiles, chunks, 32]: for each pixel,
    from 0.0, chunk by chunk, its run's lanes in order, samples below spp
    only.  Returns [shard_rows, width] (pixels outside the frame dropped):
    K1's acc = acc + c over samples 0 .. spp - 1."""
    lay = thread_layout(width, shard_rows, spp)
    row, col, _, live = layout_samples(width, shard_rows, spp)
    acc = torch.zeros((lay.n_tiles, WARP // lay.run), dtype=_F32)
    v = lane_values.reshape(lay.n_tiles, lay.chunks, WARP // lay.run,
                            lay.run)
    ok = torch.from_numpy((np.arange(lay.chunks)[:, None] * lay.run
                           + np.arange(lay.run)[None, :]) < spp)
    for c in range(lay.chunks):
        for j in range(lay.run):
            if ok[c, j]:
                acc = acc + v[:, c, :, j]
    out = torch.zeros((shard_rows, width), dtype=_F32)
    first = (slice(None), 0, slice(0, WARP, lay.run))
    inside = (row[first] < shard_rows) & (col[first] < width)
    out[row[first][inside], col[first][inside]] = acc[torch.from_numpy(
        inside)]
    return out


def _check_inputs(sph, tri, leaf_bounds, leaf_counts, top_bounds, top_ranges,
                  root, cam_vec, top_order, top_keys, sph_clusters,
                  sub_bounds=None, **shape):
    device = sph.device
    wf.check_sphere_tables(sph, sph_clusters, device)
    wf.check_tensor(tri, "tri", _F32, (tables.TRI_ROWS_PAD, None), device)
    n_leaves = leaf_bounds.shape[1] if leaf_bounds.dim() == 2 else 0
    n_tops = top_bounds.shape[1] if top_bounds.dim() == 2 else 0
    if n_leaves < 1 or n_tops < 1 or tri.shape[1] != n_leaves * LEAF:
        raise ValueError(f"tri has {tri.shape[1]} columns for {n_leaves} "
                         f"leaves of {LEAF} and {n_tops} tops")
    wf.check_tensor(leaf_bounds, "leaf_bounds", _F32, (4, n_leaves), device)
    wf.check_tensor(leaf_counts, "leaf_counts", torch.int32, (1, n_leaves),
                    device)
    wf.check_tensor(top_bounds, "top_bounds", _F32, (4, n_tops), device)
    wf.check_tensor(top_ranges, "top_ranges", torch.int32, (2, n_tops),
                    device)
    wf.check_tensor(root, "root", _F32, (4, 1), device)
    wf.check_tensor(cam_vec, "cam_vec", _F32, (12,), device)
    wf.check_tensor(top_order, "top_order", torch.int32, (1, n_tops), device)
    wf.check_tensor(top_keys, "top_keys", _F32, (1, n_tops), device)
    if sub_bounds is not None:
        wf.check_tensor(sub_bounds, "sub_bounds", _F32, (4, n_leaves * SUBS),
                        device)
    _check_ranges(leaf_counts, top_ranges, top_order, n_leaves, n_tops)
    return wf.check_shape(**shape)


# the index tables whose ranges passed last, as (weakref, version) pairs
# and the table sizes: the bands of a frame launch over the same tables,
# so the check syncs the device once a frame, not once a band (an in-place
# change bumps a tensor's version and is checked again)
_RANGES_CHECKED = None


def _check_ranges(leaf_counts, top_ranges, top_order, n_leaves, n_tops):
    """Raise unless the leaf counts, top ranges and top order index inside
    the tables; a top spans at most TOP_FANOUT leaves (the kernel stages a
    top's sub-leaves through a 32-bit mask).  One device sync, skipped for
    the tables checked last."""
    global _RANGES_CHECKED
    ts = (leaf_counts, top_ranges, top_order)
    last = _RANGES_CHECKED
    if last is not None and last[0] == (n_leaves, n_tops) and all(
            ref() is t and version == t._version
            for (ref, version), t in zip(last[1], ts)):
        return
    if bool((leaf_counts.min() < 0) | (leaf_counts.max() > LEAF)
            | (top_ranges.min() < 0) | (top_ranges.max() > n_leaves)
            | ((top_ranges[1] - top_ranges[0]).max() > TOP_FANOUT)
            | (top_order.min() < 0) | (top_order.max() >= n_tops)):
        raise ValueError("leaf counts, top ranges or top order fall outside "
                         "the tables")
    _RANGES_CHECKED = ((n_leaves, n_tops),
                       tuple((weakref.ref(t), t._version) for t in ts))


def _order_or_table(top_bounds, top_order, top_keys):
    """Without a camera order the tops are walked in table order and the
    primary walk never exits early (-inf keys)."""
    if top_order is not None:
        return top_order, top_keys
    n = top_bounds.shape[1]
    dev = top_bounds.device
    return (torch.arange(n, dtype=torch.int32, device=dev).reshape(1, n),
            torch.full((1, n), float("-inf"), dtype=_F32, device=dev))


def render_linear_stream_cuda(sph, tri, leaf_bounds, leaf_counts, top_bounds,
                              top_ranges, root, cam_vec, *, width, height,
                              samples_per_pixel, depth, seed=0,
                              sph_clusters=None, top_order=None,
                              top_keys=None, shard_rows=None, row_offset=0,
                              row_stride=1, sub_bounds=None):
    """Mean linear radiance [shard_rows, W, 3] + segment count through K4
    (the plain version for CPU tensors).  Always the correct plane
    equation.  ``top_order`` / ``top_keys`` from ``sorted_top_order``
    enable the primary bounce's front-to-back early exit; sharding
    arguments as K1's.  ``sub_bounds`` (``build_tri_stream_tables(...,
    sub_bounds=True)``'s, on the device) lets the kernel cull sub-leaves;
    without them each sub-leaf takes its leaf's bound."""
    global LAUNCHES
    args = (sph, tri, leaf_bounds, leaf_counts, top_bounds, top_ranges, root,
            cam_vec)
    kw = dict(width=width, height=height,
              samples_per_pixel=samples_per_pixel, depth=depth, seed=seed,
              sph_clusters=sph_clusters, top_order=top_order,
              top_keys=top_keys, shard_rows=shard_rows,
              row_offset=row_offset, row_stride=row_stride,
              sub_bounds=sub_bounds)
    if sph.device.type == "cpu":
        return render_linear_stream_ref(*args, **kw)
    if sph.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA tensors, got {sph.device}")
    top_order, top_keys = _order_or_table(top_bounds, top_order, top_keys)
    if sub_bounds is None:
        sub_bounds = leaf_bounds.repeat_interleave(SUBS, dim=1)
    shard_rows = _check_inputs(
        *args, top_order, top_keys, sph_clusters, sub_bounds, width=width,
        height=height, samples_per_pixel=samples_per_pixel, depth=depth,
        shard_rows=shard_rows, row_offset=row_offset, row_stride=row_stride)
    lay = thread_layout(width, shard_rows, samples_per_pixel)
    from . import build
    lib = build.load()
    device = sph.device
    mean = torch.empty((shard_rows, width, 3), dtype=_F32, device=device)
    segs = torch.empty((shard_rows, width), dtype=torch.int32, device=device)
    next_tile = torch.zeros((1,), dtype=torch.int32, device=device)
    sphc_b, sphc_r = sph_clusters if sph_clusters is not None else (None,
                                                                    None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        rc = lib.rt_stream_render(
            ptr(sph), sph.shape[1], ptr(sphc_b), ptr(sphc_r),
            0 if sphc_b is None else sphc_b.shape[1],
            ptr(tri), ptr(leaf_bounds), ptr(leaf_counts), ptr(sub_bounds),
            leaf_bounds.shape[1], ptr(top_bounds), ptr(top_ranges),
            ptr(top_order), ptr(top_keys), top_bounds.shape[1], ptr(root),
            ptr(cam_vec), ptr(mean), ptr(segs), ptr(next_tile), width,
            height, rng.seed_word(seed), row_offset, row_stride, shard_rows,
            samples_per_pixel, depth, wf._inv_spp(samples_per_pixel),
            lay.run, lay.tile_w, lay.tile_h, lay.tiles_x, lay.n_tiles,
            lay.blocks, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K4 (rt_stream_render) launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 1
    return mean, int(torch.sum(segs, dtype=torch.int64))


def bound_test(b, ci, ray, t_best):
    """_bound_test: could the ray hit something inside bounding sphere
    ``ci`` of ``b`` (host rows [cx, cy, cz, r^2]) no farther than t_best?"""
    ox, oy, oz, dx, dy, dz = ray
    ocx = ox - b[0][ci]
    ocy = oy - b[1][ci]
    ocz = oz - b[2][ci]
    hb = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - b[3][ci]
    disc = hb * hb - cc
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    entry = torch.clamp_min(-hb - sq, 0.0)
    return (disc >= 0.0) & (-hb + sq > wf.T_MIN) & (entry <= t_best)


def render_linear_stream_ref(sph, tri, leaf_bounds, leaf_counts, top_bounds,
                             top_ranges, root, cam_vec, *, width, height,
                             samples_per_pixel, depth, seed=0,
                             sph_clusters=None, top_order=None,
                             top_keys=None, shard_rows=None, row_offset=0,
                             row_stride=1, sub_bounds=None):
    """K4's plain PyTorch version: same arguments and results as
    ``render_linear_stream_cuda``, on whatever device the tensors are.
    Each bounce visits the tops in ``top_order`` and takes every ray's
    closest hit over the tops whose bound it passes; culling (by leaf or
    sub-leaf) and the early exit cannot change a hit, so only the visit
    order (ties) is kept and ``sub_bounds`` is only checked."""
    top_order, top_keys = _order_or_table(top_bounds, top_order, top_keys)
    shard_rows = _check_inputs(
        sph, tri, leaf_bounds, leaf_counts, top_bounds, top_ranges, root,
        cam_vec, top_order, top_keys, sph_clusters, sub_bounds, width=width,
        height=height, samples_per_pixel=samples_per_pixel, depth=depth,
        shard_rows=shard_rows, row_offset=row_offset, row_stride=row_stride)
    dev = sph.device
    topb_h = top_bounds.cpu().tolist()
    topr_h = top_ranges.cpu().tolist()
    counts = leaf_counts[0].cpu().tolist()
    span = tri.shape[1]              # more columns than any top holds
    visits = []                      # (top, its columns in visit order, rank)
    for pos, ci in enumerate(top_order[0].cpu().tolist()):
        cols = [torch.arange(li * LEAF, li * LEAF + counts[li], device=dev)
                for li in range(topr_h[0][ci], topr_h[1][ci])]
        cols = torch.cat(cols) if cols else torch.zeros(0, dtype=torch.int64)
        if cols.numel():
            visits.append((ci, cols, pos * span))

    def tri_stage(ray, h, alive, _b):
        rank = torch.full_like(alive, -1, dtype=torch.int64)
        for ci, cols, base in visits:
            sel = (bound_test(topb_h, ci, ray, h[0]) & alive).nonzero()[:, 0]
            if sel.numel():
                wf.tri_block_hits(tri, cols, ray, h, rank, base, sel)

    return wf.trace_pixels_ref(
        sph, cam_vec, tri_stage, width=width, height=height,
        samples_per_pixel=samples_per_pixel, depth=depth, seed=seed,
        sph_clusters=sph_clusters, shard_rows=shard_rows,
        row_offset=row_offset, row_stride=row_stride)
