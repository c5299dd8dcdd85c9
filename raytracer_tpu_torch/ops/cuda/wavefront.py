"""K1, K2 and K1-lowp, the fused forward render kernels: CUDA wrapper and
plain version.

``render_linear_cuda`` launches the hand-written CUDA kernels in
``raytracer_tpu_torch/csrc/wavefront.cu``, which replace the TPU kernel
``raytracer_tpu/ops/pallas/wavefront.py`` ``render_linear_pallas`` /
``_make_kernel``: the whole path trace of a frame (or of a row band) fused
into one launch.  On the card K1 is bound by FP32 ALU throughput,
occupancy and branch divergence, not by bytes (the scene tables stay in
L1/L2 and device memory sees one write of the image).  It runs one thread
per (pixel, sample) in the layout of ``wavefront_stream.thread_layout`` on
persistent warps, keeps all ray state in registers, and ends a warp's
bounce loop when none of its rays is alive; each pixel's samples are summed
in sample order (``wavefront_stream.pixel_sum_ref``), so its image is
bitwise what one thread per pixel gives.  Its triangle walk (``tri_walk``)
is compiled into the instance it launches: none for a table of one padding
column, the flat scan, or the one-level walk over ``tri_clusters``, which
copies a passing leaf's 32-column chunks into shared memory.  K1-lowp is K1
with ``lowp``: the sphere quadratic in bfloat16 (``_sphere_loop_lowp``, the
reduced-precision study of the JAX package), a flat scan of the sphere
table that ignores its clusters, two spheres at a time in Hopper's packed
bfloat16 instructions over ``lowp_sphere_table`` (built once per table).
K2 is the kernel of ``tri_stream``: the two-level walk of
``_streamed_tri_walk`` over a leaf-aligned triangle table
(``ops.diff.tri_stream_table``), the differentiable forward of meshes past
the table budget, in K1's layout; it culls each leaf's 32-column sub-leaves
by their own boxes (``sub_bounds``) and stages a passing sub-leaf in shared
memory.

``render_linear_ref`` is the plain PyTorch version: vectorised over pixels,
a Python loop over primitives (K2's: over tops, a top's columns at once),
the kernel's operation order, and the per-ray cluster test applied as a
mask; with ``lowp`` the sphere stage in torch bfloat16 ops, which round
each result once as the kernel's ``__float2bfloat16_rn`` does.  Culling by
sub-leaf boxes cannot change a hit (the boxes are conservative), so K2's
plain version only checks ``sub_bounds``.  It runs wherever its tensors
are (the CPU tests, and on the card to check the kernel).

The wrapper uses the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  ``LAUNCHES`` counts the
wrapper's K1 launches, ``STREAM_LAUNCHES`` its K2 launches and
``LOWP_LAUNCHES`` its K1-lowp launches.

Arguments of both (the keywords of ``render_linear_pallas``):
  sph (SPH_ROWS, S) f32, tri (TRI_ROWS, T) f32, cam_vec (12,) f32 from
  ``ops.tables``; sph_clusters / tri_clusters: optional (bounds (6, C) f32,
  ranges (2, C) int32) matching tables packed with the cluster ``perm``;
  tri_stream: optional (top bounds (6, Ct) f32, top ranges (2, Ct) int32
  over the leaves, at most 16 leaves a top) of the two-level walk; ``tri``
  is then the leaf-aligned (TRI_ROWS_PAD, 128 C) table and
  ``tri_clusters`` the leaf bounds with their ranges in the PACKED table,
  so winners are packed columns; sub_bounds: with tri_stream, optional
  (6, 4 C) f32 boxes of each leaf's slot columns [32k, 32k + 32)
  (``ops.diff.tri_sub_bounds``; without them K2 gives each sub-leaf its
  leaf's box); shard_rows / row_offset / row_stride render rows
  ``row_offset + k * row_stride`` for k < shard_rows.  Pixel ids, and so
  the random streams, depend only on the global (row, col): a banded
  render is bitwise the matching rows of a whole one.  Returns (mean
  [shard_rows, W, 3] f32, traced segments as a Python int).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from .. import tables
from ... import rng

__all__ = ["LAUNCHES", "STREAM_LAUNCHES", "LOWP_LAUNCHES", "STREAM_LEAF_PAD",
           "LEAF_SUBS", "TOP_LEAVES_MAX", "WALK_NONE", "WALK_FLAT",
           "WALK_LEAVES", "CHUNK", "tri_walk", "lowp_sphere_table",
           "render_linear_cuda", "render_linear_ref"]

LAUNCHES = 0
STREAM_LAUNCHES = 0
LOWP_LAUNCHES = 0
# columns of a leaf's slot in the two-level walk's leaf-aligned table, its
# 32-column sub-leaves, and the most leaves a top may hold (K2 and K5s
# stage a top's sub-leaves through a 64-bit mask: path_common.cuh)
STREAM_LEAF_PAD = 128
LEAF_SUBS = 4
TOP_LEAVES_MAX = 16
# K1's and K5's triangle walks (TriWalk in path_common.cuh), and the columns
# of a one-level leaf's staged chunk; a leaf's chunks fit one 64-bit mask
WALK_NONE, WALK_FLAT, WALK_LEAVES = 0, 1, 2
CHUNK = 32
MAX_LEAF_CHUNKS = 64

_F32 = torch.float32
# float32 values of the kernel's constants (wavefront.cu)
T_MIN = float(np.float32(0.001))
BIG = float(np.float32(3.0e38))
EPS8 = float(np.float32(1e-8))
TINY = float(np.float32(1e-20))
SKY_G = float(np.float32(0.3))


def check_tensor(t, name, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    whose shape matches ``shape`` (None: any extent)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_sphere_tables(sph, sph_clusters, device):
    """The sphere table and its optional clusters (bounds, ranges)."""
    check_tensor(sph, "sph", _F32, (tables.SPH_ROWS, None), device)
    if sph.shape[1] < 1:
        raise ValueError("tables need at least one (padding) column")
    check_clusters("sph_clusters", sph_clusters, sph.shape[1], device)


def check_clusters(name, cl, n, device):
    if cl is None:
        return
    bounds, ranges = cl
    check_tensor(bounds, f"{name} bounds", _F32, (6, None), device)
    check_tensor(ranges, f"{name} ranges", torch.int32, (2, bounds.shape[1]),
                 device)
    if ranges.numel() and (int(ranges.min()) < 0 or int(ranges.max()) > n):
        raise ValueError(f"{name} ranges fall outside the table")


def check_stream(tri, tri_clusters, tri_stream, sub_bounds, device):
    """The two-level walk's tables: a leaf-aligned ``tri`` of 128 columns
    per leaf, leaves of at most 128 triangles, tops of at most 16 leaves,
    and optional (6, 4 C) sub-leaf boxes."""
    if tri_clusters is None:
        raise ValueError("tri_stream needs the leaf clusters (tri_clusters)")
    bounds, ranges = tri_clusters
    n_leaves = bounds.shape[1]
    if tri.shape[1] != STREAM_LEAF_PAD * n_leaves:
        raise ValueError(f"the leaf-aligned table has {tri.shape[1]} "
                         f"columns, expected {STREAM_LEAF_PAD} x {n_leaves}")
    check_clusters("tri_stream", tri_stream, n_leaves, device)
    counts = ranges[1] - ranges[0]
    spans = tri_stream[1][1] - tri_stream[1][0]
    if bool((counts.min() < 0) | (counts.max() > STREAM_LEAF_PAD)
            | (spans.min() < 0) | (spans.max() > TOP_LEAVES_MAX)):
        raise ValueError(f"a leaf holds more than {STREAM_LEAF_PAD} "
                         f"triangles or a top more than {TOP_LEAVES_MAX} "
                         f"leaves")
    if sub_bounds is not None:
        check_tensor(sub_bounds, "sub_bounds", _F32,
                     (6, LEAF_SUBS * n_leaves), device)


def _check_inputs(sph, tri, cam_vec, sph_clusters, tri_clusters, *, width,
                  height, samples_per_pixel, depth, parity_plane_sign,
                  shard_rows, row_offset, row_stride, tri_stream=None,
                  sub_bounds=None) -> int:
    """Raise on anything the kernel cannot take; return shard_rows."""
    if tri_clusters is not None and parity_plane_sign:
        raise ValueError(
            "tri_clusters culling is unsound with parity_plane_sign=True "
            "(bounce-ray hits escape vertex-derived bounds)")
    device = sph.device
    check_sphere_tables(sph, sph_clusters, device)
    rows = tables.TRI_ROWS if tri_stream is None else tables.TRI_ROWS_PAD
    check_tensor(tri, "tri", _F32, (rows, None), device)
    check_tensor(cam_vec, "cam_vec", _F32, (12,), device)
    check_clusters("tri_clusters", tri_clusters, tri.shape[1], device)
    if tri.shape[1] < 1:
        raise ValueError("tables need at least one (padding) column")
    if tri_stream is not None:
        check_stream(tri, tri_clusters, tri_stream, sub_bounds, device)
    elif sub_bounds is not None:
        raise ValueError("sub_bounds belong to the two-level walk "
                         "(tri_stream)")
    return check_shape(width=width, height=height,
                       samples_per_pixel=samples_per_pixel, depth=depth,
                       shard_rows=shard_rows, row_offset=row_offset,
                       row_stride=row_stride)


def check_shape(*, width, height, samples_per_pixel, depth, shard_rows,
                row_offset, row_stride) -> int:
    """Raise on a render shape the fused kernels cannot take; return
    shard_rows."""
    shard_rows = height if shard_rows is None else shard_rows
    if min(width, height, samples_per_pixel, shard_rows, row_stride) < 1 \
            or depth < 0 or row_offset < 0:
        raise ValueError(
            f"bad render shape: width={width} height={height} "
            f"spp={samples_per_pixel} depth={depth} shard_rows={shard_rows} "
            f"row_offset={row_offset} row_stride={row_stride}")
    return shard_rows


def _inv_spp(samples_per_pixel: int) -> float:
    return float(np.float32(1.0 / samples_per_pixel))


def render_linear_cuda(sph, tri, cam_vec, *, width, height,
                       samples_per_pixel, depth, seed=0,
                       parity_plane_sign=True, sph_clusters=None,
                       tri_clusters=None, shard_rows=None, row_offset=0,
                       row_stride=1, tri_stream=None, sub_bounds=None,
                       lowp=False):
    """Mean linear radiance [shard_rows, W, 3] + segment count through K1,
    K2 with ``tri_stream``, K1-lowp with ``lowp`` (the plain version for
    CPU tensors)."""
    global LAUNCHES, LOWP_LAUNCHES
    kw = dict(width=width, height=height,
              samples_per_pixel=samples_per_pixel, depth=depth,
              parity_plane_sign=parity_plane_sign, shard_rows=shard_rows,
              row_offset=row_offset, row_stride=row_stride,
              tri_stream=tri_stream, sub_bounds=sub_bounds)
    name = "K1-lowp" if lowp else "K1" if tri_stream is None else "K2"
    if sph.device.type == "cpu":
        return render_linear_ref(sph, tri, cam_vec, seed=seed,
                                 sph_clusters=sph_clusters,
                                 tri_clusters=tri_clusters, lowp=lowp, **kw)
    if sph.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {sph.device}")
    if tri_stream is not None and lowp:
        raise ValueError("K1-lowp takes no two-level walk (tri_stream)")
    shard_rows = _check_inputs(sph, tri, cam_vec, sph_clusters,
                               tri_clusters, **kw)
    from . import build
    lib = build.load()
    device = sph.device
    mean = torch.empty((shard_rows, width, 3), dtype=_F32, device=device)
    segs = torch.empty((shard_rows, width), dtype=torch.int32, device=device)
    if tri_stream is not None:
        _launch_k2(lib, sph, tri, cam_vec, sph_clusters, tri_clusters, mean,
                   segs, seed=seed, **dict(kw, shard_rows=shard_rows))
        return mean, int(torch.sum(segs, dtype=torch.int64))
    walk, chunks = tri_walk(tri, tri_clusters)
    lay = layout_args(width, shard_rows, samples_per_pixel)
    next_tile = torch.zeros((1,), dtype=torch.int32, device=device)
    sphc_b, sphc_r = sph_clusters if sph_clusters is not None else (None,
                                                                    None)
    tric_b, tric_r = tri_clusters if tri_clusters is not None else (None,
                                                                    None)
    sph_lp = lowp_sphere_table(sph) if lowp else None
    with torch.cuda.device(device):
        rc = lib.rt_wavefront_render(
            ptr(sph), sph.shape[1], ptr(sph_lp), ptr(tri), tri.shape[1],
            ptr(cam_vec),
            ptr(sphc_b), ptr(sphc_r), 0 if sphc_b is None else sphc_b.shape[1],
            ptr(tric_b), ptr(tric_r), 0 if tric_b is None else tric_b.shape[1],
            chunks, ptr(mean), ptr(segs), ptr(next_tile), width, height,
            rng.seed_word(seed), row_offset, row_stride, shard_rows,
            samples_per_pixel, depth, _inv_spp(samples_per_pixel),
            int(bool(parity_plane_sign)), int(bool(lowp)), walk, *lay,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} (rt_wavefront_render) launch failed: "
                           f"cudaError {rc}")
    if lowp:
        LOWP_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return mean, int(torch.sum(segs, dtype=torch.int64))


# the table tri_walk found to be one padding column, or not, last: a frame's
# bands and a gradient pass's two kernels launch over one table, so the
# check syncs the device once for them (an in-place change bumps the
# tensor's version and is checked again)
_PADDING_CHECKED = (None, -1, False)


def _one_padding_column(tri) -> bool:
    """Whether ``tri`` is a single column with a zero plane normal, which
    never hits (``pack_triangles``' padding)."""
    global _PADDING_CHECKED
    if tri.shape[1] != 1:
        return False
    ref, version, result = _PADDING_CHECKED
    if ref is None or ref() is not tri or version != tri._version:
        result = not bool(tri[:3].any())
        _PADDING_CHECKED = (weakref.ref(tri), tri._version, result)
    return result


# K1-lowp's packed table, last built: (its float32 table, version, packed)
_LOWP_TABLE = (None, -1, None)


def lowp_sphere_table(sph):
    """K1-lowp's packed sphere table (``sphere_pair_lowp`` in
    path_common.cuh) on ``sph``'s device: (ceil(S / 2), 4, 2) bfloat16,
    row k holding cx, cy, cz and r^2 of spheres 2k and 2k + 1 (a 16-byte
    ``uint4`` of four bfloat16x2 words, sphere 2k in each low half), each
    the float32 value rounded once to bfloat16 (ties to even).  r^2 is -1
    where the float32 r^2 is not > 0 and for the sphere that pads an odd
    count, so neither can win.  Cached on the table's identity and version
    (as ``_one_padding_column`` caches its check), so a render enqueues no
    work for it after the first and never syncs."""
    global _LOWP_TABLE
    ref, version, packed = _LOWP_TABLE
    if ref is not None and ref() is sph and version == sph._version:
        return packed
    n = sph.shape[1]
    r2 = torch.where(sph[tables.SPH_R2] > 0.0, sph[tables.SPH_R2], -1.0)
    rows = torch.stack([sph[tables.SPH_CX], sph[tables.SPH_CY],
                        sph[tables.SPH_CZ], r2])
    if n % 2:
        pad = torch.tensor([0.0, 0.0, 0.0, -1.0], dtype=_F32,
                           device=sph.device)
        rows = torch.cat([rows, pad[:, None]], dim=1)
    packed = rows.to(torch.bfloat16).reshape(4, -1, 2).permute(1, 0, 2) \
        .contiguous()
    _LOWP_TABLE = (weakref.ref(sph), sph._version, packed)
    return packed


def tri_walk(tri, tri_clusters) -> tuple[int, int]:
    """(walk, chunks): the triangle walk of the K1 or K5 instance that a
    launch over these tables takes (``WALK_NONE`` for a table of one
    padding column, ``WALK_LEAVES`` over clusters, else ``WALK_FLAT``), and
    the most 32-column chunks a cluster holds (0 without clusters)."""
    if tri_clusters is None:
        return (WALK_NONE if _one_padding_column(tri) else WALK_FLAT), 0
    ranges = tri_clusters[1]
    most = int((ranges[1] - ranges[0]).max()) if ranges.numel() else 0
    chunks = max(-(-most // CHUNK), 1)
    if chunks > MAX_LEAF_CHUNKS:
        raise ValueError(f"a triangle cluster holds {most} triangles, more "
                         f"than the {CHUNK * MAX_LEAF_CHUNKS} the one-level "
                         f"walk stages")
    return WALK_LEAVES, chunks


def layout_args(width, shard_rows, samples_per_pixel) -> tuple:
    """The (pixel, sample) thread layout of K1, K2, K5 and K5s in the C
    entry points' order: (run, tile_w, tile_h, tiles_x, n_tiles, blocks)."""
    from . import wavefront_stream as ws
    lay = ws.thread_layout(width, shard_rows, samples_per_pixel)
    return (lay.run, lay.tile_w, lay.tile_h, lay.tiles_x, lay.n_tiles,
            lay.blocks)


def ptr(t):
    """A tensor's device address for the C entry points (None: null)."""
    return None if t is None else t.data_ptr()


def stream_launch_args(tri, tri_clusters, tri_stream, sub_bounds, *, width,
                       shard_rows, samples_per_pixel):
    """The two-level walk's table pointers and counts and the thread layout
    of K2 and K5s, in the C entry points' order: (tri, leaf bounds, leaf
    ranges, sub-leaf bounds, n_leaves, top bounds, top ranges, n_tops),
    (run, tile_w, tile_h, tiles_x, n_tiles, blocks), and the tensors they
    point into.  Without ``sub_bounds`` each sub-leaf takes its leaf's
    box."""
    (leaf_b, leaf_r), (top_b, top_r) = tri_clusters, tri_stream
    if sub_bounds is None:
        sub_bounds = leaf_b.repeat_interleave(LEAF_SUBS, dim=1)
    walk = (ptr(tri), ptr(leaf_b), ptr(leaf_r), ptr(sub_bounds),
            leaf_b.shape[1], ptr(top_b), ptr(top_r), top_b.shape[1])
    return walk, layout_args(width, shard_rows, samples_per_pixel), \
        sub_bounds


def _launch_k2(lib, sph, tri, cam_vec, sph_clusters, tri_clusters, mean,
               segs, *, width, height, samples_per_pixel, depth, seed,
               shard_rows, row_offset, row_stride, tri_stream, sub_bounds,
               parity_plane_sign):
    global STREAM_LAUNCHES
    device = sph.device
    walk, lay, subs = stream_launch_args(
        tri, tri_clusters, tri_stream, sub_bounds, width=width,
        shard_rows=shard_rows, samples_per_pixel=samples_per_pixel)
    next_tile = torch.zeros((1,), dtype=torch.int32, device=device)
    sphc_b, sphc_r = sph_clusters if sph_clusters is not None else (None,
                                                                    None)
    with torch.cuda.device(device):
        rc = lib.rt_wavefront_render_stream(
            ptr(sph), sph.shape[1], ptr(sphc_b), ptr(sphc_r),
            0 if sphc_b is None else sphc_b.shape[1], *walk, ptr(cam_vec),
            ptr(mean), ptr(segs), ptr(next_tile), width, height,
            rng.seed_word(seed), row_offset, row_stride, shard_rows,
            samples_per_pixel, depth, _inv_spp(samples_per_pixel), *lay,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K2 (rt_wavefront_render_stream) launch failed: "
                           f"cudaError {rc}")
    STREAM_LAUNCHES += 1


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _inv_dir(v):
    """1/v with tiny components clamped (the slab test stays finite)."""
    mag = torch.clamp_min(v.abs(), TINY)
    q = torch.ones_like(mag) / mag
    return torch.where(v >= 0.0, q, -q)


def _aabb_possible(bounds_h, ci, ray, inv, t_best, alive):
    """Per-ray form of _aabb_test for cluster ``ci``."""
    ox, oy, oz = ray[:3]
    ivx, ivy, ivz = inv
    lox, loy, loz, hix, hiy, hiz = (bounds_h[k][ci] for k in range(6))
    tx0 = (lox - ox) * ivx
    tx1 = (hix - ox) * ivx
    ty0 = (loy - oy) * ivy
    ty1 = (hiy - oy) * ivy
    tz0 = (loz - oz) * ivz
    tz1 = (hiz - oz) * ivz
    tnear = torch.maximum(
        torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
        torch.clamp_min(torch.minimum(tz0, tz1), 0.0))
    tfar = torch.minimum(
        torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
        torch.maximum(tz0, tz1))
    return (tnear <= tfar) & (tfar > T_MIN) & (tnear <= t_best) & alive


def _bf16(v: float) -> float:
    """The float32 value ``v`` rounded to bfloat16 (ties to even)."""
    return float(torch.tensor(v, dtype=_F32).to(torch.bfloat16))


def _sphere_step(col, ray, h, mask, ray_bf16=None):
    """One sphere of _sphere_loop; h[1:4] carry the winning centre.  With
    ``ray_bf16`` (the ray in bfloat16) the step of _sphere_loop_lowp: the
    centre difference, half_b and c in bfloat16, each op rounded once,
    then upcast."""
    cx, cy, cz, _r, r2, kind, ar, ag, ab, fz, ir = col
    if not r2 > 0.0:        # padding: never hits
        return
    if ray_bf16 is None:
        ox, oy, oz, dx, dy, dz = ray
        ocx = ox - cx
        ocy = oy - cy
        ocz = oz - cz
        half_b = ocx * dx + ocy * dy + ocz * dz
        cc = ocx * ocx + ocy * ocy + ocz * ocz - r2
    else:
        ox, oy, oz, dx, dy, dz = ray_bf16
        ocx = ox - _bf16(cx)
        ocy = oy - _bf16(cy)
        ocz = oz - _bf16(cz)
        half_b = (ocx * dx + ocy * dy + ocz * dz).to(_F32)
        cc = (ocx * ocx + ocy * ocy + ocz * ocz - _bf16(r2)).to(_F32)
    disc = half_b * half_b - cc
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    root1 = -half_b - sq
    root2 = -half_b + sq
    t = torch.where(root1 > T_MIN, root1,
                    torch.where(root2 > T_MIN, root2, BIG))
    t = torch.where(disc >= 0.0, t, BIG)
    better = t < h[0]
    if mask is not None:
        better = better & mask
    for k, val in enumerate((t, cx, cy, cz, kind, ar, ag, ab, fz, ir)):
        h[k] = torch.where(better, val, h[k])


def _tri_step(col, ray, h, parity_plane_sign, mask):
    """One triangle of _make_tri_body; h[1:4] carry the raw plane normal
    and kind gets +8."""
    tnx, tny, tnz, td = col[:4]
    if tnx == 0.0 and tny == 0.0 and tnz == 0.0:   # padding: parallel
        return
    ox, oy, oz, dx, dy, dz = ray
    nd = tnx * dx + tny * dy + tnz * dz
    no = tnx * ox + tny * oy + tnz * oz
    par = nd.abs() < EPS8
    nd_safe = torch.where(par, 1.0, nd)
    if parity_plane_sign:       # the reference's sign (common.rs:140-141)
        t = (no + td) / nd_safe
    else:
        t = (td - no) / nd_safe
    ok = ~par & (t >= T_MIN)
    for k in range(3):
        gx, gy, gz, w = col[4 + 4 * k: 8 + 4 * k]
        e = ox * gx + oy * gy + oz * gz + t * (dx * gx + dy * gy + dz * gz) - w
        ok = ok & (e >= 0.0)
    better = ok & (t <= h[0])           # triangles win ties
    if mask is not None:
        better = better & mask
    tkind, textra, tar, tag, tab = col[16:21]
    fz = textra if 0.5 <= tkind < 1.5 else 0.0
    ir = textra if 1.5 <= tkind < 2.5 else 1.0
    for k, val in enumerate((t, tnx, tny, tnz, tkind + 8.0, tar, tag, tab,
                             fz, ir)):
        h[k] = torch.where(better, val, h[k])


def _closest_hit(table_h, clusters_h, step, ray, h, alive):
    """Flat scan, or per-ray culled scan over cluster member ranges."""
    if clusters_h is None:
        for col in table_h:
            step(col, ray, h, None)
        return
    bounds_h, ranges_h = clusters_h
    inv = tuple(_inv_dir(d) for d in ray[3:])
    for ci in range(len(ranges_h[0])):
        possible = _aabb_possible(bounds_h, ci, ray, inv, h[0], alive)
        if not bool(possible.any()):
            continue
        for i in range(ranges_h[0][ci], ranges_h[1][ci]):
            step(table_h[i], ray, h, possible)


def tri_block_hits(tri, cols, ray, h, rank, rank_base, sel, mask=None,
                   wins=None):
    """Closest triangle hit over the columns ``cols`` of a leaf-aligned
    table ``tri`` (correct plane sign) for the rays ``sel``, all columns at
    once, taken as the kernels' sequential scan with ``t <= t_best`` takes
    it: the least t, and among equal t the column visited last.  The
    visit rank of ``cols[j]`` for ray i is ``rank_base[i] + j`` (an int or
    one per ray of ``sel``); ``rank`` holds each ray's winner's rank (-1
    for a sphere or none), so a triangle beats a sphere at equal t.
    ``mask`` [len(sel), len(cols)] leaves out the columns a ray does not
    test.  With ``wins`` (the float winner id of each column) ``h`` is K5's
    record: the raw kind, then the winner id and the plane d.  Updates
    ``h`` and ``rank`` in place, in chunks of rays that keep each temporary
    near 4M elements; every operation rounds as in ``tri_step``."""
    T = tri[:, cols]
    step = max(1, (1 << 22) // max(cols.shape[0], 1))
    for i in range(0, sel.shape[0], step):
        base = (rank_base[i:i + step] if isinstance(rank_base, torch.Tensor)
                else rank_base)
        _tri_block(tri, T, cols, ray, h, rank, base, sel[i:i + step],
                   None if mask is None else mask[i:i + step], wins)


def _tri_block(tri, T, cols, ray, h, rank, rank_base, sel, mask, wins):
    ox, oy, oz, dx, dy, dz = (r[sel][:, None] for r in ray)
    tnx, tny, tnz, td = (T[k][None, :] for k in range(4))
    nd = tnx * dx + tny * dy + tnz * dz
    no = tnx * ox + tny * oy + tnz * oz
    par = nd.abs() < EPS8
    nd_safe = torch.where(par, 1.0, nd)
    t = (td - no) / nd_safe
    ok = ~par & (t >= T_MIN)
    for k in range(3):
        gx, gy, gz, w = (T[4 + 4 * k + q][None, :] for q in range(4))
        e = ox * gx + oy * gy + oz * gz + t * (dx * gx + dy * gy + dz * gz) - w
        ok = ok & (e >= 0.0)
    if mask is not None:
        ok = ok & mask
    tm = torch.where(ok, t, float("inf"))
    t_min = tm.min(dim=1).values
    j = torch.arange(cols.shape[0], device=tm.device)
    last = torch.where(ok & (tm == t_min[:, None]), j, -1).max(dim=1).values
    cand = rank_base + last
    t_best, r_best = h[0][sel], rank[sel]
    better = (last >= 0) & ((t_min < t_best)
                            | ((t_min == t_best) & (cand > r_best)))
    win = cols[last.clamp_min(0)]
    tkind = tri[tables.TRI_KIND][win]
    textra = tri[tables.TRI_EXTRA][win]
    t_met = (tkind >= 0.5) & (tkind < 1.5)
    t_die = (tkind >= 1.5) & (tkind < 2.5)
    vals = (t_min, tri[0][win], tri[1][win], tri[2][win],
            tkind + 8.0 if wins is None else tkind,
            tri[tables.TRI_AR][win], tri[tables.TRI_AG][win],
            tri[tables.TRI_AB][win], torch.where(t_met, textra, 0.0),
            torch.where(t_die, textra, 1.0))
    if wins is not None:
        vals += (wins[last.clamp_min(0)], tri[tables.TRI_D][win])
    for k, val in enumerate(vals):
        h[k][sel] = torch.where(better, val, h[k][sel])
    rank[sel] = torch.where(better, cand, r_best)


def stream_tri_stage(tri, tri_clusters, tri_stream, n_sph=None):
    """The plain version of the two-level walk (K2's; K5s's with ``n_sph``,
    which fills K5's hit record, winners n_sph + packed column): returns
    ``stage(ray, h, alive, _b=None)``, updating ``h`` in place.  Per top in
    order, the rays that pass its box test their leaves' boxes at once and
    grind the columns of the leaves they pass, all of a top's columns in
    one ``tri_block_hits`` with the visit rank (top, slot column).  The
    culling distance is each ray's closest hit when the top begins, never
    below the kernel's, and the bounds are conservative, so the hits are
    the kernel's."""
    leaf_b, leaf_r = tri_clusters
    top_h, top_r = _host_clusters(tri_stream)
    starts, ends = leaf_r.cpu().tolist()
    dev = tri.device
    visits = []                 # (top, its leaves, columns, column -> leaf)
    for tci, (c0, c1) in enumerate(zip(*top_r)):
        cols, owner = [], []
        for k, ci in enumerate(range(c0, c1)):
            n = ends[ci] - starts[ci]
            cols += range(ci * STREAM_LEAF_PAD, ci * STREAM_LEAF_PAD + n)
            owner += [k] * n
        if cols:
            visits.append((tci, torch.arange(c0, c1, device=dev),
                           torch.tensor(cols, device=dev),
                           torch.tensor(owner, device=dev)))
    wins = None
    if n_sph is not None:
        # slot column -> packed column: column 128 ci + j holds starts[ci] + j
        cols = torch.arange(tri.shape[1], device=dev)
        packed = leaf_r[0].to(dev).long()[cols // STREAM_LEAF_PAD] \
            + cols % STREAM_LEAF_PAD
        wins = torch.tensor(float(n_sph), device=dev) + packed.to(_F32)
    span = tri.shape[1]

    def stage(ray, h, alive, _b=None):
        inv = tuple(_inv_dir(d) for d in ray[3:])
        rank = torch.full_like(alive, -1, dtype=torch.int64)
        for tci, leaves, cols, owner in visits:
            sel = _aabb_possible(top_h, tci, ray, inv, h[0],
                                 alive).nonzero()[:, 0]
            if not sel.numel():
                continue
            leaf_p = _aabb_possible(
                leaf_b, leaves, [x[sel][:, None] for x in ray],
                [x[sel][:, None] for x in inv], h[0][sel][:, None], True)
            tri_block_hits(tri, cols, ray, h, rank, tci * span, sel,
                           mask=leaf_p[:, owner],
                           wins=None if wins is None else wins[cols])
    return stage


def _host_clusters(cl):
    if cl is None:
        return None
    bounds, ranges = cl
    return bounds.cpu().tolist(), ranges.cpu().tolist()


def new_hit(n, dev):
    """The closest-hit record before any primitive: t, normal, kind,
    albedo, fuzz, ir (Hit in path_common.cuh)."""
    def full(v):
        return torch.full((n,), v, dtype=_F32, device=dev)
    return [full(BIG), full(0.0), full(0.0), full(1.0), full(0.0),
            full(0.0), full(0.0), full(0.0), full(0.0), full(1.0)]


def sphere_hits(sph_h, sphc_h, ray, alive, lowp=False):
    """Closest sphere hit per ray (flat or culled by cluster AABBs; with
    ``lowp`` K1-lowp's flat bfloat16 scan), with the normal recovered from
    the winning centre (_sphere_normals)."""
    h = new_hit(ray[0].shape[0], ray[0].device)
    if lowp:
        ray_bf16 = [x.to(torch.bfloat16) for x in ray]
        for col in sph_h:
            _sphere_step(col, ray, h, None, ray_bf16)
    else:
        _closest_hit(sph_h, sphc_h, _sphere_step, ray, h, alive)
    ox, oy, oz, dx, dy, dz = ray
    snx = ox + h[0] * dx - h[1]
    sny = oy + h[0] * dy - h[2]
    snz = oz + h[0] * dz - h[3]
    slen = torch.sqrt(snx * snx + sny * sny + snz * snz)
    slen = torch.where(slen == 0.0, 1.0, slen)
    neg_r = h[4] >= 3.5
    slen = torch.where(neg_r, -slen, slen)
    h[4] = torch.where(neg_r, h[4] - 4.0, h[4])
    h[1], h[2], h[3] = snx / slen, sny / slen, snz / slen
    return h


def resolve_tri_normals(h):
    """Normalise a triangle winner's raw plane normal and strip its +8."""
    is_tri = h[4] >= 7.5
    ln = torch.sqrt(h[1] * h[1] + h[2] * h[2] + h[3] * h[3])
    ln = torch.where(ln == 0.0, 1.0, ln)
    for k in (1, 2, 3):
        h[k] = torch.where(is_tri, h[k] / ln, h[k])
    h[4] = torch.where(is_tri, h[4] - 8.0, h[4])


def scatter_bookkeep(ray, h, pix_u, s, b, tp, rad, alive):
    """_scatter_bookkeep: the draw at site 1 + b, the material scatter and
    the bounce bookkeeping (common.rs:263-285).  ``tp`` / ``rad`` are the
    throughput and radiance triples.  Returns (ray, tp, rad, cont)."""
    t_best, nx, ny, nz, kind, ar, ag, ab, fz, irx = h
    ox, oy, oz, dx, dy, dz = ray
    hit = t_best < BIG
    hpx = torch.where(hit, ox + t_best * dx, ox)
    hpy = torch.where(hit, oy + t_best * dy, oy)
    hpz = torch.where(hit, oz + t_best * dz, oz)

    bx, by, bz = rng.uniform_bilateral3(pix_u, s, 1 + b)
    rl = torch.sqrt(bx * bx + by * by + bz * bz)
    rx, ry, rz = bx / rl, by / rl, bz / rl

    sdx, sdy, sdz = nx + rx, ny + ry, nz + rz
    deg = (sdx.abs() < EPS8) & (sdy.abs() < EPS8) & (sdz.abs() < EPS8)
    sl = torch.sqrt(sdx * sdx + sdy * sdy + sdz * sdz)
    sl = torch.where(sl == 0.0, 1.0, sl)
    difx = torch.where(deg, nx, sdx / sl)
    dify = torch.where(deg, ny, sdy / sl)
    difz = torch.where(deg, nz, sdz / sl)

    dn = dx * nx + dy * ny + dz * nz
    mx = dx - 2.0 * dn * nx + fz * rx
    my = dy - 2.0 * dn * ny + fz * ry
    mz = dz - 2.0 * dn * nz + fz * rz
    met_keep = (mx * nx + my * ny + mz * nz) >= 0.0
    ml = torch.sqrt(mx * mx + my * my + mz * mz)
    ml = torch.where(ml == 0.0, 1.0, ml)
    metx, mety, metz = mx / ml, my / ml, mz / ml

    inside = dn >= 0.0
    sgn = torch.where(inside, -1.0, 1.0)
    nex, ney, nez = sgn * nx, sgn * ny, sgn * nz
    ratio = torch.where(inside, torch.ones_like(irx) / irx, irx)
    cos_t = -(dx * nex + dy * ney + dz * nez)
    px = ratio * (dx + cos_t * nex)
    py = ratio * (dy + cos_t * ney)
    pz = ratio * (dz + cos_t * nez)
    pl2 = px * px + py * py + pz * pz
    para = -torch.sqrt((1.0 - pl2).abs())
    qx, qy, qz = px + para * nex, py + para * ney, pz + para * nez
    ql = torch.sqrt(qx * qx + qy * qy + qz * qz)
    ql = torch.where(ql == 0.0, 1.0, ql)
    diex, diey, diez = qx / ql, qy / ql, qz / ql

    is_dif = kind < 0.5
    is_met = (kind >= 0.5) & (kind < 1.5)
    is_die = (kind >= 1.5) & (kind < 2.5)
    is_emi = kind >= 2.5
    scr = torch.where(is_die, 1.0, ar)
    scg = torch.where(is_die, 1.0, ag)
    scb = torch.where(is_die, 1.0, ab)

    def pick(dif, met, die, nrm):
        return torch.where(is_dif, dif, torch.where(
            is_met, met, torch.where(is_die, die, nrm)))

    ndx = pick(difx, metx, diex, nx)
    ndy = pick(dify, mety, diey, ny)
    ndz = pick(difz, metz, diez, nz)
    term = is_emi | (is_met & ~met_keep)

    miss = alive & ~hit
    terminal = alive & hit & term
    cont = alive & hit & ~term
    tsky = 0.5 * (dy + 1.0)
    skyr = 1.0 - tsky * 0.5
    skyg = 1.0 - tsky * SKY_G
    (tpr, tpg, tpb), (rr, rg, rb) = tp, rad
    rr = rr + torch.where(miss, tpr * skyr,
                          torch.where(terminal, tpr * scr, 0.0))
    rg = rg + torch.where(miss, tpg * skyg,
                          torch.where(terminal, tpg * scg, 0.0))
    rb = rb + torch.where(miss, tpb, torch.where(terminal, tpb * scb, 0.0))
    tp = (torch.where(cont, tpr * scr, tpr), torch.where(cont, tpg * scg, tpg),
          torch.where(cont, tpb * scb, tpb))
    ray = [torch.where(cont, a, o) for a, o in
           zip((hpx, hpy, hpz, ndx, ndy, ndz), ray)]
    return ray, tp, (rr, rg, rb), cont


def trace_pixels_ref(sph, cam_vec, tri_stage, *, width, height,
                     samples_per_pixel, depth, seed, sph_clusters,
                     shard_rows, row_offset, row_stride, lowp=False):
    """The fused kernels' per-pixel loop in plain PyTorch (K1 and K4):
    samples, camera rays, the bounce loop with its early exit, spheres,
    ``tri_stage(ray, h, alive, b)`` for the triangles, shading.  Returns
    (mean [shard_rows, W, 3], segments)."""
    dev = sph.device
    sph_h = sph.cpu().t().tolist()           # one list of rows per column
    sphc_h = _host_clusters(sph_clusters)
    (ox0, oy0, oz0, llcx, llcy, llcz,
     hx, hy, hz, vx, vy, vz) = cam_vec.cpu().tolist()

    # _block_pixel_setup
    i32 = torch.int32
    band_row = torch.arange(shard_rows, dtype=i32, device=dev)[:, None]
    pcol = torch.arange(width, dtype=i32, device=dev)[None, :]
    prow = (row_offset + band_row * row_stride).expand(shard_rows, width)
    pcol = pcol.expand(shard_rows, width)
    active0 = (prow < height).reshape(-1)
    prow = torch.clamp_max(prow, height - 1).reshape(-1)
    pcol = pcol.reshape(-1)
    sw = rng.as_int32(rng.seed_word(seed), dev)
    pix_u = (prow * width + pcol) + sw
    prow_f = prow.to(_F32)
    pcol_f = pcol.to(_F32)
    w1 = torch.tensor(float(width - 1), dtype=_F32, device=dev)
    h1 = torch.tensor(float(height - 1), dtype=_F32, device=dev)
    n = pix_u.shape[0]

    def full(v):
        return torch.full((n,), v, dtype=_F32, device=dev)

    acc_r, acc_g, acc_b = full(0.0), full(0.0), full(0.0)
    seg = torch.zeros(n, dtype=torch.int64, device=dev)
    for s in range(samples_per_pixel):
        ju, jv, _ = rng.pcg3d(pix_u, s, 0)
        u = (pcol_f + rng.random_f32_from_bits24(ju)) / w1
        v = (prow_f + rng.random_f32_from_bits24(jv)) / h1
        dx = llcx + u * hx + v * vx - ox0
        dy = llcy + u * hy + v * vy - oy0
        dz = llcz + u * hz + v * vz - oz0
        dlen = torch.sqrt(dx * dx + dy * dy + dz * dz)
        ray = [full(ox0), full(oy0), full(oz0), dx / dlen, dy / dlen,
               dz / dlen]
        tp = (full(1.0), full(1.0), full(1.0))
        rad = (full(0.0), full(0.0), full(0.0))
        alive = active0
        for b in range(depth):
            if not bool(alive.any()):     # dead rays change nothing
                break
            seg = seg + alive
            h = sphere_hits(sph_h, sphc_h, ray, alive, lowp)
            tri_stage(ray, h, alive, b)
            resolve_tri_normals(h)
            ray, tp, rad, alive = scatter_bookkeep(ray, h, pix_u, s, b, tp,
                                                   rad, alive)
        acc_r, acc_g, acc_b = acc_r + rad[0], acc_g + rad[1], acc_b + rad[2]

    inv_spp = _inv_spp(samples_per_pixel)
    mean = torch.stack([acc_r * inv_spp, acc_g * inv_spp, acc_b * inv_spp],
                       dim=-1).reshape(shard_rows, width, 3)
    return mean, int(seg.sum())


def render_linear_ref(sph, tri, cam_vec, *, width, height,
                      samples_per_pixel, depth, seed=0,
                      parity_plane_sign=True, sph_clusters=None,
                      tri_clusters=None, shard_rows=None, row_offset=0,
                      row_stride=1, tri_stream=None, sub_bounds=None,
                      lowp=False):
    """K1's (K2's with ``tri_stream``, K1-lowp's with ``lowp``) plain
    PyTorch version: same arguments and results as ``render_linear_cuda``,
    on whatever device the tensors are."""
    shard_rows = _check_inputs(
        sph, tri, cam_vec, sph_clusters, tri_clusters, width=width,
        height=height, samples_per_pixel=samples_per_pixel, depth=depth,
        parity_plane_sign=parity_plane_sign, shard_rows=shard_rows,
        row_offset=row_offset, row_stride=row_stride, tri_stream=tri_stream,
        sub_bounds=sub_bounds)
    if tri_stream is not None:
        tri_stage = stream_tri_stage(tri, tri_clusters, tri_stream)
    else:
        tri_h = tri.cpu().t().tolist()
        tric_h = _host_clusters(tri_clusters)

        def tri_stage(ray, h, alive, _b):
            _closest_hit(tri_h, tric_h,
                         lambda c, r_, hh, m: _tri_step(
                             c, r_, hh, parity_plane_sign, m),
                         ray, h, alive)

    return trace_pixels_ref(
        sph, cam_vec, tri_stage, width=width, height=height,
        samples_per_pixel=samples_per_pixel, depth=depth, seed=seed,
        sph_clusters=sph_clusters, shard_rows=shard_rows,
        row_offset=row_offset, row_stride=row_stride, lowp=lowp)
