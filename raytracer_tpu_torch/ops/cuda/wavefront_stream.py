"""K4, the streamed big-mesh kernel: host tables, CUDA wrapper and plain
version.

``render_linear_stream_cuda`` launches the hand-written CUDA kernel in
``raytracer_tpu_torch/csrc/wavefront_stream.cu``, which replaces the TPU
kernel ``raytracer_tpu/ops/pallas/wavefront_stream.py``
``render_linear_pallas_stream`` / ``_make_stream_kernel``: K1's fused path
trace (one thread per pixel, spp x depth in the thread) with the triangles
in device memory as 128-column leaves under a two-level bounding-sphere
tree, walked top node by top node in the camera's front-to-back order, with
an early exit on the primary bounce and a root-bound sky test.  It is the
banded engine for meshes (the CLI's ``obj=`` and any render with a progress
logger), since the binned engine renders whole regrouped frames.

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
int32; top_ranges (2, C) int32 leaf ranges; root (4, 1) f32.
``sorted_top_order`` gives the camera's visit order and entry keys.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tables
from ... import rng
from . import wavefront as wf

__all__ = ["LAUNCHES", "LEAF", "build_tri_stream_tables", "sorted_top_order",
           "render_linear_stream_cuda", "render_linear_stream_ref"]

LAUNCHES = 0
LEAF = 128           # triangles per leaf slot
TOP_FANOUT = 8       # leaves per top node
_F32 = torch.float32


def build_tri_stream_tables(scene):
    """(tri, leaf_bounds, leaf_counts, top_bounds, top_ranges, root) as
    numpy arrays, equal to ``wavefront_stream.build_tri_stream_tables``:
    leaves are median-split clusters of <= LEAF valid triangles in
    depth-first order; top node k covers leaves [k*TOP_FANOUT,
    (k+1)*TOP_FANOUT); the root bounds every non-empty leaf.  ``scene``:
    a Scene or HostScene."""
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
    for k, (s, e) in enumerate(slices or [(0, 0)]):
        n = e - s
        tri[:tables.TRI_ROWS, k * LEAF:k * LEAF + n] = packed[:, s:e]
        leaf_counts[0, k] = n
        if n == 0:
            leaf_bounds[3, k] = -1.0
            continue
        mem = perm_valid[s:e]
        bc, br = tables._bounding_sphere(
            np.concatenate([v0[mem], v1[mem], v2[mem]], axis=0))
        leaf_bounds[0:3, k] = bc
        leaf_bounds[3, k] = br * br

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
    return tri, leaf_bounds, leaf_counts, top_bounds, top_ranges, root


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


def _check_inputs(sph, tri, leaf_bounds, leaf_counts, top_bounds, top_ranges,
                  root, cam_vec, top_order, top_keys, sph_clusters, **shape):
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
    if int(leaf_counts.min()) < 0 or int(leaf_counts.max()) > LEAF \
            or int(top_ranges.min()) < 0 \
            or int(top_ranges.max()) > n_leaves \
            or int(top_order.min()) < 0 or int(top_order.max()) >= n_tops:
        raise ValueError("leaf counts, top ranges or top order fall outside "
                         "the tables")
    return wf.check_shape(**shape)


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
                              row_stride=1):
    """Mean linear radiance [shard_rows, W, 3] + segment count through K4
    (the plain version for CPU tensors).  Always the correct plane
    equation.  ``top_order`` / ``top_keys`` from ``sorted_top_order``
    enable the primary bounce's front-to-back early exit; sharding
    arguments as K1's."""
    global LAUNCHES
    args = (sph, tri, leaf_bounds, leaf_counts, top_bounds, top_ranges, root,
            cam_vec)
    kw = dict(width=width, height=height,
              samples_per_pixel=samples_per_pixel, depth=depth, seed=seed,
              sph_clusters=sph_clusters, top_order=top_order,
              top_keys=top_keys, shard_rows=shard_rows,
              row_offset=row_offset, row_stride=row_stride)
    if sph.device.type == "cpu":
        return render_linear_stream_ref(*args, **kw)
    if sph.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA tensors, got {sph.device}")
    top_order, top_keys = _order_or_table(top_bounds, top_order, top_keys)
    shard_rows = _check_inputs(
        *args, top_order, top_keys, sph_clusters, width=width, height=height,
        samples_per_pixel=samples_per_pixel, depth=depth,
        shard_rows=shard_rows, row_offset=row_offset, row_stride=row_stride)
    from . import build
    lib = build.load()
    device = sph.device
    mean = torch.empty((shard_rows, width, 3), dtype=_F32, device=device)
    segs = torch.empty((shard_rows, width), dtype=torch.int32, device=device)
    sphc_b, sphc_r = sph_clusters if sph_clusters is not None else (None,
                                                                    None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        rc = lib.rt_stream_render(
            ptr(sph), sph.shape[1], ptr(sphc_b), ptr(sphc_r),
            0 if sphc_b is None else sphc_b.shape[1],
            ptr(tri), ptr(leaf_bounds), ptr(leaf_counts),
            leaf_bounds.shape[1], ptr(top_bounds), ptr(top_ranges),
            ptr(top_order), ptr(top_keys), top_bounds.shape[1], ptr(root),
            ptr(cam_vec), ptr(mean), ptr(segs), width, height,
            rng.seed_word(seed), row_offset, row_stride, shard_rows,
            samples_per_pixel, depth, wf._inv_spp(samples_per_pixel),
            torch.cuda.current_stream(device).cuda_stream)
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
                             row_stride=1):
    """K4's plain PyTorch version: same arguments and results as
    ``render_linear_stream_cuda``, on whatever device the tensors are.
    Each bounce visits the tops in ``top_order`` and takes every ray's
    closest hit over the tops whose bound it passes; culling and the early
    exit cannot change a hit, so only the visit order (ties) is kept."""
    top_order, top_keys = _order_or_table(top_bounds, top_order, top_keys)
    shard_rows = _check_inputs(
        sph, tri, leaf_bounds, leaf_counts, top_bounds, top_ranges, root,
        cam_vec, top_order, top_keys, sph_clusters, width=width,
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
