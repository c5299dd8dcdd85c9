"""Host-side scene tables for the render kernels.

Port of the numpy half of ``raytracer_tpu/ops/pallas/wavefront.py`` (K1's
tables) and of ``build_tri_sorted_tables`` in
``raytracer_tpu/ops/pallas/wavefront_sorted.py`` (the sorted tables that
the binned engine K3 reads; they stay here, beside the K1 packers they
build on, until the sorted engine K6, which shares them, is ported): the
same row layouts, the same float64-then-float32 arithmetic and the same
padding of invalid primitives, so the tables are equal to the JAX package's
element for element.  The kernels read them as row-major ``(ROWS, N)``
float32 tensors.

Spheres, (SPH_ROWS, S): center xyz, radius, r^2 (< 0 for padding), material
kind (+4 for a negative radius), albedo rgb, fuzz, ir.

Triangles, (TRI_ROWS, T): plane normal n = (v1-v0)x(v2-v0), d = n.v0, the
three edge constants g_k = n x edge_k with w_k = v_k.g_k, the material kind,
one extra row (fuzz for metal, ir for dielectric) and the albedo.  Padding
rows are all zero, so the parallel test rejects every ray.

Clusters, from a median split: bounds (6, C) float32 [lo xyz, hi xyz]
(empty nodes have lo > hi) and ranges (2, C) int32 [start, end) into the
table packed with the matching ``perm``.

Sorted tables (``build_tri_sorted_tables``): the triangle table laid out as
32-column sub-leaves (TRI_ROWS_PAD rows, zero columns never hit), four
sub-leaves to a 128-column group, eight groups to a top node, with a
bounding sphere and an AABB per level, the root sphere, the secondary-bounce
reference points with their visit orders, keys and run bounds, and the box
that quantises the next-top sort keys.
"""

from __future__ import annotations

import numpy as np
import torch

from ..camera import Camera

__all__ = ["SPH_ROWS", "TRI_ROWS", "TRI_ROWS_PAD", "SUB", "GROUP_SUBS",
           "GROUP", "TOP_GROUPS", "TOP_SPAN", "RUN", "REF_TOPS",
           "pack_spheres", "pack_triangles", "cluster_spheres",
           "cluster_triangles", "build_tri_sorted_tables", "camera_vec"]

# sphere table rows
(SPH_CX, SPH_CY, SPH_CZ, SPH_R, SPH_R2,
 SPH_KIND, SPH_AR, SPH_AG, SPH_AB, SPH_FUZZ, SPH_IR) = range(11)
SPH_ROWS = 11

# triangle table rows
(TRI_NX, TRI_NY, TRI_NZ, TRI_D,
 TRI_G0X, TRI_G0Y, TRI_G0Z, TRI_W0,
 TRI_G1X, TRI_G1Y, TRI_G1Z, TRI_W1,
 TRI_G2X, TRI_G2Y, TRI_G2Z, TRI_W2,
 TRI_KIND, TRI_EXTRA, TRI_AR, TRI_AG, TRI_AB) = range(21)
TRI_ROWS = 21
# rows of the leaf-aligned tables (K3, K4): TRI_ROWS and zero rows up to a
# multiple of 8, as the JAX package lays them out
TRI_ROWS_PAD = -(-TRI_ROWS // 8) * 8

# sorted-table layout (wavefront_sorted.py:66-76)
SUB = 32                    # triangles per sub-leaf
GROUP_SUBS = 4              # sub-leaves per 128-column group
GROUP = SUB * GROUP_SUBS
TOP_GROUPS = 8              # groups per top node
TOP_SPAN = TOP_GROUPS * GROUP
RUN = 8                     # visit-order entries under one run bound
REF_TOPS = 4                # top nodes per secondary reference point

# conservative float32 padding of bounding-sphere radii
BOUND_PAD = 1.0 + 1e-4


def pack_spheres(scene, perm=None) -> np.ndarray:
    """(SPH_ROWS, S) float32 table; ``perm`` reorders the columns
    (``cluster_spheres`` order).  ``scene``: a Scene or HostScene."""
    h = scene.numpy()
    c = np.asarray(h.sphere_center, np.float32)
    r = np.asarray(h.sphere_radius, np.float32)
    valid = np.asarray(h.sphere_valid)
    mat = np.asarray(h.sphere_mat)
    if perm is not None:
        c, r, valid, mat = c[perm], r[perm], valid[perm], mat[perm]
    kind = np.asarray(h.mat_kind, np.float32)[mat]
    alb = np.asarray(h.mat_color, np.float32)[mat]
    out = np.zeros((SPH_ROWS, c.shape[0]), np.float32)
    out[SPH_CX], out[SPH_CY], out[SPH_CZ] = c[:, 0], c[:, 1], c[:, 2]
    out[SPH_R] = r
    out[SPH_R2] = np.where(valid, r * r, -1.0)  # padding: r2 < 0 never hits
    # a negative radius flips the normal ((p-c)/r, common.rs:94-95)
    out[SPH_KIND] = kind + np.where(valid & (r < 0.0), 4.0, 0.0)
    out[SPH_AR], out[SPH_AG], out[SPH_AB] = alb[:, 0], alb[:, 1], alb[:, 2]
    out[SPH_FUZZ] = np.asarray(h.mat_fuzz, np.float32)[mat]
    out[SPH_IR] = np.asarray(h.mat_ir, np.float32)[mat]
    out[SPH_CX] = np.where(valid, out[SPH_CX], 1e9)  # padding far away too
    return out


def pack_triangles(scene, perm=None) -> np.ndarray:
    """(TRI_ROWS, T) float32 table of plane and edge constants, computed in
    float64 and rounded once; ``perm`` reorders the columns."""
    h = scene.numpy()
    v0 = np.asarray(h.tri_v0, np.float64)
    v1 = np.asarray(h.tri_v1, np.float64)
    v2 = np.asarray(h.tri_v2, np.float64)
    valid = np.asarray(h.tri_valid)
    mat = np.asarray(h.tri_mat)
    if perm is not None:
        v0, v1, v2 = v0[perm], v1[perm], v2[perm]
        valid, mat = valid[perm], mat[perm]
    kind = np.asarray(h.mat_kind, np.float32)[mat]
    alb = np.asarray(h.mat_color, np.float32)[mat]
    fuzz = np.asarray(h.mat_fuzz, np.float32)[mat]
    ir = np.asarray(h.mat_ir, np.float32)[mat]
    n = np.cross(v1 - v0, v2 - v0)
    g0 = np.cross(n, v1 - v0)
    g1 = np.cross(n, v2 - v1)
    g2 = np.cross(n, v0 - v2)
    out = np.zeros((TRI_ROWS, v0.shape[0]), np.float32)
    out[TRI_NX], out[TRI_NY], out[TRI_NZ] = n[:, 0], n[:, 1], n[:, 2]
    out[TRI_D] = np.einsum("ij,ij->i", n, v0)
    for g, vk, base in ((g0, v0, TRI_G0X), (g1, v1, TRI_G1X),
                        (g2, v2, TRI_G2X)):
        out[base], out[base + 1], out[base + 2] = g[:, 0], g[:, 1], g[:, 2]
        out[base + 3] = np.einsum("ij,ij->i", vk, g)
    out[TRI_KIND] = kind
    out[TRI_EXTRA] = np.where(kind == 1.0, fuzz,
                              np.where(kind == 2.0, ir, 0.0))
    out[TRI_AR], out[TRI_AG], out[TRI_AB] = alb[:, 0], alb[:, 1], alb[:, 2]
    out[:, ~valid] = 0.0   # zero normal -> the parallel test rejects
    return out


def _median_split_order(points: np.ndarray, leaf_target: int):
    """Recursive median split over ``points`` [N, 3] (widest axis, stable
    sort).  Returns (perm, leaf_slices) with every leaf's members
    contiguous in ``perm``."""
    leaves: list[np.ndarray] = []

    def rec(ids: np.ndarray):
        if len(ids) <= leaf_target:
            leaves.append(ids)
            return
        pts = points[ids]
        ax = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        order = np.argsort(pts[:, ax], kind="stable")
        half = len(ids) // 2
        rec(ids[order[:half]])
        rec(ids[order[half:]])

    rec(np.arange(len(points)))
    perm = np.concatenate(leaves) if leaves else np.arange(0)
    slices, off = [], 0
    for leaf in leaves:
        slices.append((off, off + len(leaf)))
        off += len(leaf)
    return perm, slices


def _aabb_pad_np(lo: np.ndarray, hi: np.ndarray):
    """Conservative float32 box around float64 bounds."""
    pad = 1e-4 + 1e-5 * np.maximum(np.abs(lo), np.abs(hi))
    return (lo - pad).astype(np.float32), (hi + pad).astype(np.float32)


def _clusters(points, valid, leaf_target, member_bounds):
    vidx = np.nonzero(valid)[0]
    perm_v, slices = _median_split_order(points[vidx], leaf_target)
    perm = np.concatenate([vidx[perm_v], np.nonzero(~valid)[0]]).astype(
        np.int64)
    n_clusters = max(len(slices), 1)
    bounds = np.zeros((6, n_clusters), np.float32)
    bounds[0:3] = 1.0
    bounds[3:6] = -1.0
    ranges = np.zeros((2, n_clusters), np.int32)
    for k, (s, e) in enumerate(slices):
        if e == s:      # no valid primitive: the empty node stays lo > hi
            continue
        lo, hi = member_bounds(perm[s:e])
        bounds[0:3, k], bounds[3:6, k] = _aabb_pad_np(lo, hi)
        ranges[0, k], ranges[1, k] = s, e
    return perm, bounds, ranges


def cluster_spheres(scene, leaf_target: int = 48):
    """Cluster the valid spheres for culling.  Returns (perm, bounds,
    ranges); ``perm`` covers ALL columns (valid members leaf-contiguous
    first, padding last) and feeds ``pack_spheres(scene, perm=...)``."""
    h = scene.numpy()
    c = np.asarray(h.sphere_center, np.float64)
    r = np.asarray(h.sphere_radius, np.float64)

    def member_bounds(mem):
        cm, rm = c[mem], np.abs(r[mem])[:, None]
        return (cm - rm).min(axis=0), (cm + rm).max(axis=0)

    return _clusters(c, np.asarray(h.sphere_valid), leaf_target,
                     member_bounds)


def cluster_triangles(scene, leaf_target: int = 64):
    """As ``cluster_spheres`` for triangles: split on centroids, bound all
    three vertices."""
    h = scene.numpy()
    v0 = np.asarray(h.tri_v0, np.float64)
    v1 = np.asarray(h.tri_v1, np.float64)
    v2 = np.asarray(h.tri_v2, np.float64)

    def member_bounds(mem):
        verts = np.concatenate([v0[mem], v1[mem], v2[mem]], axis=0)
        return verts.min(axis=0), verts.max(axis=0)

    return _clusters((v0 + v1 + v2) / 3.0, np.asarray(h.tri_valid),
                     leaf_target, member_bounds)


def _bounding_sphere(points: np.ndarray):
    bc = (points.min(axis=0) + points.max(axis=0)) * 0.5
    br = float(np.max(np.linalg.norm(points - bc, axis=-1)))
    return bc, br * BOUND_PAD + 1e-4


def _aabb_of(points: np.ndarray):
    """Conservatively padded float32 AABB of ``points``."""
    return _aabb_pad_np(points.min(axis=0), points.max(axis=0))


def _aabb_union(aabb: np.ndarray, members):
    """Union of child AABB columns (aabb (6, M): lo rows 0-2, hi 3-5)."""
    return (aabb[0:3, members].min(axis=1).astype(np.float32),
            aabb[3:6, members].max(axis=1).astype(np.float32))


def union_bound(child_bounds: np.ndarray, members):
    """Bounding sphere (centre, padded radius) of child bounding spheres
    (columns [cx, cy, cz, r^2] of ``child_bounds``)."""
    cs = child_bounds[0:3, members]
    bc = (cs.min(axis=1) + cs.max(axis=1)) * 0.5
    br = 0.0
    for m in members:
        d = float(np.linalg.norm(child_bounds[0:3, m] - bc))
        br = max(br, d + float(np.sqrt(child_bounds[3, m])))
    return bc, br * BOUND_PAD + 1e-4


def build_tri_sorted_tables(scene):
    """Sub-leaf-aligned triangle table, three levels of bounds and the
    sort-key box (``wavefront_sorted.build_tri_sorted_tables``).

    Returns (tri (TRI_ROWS_PAD, L*SUB) f32, sub_bounds (4, L) f32,
    sub_counts (1, L) i32, grp_bounds (4, G) f32, top_bounds (4, C) f32,
    top_ranges (2, C) i32 [group ranges], root (4, 1) f32,
    ref_pts (4, NR) f32, node_orders (NR, C) i32, node_keys (NR, C) f32,
    node_run_bounds (4, NR*R8) f32, key_lo (3,) f32, key_hi (3,) f32,
    sub_aabb (6, L) f32, grp_aabb (6, G) f32, top_aabb (6, C) f32), with
    NR = ceil(C / REF_TOPS) and R8 = ceil(C / RUN).  Bounding spheres are
    [cx, cy, cz, r^2] (r^2 < 0: empty); AABBs [lo xyz, hi xyz] (lo > hi:
    empty).  Sub-leaves are median-split clusters of <= SUB valid
    triangles in depth-first order, L padded to a whole top node.  Row i
    of node_orders is the top visit order from reference point i (the
    centroid of REF_TOPS consecutive tops) with keys dist - radius;
    node_run_bounds[:, i*R8 + k] bounds that order's entries
    [k*RUN, (k+1)*RUN).  key_lo/key_hi is the triangles' box grown 25% a
    side.  ``scene``: a Scene or HostScene."""
    h = scene.numpy()
    v0 = np.asarray(h.tri_v0, np.float64)
    v1 = np.asarray(h.tri_v1, np.float64)
    v2 = np.asarray(h.tri_v2, np.float64)
    valid = np.asarray(h.tri_valid)
    vidx = np.nonzero(valid)[0]
    cen = (v0 + v1 + v2) / 3.0
    perm_v, slices = _median_split_order(cen[vidx], SUB)
    perm_valid = vidx[perm_v]
    n_sub = max(len(slices), 1)
    L = -(-n_sub // (GROUP_SUBS * TOP_GROUPS)) * (GROUP_SUBS * TOP_GROUPS)
    G = L // GROUP_SUBS
    C = max(G // TOP_GROUPS, 1)

    packed = pack_triangles(h, perm=np.concatenate(
        [perm_valid, np.nonzero(~valid)[0]]).astype(np.int64))
    tri = np.zeros((TRI_ROWS_PAD, L * SUB), np.float32)
    sub_bounds = np.zeros((4, L), np.float32)
    sub_bounds[3] = -1.0
    sub_counts = np.zeros((1, L), np.int32)
    sub_aabb = np.zeros((6, L), np.float32)
    sub_aabb[0:3] = 1.0
    sub_aabb[3:6] = -1.0
    for k, (s, e) in enumerate(slices or [(0, 0)]):
        n = e - s
        tri[:TRI_ROWS, k * SUB:k * SUB + n] = packed[:, s:e]
        sub_counts[0, k] = n
        if n == 0:
            continue
        mem = perm_valid[s:e]
        verts = np.concatenate([v0[mem], v1[mem], v2[mem]], axis=0)
        bc, br = _bounding_sphere(verts)
        sub_bounds[0:3, k] = bc
        sub_bounds[3, k] = br * br
        sub_aabb[0:3, k], sub_aabb[3:6, k] = _aabb_of(verts)

    grp_bounds = np.zeros((4, G), np.float32)
    grp_bounds[3] = -1.0
    grp_aabb = np.zeros((6, G), np.float32)
    grp_aabb[0:3] = 1.0
    grp_aabb[3:6] = -1.0
    for g in range(G):
        members = [m for m in range(g * GROUP_SUBS, (g + 1) * GROUP_SUBS)
                   if sub_counts[0, m] > 0]
        if not members:
            continue
        bc, br = union_bound(sub_bounds, members)
        grp_bounds[0:3, g] = bc
        grp_bounds[3, g] = br * br
        grp_aabb[0:3, g], grp_aabb[3:6, g] = _aabb_union(sub_aabb, members)

    top_bounds = np.zeros((4, C), np.float32)
    top_bounds[3] = -1.0
    top_ranges = np.zeros((2, C), np.int32)
    top_aabb = np.zeros((6, C), np.float32)
    top_aabb[0:3] = 1.0
    top_aabb[3:6] = -1.0
    for c in range(C):
        g0, g1 = c * TOP_GROUPS, min((c + 1) * TOP_GROUPS, G)
        top_ranges[0, c], top_ranges[1, c] = g0, g1
        members = [m for m in range(g0, g1) if grp_bounds[3, m] > 0]
        if not members:
            continue
        bc, br = union_bound(grp_bounds, members)
        top_bounds[0:3, c] = bc
        top_bounds[3, c] = br * br
        top_aabb[0:3, c], top_aabb[3:6, c] = _aabb_union(grp_aabb, members)

    root = np.zeros((4, 1), np.float32)
    root[3] = -1.0
    live = [m for m in range(G) if grp_bounds[3, m] > 0]
    if live:
        bc, br = union_bound(grp_bounds, live)
        root[0:3, 0] = bc
        root[3, 0] = br * br

    centers = top_bounds[0:3]
    rads = np.sqrt(np.maximum(top_bounds[3], 0.0))
    valid_top = top_bounds[3] > 0.0
    NR = -(-C // REF_TOPS)
    R8 = -(-C // RUN)
    ref_pts = np.zeros((4, NR), np.float32)
    node_orders = np.zeros((NR, C), np.int32)
    node_keys = np.zeros((NR, C), np.float32)
    node_run_bounds = np.zeros((4, NR * R8), np.float32)
    node_run_bounds[3] = -1.0
    for i in range(NR):
        members = [m for m in range(i * REF_TOPS, min((i + 1) * REF_TOPS, C))
                   if valid_top[m]]
        p = (centers[:, members].mean(axis=1) if members
             else centers[:, min(i * REF_TOPS, C - 1)])
        ref_pts[0:3, i] = p
        ref_pts[3, i] = 1.0 if members else -1.0
        d = np.linalg.norm(centers.T - p, axis=1)
        keys = np.where(valid_top, d - rads, np.inf)
        order = np.argsort(keys, kind="stable").astype(np.int32)
        node_orders[i] = order
        node_keys[i] = keys[order].astype(np.float32)
        for k in range(R8):
            run = [int(j) for j in order[k * RUN:(k + 1) * RUN]
                   if valid_top[j]]
            if not run:
                continue
            bc, br = union_bound(top_bounds, run)
            node_run_bounds[0:3, i * R8 + k] = bc
            node_run_bounds[3, i * R8 + k] = br * br

    if len(vidx):
        verts = np.concatenate([v0[vidx], v1[vidx], v2[vidx]], axis=0)
        lo = verts.min(axis=0)
        hi = verts.max(axis=0)
        pad = 0.25 * np.maximum(hi - lo, 1e-3)
        key_lo = (lo - pad).astype(np.float32)
        key_hi = (hi + pad).astype(np.float32)
    else:
        key_lo = np.full(3, -1.0, np.float32)
        key_hi = np.full(3, 1.0, np.float32)
    return (tri, sub_bounds, sub_counts, grp_bounds, top_bounds,
            top_ranges, root, ref_pts, node_orders, node_keys,
            node_run_bounds, key_lo, key_hi, sub_aabb, grp_aabb, top_aabb)


def camera_vec(camera: Camera) -> torch.Tensor:
    """(12,) float32 [origin, lower-left corner, horizontal, vertical] on
    the camera's device."""
    return torch.cat([camera.origin, camera.lower_left_corner,
                      camera.horizontal, camera.vertical]).to(torch.float32)
