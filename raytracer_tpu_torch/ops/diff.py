"""The differentiable kernel path: K1 (or K2) forward, K5 (or K5s)
backward.

Port of ``raytracer_tpu/ops/diff.py``.  ``render_linear_diff`` is a
``torch.autograd.Function`` over the packed tables (sph, tri, cam_vec):

  * forward  -- K1 (``render_linear_cuda``) renders the mean linear image;
  * backward -- K5 (``render_grad_cuda``) maps the image cotangent onto the
    table rows.

The packers below and ``tables.camera_vec`` sit upstream of it in the
autograd graph, so vertex, material and camera gradients chain through
their own backward (the JAX ``_bwd`` does this by hand with ``jax.vjp``).
On CPU tensors both kernels run their plain versions.  The JAX package's
recompute backward through the XLA renderer has no counterpart here: K5
takes every scene K1 takes (``bwd_kernel_eligible``); the port's
wavefront autograd is ``render.render_linear``.

Spheres are packed without a permutation and scanned flat by both kernels,
so the two sweeps see one table order.  Triangles may cull through a
``TriCull``: the grouping is frozen from the scene at build time, the
bounds are recomputed from the live vertices on every call, so culling
stays sound while an optimiser moves geometry.  Culling is only used under
the correct plane equation (``parity_plane_sign=False``).

Meshes whose packed tables pass the JAX package's table budget
(``_needs_stream``) take the two-level walk, as the JAX package streams
them: leaves of 128 triangles, each in a 128-column slot of a leaf-aligned
table (``tri_stream_table``), tops of 16 leaves (``tri_stream_tops``); K2
renders and K5s differentiates.  The port's kernels also cull each leaf's
32-column sub-leaves by their own boxes (``tri_sub_bounds``, from the live
vertices like the leaf boxes).  The autograd input stays the PACKED table
and K5s's winners are packed columns, so the cotangent lands on the packed
columns as with K1 + K5.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from .. import maths
from ..camera import Camera
from ..scene import Scene
from . import tables
from .cuda import wavefront, wavefront_bwd

__all__ = ["pack_spheres", "pack_triangles", "TriCull", "build_tri_cull",
           "tri_cluster_bounds", "tri_sub_bounds", "tri_stream_table",
           "tri_stream_tops",
           "walk_tables", "table_bytes", "render_linear_diff", "bwd_kernel_eligible",
           "LEAF_SIZE", "STREAM_LEAF_PAD", "STREAM_ROWS_PAD",
           "STREAM_BUDGET_BYTES"]

LEAF_SIZE = 64   # triangles per cull leaf of the one-level walk
# leaf slot width and rows of the two-level walk's leaf-aligned table
# (raytracer_tpu/ops/pallas/wavefront.py:703-705); a leaf of the two-level
# walk fills one slot, so it holds up to 128 triangles
STREAM_LEAF_PAD = wavefront.STREAM_LEAF_PAD
# a two-level leaf's sub-leaves: SUBS boxes of SUB slot columns each
SUBS = wavefront.LEAF_SUBS
SUB = STREAM_LEAF_PAD // SUBS
STREAM_ROWS_PAD = tables.TRI_ROWS_PAD
# Packed-table bytes past which the differentiable path takes the two-level
# walk.  This is the JAX package's PALLAS_SMEM_BUDGET_BYTES, a TPU v5e
# scalar-memory size (raytracer_tpu/ops/__init__.py:37), carried over as the
# starting crossover between the walks so that both packages pick the same
# topology on every scene; the card's own crossover is measured by
# chip_smoke.py and recorded in PERF.md.
STREAM_BUDGET_BYTES = 970_828


def pack_spheres(scene: Scene) -> torch.Tensor:
    """Differentiable (SPH_ROWS, S) float32 sphere table, no permutation:
    the torch counterpart of ``pack_spheres_jnp`` (diff.py:45-65).  A
    negative radius is encoded as kind + 4; padding rows sit at x = 1e9
    with r^2 = -1 and never hit."""
    c = scene.sphere_center.to(torch.float32)
    r = scene.sphere_radius.to(torch.float32)
    valid = scene.sphere_valid
    mat = scene.sphere_mat.long()
    m = scene.materials
    kind = m.kind.to(torch.float32)[mat]
    alb = m.color.to(torch.float32)[mat]
    kind = kind + torch.where(valid & (r < 0.0), 4.0, 0.0)
    return torch.stack([
        torch.where(valid, c[:, 0], 1e9), c[:, 1], c[:, 2], r,
        torch.where(valid, r * r, -1.0),
        kind, alb[:, 0], alb[:, 1], alb[:, 2],
        m.fuzz.to(torch.float32)[mat], m.ir.to(torch.float32)[mat],
    ])


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise a . b over 3 columns as explicit multiply-adds."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def pack_triangles(scene: Scene, perm=None) -> torch.Tensor:
    """Differentiable (TRI_ROWS, T) float32 triangle table: the torch
    counterpart of ``pack_triangles_jnp`` (diff.py:68-105), float32 end to
    end (``ops.tables.pack_triangles`` computes in float64 and is not
    differentiable).  ``perm`` (int array) reorders the columns for
    culling; gradients flow back through the gather."""
    v0 = scene.tri_v0.to(torch.float32)
    v1 = scene.tri_v1.to(torch.float32)
    v2 = scene.tri_v2.to(torch.float32)
    valid = scene.tri_valid
    mat = scene.tri_mat.long()
    if perm is not None:
        p = torch.as_tensor(perm, dtype=torch.int64, device=v0.device)
        v0, v1, v2, valid, mat = v0[p], v1[p], v2[p], valid[p], mat[p]
    m = scene.materials
    kind = m.kind.to(torch.float32)[mat]
    alb = m.color.to(torch.float32)[mat]
    fuzz = m.fuzz.to(torch.float32)[mat]
    ir = m.ir.to(torch.float32)[mat]
    n = maths.cross(v1 - v0, v2 - v0)
    g0 = maths.cross(n, v1 - v0)
    g1 = maths.cross(n, v2 - v1)
    g2 = maths.cross(n, v0 - v2)
    extra = torch.where(kind == 1.0, fuzz,
                        torch.where(kind == 2.0, ir, torch.zeros_like(ir)))
    rows = torch.stack([
        n[:, 0], n[:, 1], n[:, 2], _dot3(n, v0),
        g0[:, 0], g0[:, 1], g0[:, 2], _dot3(v0, g0),
        g1[:, 0], g1[:, 1], g1[:, 2], _dot3(v1, g1),
        g2[:, 0], g2[:, 1], g2[:, 2], _dot3(v2, g2),
        kind, extra, alb[:, 0], alb[:, 1], alb[:, 2],
    ])
    return torch.where(valid[None, :], rows, 0.0)


class TriCull:
    """Static triangle-cluster topology for the differentiable kernels:
    the median-split permutation and leaf ranges, frozen from the scene's
    geometry when built.  The bounds come from ``tri_cluster_bounds``."""

    def __init__(self, perm: np.ndarray, ranges: np.ndarray,
                 leaf_ids: np.ndarray):
        self.perm = perm            # (T,) int64: packed column -> triangle
        self.ranges = ranges        # (2, C) int32 leaf [start, end)
        self.leaf_ids = leaf_ids    # (T,) int32 leaf of each packed column
        self.colmap = None          # _stream_colmap, built on first use
        self._on = {}               # (device, name) -> tensor, see on()

    def on(self, device, name: str) -> torch.Tensor:
        """The static index ``name`` as a tensor on ``device``, copied once:
        ``perm`` and ``ranges`` as stored, ``leaf_ids`` as int64,
        ``sub_ids`` (int64: each packed column's sub-leaf, leaf * 4 + its
        slot column // 32; 4 C for invalid columns), and the leaf-aligned
        table's ``src`` columns and ``mask`` (1.0 on filled slot columns)
        from the column map."""
        key = (torch.device(device), name)
        hit = self._on.get(key)
        if hit is None:
            if name in ("src", "mask"):
                colmap = _stream_colmap(self)
                arr = (np.maximum(colmap, 0) if name == "src"
                       else (colmap >= 0).astype(np.float32))
            elif name == "leaf_ids":
                arr = self.leaf_ids.astype(np.int64)
            elif name == "sub_ids":
                C = self.ranges.shape[1]
                leaf = self.leaf_ids.astype(np.int64)
                col = np.arange(len(leaf)) - self.ranges[0][np.minimum(
                    leaf, C - 1)]
                arr = np.where(leaf < C, leaf * SUBS + col // SUB, C * SUBS)
            else:
                arr = getattr(self, name)
            hit = self._on[key] = torch.from_numpy(arr).to(device)
        return hit


_CULL_CACHE: dict = {}


def table_bytes(scene: Scene) -> int:
    """Bytes of the packed sphere and triangle tables, counted as the JAX
    package's ``pallas_table_bytes`` counts them."""
    return 4 * (scene.num_spheres * tables.SPH_ROWS
                + max(scene.num_triangles, 1) * tables.TRI_ROWS)


def _needs_stream(scene: Scene) -> bool:
    """Whether the differentiable path takes the two-level walk."""
    return table_bytes(scene) > STREAM_BUDGET_BYTES


def build_tri_cull(scene: Scene, leaf_target: int | None = None
                   ) -> TriCull | None:
    """Host-side cull topology of ``scene`` (cached on its identity), or
    None below 64 valid triangles.  Leaves hold up to ``leaf_target``
    triangles; by default 128 (one slot of the two-level walk) for scenes
    past the table budget, else 64, as the JAX package decides.  As there,
    the first build of a scene is cached and later calls return it, so a
    caller forces a leaf size by building with it first."""
    if leaf_target is None:
        leaf_target = (STREAM_LEAF_PAD if table_bytes(scene)
                       > STREAM_BUDGET_BYTES else LEAF_SIZE)
    hit = _CULL_CACHE.get(id(scene))
    if hit is not None and hit[0]() is scene:
        return hit[1]
    h = scene.numpy()
    valid = np.asarray(h.tri_valid)
    if int(valid.sum()) < 64:
        return None
    v0 = np.asarray(h.tri_v0, np.float64)
    v1 = np.asarray(h.tri_v1, np.float64)
    v2 = np.asarray(h.tri_v2, np.float64)
    vidx = np.nonzero(valid)[0]
    perm_v, slices = tables._median_split_order(
        ((v0 + v1 + v2) / 3.0)[vidx], leaf_target)
    perm = np.concatenate([vidx[perm_v],
                           np.nonzero(~valid)[0]]).astype(np.int64)
    C = max(len(slices), 1)
    ranges = np.zeros((2, C), np.int32)
    leaf_ids = np.full(len(perm), C, np.int32)    # C: the dump id (invalid)
    for k, (s, e) in enumerate(slices or [(0, 0)]):
        ranges[0, k], ranges[1, k] = s, e
        leaf_ids[s:e] = k
    cull = TriCull(perm, ranges, leaf_ids)
    for k in [k for k, v in _CULL_CACHE.items() if v[0]() is None]:
        del _CULL_CACHE[k]
    _CULL_CACHE[id(scene)] = (weakref.ref(scene), cull)
    return cull


def _boxes(scene: Scene, cull: TriCull, ids: torch.Tensor,
           n: int) -> torch.Tensor:
    """(6, n) float32 AABBs [lo xyz; hi xyz] of the LIVE vertices of the
    packed columns grouped by ``ids`` (n: invalid columns), padded like the
    host clusters; empty groups get the sentinel lo = +1 > hi = -1."""
    dev = scene.device
    perm = cull.on(dev, "perm")
    v0 = scene.tri_v0.to(torch.float32)[perm]
    v1 = scene.tri_v1.to(torch.float32)[perm]
    v2 = scene.tri_v2.to(torch.float32)[perm]
    valid = scene.tri_valid[perm][:, None]
    vmin = torch.where(valid, torch.minimum(torch.minimum(v0, v1), v2), 1e30)
    vmax = torch.where(valid, torch.maximum(torch.maximum(v0, v1), v2),
                       -1e30)
    idx = ids[:, None].expand(-1, 3)
    lo = torch.full((n + 1, 3), float("inf"), device=dev).scatter_reduce(
        0, idx, vmin, "amin")[:n]
    hi = torch.full((n + 1, 3), float("-inf"), device=dev).scatter_reduce(
        0, idx, vmax, "amax")[:n]
    pad = 1e-4 + 1e-5 * torch.maximum(lo.abs(), hi.abs())
    empty = (lo[:, 0] > hi[:, 0])[:, None]
    lo_p = torch.where(empty, 1.0, lo - pad)
    hi_p = torch.where(empty, -1.0, hi + pad)
    return torch.cat([lo_p.T, hi_p.T]).to(torch.float32).contiguous()


@torch.no_grad()
def tri_cluster_bounds(scene: Scene, cull: TriCull) -> torch.Tensor:
    """(6, C) float32 leaf AABBs [lo xyz; hi xyz] from the LIVE vertices,
    padded like the host clusters; empty leaves get lo > hi.  The bounds
    only gate work (a piecewise-constant decision), so they carry no
    gradient."""
    return _boxes(scene, cull, cull.on(scene.device, "leaf_ids"),
                  cull.ranges.shape[1])


@torch.no_grad()
def tri_sub_bounds(scene: Scene, cull: TriCull) -> torch.Tensor:
    """(6, 4 C) float32 AABBs of each leaf's sub-leaves, the columns
    [32k, 32k + 32) of its slot in the leaf-aligned table (column 4 ci + k),
    from the LIVE vertices on every call with ``tri_cluster_bounds``'
    padding and empty sentinel: an optimiser moves the geometry between
    calls, so boxes built once would be unsound.  K2 and K5s cull by them;
    no gradient."""
    return _boxes(scene, cull, cull.on(scene.device, "sub_ids"),
                  SUBS * cull.ranges.shape[1])


def _stream_colmap(cull: TriCull) -> np.ndarray:
    """(C * STREAM_LEAF_PAD,) map from the leaf-aligned table's columns to
    the packed columns, -1 on the zero padding of partly filled slots;
    cached on the cull."""
    if cull.colmap is None:
        P = STREAM_LEAF_PAD
        C = cull.ranges.shape[1]
        colmap = np.full(C * P, -1, np.int64)
        for k in range(C):
            s, e = int(cull.ranges[0, k]), int(cull.ranges[1, k])
            if e - s > P:
                raise ValueError(f"cull leaf {k} holds {e - s} triangles, "
                                 f"more than a {P}-column slot")
            colmap[k * P:k * P + (e - s)] = np.arange(s, e)
        cull.colmap = colmap
    return cull.colmap


def _align(packed: torch.Tensor, cull: TriCull) -> torch.Tensor:
    """The leaf-aligned (STREAM_ROWS_PAD, C * 128) table from the packed
    (TRI_ROWS, T) one: leaf k's triangles in slot columns [128k, 128k + n),
    zero pad columns and rows (a zero plane normal never hits)."""
    dev = packed.device
    vals = packed[:, cull.on(dev, "src")] * cull.on(dev, "mask")[None, :]
    pad = torch.zeros((STREAM_ROWS_PAD - vals.shape[0], vals.shape[1]),
                      dtype=vals.dtype, device=dev)
    return torch.cat([vals, pad]).contiguous()


def tri_stream_table(scene: Scene, cull: TriCull) -> torch.Tensor:
    """Differentiable leaf-aligned triangle table of the two-level walk:
    the torch counterpart of ``tri_stream_table_jnp`` (diff.py:236-248)."""
    return _align(pack_triangles(scene, perm=cull.on(scene.device, "perm")),
                  cull)


@torch.no_grad()
def tri_stream_tops(cull: TriCull, tric_b: torch.Tensor, group: int = 16):
    """Tops of the two-level walk: ``group`` consecutive leaves each, as
    (bounds (6, Ct) float32, ranges (2, Ct) int32 over the leaves).  A
    top's box is the union of its leaves' live boxes; a ragged last top
    is padded with lo = +1 / hi = -1 sentinels, which only enlarge a
    nonempty union (diff.py:251-272)."""
    C = cull.ranges.shape[1]
    Ct = -(-C // group)
    dev = tric_b.device
    ranges = torch.from_numpy(np.stack([
        np.arange(Ct, dtype=np.int32) * group,
        np.minimum(np.arange(1, Ct + 1, dtype=np.int32) * group, C)]))
    pad = Ct * group - C
    sentinel = torch.tensor([[1.0], [1.0], [1.0], [-1.0], [-1.0], [-1.0]],
                            dtype=tric_b.dtype, device=dev)
    b = torch.cat([tric_b, sentinel.expand(6, pad)], dim=1)
    lo = b[0:3].reshape(3, Ct, group).amin(dim=2)
    hi = b[3:6].reshape(3, Ct, group).amax(dim=2)
    return torch.cat([lo, hi]).contiguous(), ranges.to(dev)


def walk_tables(scene: Scene, cull: TriCull | None,
                two_level: bool = False) -> dict:
    """The kernels' tables of ``scene`` over the topology ``cull``:
    ``sph``, ``packed`` (the triangle table, columns in ``cull.perm``
    order; both differentiable), ``clusters`` (leaf bounds and ranges, None
    without a cull), and with ``two_level`` the walk's ``aligned`` table,
    gathered from the detached packed one, its ``tops`` and its sub-leaf
    boxes ``subs`` (``tri_sub_bounds``; else None)."""
    dev = scene.device
    t = dict(sph=pack_spheres(scene), clusters=None, aligned=None, tops=None,
             subs=None)
    if cull is None:
        t["packed"] = pack_triangles(scene)
        return t
    t["packed"] = pack_triangles(scene, perm=cull.on(dev, "perm"))
    b = tri_cluster_bounds(scene, cull)
    t["clusters"] = (b, cull.on(dev, "ranges"))
    if two_level:
        t["aligned"] = _align(t["packed"].detach(), cull)
        t["tops"] = tri_stream_tops(cull, b)
        t["subs"] = tri_sub_bounds(scene, cull)
    return t


class _KernelRender(torch.autograd.Function):
    """Mean image from the packed tables: K1 forward and K5 backward, or,
    with ``stream`` (the leaf-aligned table gathered from the packed one,
    the tops and the sub-leaf boxes), K2 and K5s."""

    @staticmethod
    def forward(ctx, sph, tri, cam_vec, tri_clusters, cfg, stream=None):
        walk, tops, subs = (tri, None, None) if stream is None else stream
        mean, _segs = wavefront.render_linear_cuda(
            sph, walk, cam_vec, tri_clusters=tri_clusters, tri_stream=tops,
            sub_bounds=subs, **cfg)
        ctx.save_for_backward(sph, walk, cam_vec)
        ctx.tri_clusters = tri_clusters
        ctx.stream = dict(tri_stream=tops, sub_bounds=subs)
        ctx.n_tris = tri.shape[1]
        ctx.cfg = cfg
        return mean

    @staticmethod
    def backward(ctx, g):
        sph, walk, cam_vec = ctx.saved_tensors
        # dtri has the packed table's columns either way: K5s's winners
        # are packed columns, as the JAX _bwd chains them
        dsph, dtri, dcam = wavefront_bwd.render_grad_cuda(
            sph, walk, g.contiguous(), cam_vec,
            tri_clusters=ctx.tri_clusters, n_tris_packed=ctx.n_tris,
            **ctx.stream, **ctx.cfg)
        # dsph rows are cx, cy, cz, r, rgb, fuzz, ir; the table's r^2 and
        # kind rows take zero (K5's dr is the total derivative)
        d_table = torch.zeros_like(sph)
        d_table[wavefront_bwd.SPH_GRAD_ROWS] = dsph
        return d_table, dtri, dcam, None, None, None


def render_linear_diff(scene: Scene, camera: Camera, *, width: int,
                       height: int, samples_per_pixel: int, depth: int,
                       seed: int = 0, parity_plane_sign: bool = True,
                       tri_cull: TriCull | None = None, shard_rows=None,
                       row_offset: int = 0, row_stride: int = 1
                       ) -> torch.Tensor:
    """Differentiable mean linear radiance [rows, W, 3] through K1 and K5
    (their plain versions on CPU tensors).

    ``tri_cull`` (from ``build_tri_cull``) culls triangles, only under the
    correct plane equation (it is ignored under ``parity_plane_sign``):
    one level of leaves, or, for scenes past the table budget
    (``_needs_stream``), the two-level walk of K2 and K5s.
    ``shard_rows`` / ``row_offset`` / ``row_stride`` render the global rows
    ``row_offset + k * row_stride`` for k < shard_rows (rows = height when
    shard_rows is None), forward and backward."""
    cull = None if parity_plane_sign else tri_cull
    t = walk_tables(scene, cull, cull is not None and _needs_stream(scene))
    stream = None if t["tops"] is None else (t["aligned"], t["tops"],
                                             t["subs"])
    cfg = dict(width=width, height=height,
               samples_per_pixel=samples_per_pixel, depth=depth, seed=seed,
               parity_plane_sign=parity_plane_sign, shard_rows=shard_rows,
               row_offset=row_offset, row_stride=row_stride)
    cv = tables.camera_vec(camera).to(scene.device)
    return _KernelRender.apply(t["sph"], t["packed"], cv, t["clusters"], cfg,
                               stream)


def bwd_kernel_eligible(scene: Scene,
                        parity_plane_sign: bool | None = None) -> bool:
    """Whether the backward kernels cover ``scene``: always.  Past the
    table budget under the correct plane sign, K5s takes the two-level walk
    as the JAX package's streamed backward does; every other scene,
    including a big one under the parity sign (which the JAX package sends
    to its XLA backward), goes to K5, which reads its tables from device
    memory at any size.  The arguments are kept for the JAX package's
    callers."""
    return True
