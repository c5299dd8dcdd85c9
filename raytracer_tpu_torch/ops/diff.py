"""The differentiable kernel path: K1 forward, K5 backward.

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
           "tri_cluster_bounds", "render_linear_diff", "bwd_kernel_eligible",
           "LEAF_SIZE"]

LEAF_SIZE = 64   # triangles per cull leaf


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


_CULL_CACHE: dict = {}


def build_tri_cull(scene: Scene, leaf_target: int = LEAF_SIZE
                   ) -> TriCull | None:
    """Host-side cull topology of ``scene`` (cached on its identity), or
    None below 64 valid triangles.  Leaves hold up to ``leaf_target``
    triangles (64: the TPU's 128-wide leaves for tables past its scalar
    memory have no counterpart on the card)."""
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


@torch.no_grad()
def tri_cluster_bounds(scene: Scene, cull: TriCull) -> torch.Tensor:
    """(6, C) float32 leaf AABBs [lo xyz; hi xyz] from the LIVE vertices,
    padded like the host clusters; empty leaves get lo > hi.  The bounds
    only gate work (a piecewise-constant decision), so they carry no
    gradient."""
    dev = scene.device
    C = cull.ranges.shape[1]
    ids = torch.from_numpy(cull.leaf_ids).to(dev, torch.int64)
    perm = torch.from_numpy(cull.perm).to(dev)
    v0 = scene.tri_v0.to(torch.float32)[perm]
    v1 = scene.tri_v1.to(torch.float32)[perm]
    v2 = scene.tri_v2.to(torch.float32)[perm]
    valid = scene.tri_valid[perm][:, None]
    vmin = torch.where(valid, torch.minimum(torch.minimum(v0, v1), v2), 1e30)
    vmax = torch.where(valid, torch.maximum(torch.maximum(v0, v1), v2),
                       -1e30)
    idx = ids[:, None].expand(-1, 3)
    lo = torch.full((C + 1, 3), float("inf"), device=dev).scatter_reduce(
        0, idx, vmin, "amin")[:C]
    hi = torch.full((C + 1, 3), float("-inf"), device=dev).scatter_reduce(
        0, idx, vmax, "amax")[:C]
    pad = 1e-4 + 1e-5 * torch.maximum(lo.abs(), hi.abs())
    empty = (lo[:, 0] > hi[:, 0])[:, None]
    lo_p = torch.where(empty, 1.0, lo - pad)
    hi_p = torch.where(empty, -1.0, hi + pad)
    return torch.cat([lo_p.T, hi_p.T]).to(torch.float32).contiguous()


class _KernelRender(torch.autograd.Function):
    """Mean image from the packed tables: K1 forward, K5 backward."""

    @staticmethod
    def forward(ctx, sph, tri, cam_vec, tri_clusters, cfg):
        mean, _segs = wavefront.render_linear_cuda(
            sph, tri, cam_vec, tri_clusters=tri_clusters, **cfg)
        ctx.save_for_backward(sph, tri, cam_vec)
        ctx.tri_clusters = tri_clusters
        ctx.cfg = cfg
        return mean

    @staticmethod
    def backward(ctx, g):
        sph, tri, cam_vec = ctx.saved_tensors
        dsph, dtri, dcam = wavefront_bwd.render_grad_cuda(
            sph, tri, g.contiguous(), cam_vec,
            tri_clusters=ctx.tri_clusters, **ctx.cfg)
        # dsph rows are cx, cy, cz, r, rgb, fuzz, ir; the table's r^2 and
        # kind rows take zero (K5's dr is the total derivative)
        d_table = torch.zeros_like(sph)
        d_table[wavefront_bwd.SPH_GRAD_ROWS] = dsph
        return d_table, dtri, dcam, None, None


def render_linear_diff(scene: Scene, camera: Camera, *, width: int,
                       height: int, samples_per_pixel: int, depth: int,
                       seed: int = 0, parity_plane_sign: bool = True,
                       tri_cull: TriCull | None = None, shard_rows=None,
                       row_offset: int = 0, row_stride: int = 1
                       ) -> torch.Tensor:
    """Differentiable mean linear radiance [rows, W, 3] through K1 and K5
    (their plain versions on CPU tensors).

    ``tri_cull`` (from ``build_tri_cull``) culls triangles, only under the
    correct plane equation (it is ignored under ``parity_plane_sign``).
    ``shard_rows`` / ``row_offset`` / ``row_stride`` render the global rows
    ``row_offset + k * row_stride`` for k < shard_rows (rows = height when
    shard_rows is None), forward and backward."""
    cull = None if parity_plane_sign else tri_cull
    sph = pack_spheres(scene)
    tri = pack_triangles(scene, perm=None if cull is None else cull.perm)
    tri_cl = None
    if cull is not None:
        tri_cl = (tri_cluster_bounds(scene, cull),
                  torch.from_numpy(cull.ranges).to(scene.device))
    cfg = dict(width=width, height=height,
               samples_per_pixel=samples_per_pixel, depth=depth, seed=seed,
               parity_plane_sign=parity_plane_sign, shard_rows=shard_rows,
               row_offset=row_offset, row_stride=row_stride)
    cv = tables.camera_vec(camera).to(scene.device)
    return _KernelRender.apply(sph, tri, cv, tri_cl, cfg)


def bwd_kernel_eligible(scene: Scene,
                        parity_plane_sign: bool | None = None) -> bool:
    """Whether K5 covers ``scene``: always.  On the card K5 reads every
    table from device memory, so it takes every scene K1 takes (the TPU's
    scalar-memory budget and its streamed fallback have no counterpart);
    the arguments are kept for the JAX package's callers."""
    return True
