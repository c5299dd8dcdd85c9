"""Ray-primitive intersection over a wavefront: the closest hit.

Port of ``raytracer_tpu/intersect.py`` (the batch half).  The reference's
``World::hit`` is a scalar scan with a running closest bound
(common.rs:237-258) over ``Sphere::hit`` (half-b quadratic, common.rs:60-98)
and ``Triangle::intersect`` (plane + three edge tests, common.rs:124-166).
Here each (ray, primitive) pair is one element of a [B, P] tensor and the
scan becomes a masked minimum with the scan's tie rules: among spheres the
first of equal t wins (strict ``<``), a triangle beats a sphere and a later
triangle an earlier one at equal t (``<=``, common.rs:142).  Primitives are
taken in chunks of ``CHUNK`` columns, so memory stays [B, CHUNK] whatever
the scene's size.

Every step is differentiable by autograd: the selection routes cotangents
to the winning primitive only, and guarded square roots and divisions
(``maths.safe_sqrt``, the double-where pattern) keep NaN out of the
cotangents of masked lanes.  Geometric contractions are written as explicit
multiply-adds (``contract3``) and never as a matrix product: a float32
``@`` may run in TF32 on Hopper, which rounds a K=3 product the way the
TPU's bf16 pass did.

``closest_hit_exact`` is the parity renderer's single-ray closest hit in
the reference's exact operation order (``raytracer_tpu/intersect.py:349``):
dot products added left to right (``dot3``), square roots rounded once
(``maths.sqrt_rn``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import maths
from .scene import Scene, triangle_normals

__all__ = ["INF", "T_MIN", "CHUNK", "contract3", "HitRecord", "ScenePack",
           "pack_scene", "sphere_hits_batch", "triangle_hits_batch",
           "closest_hit_batch", "closest_hit_batch_argmin", "ExactPack",
           "exact_pack",
           "closest_hit_exact"]

INF = float("inf")
T_MIN = float(np.float32(0.001))   # shadow-acne epsilon, common.rs:242,250
EPS8 = float(np.float32(1e-8))     # NVec3::is_zero, common.rs:135-138
CHUNK = 64                         # primitives per [B, CHUNK] block


def contract3(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """[B, 3] x [3, P] -> [B, P] as three broadcast multiply-adds, never a
    matmul (TF32 would round the K=3 product)."""
    return (a[:, 0:1] * b_t[0][None, :]
            + a[:, 1:2] * b_t[1][None, :]
            + a[:, 2:3] * b_t[2][None, :])


@dataclasses.dataclass(frozen=True)
class HitRecord:
    """Batched HitRecord (common.rs:42-47) plus a hit mask."""
    t: torch.Tensor          # [B] f32, inf where nothing is hit
    position: torch.Tensor   # [B, 3]
    normal: torch.Tensor     # [B, 3] unit
    mat: torch.Tensor        # [B] int32 material index
    hit: torch.Tensor        # [B] bool


@dataclasses.dataclass(frozen=True)
class ScenePack:
    """Per-primitive constants, built with differentiable ops from the
    scene so gradients reach centres, radii and vertices."""
    center_t: torch.Tensor            # [3, S]
    center_sq_minus_r2: torch.Tensor  # [S] |c|^2 - r^2
    n_t: torch.Tensor                 # [3, T] plane normal (common.rs:131-133)
    d: torch.Tensor                   # [T] n . v0 (common.rs:140)
    g0_t: torch.Tensor                # [3, T] n x e0 (edge-test constants)
    g1_t: torch.Tensor                # [3, T] n x e1
    g2_t: torch.Tensor                # [3, T] n x e2
    v0g0: torch.Tensor                # [T] v0 . g0
    v1g1: torch.Tensor                # [T] v1 . g1
    v2g2: torch.Tensor                # [T] v2 . g2
    unit_normal: torch.Tensor         # [T, 3] Triangle::new normal


def pack_scene(scene: Scene) -> ScenePack:
    c, r = scene.sphere_center, scene.sphere_radius
    v0, v1, v2 = scene.tri_v0, scene.tri_v1, scene.tri_v2
    n = maths.cross(v1 - v0, v2 - v0)
    g0 = maths.cross(n, v1 - v0)
    g1 = maths.cross(n, v2 - v1)
    g2 = maths.cross(n, v0 - v2)
    return ScenePack(
        center_t=c.T, center_sq_minus_r2=torch.sum(c * c, dim=-1) - r * r,
        n_t=n.T, d=maths.dot(n, v0), g0_t=g0.T, g1_t=g1.T, g2_t=g2.T,
        v0g0=maths.dot(v0, g0), v1g1=maths.dot(v1, g1),
        v2g2=maths.dot(v2, g2), unit_normal=triangle_normals(scene))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for a [B, C] tensor."""
    return torch.gather(x, 1, idx[:, None])[:, 0]


def _last_argmin(x: torch.Tensor) -> torch.Tensor:
    """Index of the LAST minimum along dim 1 (torch.argmin gives the
    first)."""
    return x.shape[1] - 1 - torch.argmin(torch.flip(x, dims=[1]), dim=1)


def _sphere_t(ox, oy, oz, dx, dy, dz, c, r, valid, t_min):
    """[B, C] hit distances (inf for none) of the rays against spheres
    ``c`` [C, 3], ``r`` [C] in the reference's half-b form with a == 1
    (NVec3::length_squared is hardcoded to 1, maths.rs:127-128)."""
    ocx = ox[:, None] - c[None, :, 0]
    ocy = oy[:, None] - c[None, :, 1]
    ocz = oz[:, None] - c[None, :, 2]
    half_b = ocx * dx[:, None] + ocy * dy[:, None] + ocz * dz[:, None]
    cc = ocx * ocx + ocy * ocy + ocz * ocz - (r * r)[None, :]
    disc = half_b * half_b - cc
    ok = disc >= 0.0
    # the guard value is positive: sqrt'(0) = inf would turn the masked
    # lanes' zero cotangents into NaN
    sq = maths.safe_sqrt(torch.where(ok, disc, torch.ones_like(disc)))
    root1 = -half_b - sq
    root2 = -half_b + sq
    t = torch.where(root1 > t_min, root1,
                    torch.where(root2 > t_min, root2, INF))
    return torch.where(ok & valid[None, :], t, INF)


def _triangle_t(ox, oy, oz, dx, dy, dz, pack, s0, s1, valid, t_min,
                parity_plane_sign):
    """[B, C] plane-hit distances and the [B, C] mask of hits that pass
    the edge tests, for triangles s0..s1 (``triangle_hits_batch``'s edge
    constants: n . (e_k x (p - v_k)) >= 0 as o.g_k + t d.g_k - v_k.g_k)."""
    n = pack.n_t[:, s0:s1]
    nd = n[0] * dx[:, None] + n[1] * dy[:, None] + n[2] * dz[:, None]
    no = n[0] * ox[:, None] + n[1] * oy[:, None] + n[2] * oz[:, None]
    parallel = nd.abs() < EPS8
    nd_safe = torch.where(parallel, torch.ones_like(nd), nd)
    d = pack.d[None, s0:s1]
    # parity_plane_sign: the reference's wrong-sign plane equation
    # (common.rs:140-141); otherwise the correct (d - n.o) / (n.dir)
    t = (no + d) / nd_safe if parity_plane_sign else (d - no) / nd_safe
    ok = ~parallel & (t >= t_min) & valid[None, s0:s1]
    for g_t, w in ((pack.g0_t, pack.v0g0), (pack.g1_t, pack.v1g1),
                   (pack.g2_t, pack.v2g2)):
        g = g_t[:, s0:s1]
        e = (ox[:, None] * g[0] + oy[:, None] * g[1] + oz[:, None] * g[2]
             + t * (dx[:, None] * g[0] + dy[:, None] * g[1]
                    + dz[:, None] * g[2]) - w[None, s0:s1])
        ok = ok & (e >= 0.0)
    return t, ok


def sphere_hits_batch(origin, direction, scene: Scene, pack: ScenePack,
                      t_min=T_MIN) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closest sphere per ray: (t [B], inf if none; index [B]), with
    ``contract3`` contractions against the packed centres."""
    od = maths.dot(origin, direction)
    half_b = od[:, None] - contract3(direction, pack.center_t)
    oo = maths.dot(origin, origin)
    c = (oo[:, None] - 2.0 * contract3(origin, pack.center_t)
         + pack.center_sq_minus_r2[None, :])
    disc = half_b * half_b - c
    has_root = disc >= 0.0
    sq = maths.safe_sqrt(torch.where(has_root, disc, torch.ones_like(disc)))
    root1 = -half_b - sq
    root2 = -half_b + sq
    t = torch.where(root1 > t_min, root1,
                    torch.where(root2 > t_min, root2, INF))
    t = torch.where(has_root & scene.sphere_valid[None, :], t, INF)
    idx = torch.argmin(t, dim=-1)
    return _take(t, idx), idx


def triangle_hits_batch(origin, direction, scene: Scene, pack: ScenePack,
                        t_min=T_MIN, parity_plane_sign: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closest triangle per ray: (t [B], inf if none; index [B])."""
    no = contract3(origin, pack.n_t)
    nd = contract3(direction, pack.n_t)
    parallel = nd.abs() < EPS8
    nd_safe = torch.where(parallel, torch.ones_like(nd), nd)
    d = pack.d[None, :]
    t = (no + d) / nd_safe if parity_plane_sign else (d - no) / nd_safe
    ok = ~parallel & (t >= t_min)
    for g_t, w in ((pack.g0_t, pack.v0g0), (pack.g1_t, pack.v1g1),
                   (pack.g2_t, pack.v2g2)):
        ok = ok & ((contract3(origin, g_t) + t * contract3(direction, g_t)
                    - w[None, :]) >= 0.0)
    t = torch.where(ok & scene.tri_valid[None, :], t, INF)
    idx = torch.argmin(t, dim=-1)
    return _take(t, idx), idx


def closest_hit_batch(origin, direction, scene: Scene, pack: ScenePack,
                      t_min=T_MIN, parity_plane_sign: bool = True
                      ) -> HitRecord:
    """World::hit (common.rs:237-258) over the wavefront with the scan's
    semantics (``raytracer_tpu/intersect.py:226``): spheres first, the
    sphere normal ((p - c)/r).normalize() with the radius reduced to its
    sign (a negative radius flips the normal, the hollow-glass trick), then
    triangles, which win ties."""
    B = origin.shape[0]
    dev = origin.device
    ox, oy, oz = origin[:, 0], origin[:, 1], origin[:, 2]
    dx, dy, dz = direction[:, 0], direction[:, 1], direction[:, 2]

    def full(v):
        return torch.full((B,), v, dtype=torch.float32, device=dev)

    t_best, cx, cy, cz, sg = full(INF), full(0.0), full(0.0), full(1.0), \
        full(1.0)
    mat = torch.zeros((B,), dtype=torch.int32, device=dev)
    for s0 in range(0, scene.num_spheres, CHUNK):
        s1 = min(s0 + CHUNK, scene.num_spheres)
        c = scene.sphere_center[s0:s1]
        r = scene.sphere_radius[s0:s1]
        t = _sphere_t(ox, oy, oz, dx, dy, dz, c, r,
                      scene.sphere_valid[s0:s1], t_min)
        idx = torch.argmin(t, dim=1)            # first of equals wins
        tc = _take(t, idx)
        better = tc < t_best
        t_best = torch.where(better, tc, t_best)
        cx = torch.where(better, c[idx, 0], cx)
        cy = torch.where(better, c[idx, 1], cy)
        cz = torch.where(better, c[idx, 2], cz)
        sg = torch.where(better, torch.where(r[idx] < 0.0, -1.0, 1.0), sg)
        mat = torch.where(better, scene.sphere_mat[s0:s1][idx], mat)

    ts_safe = torch.where(torch.isfinite(t_best), t_best, 0.0)
    snx = ox + ts_safe * dx - cx
    sny = oy + ts_safe * dy - cy
    snz = oz + ts_safe * dz - cz
    ln = maths.safe_sqrt(snx * snx + sny * sny + snz * snz)
    ln = torch.where(ln == 0.0, torch.ones_like(ln), ln) * sg
    nx, ny, nz = snx / ln, sny / ln, snz / ln

    for s0 in range(0, scene.num_triangles, CHUNK):
        s1 = min(s0 + CHUNK, scene.num_triangles)
        t, ok = _triangle_t(ox, oy, oz, dx, dy, dz, pack, s0, s1,
                            scene.tri_valid, t_min, parity_plane_sign)
        idx = _last_argmin(torch.where(ok, t, INF))   # later wins ties
        tc = _take(t, idx)
        better = _take(ok, idx) & (tc <= t_best)
        un = pack.unit_normal[s0:s1][idx]
        t_best = torch.where(better, tc, t_best)
        nx = torch.where(better, un[:, 0], nx)
        ny = torch.where(better, un[:, 1], ny)
        nz = torch.where(better, un[:, 2], nz)
        mat = torch.where(better, scene.tri_mat[s0:s1][idx], mat)

    hit = torch.isfinite(t_best)
    t_safe = torch.where(hit, t_best, 0.0)
    return HitRecord(t=t_best, position=origin + t_safe[:, None] * direction,
                     normal=torch.stack([nx, ny, nz], dim=-1),
                     mat=mat.to(torch.int32), hit=hit)


def closest_hit_batch_argmin(origin, direction, scene: Scene,
                             pack: ScenePack, t_min=T_MIN,
                             parity_plane_sign: bool = True) -> HitRecord:
    """World::hit as one [B, S] and one [B, T] block, an argmin each and a
    gather (``raytracer_tpu/intersect.py:192``): the JAX package's
    reference formulation, kept for studies and tests; ``closest_hit_batch``
    is the one renders use.  A triangle wins a tie with a sphere; among
    equal triangles the first wins here (the last in
    ``closest_hit_batch``), the only difference between the two."""
    ts, si = sphere_hits_batch(origin, direction, scene, pack, t_min)
    tt, ti = triangle_hits_batch(origin, direction, scene, pack, t_min,
                                 parity_plane_sign)
    tri_wins = tt <= ts
    t = torch.where(tri_wins, tt, ts)
    hit = torch.isfinite(t)
    t_safe = torch.where(hit, t, 0.0)
    position = origin + t_safe[:, None] * direction
    # sphere normal ((p - c) / r).normalize() (common.rs:94-95)
    rad = scene.sphere_radius[si][:, None]
    raw = (position - scene.sphere_center[si]) / torch.where(
        rad == 0.0, torch.ones_like(rad), rad)
    ln = maths.safe_sqrt(torch.sum(raw * raw, dim=-1, keepdim=True))
    sph_n = raw / torch.where(ln == 0.0, torch.ones_like(ln), ln)
    normal = torch.where(tri_wins[:, None], pack.unit_normal[ti], sph_n)
    mat = torch.where(tri_wins, scene.tri_mat[ti], scene.sphere_mat[si])
    return HitRecord(t=t, position=position, normal=normal,
                     mat=mat.to(torch.int32), hit=hit)


# ---------------------------------------------------------------------------
# Exact path (sequential parity renderer) -- the reference's operation order
# ---------------------------------------------------------------------------

def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x*x' + y*y' + z*z' over the last axis, added left to right as the
    reference does (maths.rs:82): each product and sum rounded once, in
    that order, on any device (a reduction op fixes no order)."""
    x, y, z = (a * b).unbind(-1)
    return (x + y) + z


@dataclasses.dataclass(frozen=True)
class ExactPack:
    """The per-primitive constants of ``closest_hit_exact``, each the value
    the reference computes per ray (so computing them once changes no bit):
    r^2, the plane normal n = (v1 - v0) x (v2 - v0), n . v0, the three
    edges and their start vertices; the rows a hit reads, triangles first
    (unit normal, 1, material, 1) then spheres (centre, radius with 0 read
    as 1, material, 0); and the constants the tests compare with, as
    device tensors."""
    center: torch.Tensor       # [S, 3]
    r2: torch.Tensor           # [S]
    sphere_valid: torch.Tensor  # [S]
    n: torch.Tensor            # [T, 3] (common.rs:131-133, not normalised)
    d: torch.Tensor            # [T] n . v0 (common.rs:140)
    starts: torch.Tensor       # [3, T, 3] v0, v1, v2
    edges_yzx: torch.Tensor    # [3, T, 3] v1 - v0, v2 - v1, v0 - v2 rolled
    edges_zxy: torch.Tensor
    tri_valid: torch.Tensor    # [T]
    rows: torch.Tensor         # [T + S, 6]
    consts: torch.Tensor       # [5] 0, 1, T_MIN, EPS8, inf


def exact_pack(scene: Scene) -> ExactPack:
    v0, v1, v2 = scene.tri_v0, scene.tri_v1, scene.tri_v2
    n = maths.cross(v1 - v0, v2 - v0)
    ln = maths.sqrt_rn(dot3(n, n))[:, None]
    unit = n / torch.where(ln == 0.0, torch.ones_like(ln), ln)
    r = scene.sphere_radius
    edges = torch.stack([v1 - v0, v2 - v1, v0 - v2])
    f32 = torch.float32

    def col(x):
        return x.to(f32)[:, None]

    ones_t, zeros_s = torch.ones_like(v0[:, :1]), torch.zeros_like(r)
    return ExactPack(
        center=scene.sphere_center, r2=r * r,
        sphere_valid=scene.sphere_valid,
        n=n, d=dot3(n, v0), starts=torch.stack([v0, v1, v2]),
        edges_yzx=edges.roll(-1, -1), edges_zxy=edges.roll(1, -1),
        tri_valid=scene.tri_valid,
        rows=torch.cat([
            torch.cat([unit, ones_t, col(scene.tri_mat), ones_t], dim=1),
            torch.cat([scene.sphere_center,
                       col(torch.where(r == 0.0, torch.ones_like(r), r)),
                       col(scene.sphere_mat), col(zeros_s)], dim=1)]),
        consts=torch.tensor([0.0, 1.0, T_MIN, EPS8, INF], dtype=f32,
                            device=scene.device))


def _closest_hit_exact(origin, direction, pack: ExactPack,
                       parity_plane_sign: bool) -> HitRecord:
    """``closest_hit_exact`` over a prebuilt pack; t, hit and the material
    (as float32) have shape [1]."""
    zero, one, t_min, eps, inf = pack.consts.unbind()
    # --- spheres: common.rs:74-97 (a == 1)
    oc = origin - pack.center
    half_b = dot3(oc, direction)
    disc = half_b * half_b - (dot3(oc, oc) - pack.r2)
    has_root = disc >= zero
    sq = maths.sqrt_rn(torch.where(has_root, disc, one))
    root1 = -half_b - sq
    root2 = -half_b + sq
    ts = torch.where(root1 > t_min, root1,
                     torch.where(root2 > t_min, root2, inf))
    ts = torch.where(has_root & pack.sphere_valid, ts, inf)

    # --- triangles: common.rs:131-165
    n = pack.n
    cos_al = dot3(n, direction)
    parallel = cos_al.abs() < eps       # -1e-8 < cos < 1e-8
    n_dot_o = dot3(n, origin)
    tt = ((n_dot_o + pack.d) if parity_plane_sign
          else (pack.d - n_dot_o)) / torch.where(parallel, one, cos_al)
    p = origin + tt[:, None] * direction
    # edge k: n . (e_k x (p - v_k)) >= 0, the three edges at once; a cross
    # product's middle term is rounded as -(ax bz - az bx) in the reference
    # and as az bx - ax bz here: equal but for the sign of an exact zero,
    # which no ">= 0" test sees
    q = p - pack.starts
    cr = pack.edges_yzx * q.roll(1, -1) - pack.edges_zxy * q.roll(-1, -1)
    ok = ((dot3(n, cr) >= zero).all(0) & ~parallel & (tt >= t_min)
          & pack.tri_valid)

    # the first minimum of triangles-then-spheres: the first of equal
    # sphere t and of equal triangle t wins, and a triangle wins a tie
    # against a sphere (t_t <= t_s)
    t_all = torch.cat([torch.where(ok, tt, inf), ts])
    k = torch.argmin(t_all, 0, keepdim=True)
    t = t_all.gather(0, k)
    hit = torch.isfinite(t)
    position = origin + torch.where(hit, t, zero) * direction
    vec, rad, mat, is_tri = torch.index_select(pack.rows, 0, k)[0].split(
        (3, 1, 1, 1))
    sph_raw = (position - vec) / rad
    ln = maths.sqrt_rn(dot3(sph_raw, sph_raw))
    sph_n = sph_raw / torch.where(ln == zero, one, ln)
    return HitRecord(t=t, position=position,
                     normal=torch.where(is_tri > zero, vec, sph_n), mat=mat,
                     hit=hit)


def closest_hit_exact(origin, direction, scene: Scene,
                      parity_plane_sign: bool = True) -> HitRecord:
    """Single-ray (shape [3]) closest hit in the reference's exact
    operation order (World::hit, common.rs:237-258): every dot product
    added left to right, the first of equal sphere t and of equal triangle
    t winning, a triangle winning a tie against a sphere (``t_t <= t_s``).
    Vectorised only across primitives, with no host sync.  Returns a
    HitRecord of 0-d tensors (position and normal [3], ``mat`` int32)."""
    h = _closest_hit_exact(origin, direction, exact_pack(scene),
                           parity_plane_sign)
    return HitRecord(t=h.t[0], position=h.position, normal=h.normal,
                     mat=h.mat[0].to(torch.int32), hit=h.hit[0])
