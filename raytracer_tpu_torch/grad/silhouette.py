"""Silhouette (visibility-boundary) gradients by edge sampling.

Port of ``raytracer_tpu/grad/silhouette.py``.  Autograd through the
renderer follows the selected branch of every hit and miss decision, so it
gives the shading derivatives and drops the boundary terms: moving a
primitive also moves the pixels it covers, and the loss changes by
(radiance inside - radiance outside) x (edge velocity) integrated along
the silhouette.  The estimators here add that term (Li et al. 2018's edge
sampling) for an image cotangent ``g = dL/dimage``:

    dL/dtheta |_boundary ~= sum_k  g[pix_k] . (f_in - f_out)_k
                            * (n_hat_k . d(uv)_k/dtheta) * |d(uv)_k/ds| ds
                            / A_cell

  * ``silhouette_grad``: sphere silhouettes seen by the camera, sampled on
    the analytic silhouette circle;
  * ``triangle_silhouette_grad``: every triangle edge, or past
    ``MAX_EDGE_SAMPLES`` edges the top ones of an importance prepass
    (``_select_edges``);
  * ``mirror_silhouette_grad`` / ``mirror_triangle_silhouette_grad``: sphere
    silhouettes and mesh edges seen in a fuzz-0 metal sphere, through a
    virtual viewpoint across the mirror's camera-facing tangent plane;
  * ``glass_silhouette_grad``: a sphere seen through the always-refract
    dielectric, its boundary found by bisection of an analytic
    refraction chain and differentiated by the implicit function theorem;
  * ``value_and_grad_with_silhouette``: the unmasked MSE loss, the interior
    gradient by autograd through ``render.render_linear`` plus the
    estimators above, gated on the host as the JAX package gates them.

How the JAX estimators map onto PyTorch:

  * The edge velocities are ``torch.func.jacfwd`` under ``torch.func.vmap``
    of the same (u, v) maps, one call per estimator over all its points.
    The camera equation ``llc + u h + v vv - o = t (p - o)`` is solved in
    closed form (Cramer's rule, ``_solve_uvt``) where the JAX package calls
    ``jnp.linalg.solve``: the same 3x3 solve, written in element-wise
    operations, so it rounds alike on the CPU and the card, gives inf or
    NaN on a singular system as the LU solve does (never an error), and
    forward-mode AD goes through it.  The glass derivatives of ``f`` are
    ``torch.func.grad`` under ``vmap``.
  * The radiance probes do not run under ``vmap`` (``render.trace_rays``
    stops early on a host check and loops over primitive chunks): each
    estimator builds all its inside and outside probe rays as one batch
    and calls ``trace_rays`` once, on a scene without autograd.  A ray's
    radiance depends only on its own (pix_id, sample_id), so this is the
    same function as the JAX package's per-sphere / per-edge / per-pair
    calls.  The pcg3d counters are the JAX package's uint32 words, built in
    int64 and wrapped to 32 bits, quirks included: the mirrored-edge
    estimator adds ``salt * 0x9E3779B9`` to its outside probes, the glass
    estimator adds ``salt * 0x85EBCA6B`` and traces sample 1, and the
    mirror-sphere estimator's two probes share one stream.
  * Pairs whose mirror or glass sphere is not one (a host check) are not
    built: their terms are exactly zero in the JAX package, and the
    counters depend on (mi, si), not on a pair's place in the batch.
  * ``lax.top_k`` puts the lower index first among equal scores; the
    selection here is a stable descending sort's head, so the same edges
    come out (and feed the same counters).
  * The glass bisection is 24 ``torch.where`` steps over the whole batch.

The functions run on the device of the scene they are given.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch.func import grad as func_grad, jacfwd, vmap

from .. import intersect, maths, render as render_mod, rng
from ..camera import Camera
from ..scene import Scene
from .inverse import _device, _move, image_loss
from .params import apply_params

__all__ = ["MAX_EDGE_TRIS", "MAX_EDGE_SAMPLES", "silhouette_grad",
           "triangle_silhouette_grad", "mirror_silhouette_grad",
           "mirror_triangle_silhouette_grad", "glass_silhouette_grad",
           "value_and_grad_with_silhouette"]

MAX_EDGE_TRIS = 2048   # below this, ALL 3*T edges are sampled
# above it, an importance prepass selects this many edges
MAX_EDGE_SAMPLES = 3 * MAX_EDGE_TRIS

_F32 = torch.float32
_MASK32 = 0xFFFFFFFF
_SALT_MIRROR_TRI = 0x9E3779B9
_SALT_GLASS = 0x85EBCA6B
_TWO_PI = 2.0 * np.pi


# ---------------------------------------------------------------------------
# element-wise vector helpers (work batched and under vmap)
# ---------------------------------------------------------------------------

def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _dot2(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _cross(a, b):
    """jnp.cross's form."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _max(x, c: float):
    """jnp.maximum(x, c): NaN propagates, ties split the derivative."""
    return torch.maximum(x, torch.full_like(x, c))


def _sqrt(x):
    return maths.sqrt_rn(x)


def _fin(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _f32(v, dev):
    """A float32 scalar on ``dev``: CUDA divides by a Python scalar as a
    multiplication by its reciprocal, by a device tensor exactly."""
    return torch.tensor(v, dtype=_F32, device=dev)


def _solve_uvt(camera: Camera, p):
    """(u, v, t) with llc + u h + v vv - o = t (p - o): the system
    [h, vv, -(p - o)] x = o - llc by Cramer's rule."""
    o = camera.origin
    h, vv = camera.horizontal, camera.vertical
    w = -(p - o)
    rhs = o - camera.lower_left_corner
    vxw = _cross(vv, w)
    det = _dot(h, vxw)
    u = _dot(rhs, vxw) / det
    v = _dot(h, _cross(rhs, w)) / det
    t = _dot(h, _cross(vv, rhs)) / det
    return u, v, t


def _in_unit(u, v):
    return (u >= 0.0) & (u < 1.0) & (v >= 0.0) & (v < 1.0)


def _cell(x, n: int):
    """clip(int32(x * (n - 1)), 0, n - 1) as XLA casts (NaN -> 0,
    saturating)."""
    x = torch.nan_to_num(x * (n - 1), nan=0.0)
    return torch.clamp(x, 0.0, float(n - 1)).to(torch.int64)


def _g_at(g_img, u, v, width: int, height: int):
    """The loss cotangent at the pixel of (u, v): [N, 3]."""
    return g_img[_cell(v, height), _cell(u, width)]


def _a_cell(width: int, height: int) -> float:
    return 1.0 / ((width - 1) * (height - 1))


def _outward(tan, away):
    """(|tan|, outward unit normal): the perpendicular of the image-space
    tangent, oriented along ``away``."""
    tlen = _sqrt(_max(_dot2(tan, tan), 1e-20))
    n1 = torch.stack([tan[:, 1], -tan[:, 0]], -1) / tlen[:, None]
    sign = torch.sign(_dot2(n1, away))
    sign = torch.where(sign == 0.0, torch.ones_like(sign), sign)
    return tlen, n1 * sign[:, None]


def _n_dot(n_hat, jac):
    """einsum('nk,nkj->nj', n_hat, jac)."""
    return n_hat[:, 0:1] * jac[:, 0, :] + n_hat[:, 1:2] * jac[:, 1, :]


def _jac(fn, diff_args, const_args=()):
    """vmap(jacfwd) of ``fn(*diff_args, *const_args) -> (out, aux)`` over
    dim 0 of every argument: (jacobians w.r.t. each of ``diff_args``,
    aux)."""
    n = len(diff_args)
    return vmap(jacfwd(fn, argnums=tuple(range(n)), has_aux=True))(
        *diff_args, *const_args)


def _counters(words) -> torch.Tensor:
    """uint32 pcg3d counters from int64 words (wrapped to 32 bits)."""
    return rng.as_int32(words & _MASK32)


def _sample_ids(block, n: int, seed: int):
    """The JAX estimators' pix_id words before wrapping: arange(n) + block
    * n + uint32(seed) * SEED_MIX for each block id (a sphere, an edge, a
    pair), flattened block-major (int64)."""
    k = torch.arange(n, dtype=torch.int64, device=block.device)
    return (k[None, :] + (block.to(torch.int64) * n)[:, None]).reshape(-1) \
        + rng.seed_word(seed)


def _detach(scene: Scene) -> Scene:
    geom = {f.name: getattr(scene, f.name).detach()
            for f in dataclasses.fields(scene)
            if isinstance(getattr(scene, f.name), torch.Tensor)}
    m = scene.materials
    mats = dataclasses.replace(m, **{f.name: getattr(m, f.name).detach()
                                     for f in dataclasses.fields(m)})
    return dataclasses.replace(scene, materials=mats, **geom)


def _image(x, dev) -> torch.Tensor:
    """An image (tensor or array) as a float32 tensor on ``dev``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.detach().to(device=dev, dtype=_F32)


def _inputs(scene: Scene, camera: Camera, g_img):
    """The estimator's scene without autograd, the camera and ``g_img`` on
    the scene's device."""
    scene = _detach(scene)
    return scene, _move(camera, scene.device), _image(g_img, scene.device)


def _probe_jump(scene: Scene, camera: Camera, uv_in, uv_out, ids_in,
                ids_out, sample_id: int, depth: int,
                parity_plane_sign: bool):
    """f_in - f_out [N, 3]: the inside and outside probes traced as one
    wavefront through the real renderer."""
    o = camera.origin
    uv = torch.cat([uv_in, uv_out])
    with torch.no_grad():
        d3 = (camera.lower_left_corner[None, :]
              + uv[:, 0:1] * camera.horizontal[None, :]
              + uv[:, 1:2] * camera.vertical[None, :] - o[None, :])
        # the intersector assumes unit directions
        d3 = d3 / _sqrt(_dot(d3, d3))[:, None]
        o3 = o.expand(d3.shape)
        pack = intersect.pack_scene(scene)
        rad, _ = render_mod.trace_rays(
            scene, pack, o3, d3, _counters(torch.cat([ids_in, ids_out])),
            sample_id, depth, parity_plane_sign)
    n = uv_in.shape[0]
    return rad[:n] - rad[n:]


def _sphere_kinds(scene: Scene):
    return scene.materials.kind[scene.sphere_mat.long()], \
        scene.materials.fuzz[scene.sphere_mat.long()]


def _host_nonzero(mask: torch.Tensor):
    return [int(i) for i in torch.nonzero(mask).flatten().tolist()]


def _pairs(firsts, S: int, dev):
    """(first, si) for each first sphere (a host list) and every si."""
    return (torch.tensor(firsts, device=dev).repeat_interleave(S),
            torch.arange(S, device=dev).repeat(len(firsts)))


def _phis(n: int, dev):
    return (torch.arange(n, dtype=_F32, device=dev) + 0.5) * (_TWO_PI / n)


# ---------------------------------------------------------------------------
# primary sphere silhouettes
# ---------------------------------------------------------------------------

def _silhouette_point(eye, c, r, phi):
    """The point at angle ``phi`` on the silhouette circle of sphere (c, r)
    seen from ``eye``, and whether the eye is outside the sphere."""
    w = c - eye
    d2 = _dot(w, w)
    d = _sqrt(_max(d2, 1e-12))
    w_hat = w / d[..., None]
    # any stable orthobasis of the silhouette plane
    y_axis = torch.tensor([0.0, 1.0, 0.0], dtype=_F32, device=c.device)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=_F32, device=c.device)
    up = torch.where((w_hat[..., 1].abs() < 0.9)[..., None], y_axis, x_axis)
    e1 = _cross(up, w_hat)
    e1 = e1 / _sqrt(_max(_dot(e1, e1), 1e-12))[..., None]
    e2 = _cross(w_hat, e1)
    r_abs = r.abs()
    cos_a2 = _max(1.0 - (r_abs * r_abs) / _max(d2, 1e-12), 0.0)
    ring = r_abs * _sqrt(cos_a2)
    p = (c - (r_abs * r_abs / d)[..., None] * w_hat
         + ring[..., None] * (torch.cos(phi)[..., None] * e1
                              + torch.sin(phi)[..., None] * e2))
    return p, d2 > r_abs * r_abs


def _edge_uv(camera: Camera, c, r, phi):
    """Image coordinates (u, v) of the silhouette point of sphere (c, r)
    at angle ``phi``, the ray parameter t, and validity."""
    p, outside = _silhouette_point(camera.origin, c, r, phi)
    u, v, t = _solve_uvt(camera, p)
    return u, v, t, outside


def silhouette_grad(scene: Scene, camera: Camera, g_img, *, width: int,
                    height: int, depth: int,
                    parity_plane_sign: bool = True, seed: int = 0,
                    n_edge: int = 512, delta: float = 5e-4):
    """Boundary-term gradients (d_center [S, 3], d_radius [S]) for an
    image cotangent ``g_img`` [H, W, 3] (dL/d mean-linear-radiance).

    ``n_edge`` silhouette samples per sphere; ``delta`` is the image-space
    offset (in u,v units) of the inside/outside radiance probes.
    """
    scene, camera, g_img = _inputs(scene, camera, g_img)
    dev = scene.device
    S, N = scene.num_spheres, n_edge
    phi = _phis(N, dev).repeat(S)
    c = scene.sphere_center.repeat_interleave(N, 0)
    r = scene.sphere_radius.repeat_interleave(N)

    def uv_of(c_, r_, ph):
        u, v, t, ok = _edge_uv(camera, c_, r_, ph)
        uv = torch.stack([u, v], -1)
        return uv, (uv, t, ok)

    (duv_dc, duv_dr, tan), (uv, t_hit, ok) = _jac(uv_of, (c, r, phi))
    u, v = uv[:, 0], uv[:, 1]
    inside = (_in_unit(u, v) & (t_hit > 0.0) & ok
              & scene.sphere_valid.repeat_interleave(N) & (r.abs() > 1e-6))
    zero = torch.zeros(S, dtype=_F32, device=dev)
    uc, vc, _, _ = _edge_uv(camera, scene.sphere_center, zero, zero)
    centre = torch.stack([uc, vc], -1).repeat_interleave(N, 0)
    tlen, n_hat = _outward(tan, uv - centre)

    # COMMON RANDOM NUMBERS across the in/out pair
    ids = _sample_ids(torch.arange(S, device=dev), N, seed)
    df = _probe_jump(scene, camera, uv - delta * n_hat, uv + delta * n_hat,
                     ids, ids, 0, depth, parity_plane_sign)
    w_scalar = (_g_at(g_img, u, v, width, height) * df).sum(-1)
    meas = tlen * (_TWO_PI / N) / _f32(_a_cell(width, height), dev)
    w_all = torch.where(inside, w_scalar * meas, torch.zeros_like(meas))
    d_c = (w_all[:, None] * _n_dot(n_hat, duv_dc)).reshape(S, N, 3).sum(1)
    d_r = (w_all * _dot2(n_hat, duv_dr)).reshape(S, N).sum(1)
    return d_c, d_r


# ---------------------------------------------------------------------------
# triangle edges
# ---------------------------------------------------------------------------

def _all_edges(T: int, dev):
    tis = torch.arange(T, device=dev).repeat_interleave(3)
    es = torch.arange(3, device=dev).repeat(T)
    return tis, es


def _top(score, n: int):
    """Indices of the ``n`` largest scores along the last axis, lower index
    first among equals (``lax.top_k``'s order)."""
    return torch.sort(score, dim=-1, descending=True, stable=True)[1][..., :n]


def _select_edges(scene: Scene, camera: Camera, g_img, width, height,
                  n_select: int):
    """Cheap importance prepass over ALL 3T edges: score = (in-image) x
    (projected edge length) x (loss-cotangent magnitude at the
    endpoints/midpoint), an upper-bound proxy for the edge's possible
    boundary contribution.  Returns the top ``n_select`` (ti, e) pairs."""
    scene, camera, g_img = _inputs(scene, camera, g_img)
    T = scene.num_triangles
    verts = torch.stack([scene.tri_v0, scene.tri_v1, scene.tri_v2], 1)
    u_all, v_all, t_all = _solve_uvt(camera, verts)        # [T, 3] each
    tis, es = _all_edges(T, scene.device)
    nxt = (es + 1) % 3
    ua, va, ta = u_all[tis, es], v_all[tis, es], t_all[tis, es]
    ub, vb, tb = u_all[tis, nxt], v_all[tis, nxt], t_all[tis, nxt]
    in_img = (_in_unit(ua, va) & _in_unit(ub, vb) & (ta > 0.0) & (tb > 0.0)
              & scene.tri_valid[tis])
    du, dv = ub - ua, vb - va
    length = _sqrt(du * du + dv * dv)

    def g_mag(u, v):
        g = _g_at(g_img, u, v, width, height).abs()
        return g[:, 0] + g[:, 1] + g[:, 2]

    gmag = (g_mag(ua, va) + g_mag(ub, vb)
            + g_mag((ua + ub) * 0.5, (va + vb) * 0.5))
    score = torch.where(in_img, length * gmag, torch.zeros_like(length))
    sel = _top(score, n_select)
    return tis[sel], es[sel]


def _edge_terms(g_img, u, v, ok, tlen, n_hat, duv_dpa, duv_dpb, df, K: int,
                width: int, height: int, sanitize: bool):
    """Per-edge (d_pa, d_pb) [E, 3] of the edge estimators from K samples
    per edge (flattened edge-major); ``sanitize`` zeroes the non-finite
    values of degenerate (mirrored) samples, as the JAX estimator does."""
    if sanitize:
        tlen, df = _fin(tlen), _fin(df)
        duv_dpa, duv_dpb = _fin(duv_dpa), _fin(duv_dpb)
        u, v = _fin(u), _fin(v)
    w = ((_g_at(g_img, u, v, width, height) * df).sum(-1) * tlen
         / _f32(K * _a_cell(width, height), u.device))
    w_all = torch.where(ok, w, torch.zeros_like(w))
    d_pa = (w_all[:, None] * _n_dot(n_hat, duv_dpa)).reshape(-1, K, 3).sum(1)
    d_pb = (w_all[:, None] * _n_dot(n_hat, duv_dpb)).reshape(-1, K, 3).sum(1)
    if sanitize:
        d_pa, d_pb = _fin(d_pa), _fin(d_pb)
    return d_pa, d_pb


def _scatter_vertices(T: int, dev, tis, es, d_pa, d_pb):
    """(d_v0, d_v1, d_v2) [T, 3] from per-edge endpoint gradients."""
    d_v = torch.zeros((T, 3, 3), dtype=_F32, device=dev)
    d_v.index_put_((tis, es), d_pa, accumulate=True)
    d_v.index_put_((tis, (es + 1) % 3), d_pb, accumulate=True)
    return d_v[:, 0], d_v[:, 1], d_v[:, 2]


def _edge_ts(K: int, dev):
    return (torch.arange(K, dtype=_F32, device=dev) + 0.5) / _f32(K, dev)


def triangle_silhouette_grad(scene: Scene, camera: Camera, g_img, *,
                             width: int, height: int, depth: int,
                             parity_plane_sign: bool = True, seed: int = 0,
                             samples_per_edge: int = 8,
                             delta: float = 5e-4,
                             max_edges: int = MAX_EDGE_SAMPLES):
    """Boundary-term vertex gradients (d_v0, d_v1, d_v2 -- each [T, 3]).

    EVERY triangle edge is treated as a visibility boundary of its own
    triangle: the radiance jump measured by the paired probes vanishes on
    edges interior to a smooth surface and at occluded edges, so no
    silhouette classification is needed.  The outward image-space normal
    points away from the projected third vertex.  When 3*T exceeds
    ``max_edges`` the importance prepass (``_select_edges``) picks the top
    edges by their possible contribution.
    """
    scene, camera, g_img = _inputs(scene, camera, g_img)
    dev = scene.device
    T, K = scene.num_triangles, samples_per_edge
    if 3 * T > max_edges:
        tis, es = _select_edges(scene, camera, g_img, width, height,
                                max_edges)
    else:
        tis, es = _all_edges(T, dev)
    verts = torch.stack([scene.tri_v0, scene.tri_v1, scene.tri_v2], 1)
    pa, pb = verts[tis, es], verts[tis, (es + 1) % 3]
    pc = verts[tis, (es + 2) % 3]
    E = tis.shape[0]

    def uv_at(pa_, pb_, t):
        u, v, tt = _solve_uvt(camera, (1.0 - t)[..., None] * pa_
                              + t[..., None] * pb_)
        uv = torch.stack([u, v], -1)
        return uv, (uv, tt)

    (duv_dpa, duv_dpb, tan), (uv, tdist) = _jac(
        uv_at, (pa.repeat_interleave(K, 0), pb.repeat_interleave(K, 0),
                _edge_ts(K, dev).repeat(E)))
    ok = (_in_unit(uv[:, 0], uv[:, 1]) & (tdist > 0.0)
          & scene.tri_valid[tis].repeat_interleave(K))
    uc, vc, _ = _solve_uvt(camera, pc)
    uv_c = torch.stack([uc, vc], -1).repeat_interleave(K, 0)
    tlen, n_hat = _outward(tan, uv - uv_c)
    ids = _sample_ids(tis * 3 + es, K, seed)
    df = _probe_jump(scene, camera, uv - delta * n_hat, uv + delta * n_hat,
                     ids, ids, 0, depth, parity_plane_sign)
    d_pa, d_pb = _edge_terms(g_img, uv[:, 0], uv[:, 1], ok, tlen, n_hat,
                             duv_dpa, duv_dpb, df, K, width, height,
                             sanitize=False)
    return _scatter_vertices(T, dev, tis, es, d_pa, d_pb)


# ---------------------------------------------------------------------------
# one-bounce specular (mirror) silhouettes
# ---------------------------------------------------------------------------

def _mirror_mask(scene: Scene):
    kinds, fuzz = _sphere_kinds(scene)
    return (kinds == 1) & (fuzz == 0.0) & scene.sphere_valid


def _virtual_view(camera: Camera, cm, rm):
    """(o_virt, q, un) of mirrors (cm, |r|): the camera reflected across
    each mirror's camera-facing tangent plane at q, with normal un."""
    o = camera.origin
    um = o - cm
    dm = _sqrt(_max(_dot(um, um), 1e-12))
    un = um / dm[..., None]
    q = cm + rm[..., None] * un
    o_virt = o - (2.0 * _dot(o - q, un))[..., None] * un
    return o_virt, q, un


def _fold_uv(camera: Camera, p, o_virt, q, un):
    """Image (u, v) of the camera ray through the mirror point of the
    segment o' -> p (folded at the tangent plane), and its validity."""
    o = camera.origin
    denom = _dot(p - o_virt, un)
    denom = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9),
                        denom)
    s_par = _dot(q - o_virt, un) / denom
    m = o_virt + s_par[..., None] * (p - o_virt)
    u, v, t = _solve_uvt(camera, m)
    return u, v, (s_par > 0.0) & (s_par < 1.0) & (t > 0.0)


def mirror_silhouette_grad(scene: Scene, camera: Camera, g_img, *,
                           width: int, height: int, depth: int,
                           parity_plane_sign: bool = True, seed: int = 0,
                           n_edge: int = 256, delta: float = 3e-3):
    """ONE-BOUNCE SPECULAR silhouette gradients: the boundary terms of
    sphere silhouettes seen IN A MIRROR (a fuzz=0 metal sphere).

    For each mirror M the camera is reflected across M's tangent plane at
    the point facing the camera to a virtual viewpoint o'; the silhouette
    circle of target sphere S from o' is analytic, and each silhouette
    point maps to the image by folding the virtual ray at the tangent plane
    and solving the camera equation for the mirror point.  Edge velocities
    come from jacfwd of that chain; the radiance jump from paired camera
    probes through the real renderer.  ``delta`` is wider than the primary
    estimator's: the probes must straddle the true reflected edge where
    the tangent-plane curve is off by the mirror's curvature.
    """
    scene, camera, g_img = _inputs(scene, camera, g_img)
    dev = scene.device
    S, N = scene.num_spheres, n_edge
    d_c = torch.zeros((S, 3), dtype=_F32, device=dev)
    d_r = torch.zeros((S,), dtype=_F32, device=dev)
    mirrors = _host_nonzero(_mirror_mask(scene))
    if not mirrors:
        return d_c, d_r
    mis, sis = _pairs(mirrors, S, dev)
    P = mis.shape[0]
    cm = scene.sphere_center[mis]
    rm = scene.sphere_radius[mis].abs()
    c, r = scene.sphere_center[sis], scene.sphere_radius[sis]
    pair_ok = scene.sphere_valid[sis] & (mis != sis) & (r.abs() > 1e-6)
    view = _virtual_view(camera, cm, rm)

    def uv_of(c_, r_, ph, o_virt, q, un):
        # silhouette point of S from the VIRTUAL viewpoint
        p, outside = _silhouette_point(o_virt, c_, r_, ph)
        u, v, ok = _fold_uv(camera, p, o_virt, q, un)
        uv = torch.stack([u, v], -1)
        return uv, (uv, outside & ok)

    rep = [x.repeat_interleave(N, 0) for x in view]
    (duv_dc, duv_dr, tan), (uv, ok) = _jac(
        uv_of, (c.repeat_interleave(N, 0), r.repeat_interleave(N),
                _phis(N, dev).repeat(P)), rep)
    inside = (_in_unit(uv[:, 0], uv[:, 1]) & ok
              & pair_ok.repeat_interleave(N))
    zero = torch.zeros(P, dtype=_F32, device=dev)
    uv_c, _ = uv_of(c, zero, zero, *view)
    tlen, n_hat = _outward(tan, uv - uv_c.repeat_interleave(N, 0))
    # degenerate pairs (self-pair, non-mirror, singular solves) can give
    # non-finite uv / jacobians; masked out, but 0 * nan = nan
    n_hat = _fin(n_hat)
    uvs_safe = _fin(uv)
    # the JAX estimator passes a salt to its probes and ignores it: both
    # probes of a sample share one stream
    ids = _sample_ids(mis * S + sis, N, seed)
    df = _probe_jump(scene, camera, _fin(uv - delta * n_hat),
                     _fin(uv + delta * n_hat), ids, ids, 0, depth,
                     parity_plane_sign)
    g_edge = _g_at(g_img, uvs_safe[:, 0], uvs_safe[:, 1], width, height)
    meas = _fin(tlen) * (_TWO_PI / N) / _f32(_a_cell(width, height), dev)
    w = (g_edge * _fin(df)).sum(-1) * meas
    w_all = torch.where(inside, w, torch.zeros_like(w))
    d_c_p = _fin((w_all[:, None] * _n_dot(n_hat, _fin(duv_dc)))
                 .reshape(P, N, 3).sum(1))
    d_r_p = _fin((w_all * _dot2(n_hat, _fin(duv_dr))).reshape(P, N).sum(1))
    d_c.index_add_(0, sis, d_c_p)
    d_r.index_add_(0, sis, d_r_p)
    return d_c, d_r


def mirror_triangle_silhouette_grad(scene: Scene, camera: Camera, g_img,
                                    *, width: int, height: int, depth: int,
                                    parity_plane_sign: bool = True,
                                    seed: int = 0,
                                    samples_per_edge: int = 8,
                                    delta: float = 3e-3,
                                    max_edges: int = 512,
                                    mirror_idx=None):
    """Mesh-edge boundary terms seen IN A MIRROR: the
    ``mirror_silhouette_grad`` reparameterization (virtual viewpoint o'
    across the fuzz=0 metal sphere's camera-facing tangent plane, image
    mapping by folding at that plane) applied to TRIANGLE edges, so vertex
    gradients land on tri_v0/v1/v2 as in the primary estimator.  Per
    mirror, a virtual-view importance prepass picks the top ``max_edges``
    edges."""
    scene, camera, g_img = _inputs(scene, camera, g_img)
    dev = scene.device
    S, T, K = scene.num_spheres, scene.num_triangles, samples_per_edge
    mask = _mirror_mask(scene).tolist()
    # a sphere that is no mirror adds exactly zero: it is not built
    mirrors = [int(mi) for mi in (range(S) if mirror_idx is None
                                  else mirror_idx) if mask[int(mi)]]
    if not mirrors or T == 0:
        return tuple(torch.zeros((T, 3), dtype=_F32, device=dev)
                     for _ in range(3))
    M = len(mirrors)
    mi_t = torch.tensor(mirrors, device=dev)
    o_virt, q, un = _virtual_view(camera, scene.sphere_center[mi_t],
                                  scene.sphere_radius[mi_t].abs())

    # virtual-view importance prepass (same scoring as _select_edges)
    verts = torch.stack([scene.tri_v0, scene.tri_v1, scene.tri_v2], 1)
    pv = [x[:, None, None, :] for x in (o_virt, q, un)]
    u_all, v_all, ok_all = _fold_uv(camera, verts[None], *pv)   # [M, T, 3]
    tis_a, es_a = _all_edges(T, dev)
    nxt = (es_a + 1) % 3
    ua, va = u_all[:, tis_a, es_a], v_all[:, tis_a, es_a]
    ub, vb = u_all[:, tis_a, nxt], v_all[:, tis_a, nxt]
    in_img = ((_fin(ua) == ua) & (_fin(va) == va)
              & (_fin(ub) == ub) & (_fin(vb) == vb))
    in_img = in_img & (_in_unit(ua, va) & _in_unit(ub, vb)
                       & ok_all[:, tis_a, es_a] & ok_all[:, tis_a, nxt]
                       & scene.tri_valid[tis_a])
    g = _g_at(g_img, ua, va, width, height).abs()
    gmag = g[..., 0] + g[..., 1] + g[..., 2]
    du, dv = _fin(ub - ua), _fin(vb - va)
    length = _sqrt(du * du + dv * dv)
    score = torch.where(in_img, length * (gmag + 1e-6),
                        torch.zeros_like(length))
    n_sel = min(max_edges, 3 * T)
    sel = _top(score, n_sel)                                  # [M, n_sel]
    tis, es = tis_a[sel].reshape(-1), es_a[sel].reshape(-1)
    pa, pb = verts[tis, es], verts[tis, (es + 1) % 3]
    pc = verts[tis, (es + 2) % 3]
    E = M * n_sel
    view = [x.repeat_interleave(n_sel, 0) for x in (o_virt, q, un)]

    def uv_at(pa_, pb_, t, o_v, q_, un_):
        u, v, okp = _fold_uv(camera, (1.0 - t)[..., None] * pa_
                             + t[..., None] * pb_, o_v, q_, un_)
        uv = torch.stack([u, v], -1)
        return uv, (uv, okp)

    (duv_dpa, duv_dpb, tan), (uv, okp) = _jac(
        uv_at, (pa.repeat_interleave(K, 0), pb.repeat_interleave(K, 0),
                _edge_ts(K, dev).repeat(E)),
        [x.repeat_interleave(K, 0) for x in view])
    ok = (_in_unit(uv[:, 0], uv[:, 1]) & okp
          & scene.tri_valid[tis].repeat_interleave(K))
    uc, vc, _ = _fold_uv(camera, pc, *view)
    uv_c = torch.stack([uc, vc], -1).repeat_interleave(K, 0)
    tlen, n_hat = _outward(tan, uv - uv_c)
    n_hat = _fin(n_hat)
    ids = _sample_ids(mi_t.repeat_interleave(n_sel) * (3 * T) + tis * 3 + es,
                      K, seed)
    df = _probe_jump(scene, camera, _fin(uv - delta * n_hat),
                     _fin(uv + delta * n_hat), ids, ids + _SALT_MIRROR_TRI,
                     0, depth, parity_plane_sign)
    d_pa, d_pb = _edge_terms(g_img, uv[:, 0], uv[:, 1], ok, tlen, n_hat,
                             duv_dpa, duv_dpb, df, K, width, height,
                             sanitize=True)
    return _scatter_vertices(T, dev, tis, es, d_pa, d_pb)


# ---------------------------------------------------------------------------
# silhouettes seen through glass
# ---------------------------------------------------------------------------

def _glass_f(camera: Camera, uv, cs, rs, cg, rg, irg):
    """f(u, v) = |closest approach of the exit ray to cs| - rs along the
    camera -> glass -> target refraction chain (the renderer's dielectric
    rule); behind the exit point there is no silhouette (masked via
    +rs)."""
    o = camera.origin

    def hit_t(po, pd, c, r, far):
        oc = po - c
        hb = _dot(oc, pd)
        cc = _dot(oc, oc) - r * r
        disc = hb * hb - cc
        sq = _sqrt(_max(disc, 1e-12))
        return (-hb + sq) if far else (-hb - sq)

    def refract(d, p, c, r):
        n = (p - c) / r[..., None]
        n = n / _sqrt(_max(_dot(n, n), 1e-12))[..., None]
        inside = _dot(d, n) >= 0.0
        n_eff = torch.where(inside, -1.0, 1.0)[..., None] * n
        ratio = torch.where(inside, 1.0 / irg, irg)
        cos_t = _dot(-d, n_eff)
        r_perp = ratio[..., None] * (d + cos_t[..., None] * n_eff)
        r_par = -_sqrt((1.0 - _dot(r_perp, r_perp)).abs())[..., None] * n_eff
        out = r_perp + r_par
        return out / _sqrt(_max(_dot(out, out), 1e-12))[..., None]

    d = (camera.lower_left_corner + uv[..., 0:1] * camera.horizontal
         + uv[..., 1:2] * camera.vertical - o)
    d = d / _sqrt(_max(_dot(d, d), 1e-12))[..., None]
    t1 = hit_t(o, d, cg, rg, far=False)
    p1 = o + t1[..., None] * d
    d1 = refract(d, p1, cg, rg)
    t2 = hit_t(p1, d1, cg, rg, far=True)
    p2 = p1 + t2[..., None] * d1
    d2 = refract(d1, p2, cg, rg)
    w = cs - p2
    along = _dot(w, d2)
    miss = _sqrt(_max(_dot(w, w) - along * along, 1e-12))
    return torch.where(along > 0.0, miss - rs, miss + rs + 1.0)


def glass_silhouette_grad(scene: Scene, camera: Camera, g_img, *,
                          width: int, height: int, depth: int,
                          parity_plane_sign: bool = True, seed: int = 0,
                          n_edge: int = 128, delta: float = 3e-3):
    """Silhouette gradients of a sphere seen THROUGH the always-refract
    dielectric.

    The reference dielectric never branches, so the camera -> glass ->
    target ray map is a deterministic analytic chain, and the
    through-glass silhouette of target sphere (cs, rs) is the zero level
    set of f(u, v; theta) (``_glass_f``).  Boundary points come from radial
    bisection of f around the glass disk centre; their velocities from the
    implicit function theorem,

        velocity . n_hat = -(df/dtheta) / |grad_uv f|,

    with the curve measure from the same implicit derivative along phi, and
    the radiance jump from paired probes through the real renderer.  Scope:
    one glass interface pair on the chain (camera -> G -> S), the root
    search radial around G's image centre.
    """
    scene, camera, g_img = _inputs(scene, camera, g_img)
    dev = scene.device
    S, N = scene.num_spheres, n_edge
    d_c = torch.zeros((S, 3), dtype=_F32, device=dev)
    d_r = torch.zeros((S,), dtype=_F32, device=dev)
    kinds, _ = _sphere_kinds(scene)
    glasses = _host_nonzero((kinds == 2) & scene.sphere_valid)
    if not glasses:
        return d_c, d_r
    irs = scene.materials.ir[scene.sphere_mat.long()]
    gis, sis = _pairs(glasses, S, dev)
    P = gis.shape[0]
    cg, rg, irg = (scene.sphere_center[gis], scene.sphere_radius[gis].abs(),
                   irs[gis])
    cs, rs = scene.sphere_center[sis], scene.sphere_radius[sis].abs()
    pair_ok = scene.sphere_valid[sis] & (gis != sis) & (rs > 1e-6)
    # glass disk centre in the image, and the radial span: G's own
    # silhouette radius in uv
    u0, v0, t0 = _solve_uvt(camera, cg)
    og = cg - camera.origin
    dg = _sqrt(_max(_dot(og, og), 1e-12))
    span = rg / _max(dg, 1e-6) * _max(t0, 1e-6)

    def rep(x):
        return x.repeat_interleave(N, 0)

    cg, rg, irg, cs, rs, span = map(rep, (cg, rg, irg, cs, rs, span))
    uv0 = rep(torch.stack([u0, v0], -1))
    ph = _phis(N, dev).repeat(P)
    e = torch.stack([torch.cos(ph), torch.sin(ph)], -1)

    def fs(s):
        return _glass_f(camera, uv0 + s[:, None] * e, cs, rs, cg, rg, irg)

    # bisection: f < 0 at the centre ray (target visible through the
    # lens), f > 0 at the glass rim
    found = fs(torch.zeros_like(span)) < 0.0
    lo, hi = torch.zeros_like(span), torch.ones_like(span)
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        neg = fs(mid * span) < 0.0
        lo, hi = torch.where(neg, mid, lo), torch.where(neg, hi, mid)
    s_root = 0.5 * (lo + hi) * span
    uv = uv0 + s_root[:, None] * e
    # reject rays where bisection never bracketed a crossing
    found = found & (fs(s_root).abs() < 0.05)

    # implicit-function gradients at the root
    g_uv, d_cs, d_rs, d_cg, d_rg = vmap(func_grad(
        lambda *a: _glass_f(camera, *a), argnums=(0, 1, 2, 3, 4)))(
            uv, cs, rs, cg, rg, irg)
    gnorm = _sqrt(_max(_dot2(g_uv, g_uv), 1e-12))
    n_hat = g_uv / gnorm[:, None]
    # curve tangent from the implicit derivative along phi
    e_perp = torch.stack([-e[:, 1], e[:, 0]], -1)
    dg_ds = _dot2(g_uv, e)
    dg_dphi = _dot2(g_uv, s_root[:, None] * e_perp)
    ds_dphi = -dg_dphi / torch.where(dg_ds.abs() < 1e-9,
                                     torch.full_like(dg_ds, 1e-9), dg_ds)
    tangent = ds_dphi[:, None] * e + s_root[:, None] * e_perp
    tlen = _sqrt(_max(_dot2(tangent, tangent), 1e-20))
    ok = found & _in_unit(uv[:, 0], uv[:, 1]) & rep(pair_ok)
    dtheta = torch.stack([d_cs[:, 0], d_cs[:, 1], d_cs[:, 2], d_rs,
                          d_cg[:, 0], d_cg[:, 1], d_cg[:, 2], d_rg], -1)

    # f increases outward (outside = miss): f_in at uv - delta * n_hat
    ids = _sample_ids(gis * S + sis, N, seed)
    df = _probe_jump(scene, camera, _fin(uv - delta * n_hat),
                     _fin(uv + delta * n_hat), ids, ids + _SALT_GLASS, 1,
                     depth, parity_plane_sign)
    g_edge = _g_at(g_img, _fin(uv[:, 0]), _fin(uv[:, 1]), width, height)
    meas = _fin(tlen) * (_TWO_PI / N) / _f32(_a_cell(width, height), dev)
    w = (g_edge * _fin(df)).sum(-1) * meas
    w_all = torch.where(ok, w, torch.zeros_like(w))
    # boundary velocity along n_hat per unit theta: -(df/dtheta) / |gf|
    vel = -_fin(dtheta) / _max(gnorm, 1e-9)[:, None]
    contrib = (w_all[:, None] * vel).reshape(P, N, 8).sum(1)
    d_c.index_add_(0, sis, contrib[:, 0:3])
    d_r.index_add_(0, sis, contrib[:, 3])
    d_c.index_add_(0, gis, contrib[:, 4:7])
    d_r.index_add_(0, gis, contrib[:, 7])
    return d_c, d_r


# ---------------------------------------------------------------------------
# the loss with boundary terms
# ---------------------------------------------------------------------------

def _interior(scene: Scene, camera: Camera, target, params, *, width: int,
              height: int, samples_per_pixel: int, depth: int,
              parity_plane_sign: bool, seed: int):
    """(loss, image, interior grads): autograd through the wavefront
    renderer, the JAX package's XLA ``render_linear`` under
    ``jax.value_and_grad``."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        img, _ = render_mod.render_linear(
            apply_params(scene, p), camera, width=width, height=height,
            samples_per_pixel=samples_per_pixel, depth=depth,
            parity_plane_sign=parity_plane_sign, seed=seed)
        loss = image_loss(img, target)
        gs = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(p.items(), gs)}
    return loss.detach(), img.detach(), grads


def _loss_and_grad(scene, camera, target, params, param_keys, *, width,
                   height, samples_per_pixel, depth, parity_plane_sign,
                   seed, n_edge, samples_per_edge,
                   max_edges=MAX_EDGE_SAMPLES, mirror_pairs=True,
                   mirror_idx=(), glass_pairs=False):
    loss, img, grads = _interior(
        scene, camera, target, params, width=width, height=height,
        samples_per_pixel=samples_per_pixel, depth=depth,
        parity_plane_sign=parity_plane_sign, seed=seed)
    g_img = 2.0 * (img - target) / _f32(float(img.numel()), img.device)
    s_now = apply_params(scene, {k: v.detach() for k, v in params.items()})
    shape = dict(width=width, height=height, depth=depth,
                 parity_plane_sign=parity_plane_sign)
    if "sphere_center" in param_keys or "sphere_radius" in param_keys:
        d_c, d_r = silhouette_grad(s_now, camera, g_img, seed=seed + 7919,
                                   n_edge=n_edge, **shape)
        if scene.num_spheres <= 32 and mirror_pairs:
            # one-bounce mirror silhouettes (S*S pair sweep, gated to
            # FFI/default-world-class sphere counts and on the scene
            # holding a fuzz=0 metal sphere)
            d_cm, d_rm = mirror_silhouette_grad(
                s_now, camera, g_img, seed=seed + 15485863,
                n_edge=max(n_edge // 2, 64), **shape)
            d_c = d_c + d_cm
            d_r = d_r + d_rm
        if glass_pairs and scene.num_spheres <= 16:
            # through-glass boundary terms (gated on a dielectric sphere)
            d_cg, d_rg = glass_silhouette_grad(
                s_now, camera, g_img, seed=seed + 32452843,
                n_edge=max(n_edge // 4, 64), **shape)
            d_c = d_c + d_cg
            d_r = d_r + d_rg
        if "sphere_center" in param_keys:
            grads["sphere_center"] = grads["sphere_center"] + d_c
        if "sphere_radius" in param_keys:
            grads["sphere_radius"] = grads["sphere_radius"] + d_r
    tri_keys = [k for k in ("tri_v0", "tri_v1", "tri_v2")
                if k in param_keys]
    if tri_keys and scene.num_triangles > 0:
        dv = triangle_silhouette_grad(
            s_now, camera, g_img, seed=seed + 104729,
            samples_per_edge=samples_per_edge, max_edges=max_edges, **shape)
        if mirror_idx:
            # mesh edges seen in each fuzz=0 mirror (index list from the
            # host gate)
            mv = mirror_triangle_silhouette_grad(
                s_now, camera, g_img, seed=seed + 49979687,
                samples_per_edge=samples_per_edge,
                max_edges=min(max_edges, 512), mirror_idx=mirror_idx,
                **shape)
            dv = tuple(a + b for a, b in zip(dv, mv))
        for k, d in zip(("tri_v0", "tri_v1", "tri_v2"), dv):
            if k in param_keys:
                grads[k] = grads[k] + d
    return loss, grads


def value_and_grad_with_silhouette(
        scene: Scene, camera: Camera, target, params: Mapping[str,
                                                              torch.Tensor],
        *, width: int, height: int, samples_per_pixel: int, depth: int,
        parity_plane_sign: bool = True, seed: int = 0, n_edge: int = 512,
        samples_per_edge: int = 16, max_edges: int = MAX_EDGE_SAMPLES,
        device="cuda") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, grads) for the UNMASKED MSE image loss: interior gradients by
    autograd plus the silhouette boundary terms -- the sphere-circle
    estimator for sphere_center / sphere_radius (with the mirror and glass
    terms where the scene holds a fuzz-0 mirror or a dielectric) and the
    triangle edge estimator for tri_v0/v1/v2 (with mirrored edges).

    Runs on ``device`` (default ``"cuda"``): the scene, camera, target and
    params move there, and a CUDA device without a GPU raises rather than
    fall back to the CPU.  The grads are detached tensors on ``device``."""
    device = _device(device)
    kinds, fuzz = (x.cpu().numpy() for x in _sphere_kinds(scene))
    valid = scene.sphere_valid.cpu().numpy()
    mirrors = (kinds == 1) & (fuzz == 0.0) & valid
    mirror_idx = tuple(int(i) for i in np.nonzero(mirrors)[0][:4])
    scene, camera = _move(scene, device), _move(camera, device)
    target = _image(target, device)
    params = {k: v.detach().to(device) for k, v in params.items()}
    return _loss_and_grad(
        scene, camera, target, params, tuple(sorted(params)),
        width=width, height=height, samples_per_pixel=samples_per_pixel,
        depth=depth, parity_plane_sign=parity_plane_sign, seed=seed,
        n_edge=n_edge, samples_per_edge=samples_per_edge,
        mirror_pairs=bool(mirrors.any()), mirror_idx=mirror_idx,
        glass_pairs=bool(((kinds == 2) & valid).any()), max_edges=max_edges)
