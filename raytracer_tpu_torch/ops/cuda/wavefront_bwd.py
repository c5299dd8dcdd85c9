"""K5, the backward render kernel: CUDA wrapper, plain version and the
per-primitive winner reduction.

``render_grad_cuda`` launches the hand-written CUDA kernel in
``raytracer_tpu_torch/csrc/wavefront_bwd.cu``, which replaces the TPU kernel
``raytracer_tpu/ops/pallas/wavefront_bwd.py`` ``render_grad_pallas`` /
``_make_bwd_kernel``: the adjoint of K1's path trace.  Per pixel and sample
it re-traces the path storing 22 residual planes per bounce, then sweeps
the bounces in reverse propagating the image cotangent by hand (implicit
``dt`` for spheres, direct ``dt`` for triangles under either plane sign,
the normalize, diffuse, metal, dielectric and sky adjoints, and the camera
adjoint).  It writes, per bounce and lane, the winner's id and 9 gradients
(a "slab"), and per lane the 12 camera cotangents summed over the samples.

``render_grad_ref`` is the plain PyTorch version: vectorised over lanes,
a list of per-bounce residual tensors and a reversed loop, in the kernel's
operation order.  It divides by device tensors, never by Python scalars
(PyTorch's CUDA divide-by-scalar multiplies by the reciprocal), so on the
card it agrees with the kernel to rounding.  The wrapper uses it only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts the wrapper's kernel launches.

The reduction from lanes to primitives (``_winner_reduce``) is plain
PyTorch, as it was XLA glue outside the Pallas kernel: a scatter-add by
winner id into one row per primitive plus a dump row for dead lanes, never
a (lanes x primitives) one-hot.  On the card ``index_add_`` adds with
atomics in float64, so its float32 sums may differ by one ulp from run to
run; the camera cotangents are summed by ``torch.sum`` over the per-lane
buffer and are the same from run to run.

Arguments of both (the keywords of ``render_grad_pallas``): sph
(SPH_ROWS, S), tri (TRI_ROWS, T), cam_vec (12,) and tri_clusters as for K1
(spheres are always scanned flat: the differentiable path packs them
without a permutation); g_image [shard_rows, W, 3] f32, the cotangent of
K1's mean image; shard_rows / row_offset / row_stride as for K1.  Returns
(dsph (9, S): rows cx, cy, cz, r, albedo rgb, fuzz, ir -- r's is the total
derivative, so the table's r^2 row takes none; dtri (TRI_ROWS, T): the
cotangent of the packed table, zero on the edge-constant and kind rows,
d_fuzz + d_ir on the EXTRA row; dcam (12,) matching ``tables.camera_vec``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tables
from ... import rng
from . import wavefront as wf

__all__ = ["LAUNCHES", "MAX_DEPTH", "GRAD_PLANES", "SPH_GRAD_ROWS",
           "render_grad_cuda",
           "render_grad_ref", "grad_slab_cuda", "grad_slab_ref",
           "reduce_slab"]

LAUNCHES = 0

# The kernel keeps its residuals in a per-thread array of MAX_DEPTH
# bounces; deeper paths raise instead of being cut.
MAX_DEPTH = 16

# per-lane slab planes per bounce: winner id, then 9 gradients.  C1..C3/R
# are centre/radius for sphere winners, plane normal/plane d for triangle
# winners; FZ/IR go to the triangle EXTRA row by winner kind.
(GP_WIN, GP_C1, GP_C2, GP_C3, GP_R, GP_AR, GP_AG, GP_AB, GP_FZ,
 GP_IR) = range(10)
GRAD_PLANES = 10

_F32 = torch.float32
BIG = wf.BIG
T_MIN = wf.T_MIN
EPS8 = wf.EPS8
SKY_G = wf.SKY_G
EPS12 = float(np.float32(1e-12))
HUGE = float(np.float32(1e30))


def _check_grad_inputs(sph, tri, g_image, cam_vec, tri_clusters, **kw):
    shard_rows = wf._check_inputs(sph, tri, cam_vec, None, tri_clusters,
                                  **kw)
    if kw["depth"] > MAX_DEPTH:
        raise ValueError(f"K5 keeps at most MAX_DEPTH={MAX_DEPTH} bounces "
                         f"of residuals, got depth={kw['depth']}")
    want = (shard_rows, kw["width"], 3)
    if not isinstance(g_image, torch.Tensor) or g_image.dtype != _F32 \
            or tuple(g_image.shape) != want \
            or g_image.device != sph.device \
            or not g_image.is_contiguous():
        raise ValueError(f"g_image must be a contiguous float32 tensor of "
                         f"shape {want} on {sph.device}")
    return shard_rows


def render_grad_cuda(sph, tri, g_image, cam_vec, *, width, height,
                     samples_per_pixel, depth, seed=0,
                     parity_plane_sign=True, tri_clusters=None,
                     shard_rows=None, row_offset=0, row_stride=1):
    """(dsph, dtri, dcam) through K5 (the plain version for CPU
    tensors)."""
    slab, cam_lanes = grad_slab_cuda(
        sph, tri, g_image, cam_vec, width=width, height=height,
        samples_per_pixel=samples_per_pixel, depth=depth, seed=seed,
        parity_plane_sign=parity_plane_sign, tri_clusters=tri_clusters,
        shard_rows=shard_rows, row_offset=row_offset, row_stride=row_stride)
    return reduce_slab(slab, cam_lanes, sph.shape[1], tri.shape[1])


def render_grad_ref(sph, tri, g_image, cam_vec, *, width, height,
                    samples_per_pixel, depth, seed=0,
                    parity_plane_sign=True, tri_clusters=None,
                    shard_rows=None, row_offset=0, row_stride=1):
    """K5's plain PyTorch version: same arguments and results as
    ``render_grad_cuda``, on whatever device the tensors are."""
    slab, cam_lanes = grad_slab_ref(
        sph, tri, g_image, cam_vec, width=width, height=height,
        samples_per_pixel=samples_per_pixel, depth=depth, seed=seed,
        parity_plane_sign=parity_plane_sign, tri_clusters=tri_clusters,
        shard_rows=shard_rows, row_offset=row_offset, row_stride=row_stride)
    return reduce_slab(slab, cam_lanes, sph.shape[1], tri.shape[1])


def grad_slab_cuda(sph, tri, g_image, cam_vec, *, width, height,
                   samples_per_pixel, depth, seed=0, parity_plane_sign=True,
                   tri_clusters=None, shard_rows=None, row_offset=0,
                   row_stride=1):
    """K5 itself: (slab [spp, depth, GRAD_PLANES, shard_rows, W] f32,
    cam_lanes [12, shard_rows, W] f32).  Dead lanes have winner id -1."""
    global LAUNCHES
    kw = dict(width=width, height=height,
              samples_per_pixel=samples_per_pixel, depth=depth,
              parity_plane_sign=parity_plane_sign, shard_rows=shard_rows,
              row_offset=row_offset, row_stride=row_stride)
    if sph.device.type == "cpu":
        return grad_slab_ref(sph, tri, g_image, cam_vec, seed=seed,
                             tri_clusters=tri_clusters, **kw)
    if sph.device.type != "cuda":
        raise ValueError(f"K5 runs on CUDA tensors, got {sph.device}")
    shard_rows = _check_grad_inputs(sph, tri, g_image, cam_vec,
                                    tri_clusters, **kw)
    from . import build
    lib = build.load()
    device = sph.device
    slab = torch.empty((samples_per_pixel, depth, GRAD_PLANES, shard_rows,
                        width), dtype=_F32, device=device)
    cam_lanes = torch.empty((12, shard_rows, width), dtype=_F32,
                            device=device)
    tric_b, tric_r = tri_clusters if tri_clusters is not None else (None,
                                                                    None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        rc = lib.rt_wavefront_grad(
            ptr(sph), sph.shape[1], ptr(tri), tri.shape[1], ptr(cam_vec),
            ptr(tric_b), ptr(tric_r), 0 if tric_b is None else tric_b.shape[1],
            ptr(g_image), ptr(slab), ptr(cam_lanes), width, height,
            rng.seed_word(seed), row_offset, row_stride, shard_rows,
            samples_per_pixel, depth, wf._inv_spp(samples_per_pixel),
            int(bool(parity_plane_sign)),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K5 (rt_wavefront_grad) launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 1
    return slab, cam_lanes


# ---------------------------------------------------------------------------
# Winner reduction
# ---------------------------------------------------------------------------

def _winner_reduce(w: torch.Tensor, vals: torch.Tensor, n_targets: int
                   ) -> torch.Tensor:
    """Sum the rows of ``vals`` [L, K] by id ``w`` [L] (-1: none) into
    (n_targets, K): a scatter-add into one row per target plus a dump row,
    O(L K) work and memory whatever the target count.  It accumulates in
    float64, so the order of the card's atomics moves the float32 result
    by at most one ulp."""
    wc = torch.where(w >= 0, w, n_targets).to(torch.int64)
    acc = torch.zeros((n_targets + 1, vals.shape[1]), dtype=torch.float64,
                      device=vals.device)
    acc.index_add_(0, wc, vals.to(torch.float64))
    return acc[:n_targets].to(vals.dtype)


# sphere table rows of dsph's 9 rows; r^2 and kind take no cotangent
SPH_GRAD_ROWS = [tables.SPH_CX, tables.SPH_CY, tables.SPH_CZ, tables.SPH_R,
                  tables.SPH_AR, tables.SPH_AG, tables.SPH_AB,
                  tables.SPH_FUZZ, tables.SPH_IR]


def reduce_slab(slab, cam_lanes, n_spheres: int, n_tris: int):
    """(dsph (9, S), dtri (TRI_ROWS, T), dcam (12,)) from K5's outputs:
    slab ids < S are spheres, S + k the packed triangle column k."""
    S, T = n_spheres, n_tris
    lanes = slab.permute(2, 0, 1, 3, 4).reshape(GRAD_PLANES, -1)
    total = _winner_reduce(lanes[GP_WIN].to(torch.int64), lanes[1:].T,
                           S + T)
    dsph = total[:S].T.contiguous()
    acc = total[S:]
    dtri = torch.zeros((tables.TRI_ROWS, T), dtype=_F32, device=slab.device)
    dtri[[tables.TRI_NX, tables.TRI_NY, tables.TRI_NZ, tables.TRI_D]] = \
        acc[:, 0:4].T
    dtri[tables.TRI_EXTRA] = acc[:, 7] + acc[:, 8]
    dtri[[tables.TRI_AR, tables.TRI_AG, tables.TRI_AB]] = acc[:, 4:7].T
    return dsph, dtri, cam_lanes.reshape(12, -1).sum(dim=1)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

# residual planes per bounce (wavefront_bwd.py:68-75).  For sphere winners
# CX..CZ hold the centre and R the radius; for triangle winners the PLANE
# normal and the plane d.
(RS_OX, RS_OY, RS_OZ, RS_DX, RS_DY, RS_DZ, RS_TPR, RS_TPG, RS_TPB, RS_T,
 RS_WIN, RS_ALIVE, RS_CX, RS_CY, RS_CZ, RS_R, RS_KIND, RS_AR, RS_AG, RS_AB,
 RS_FZ, RS_IR) = range(22)

# hit state of the forward sweep: K1's ten slots, then the winner id and
# the radius (sphere) or plane d (triangle)
_H_WIN, _H_R = 10, 11


def _sphere_step(col, ray, h, mask):
    """K1's sphere step, also tracking the winner id and radius."""
    cx, cy, cz, r, r2, kind, ar, ag, ab, fz, ir, win = col
    if not r2 > 0.0:        # padding: never hits
        return
    ox, oy, oz, dx, dy, dz = ray
    ocx = ox - cx
    ocy = oy - cy
    ocz = oz - cz
    half_b = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r2
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
    for k, val in enumerate((t, cx, cy, cz, kind, ar, ag, ab, fz, ir, win,
                             r)):
        h[k] = torch.where(better, val, h[k])


def _tri_step(col, ray, h, parity_plane_sign, mask):
    """K1's triangle step, tracking the winner id and plane d and keeping
    the raw kind (the id tells triangles from spheres)."""
    tnx, tny, tnz, td = col[:4]
    if tnx == 0.0 and tny == 0.0 and tnz == 0.0:   # padding: parallel
        return
    ox, oy, oz, dx, dy, dz = ray
    nd = tnx * dx + tny * dy + tnz * dz
    no = tnx * ox + tny * oy + tnz * oz
    par = nd.abs() < EPS8
    nd_safe = torch.where(par, 1.0, nd)
    if parity_plane_sign:
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
    tkind, textra, tar, tag, tab, win = col[16:22]
    fz = textra if 0.5 <= tkind < 1.5 else 0.0
    ir = textra if 1.5 <= tkind < 2.5 else 1.0
    for k, val in enumerate((t, tnx, tny, tnz, tkind, tar, tag, tab, fz, ir,
                             win, td)):
        h[k] = torch.where(better, val, h[k])


def _shade_fwd(res, rx, ry, rz, S):
    """Next ray of the forward sweep (wavefront_bwd.py:343-446): the
    residuals of one bounce -> (cont, hit point, new direction, colour)."""
    (ox, oy, oz, dx, dy, dz, tpr, tpg, tpb, t_best, win, alive_f,
     nxc, nyc, nzc, rr, kind, ar, ag, ab, fz, irx) = res
    ones = torch.ones_like(ox)
    is_tri = win >= float(S) - 0.5
    hit = t_best < BIG
    hpx = torch.where(hit, ox + t_best * dx, ox)
    hpy = torch.where(hit, oy + t_best * dy, oy)
    hpz = torch.where(hit, oz + t_best * dz, oz)
    neg_r = kind >= 3.5
    sgn = torch.where(neg_r, -1.0, 1.0)
    kind = torch.where(neg_r, kind - 4.0, kind)
    snx = hpx - nxc
    sny = hpy - nyc
    snz = hpz - nzc
    slen = torch.sqrt(snx * snx + sny * sny + snz * snz)
    slen = torch.where(slen == 0.0, 1.0, slen) * sgn
    tln = torch.sqrt(nxc * nxc + nyc * nyc + nzc * nzc)
    tln = torch.where(tln == 0.0, 1.0, tln)
    nx = torch.where(is_tri, nxc / tln, snx / slen)
    ny = torch.where(is_tri, nyc / tln, sny / slen)
    nz = torch.where(is_tri, nzc / tln, snz / slen)

    sdx = nx + rx
    sdy = ny + ry
    sdz = nz + rz
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

    inside = dn >= 0.0
    sgn2 = torch.where(inside, -1.0, 1.0)
    nex, ney, nez = sgn2 * nx, sgn2 * ny, sgn2 * nz
    ratio = torch.where(inside, ones / irx, irx)
    cos_t = -(dx * nex + dy * ney + dz * nez)
    px = ratio * (dx + cos_t * nex)
    py = ratio * (dy + cos_t * ney)
    pz = ratio * (dz + cos_t * nez)
    pl2 = px * px + py * py + pz * pz
    para = -torch.sqrt((1.0 - pl2).abs())
    qx, qy, qz = px + para * nex, py + para * ney, pz + para * nez
    ql = torch.sqrt(qx * qx + qy * qy + qz * qz)
    ql = torch.where(ql == 0.0, 1.0, ql)

    is_dif = kind < 0.5
    is_met = (kind >= 0.5) & (kind < 1.5)
    is_die = (kind >= 1.5) & (kind < 2.5)
    is_emi = kind >= 2.5

    def pick(dif, met, die, nrm):
        return torch.where(is_dif, dif, torch.where(
            is_met, met, torch.where(is_die, die, nrm)))

    nd = (pick(difx, mx / ml, qx / ql, nx), pick(dify, my / ml, qy / ql, ny),
          pick(difz, mz / ml, qz / ql, nz))
    sc = (torch.where(is_die, 1.0, ar), torch.where(is_die, 1.0, ag),
          torch.where(is_die, 1.0, ab))
    term = is_emi | (is_met & ~met_keep)
    cont = (alive_f > 0.5) & hit & ~term
    return cont, (hpx, hpy, hpz), nd, sc


def _adjoint_step(res, adj, grads, rx, ry, rz, S, parity_plane_sign):
    """One bounce of the backward sweep (wavefront_bwd.py:457-820): the
    adjoints of the bounce's outgoing ray state -> those of its incoming
    state, and the winner's 9 gradients and id."""
    (ox, oy, oz, dx, dy, dz, tpr, tpg, tpb, t_best, win, alive_f,
     cxw, cyw, czw, rw, kind, ar, ag, ab, fz, irx) = res
    (a_ox, a_oy, a_oz, a_dx, a_dy, a_dz, a_tr, a_tg, a_tb) = adj
    gr, gg, gb = grads
    ones = torch.ones_like(ox)
    alive = alive_f > 0.5
    is_tri = win >= float(S) - 0.5
    trif = torch.where(is_tri, 1.0, 0.0)
    sphfm = 1.0 - trif
    hit = t_best < BIG
    t_s = torch.where(hit, t_best, 0.0)
    hpx = ox + t_s * dx
    hpy = oy + t_s * dy
    hpz = oz + t_s * dz
    neg_r = kind >= 3.5
    sgn = torch.where(neg_r, -1.0, 1.0)
    kind = torch.where(neg_r, kind - 4.0, kind)
    ux = hpx - cxw
    uy = hpy - cyw
    uz = hpz - czw
    ulen = torch.sqrt(ux * ux + uy * uy + uz * uz)
    ulen = torch.where(ulen == 0.0, 1.0, ulen)
    tln = torch.sqrt(cxw * cxw + cyw * cyw + czw * czw)
    tln = torch.where(tln == 0.0, 1.0, tln)
    tnhx = cxw / tln
    tnhy = cyw / tln
    tnhz = czw / tln
    nx = torch.where(is_tri, tnhx, (ux / ulen) * sgn)
    ny = torch.where(is_tri, tnhy, (uy / ulen) * sgn)
    nz = torch.where(is_tri, tnhz, (uz / ulen) * sgn)

    # diffuse
    sdx = nx + rx
    sdy = ny + ry
    sdz = nz + rz
    deg = (sdx.abs() < EPS8) & (sdy.abs() < EPS8) & (sdz.abs() < EPS8)
    sl = torch.sqrt(sdx * sdx + sdy * sdy + sdz * sdz)
    sl = torch.where(sl == 0.0, 1.0, sl)
    # metal
    dn = dx * nx + dy * ny + dz * nz
    mx = dx - 2.0 * dn * nx + fz * rx
    my = dy - 2.0 * dn * ny + fz * ry
    mz = dz - 2.0 * dn * nz + fz * rz
    met_keep = (mx * nx + my * ny + mz * nz) >= 0.0
    ml = torch.sqrt(mx * mx + my * my + mz * mz)
    ml = torch.where(ml == 0.0, 1.0, ml)
    # dielectric
    inside = dn >= 0.0
    sgn2 = torch.where(inside, -1.0, 1.0)
    nex = sgn2 * nx
    ney = sgn2 * ny
    nez = sgn2 * nz
    ratio = torch.where(inside, ones / irx, irx)
    cos_t = -(dx * nex + dy * ney + dz * nez)
    wx = dx + cos_t * nex
    wy = dy + cos_t * ney
    wz = dz + cos_t * nez
    px = ratio * wx
    py = ratio * wy
    pz = ratio * wz
    pl2 = px * px + py * py + pz * pz
    amag = (1.0 - pl2).abs()
    para = -torch.sqrt(amag)
    qx = px + para * nex
    qy = py + para * ney
    qz = pz + para * nez
    ql = torch.sqrt(qx * qx + qy * qy + qz * qz)
    ql = torch.where(ql == 0.0, 1.0, ql)

    is_dif = kind < 0.5
    is_met = (kind >= 0.5) & (kind < 1.5)
    is_die = (kind >= 1.5) & (kind < 2.5)
    is_emi = kind >= 2.5
    scr = torch.where(is_die, 1.0, ar)
    scg = torch.where(is_die, 1.0, ag)
    scb = torch.where(is_die, 1.0, ab)
    term = is_emi | (is_met & ~met_keep)
    contf = torch.where(alive & hit & ~term, 1.0, 0.0)
    missf = torch.where(alive & ~hit, 1.0, 0.0)
    termf = torch.where(alive & hit & term, 1.0, 0.0)

    # throughput and radiance adjoints
    tsky = 0.5 * (dy + 1.0)
    skyr = 1.0 - tsky * 0.5
    skyg = 1.0 - tsky * SKY_G
    c_r = contf * a_tr * tpr + termf * gr * tpr
    c_g = contf * a_tg * tpg + termf * gg * tpg
    c_b = contf * a_tb * tpb + termf * gb * tpb
    n_tr = (contf * a_tr * scr + (1.0 - contf) * a_tr
            + missf * gr * skyr + termf * gr * scr)
    n_tg = (contf * a_tg * scg + (1.0 - contf) * a_tg
            + missf * gg * skyg + termf * gg * scg)
    n_tb = (contf * a_tb * scb + (1.0 - contf) * a_tb
            + missf * gb + termf * gb * scb)
    diecf = torch.where(is_die, 0.0, 1.0)   # dielectric colour is 1
    g_ar = diecf * c_r
    g_ag = diecf * c_g
    g_ab = diecf * c_b
    # sky: d_bar.y += -0.5 (0.5 skyr_bar + 0.3 skyg_bar)
    sky_r_bar = missf * gr * tpr
    sky_g_bar = missf * gg * tpg
    tsky_bar = -(0.5 * sky_r_bar + SKY_G * sky_g_bar)
    dy_sky = 0.5 * tsky_bar

    # o' = where(cont, p, o); d' = where(cont, nd, d)
    p_bx = contf * a_ox
    p_by = contf * a_oy
    p_bz = contf * a_oz
    n_ox = (1.0 - contf) * a_ox
    n_oy = (1.0 - contf) * a_oy
    n_oz = (1.0 - contf) * a_oz
    nd_bx = contf * a_dx
    nd_by = contf * a_dy
    nd_bz = contf * a_dz
    n_dx = (1.0 - contf) * a_dx
    n_dy = (1.0 - contf) * a_dy + dy_sky
    n_dz = (1.0 - contf) * a_dz

    dif_f = torch.where(is_dif, 1.0, 0.0)
    met_f = torch.where(is_met, 1.0, 0.0)
    die_f = torch.where(is_die, 1.0, 0.0)
    emi_f = torch.where(is_emi, 1.0, 0.0)
    dd_bx = dif_f * nd_bx
    dd_by = dif_f * nd_by
    dd_bz = dif_f * nd_bz
    md_bx = met_f * nd_bx
    md_by = met_f * nd_by
    md_bz = met_f * nd_bz
    ed_bx = die_f * nd_bx
    ed_by = die_f * nd_by
    ed_bz = die_f * nd_bz
    n_nx = emi_f * nd_bx
    n_ny = emi_f * nd_by
    n_nz = emi_f * nd_bz

    # diffuse: sd = where(deg, n, (n + r) / sl)
    degf = torch.where(deg, 1.0, 0.0)
    vhx = sdx / sl
    vhy = sdy / sl
    vhz = sdz / sl
    dotg = vhx * dd_bx + vhy * dd_by + vhz * dd_bz
    vb_x = (dd_bx - vhx * dotg) / sl
    vb_y = (dd_by - vhy * dotg) / sl
    vb_z = (dd_bz - vhz * dotg) / sl
    n_nx = n_nx + (degf * dd_bx + (1.0 - degf) * vb_x)
    n_ny = n_ny + (degf * dd_by + (1.0 - degf) * vb_y)
    n_nz = n_nz + (degf * dd_bz + (1.0 - degf) * vb_z)

    # metal: md = m / ml
    mhx = mx / ml
    mhy = my / ml
    mhz = mz / ml
    dotm = mhx * md_bx + mhy * md_by + mhz * md_bz
    mb_x = (md_bx - mhx * dotm) / ml
    mb_y = (md_by - mhy * dotm) / ml
    mb_z = (md_bz - mhz * dotm) / ml
    g_fz = mb_x * rx + mb_y * ry + mb_z * rz
    n_refl = nx * mb_x + ny * mb_y + nz * mb_z
    n_dx = n_dx + (mb_x - 2.0 * nx * n_refl)
    n_dy = n_dy + (mb_y - 2.0 * ny * n_refl)
    n_dz = n_dz + (mb_z - 2.0 * nz * n_refl)
    n_nx = n_nx + -2.0 * (dx * n_refl + dn * mb_x)
    n_ny = n_ny + -2.0 * (dy * n_refl + dn * mb_y)
    n_nz = n_nz + -2.0 * (dz * n_refl + dn * mb_z)

    # dielectric: dd = q / ql
    qhx = qx / ql
    qhy = qy / ql
    qhz = qz / ql
    dotq = qhx * ed_bx + qhy * ed_by + qhz * ed_bz
    qb_x = (ed_bx - qhx * dotq) / ql
    qb_y = (ed_by - qhy * dotq) / ql
    qb_z = (ed_bz - qhz * dotq) / ql
    para_bar = qb_x * nex + qb_y * ney + qb_z * nez
    ne_bx = para * qb_x
    ne_by = para * qb_y
    ne_bz = para * qb_z
    amag_s = torch.where(amag == 0.0, 1.0, amag)
    sgn_a = torch.where(pl2 <= 1.0, 1.0, -1.0)
    pl2_bar = torch.where(amag == 0.0, 0.0,
                          para_bar * sgn_a / (2.0 * torch.sqrt(amag_s)))
    pb_x = qb_x + 2.0 * pl2_bar * px
    pb_y = qb_y + 2.0 * pl2_bar * py
    pb_z = qb_z + 2.0 * pl2_bar * pz
    ratio_bar = pb_x * wx + pb_y * wy + pb_z * wz
    wb_x = ratio * pb_x
    wb_y = ratio * pb_y
    wb_z = ratio * pb_z
    cos_bar = wb_x * nex + wb_y * ney + wb_z * nez
    ne_bx = ne_bx + cos_t * wb_x
    ne_by = ne_by + cos_t * wb_y
    ne_bz = ne_bz + cos_t * wb_z
    n_dx = n_dx + wb_x
    n_dy = n_dy + wb_y
    n_dz = n_dz + wb_z
    n_dx = n_dx + -cos_bar * nex
    n_dy = n_dy + -cos_bar * ney
    n_dz = n_dz + -cos_bar * nez
    ne_bx = ne_bx + -cos_bar * dx
    ne_by = ne_by + -cos_bar * dy
    ne_bz = ne_bz + -cos_bar * dz
    n_nx = n_nx + sgn2 * ne_bx
    n_ny = n_ny + sgn2 * ne_by
    n_nz = n_nz + sgn2 * ne_bz
    g_ir = ratio_bar * torch.where(inside, -(ones / (irx * irx)), 1.0)

    # normal cotangent by winner type.  Triangle: n = nplane / |nplane|,
    # the normalize adjoint into the plane-normal cotangent
    dotn_t = tnhx * n_nx + tnhy * n_ny + tnhz * n_nz
    gn_nx = trif * (n_nx - tnhx * dotn_t) / tln
    gn_ny = trif * (n_ny - tnhy * dotn_t) / tln
    gn_nz = trif * (n_nz - tnhz * dotn_t) / tln
    # sphere: n = sgn u / |u|, then u = p - c
    n0x = ux / ulen
    n0y = uy / ulen
    n0z = uz / ulen
    nb0x = sgn * n_nx
    nb0y = sgn * n_ny
    nb0z = sgn * n_nz
    dotn = n0x * nb0x + n0y * nb0y + n0z * nb0z
    ub_x = sphfm * (nb0x - n0x * dotn) / ulen
    ub_y = sphfm * (nb0y - n0y * dotn) / ulen
    ub_z = sphfm * (nb0z - n0z * dotn) / ulen
    p_bx = p_bx + ub_x
    p_by = p_by + ub_y
    p_bz = p_bz + ub_z
    g_cx = -ub_x
    g_cy = -ub_y
    g_cz = -ub_z

    # p = o + t d on hit lanes
    hitf = torch.where(hit, 1.0, 0.0)
    n_ox = n_ox + p_bx
    n_oy = n_oy + p_by
    n_oz = n_oz + p_bz
    n_dx = n_dx + hitf * t_s * p_bx
    n_dy = n_dy + hitf * t_s * p_by
    n_dz = n_dz + hitf * t_s * p_bz
    t_bar = hitf * (p_bx * dx + p_by * dy + p_bz * dz)

    # t cotangent, sphere winners: implicit differentiation, grazing
    # hits (u.d -> 0) guard-zeroed
    und = ux * dx + uy * dy + uz * dz
    und = torch.where(und.abs() < EPS12, HUGE, und)
    inv_und = sphfm * t_bar / und
    g_cx = g_cx + ux * inv_und
    g_cy = g_cy + uy * inv_und
    g_cz = g_cz + uz * inv_und
    g_r = rw * inv_und
    n_ox = n_ox + -ux * inv_und
    n_oy = n_oy + -uy * inv_und
    n_oz = n_oz + -uz * inv_und
    n_dx = n_dx + -t_s * ux * inv_und
    n_dy = n_dy + -t_s * uy * inv_und
    n_dz = n_dz + -t_s * uz * inv_und

    # t cotangent, triangle winners: the plane equation
    tnd = cxw * dx + cyw * dy + czw * dz
    tnd = torch.where(tnd.abs() < EPS12, HUGE, tnd)
    inv_tnd = trif * t_bar / tnd
    g_dp = inv_tnd
    # t = (n.o + d_p) / (n.d) under the parity sign, (d_p - n.o) / (n.d)
    dno_bar = inv_tnd if parity_plane_sign else -inv_tnd
    dnd_bar = -t_s * inv_tnd
    g_nx = dno_bar * ox + dnd_bar * dx + gn_nx
    g_ny = dno_bar * oy + dnd_bar * dy + gn_ny
    g_nz = dno_bar * oz + dnd_bar * dz + gn_nz
    n_ox = n_ox + dno_bar * cxw
    n_oy = n_oy + dno_bar * cyw
    n_oz = n_oz + dno_bar * czw
    n_dx = n_dx + dnd_bar * cxw
    n_dy = n_dy + dnd_bar * cyw
    n_dz = n_dz + dnd_bar * czw

    # per-primitive gradients exist only on lanes that hit this bounce
    live = alive & hit
    hlive = torch.where(live, 1.0, 0.0)
    out = (torch.where(live, win, -1.0),
           hlive * torch.where(is_tri, g_nx, g_cx),
           hlive * torch.where(is_tri, g_ny, g_cy),
           hlive * torch.where(is_tri, g_nz, g_cz),
           hlive * torch.where(is_tri, g_dp, g_r),
           g_ar * hlive, g_ag * hlive, g_ab * hlive,
           g_fz * (hlive * met_f), g_ir * (hlive * die_f))

    # off hit lanes the ray cotangent is the pass-through plus the sky
    new_adj = (torch.where(live, n_ox, (1.0 - contf) * a_ox),
               torch.where(live, n_oy, (1.0 - contf) * a_oy),
               torch.where(live, n_oz, (1.0 - contf) * a_oz),
               torch.where(live, n_dx, (1.0 - contf) * a_dx),
               torch.where(live, n_dy, (1.0 - contf) * a_dy + dy_sky),
               torch.where(live, n_dz, (1.0 - contf) * a_dz),
               n_tr, n_tg, n_tb)
    return new_adj, out


def grad_slab_ref(sph, tri, g_image, cam_vec, *, width, height,
                  samples_per_pixel, depth, seed=0, parity_plane_sign=True,
                  tri_clusters=None, shard_rows=None, row_offset=0,
                  row_stride=1):
    """K5's plain version before the reduction: same results as
    ``grad_slab_cuda``."""
    shard_rows = _check_grad_inputs(
        sph, tri, g_image, cam_vec, tri_clusters, width=width,
        height=height, samples_per_pixel=samples_per_pixel, depth=depth,
        parity_plane_sign=parity_plane_sign, shard_rows=shard_rows,
        row_offset=row_offset, row_stride=row_stride)
    dev = sph.device
    S = sph.shape[1]
    # host columns with the winner id appended (spheres si, triangles S+ti)
    sph_h = [col + [float(i)] for i, col in enumerate(sph.cpu().t().tolist())]
    tri_h = [col + [float(S + i)]
             for i, col in enumerate(tri.cpu().t().tolist())]
    tric_h = wf._host_clusters(tri_clusters)
    (ox0, oy0, oz0, llcx, llcy, llcz,
     hx, hy, hz, vx, vy, vz) = cam_vec.cpu().tolist()

    i32 = torch.int32
    band_row = torch.arange(shard_rows, dtype=i32, device=dev)[:, None]
    pcol = torch.arange(width, dtype=i32, device=dev)[None, :]
    prow = (row_offset + band_row * row_stride).expand(shard_rows, width)
    pcol = pcol.expand(shard_rows, width)
    active0 = (prow < height).reshape(-1)
    prow = torch.clamp_max(prow, height - 1).reshape(-1)
    pcol = pcol.reshape(-1)
    pix_u = (prow * width + pcol) + rng.as_int32(rng.seed_word(seed), dev)
    prow_f = prow.to(_F32)
    pcol_f = pcol.to(_F32)
    w1 = torch.tensor(float(width - 1), dtype=_F32, device=dev)
    h1 = torch.tensor(float(height - 1), dtype=_F32, device=dev)
    n = pix_u.shape[0]
    inv_spp = wf._inv_spp(samples_per_pixel)
    g = g_image.reshape(n, 3)
    grads = (g[:, 0] * inv_spp, g[:, 1] * inv_spp, g[:, 2] * inv_spp)

    def full(v):
        return torch.full((n,), v, dtype=_F32, device=dev)

    zero = full(0.0)
    slab = torch.zeros((samples_per_pixel, depth, GRAD_PLANES, n),
                       dtype=_F32, device=dev)
    slab[:, :, GP_WIN] = -1.0
    cam = [zero] * 12
    tri_step = (lambda c, r_, hh, m: _tri_step(c, r_, hh, parity_plane_sign,
                                               m))
    for s in range(samples_per_pixel):
        ju, jv, _ = rng.pcg3d(pix_u, s, 0)
        u = (pcol_f + rng.random_f32_from_bits24(ju)) / w1
        v = (prow_f + rng.random_f32_from_bits24(jv)) / h1
        dvx = llcx + u * hx + v * vx - ox0
        dvy = llcy + u * hy + v * vy - oy0
        dvz = llcz + u * hz + v * vz - oz0
        dlen = torch.sqrt(dvx * dvx + dvy * dvy + dvz * dvz)
        d0 = (dvx / dlen, dvy / dlen, dvz / dlen)
        ray = [full(ox0), full(oy0), full(oz0), *d0]
        tp = [full(1.0), full(1.0), full(1.0)]
        alive = active0
        residuals, draws = [], []
        # ---- forward sweep, keeping the residuals ----
        for b in range(depth):
            if not bool(alive.any()):     # dead rays change nothing
                break
            h = [full(BIG), zero, zero, full(1.0), zero, zero, zero, zero,
                 zero, full(1.0), full(-1.0), full(1.0)]
            wf._closest_hit(sph_h, None, _sphere_step, ray, h, alive)
            wf._closest_hit(tri_h, tric_h, tri_step, ray, h, alive)
            t_best, nxc, nyc, nzc, kind, ar, ag, ab, fz, irx, win, rr = h
            res = (*ray, *tp, t_best, win, torch.where(alive, 1.0, 0.0),
                   nxc, nyc, nzc, rr, kind, ar, ag, ab, fz, irx)
            bx, by, bz = rng.uniform_bilateral3(pix_u, s, 1 + b)
            rl = torch.sqrt(bx * bx + by * by + bz * bz)
            draw = (bx / rl, by / rl, bz / rl)
            residuals.append(res)
            draws.append(draw)
            cont, hp, nd, sc = _shade_fwd(res, *draw, S)
            tp = [torch.where(cont, t * c, t) for t, c in zip(tp, sc)]
            ray = [torch.where(cont, a, o) for a, o in zip((*hp, *nd), ray)]
            alive = cont
        # ---- backward sweep ----
        adj = (zero,) * 9
        for b in reversed(range(len(residuals))):
            adj, out = _adjoint_step(residuals[b], adj, grads, *draws[b], S,
                                     parity_plane_sign)
            slab[s, b] = torch.stack(out)
        # ---- camera: d0 = dvec / |dvec|, o0 = origin ----
        a_ox, a_oy, a_oz, a_dx, a_dy, a_dz = adj[:6]
        dx0, dy0, dz0 = d0
        dotd = dx0 * a_dx + dy0 * a_dy + dz0 * a_dz
        db_x = (a_dx - dx0 * dotd) / dlen
        db_y = (a_dy - dy0 * dotd) / dlen
        db_z = (a_dz - dz0 * dotd) / dlen
        lane = (a_ox - db_x, a_oy - db_y, a_oz - db_z, db_x, db_y, db_z,
                u * db_x, u * db_y, u * db_z, v * db_x, v * db_y, v * db_z)
        cam = [c + x for c, x in zip(cam, lane)]
    return (slab.reshape(samples_per_pixel, depth, GRAD_PLANES, shard_rows,
                         width),
            torch.stack(cam).reshape(12, shard_rows, width))
