"""K6, the sorted per-bounce mesh engine: host side, CUDA wrapper, plain
version and the driver.

``render_linear_sorted`` renders a frame one bounce per launch, the
primary bounce over side^2 * spp ray slots, side being the power of two at
or above the frame's longer edge: the primary rays go out in Morton pixel
order, so a warp's rays are a square image tile.  Every bounce intersects
(spheres, then a front-to-back walk over runs of 8 top nodes -> tops ->
128-column groups -> 32-triangle sub-leaves of the sorted tables, culled
by their bounding spheres), shades, and writes each ray's next sort key
[coarse origin cell | 6-bit direction class | fine origin cell]
(``sort_keys``; dead rays 0x7FFFFFFF).  Between bounces the rays are
reordered by key (``wavefront_binned.regroup``: a stable ``torch.sort``
and one gather of the state), so each warp of the next bounce holds rays
that share a neighbourhood and a direction cone.  Dead rays sort last and
stay dead, so each later bounce launches over the live prefix only, and
the next regroup sorts and gathers only that prefix (``_trace_sorted``).
A ray's index rides state plane 13 as int32 bits and never passes through
a float, so frames past 2^24 rays keep exact pixel and sample ids.  The
image is assembled without atomics: every ray goes back to its index, and
a pixel's samples are summed in sample order and scaled by f32(1/spp), as
K1 and K4 do, so the frame equals theirs bit for bit wherever the hits
agree.  Segments
are counted in int64.

``sorted_bounce_cuda`` launches the hand-written CUDA kernel in
``raytracer_tpu_torch/csrc/wavefront_sorted.cu``, which replaces one launch
of the TPU kernel ``raytracer_tpu/ops/pallas/wavefront_sorted.py``
``_bounce_call`` / ``_make_bounce_kernel``; the kernel writes the next sort
key itself.  ``sorted_bounce_ref`` is the same bounce in plain PyTorch,
vectorised over rays: each ray's closest hit a whole top node at a time,
ties resolved in the kernel's visit order (the camera's top order on the
primary bounce, after it the order of the reference point nearest each
warp's centroid of live origins).  The wrapper uses it only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.  ``LAUNCHES``
counts kernel launches.  The sort, the gather and the image assembly are
plain torch on both paths (XLA glue in the JAX package).

Not carried over: the JAX engine's ``block_rows`` (the warp of 32 sorted
rays is the culling unit) and ``debug_counts``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import tables
from ... import rng
from . import wavefront as wf
from . import wavefront_binned as binned
from . import wavefront_stream as stream

__all__ = ["LAUNCHES", "P_STATE", "ST_RIDX", "KEY_DEAD", "MAX_RAYS",
           "part1by2", "compact1by1", "sort_keys", "ray_layout",
           "SortedTables", "sorted_bounce_cuda", "sorted_bounce_ref",
           "render_linear_sorted"]

LAUNCHES = 0

WARP = 32
THREADS = 128
# ray-state planes: origin, direction, throughput, radiance and alive as
# float32 (the JAX engine's 13), then the ray's index as int32 bits
(ST_OX, ST_OY, ST_OZ, ST_DX, ST_DY, ST_DZ, ST_TPR, ST_TPG, ST_TPB,
 ST_RR, ST_RG, ST_RB, ST_ALIVE, ST_RIDX) = range(14)
P_STATE = 14
KEY_DEAD = 0x7FFFFFFF
# ray indices are int32 (and so is the kernel's thread index)
MAX_RAYS = (1 << 31) - THREADS

_F32 = torch.float32
_I32 = torch.int32
_KEY_SPAN_MIN = float(np.float32(1e-6))


# ---------------------------------------------------------------------------
# Morton helpers and sort keys
# ---------------------------------------------------------------------------

def part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 ``x`` over every 3rd bit (3-D
    Morton)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def compact1by1(x: torch.Tensor) -> torch.Tensor:
    """The even bits of int32 ``x`` (inverse of the 2-D Morton
    interleave)."""
    x = x & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    return (x | (x >> 8)) & 0x0000FFFF


def sort_keys(state, key_lo, key_hi):
    """The inter-bounce sort keys of ``state`` (planes 0..12 as the JAX
    engine's): [origin Morton cell >> 12 | 6-bit direction class | origin
    Morton cell & 0xFFF] over 128 cells a side of the key box, origins
    outside it clamped to its edge cells; dead rays KEY_DEAD.  int32 [n];
    K6 writes the same keys itself."""
    alive = state[ST_ALIVE] > 0.5
    span = torch.maximum(key_hi - key_lo, torch.tensor(
        _KEY_SPAN_MIN, dtype=_F32, device=key_lo.device))

    def q(v, a):
        cell = (v - key_lo[a]) / span[a] * 128.0
        return torch.clamp(cell, 0.0, 127.0).to(_I32)

    def qd(v):
        return torch.clamp((v + 1.0) * 2.0, 0.0, 3.0).to(_I32)

    mort = ((part1by2(q(state[ST_OX], 0)) << 2)
            | (part1by2(q(state[ST_OY], 1)) << 1)
            | part1by2(q(state[ST_OZ], 2)))
    dir6 = (qd(state[ST_DX]) << 4) | (qd(state[ST_DY]) << 2) \
        | qd(state[ST_DZ])
    key = ((mort >> 12) << 18) | (dir6 << 12) | (mort & 0xFFF)
    return torch.where(alive, key, KEY_DEAD).to(_I32)


def ray_layout(width, height, spp):
    """(side, n): the Morton square's side (the power of two at or above
    max(width, height), at least 2) and the ray slots, side^2 * spp in
    whole 128-thread blocks; raises past MAX_RAYS."""
    if min(width, height, spp) < 1:
        raise ValueError(f"bad render shape: {width}x{height}, spp {spp}")
    side = 1 << max(max(width, height) - 1, 1).bit_length()
    n = -(-side * side * spp // THREADS) * THREADS
    if n > MAX_RAYS:
        raise ValueError(f"the sorted engine's {n} ray slots exceed its "
                         f"int32 ray ids ({MAX_RAYS})")
    return side, n


def _ray_geometry(ridx, *, width, height, spp, side, seed_word):
    """Ray index -> (active0, prow_c, pcol_c, pix_u, s) as the kernel
    decodes it: pixel m = ridx // spp in Morton order, sample ridx % spp."""
    m = ridx // spp
    s = ridx - m * spp
    col = compact1by1(m)
    row = compact1by1(m >> 1)
    active0 = (row < height) & (col < width) & (m < side * side)
    prow_c = torch.clamp_max(row, height - 1)
    pcol_c = torch.clamp_max(col, width - 1)
    pix_u = (prow_c * width + pcol_c) + rng.as_int32(seed_word, ridx.device)
    return active0, prow_c, pcol_c, pix_u, s


# ---------------------------------------------------------------------------
# Tables, wrapper
# ---------------------------------------------------------------------------

class SortedTables(NamedTuple):
    """What a bounce reads, on the render's device (shapes as in
    ``tables.build_tri_sorted_tables``; order/keys (1, C) and crunb
    (4, R8) for the camera)."""
    sph: torch.Tensor
    sph_clusters: Optional[tuple]
    tri: torch.Tensor
    subb: torch.Tensor
    subn: torch.Tensor
    grpb: torch.Tensor
    topb: torch.Tensor
    topr: torch.Tensor
    order: torch.Tensor
    keys: torch.Tensor
    crunb: torch.Tensor
    refp: torch.Tensor
    norder: torch.Tensor
    nkeys: torch.Tensor
    nrunb: torch.Tensor
    root: torch.Tensor
    klo: torch.Tensor
    khi: torch.Tensor


def _check_tables(T: SortedTables, cam_vec, state):
    """Shapes, types, devices and contiguity of a bounce's inputs (no
    device sync: the index ranges are checked once a frame)."""
    dev = T.sph.device
    chk = wf.check_tensor
    wf.check_sphere_tables(T.sph, None, dev)
    if T.sph_clusters is not None:
        nsc = T.sph_clusters[0].shape[-1]
        chk(T.sph_clusters[0], "sph_clusters bounds", _F32, (6, nsc), dev)
        chk(T.sph_clusters[1], "sph_clusters ranges", _I32, (2, nsc), dev)
    L = T.subn.shape[1] if T.subn.dim() == 2 else 0
    C = T.topr.shape[1] if T.topr.dim() == 2 else 0
    if L < 1 or C < 1 or L % tables.GROUP_SUBS:
        raise ValueError(f"{L} sub-leaves and {C} tops do not make the "
                         f"sorted tables")
    chk(T.tri, "tri", _F32, (tables.TRI_ROWS_PAD, L * tables.SUB), dev)
    chk(T.subb, "sub_bounds", _F32, (4, L), dev)
    chk(T.subn, "sub_counts", _I32, (1, L), dev)
    chk(T.grpb, "grp_bounds", _F32, (4, L // tables.GROUP_SUBS), dev)
    chk(T.topb, "top_bounds", _F32, (4, C), dev)
    chk(T.topr, "top_ranges", _I32, (2, C), dev)
    chk(T.order, "top_order", _I32, (1, C), dev)
    chk(T.keys, "top_keys", _F32, (1, C), dev)
    r8 = -(-C // tables.RUN)
    chk(T.crunb, "camera run bounds", _F32, (4, r8), dev)
    nr = T.refp.shape[1] if T.refp.dim() == 2 else 0
    if nr < 1:
        raise ValueError("the sorted tables need a reference point")
    chk(T.refp, "ref_pts", _F32, (4, nr), dev)
    chk(T.norder, "node_orders", _I32, (nr, C), dev)
    chk(T.nkeys, "node_keys", _F32, (nr, C), dev)
    chk(T.nrunb, "node_run_bounds", _F32, (4, nr * r8), dev)
    chk(T.root, "root", _F32, (4, 1), dev)
    chk(T.klo, "key_lo", _F32, (3,), dev)
    chk(T.khi, "key_hi", _F32, (3,), dev)
    chk(cam_vec, "cam_vec", _F32, (12,), dev)
    if state is not None:
        n = state.shape[1] if state.dim() == 2 else 0
        chk(state, "state", _F32, (P_STATE, n), dev)


def _check_rays(n, width, height, spp, side, primary):
    """A bounce's slots: whole warps; on the primary bounce every slot of
    the frame, after it any live prefix."""
    if n < WARP or n % WARP or n > MAX_RAYS:
        raise ValueError(f"{n} ray slots are not whole warps below "
                         f"{MAX_RAYS}")
    if side & (side - 1) or side < max(width, height) \
            or (primary and n < side * side * spp):
        raise ValueError(f"{n} slots and side {side} do not hold a "
                         f"{width}x{height} frame at {spp} spp")


def sorted_bounce_cuda(T: SortedTables, cam_vec, state, *, n_rays, bounce,
                       primary, is_last, node_exit, width, height, spp,
                       side, seed_word):
    """One bounce through K6 (the plain version for CPU tensors): returns
    (state [P_STATE, n] f32, next sort keys [n] int32, None after the last
    bounce).  ``state`` is None on the primary bounce, which generates
    ``n_rays`` camera rays in Morton pixel order.  The wrapper checks
    shapes, types and devices; ``T``'s index ranges are checked once a
    frame by ``render_linear_sorted``, so a bounce enqueues without waiting
    for the device."""
    global LAUNCHES
    kw = dict(n_rays=n_rays, bounce=bounce, primary=primary, is_last=is_last,
              node_exit=node_exit, width=width, height=height, spp=spp,
              side=side, seed_word=seed_word)
    if T.sph.device.type == "cpu":
        return sorted_bounce_ref(T, cam_vec, state, **kw)
    if T.sph.device.type != "cuda":
        raise ValueError(f"K6 runs on CUDA tensors, got {T.sph.device}")
    _check_tables(T, cam_vec, None if primary else state)
    n = n_rays if primary else state.shape[1]
    _check_rays(n, width, height, spp, side, primary)
    from . import build
    lib = build.load()
    dev = T.sph.device
    out = torch.empty((P_STATE, n), dtype=_F32, device=dev)
    keys = None if is_last else torch.empty((n,), dtype=_I32, device=dev)
    sphc_b, sphc_r = T.sph_clusters or (None, None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        rc = lib.rt_sorted_bounce(
            ptr(T.sph), T.sph.shape[1], ptr(sphc_b), ptr(sphc_r),
            0 if sphc_b is None else sphc_b.shape[1],
            ptr(T.tri), ptr(T.subb), ptr(T.subn), T.subn.shape[1],
            ptr(T.grpb), ptr(T.topb), ptr(T.topr), T.topr.shape[1],
            ptr(T.order), ptr(T.keys), ptr(T.crunb),
            ptr(T.refp), T.refp.shape[1], ptr(T.norder), ptr(T.nkeys),
            ptr(T.nrunb), ptr(T.root), ptr(T.klo), ptr(T.khi), ptr(cam_vec),
            None if primary else ptr(state), ptr(out), ptr(keys), n,
            width, height, spp, side, seed_word, bounce, int(primary),
            int(node_exit), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K6 (rt_sorted_bounce) launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 1
    return out, keys


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def sorted_bounce_ref(T: SortedTables, cam_vec, state, *, n_rays, bounce,
                      primary, is_last, node_exit, width, height, spp, side,
                      seed_word):
    """K6's plain PyTorch version: same arguments and results as
    ``sorted_bounce_cuda``, on whatever device the tensors are."""
    _check_tables(T, cam_vec, None if primary else state)
    dev = T.sph.device
    n = n_rays if primary else state.shape[1]
    _check_rays(n, width, height, spp, side, primary)
    if primary:
        ridx = torch.arange(n, dtype=_I32, device=dev)
    else:
        ridx = state[ST_RIDX].view(_I32)
    active0, prow_c, pcol_c, pix_u, s_u = _ray_geometry(
        ridx, width=width, height=height, spp=spp, side=side,
        seed_word=seed_word)
    if primary:
        ray, tp, rad, alive_f = binned.camera_rays(
            cam_vec, pcol_c, prow_c, pix_u, s_u, active0, width - 1,
            height - 1)
    else:
        ray = [state[k] for k in range(ST_OX, ST_DZ + 1)]
        tp = tuple(state[k] for k in (ST_TPR, ST_TPG, ST_TPB))
        rad = tuple(state[k] for k in (ST_RR, ST_RG, ST_RB))
        alive_f = state[ST_ALIVE]
    alive = alive_f > 0.5

    h = wf.sphere_hits(T.sph.cpu().t().tolist(),
                       wf._host_clusters(T.sph_clusters), ray, alive)
    t_cap = binned.root_cap(T.root, ray, alive)
    row, pos = binned.visit_positions(T, ray, alive_f,
                                      node_exit and not primary)
    topb = T.topb.cpu().tolist()
    binned.top_hits(T, ray, h, alive, t_cap, row, pos,
                    lambda ci, cull: stream.bound_test(topb, ci, ray, cull))
    wf.resolve_tri_normals(h)
    ray, tp, rad, cont = wf.scatter_bookkeep(ray, h, pix_u, s_u, bounce, tp,
                                             rad, alive)
    out = torch.stack(list(ray) + list(tp) + list(rad)
                      + [torch.where(cont, 1.0, 0.0).to(_F32),
                         ridx.view(_F32)])
    return out, None if is_last else sort_keys(out, T.klo, T.khi)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def _sorted_tables(sph, tri, sub_bounds, sub_counts, grp_bounds, top_bounds,
                   top_ranges, root, ref_pts, node_orders, node_keys,
                   node_run_bounds, key_lo, key_hi, *, sph_clusters,
                   top_order, top_keys) -> SortedTables:
    """The bounce tables for one camera: its order (table order with -inf
    keys, so no early exit, when none is given) and its run bounds; the
    index ranges checked (one device sync)."""
    n_tops = top_bounds.shape[1]
    dev = top_bounds.device
    if top_order is None:
        top_order = torch.arange(n_tops, dtype=_I32,
                                 device=dev).reshape(1, n_tops)
        top_keys = torch.full((1, n_tops), float("-inf"), dtype=_F32,
                              device=dev)
    binned._check_index_ranges(sph, sph_clusters, sub_counts, top_ranges,
                               grp_bounds.shape[1], top_order, node_orders)
    return SortedTables(sph, sph_clusters, tri, sub_bounds, sub_counts,
                        grp_bounds, top_bounds, top_ranges, top_order,
                        top_keys, binned.run_bounds(top_bounds, top_order),
                        ref_pts, node_orders, node_keys, node_run_bounds,
                        root, key_lo, key_hi)


def assemble_image(chunks, *, width, height, spp, side):
    """The mean image [H, W, 3] of a finished frame, its rays' states in
    ``chunks`` (P_STATE, k) that together hold every slot once: every ray's
    radiance back at its index, each Morton pixel's samples summed in
    sample order from 0 and scaled by f32(1/spp) (K1's and K4's
    arithmetic), the pixels put in raster order.  No atomics: each target
    is written once."""
    dev = chunks[0].device
    npix = side * side
    rgb = torch.empty((3, sum(c.shape[1] for c in chunks)), dtype=_F32,
                      device=dev)
    for c in chunks:
        rgb.index_copy_(1, c[ST_RIDX].view(_I32).long(), c[ST_RR:ST_RB + 1])
    per = rgb[:, :npix * spp].reshape(3, npix, spp).permute(2, 0, 1) \
        .contiguous()
    acc = torch.zeros((3, npix), dtype=_F32, device=dev)
    for s in range(spp):
        acc = acc + per[s]
    mean = acc * wf._inv_spp(spp)
    m = torch.arange(npix, dtype=_I32, device=dev)
    col, row = compact1by1(m), compact1by1(m >> 1)
    inside = (row < height) & (col < width)
    img = torch.empty((height * width, 3), dtype=_F32, device=dev)
    img[(row * width + col)[inside].long()] = mean[:, inside].t()
    return img.reshape(height, width, 3)


def _trace_sorted(run, T, cam_vec, geo, depth, *, full_n=False, slots=None):
    """The bounces of one frame: (the final states as chunks that together
    hold every slot once, segments traced after the primary bounce).

    After each bounce the rays are regrouped by their keys, dead rays last.
    A dead ray stays dead, so a bounce launches only over the live prefix,
    in whole warps; the dead slots after it are split off and kept as they
    are for the image assembly, and the next regroup sorts and gathers only
    the prefix.  A stable sort of the prefix puts every ray where the stable
    sort of all slots would (the tail is dead and already in order), so the
    frame is bitwise the full-slot loop's.  One device sync a bounce
    reads the live count; a bounce with no live ray launches nothing.

    Test-only: ``full_n=True`` launches and sorts every slot each bounce
    (the reference the tests hold the live prefix to); ``slots(ids)`` is
    called after each regroup with the int32 ray ids of all slots in the
    full-slot loop's order."""
    state, keys = run(T, cam_vec, None, bounce=0, primary=True,
                      is_last=depth == 1, **geo)
    tails, traced = [], 0
    for b in range(1, depth):
        live = int((keys != KEY_DEAD).sum())
        traced += live
        if full_n:
            state, _ = binned.regroup(state, keys)
        elif live == 0:
            break
        else:
            state, tail = binned.regroup(state, keys,
                                         -(-live // WARP) * WARP)
            if tail is not None:
                tails.insert(0, tail)
        if slots is not None:
            slots(torch.cat([c[ST_RIDX] for c in [state] + tails]).view(
                _I32))
        state, keys = run(T, cam_vec, state, bounce=b, primary=False,
                          is_last=b == depth - 1, **geo)
    return [state] + tails, traced


def render_linear_sorted(sph, tri, sub_bounds, sub_counts, grp_bounds,
                         top_bounds, top_ranges, root, ref_pts, node_orders,
                         node_keys, node_run_bounds, key_lo, key_hi,
                         sub_aabb, grp_aabb, top_aabb, cam_vec, *, width,
                         height, samples_per_pixel, depth, seed=0,
                         sph_clusters=None, top_order=None, top_keys=None,
                         node_exit=True, plain=False):
    """Mean linear radiance [H, W, 3] + segment count through the sorted
    pipeline (``render_linear_pallas_sorted``'s arguments; tables from
    ``tables.pack_spheres`` and ``tables.build_tri_sorted_tables`` as
    tensors on one device, the AABB rows unused; always the correct plane
    equation).  ``top_order`` / ``top_keys`` from ``sorted_top_order``
    drive the primary bounce's early exit, the node orders and keys the
    later bounces' (``node_exit``).  Any spp; depth 0 gives a black frame
    and 0 segments.  ``plain=True`` runs every bounce through
    ``sorted_bounce_ref``.  Bounces after the primary launch over the live
    prefix only (``_trace_sorted``)."""
    return _render_sorted(
        sph, tri, sub_bounds, sub_counts, grp_bounds, top_bounds, top_ranges,
        root, ref_pts, node_orders, node_keys, node_run_bounds, key_lo,
        key_hi, cam_vec, width=width, height=height,
        samples_per_pixel=samples_per_pixel, depth=depth, seed=seed,
        sph_clusters=sph_clusters, top_order=top_order, top_keys=top_keys,
        node_exit=node_exit, plain=plain)


def _render_sorted(sph, tri, sub_bounds, sub_counts, grp_bounds, top_bounds,
                   top_ranges, root, ref_pts, node_orders, node_keys,
                   node_run_bounds, key_lo, key_hi, cam_vec, *, width, height,
                   samples_per_pixel, depth, seed, sph_clusters, top_order,
                   top_keys, node_exit, plain, full_n=False, slots=None):
    """``render_linear_sorted``'s body; ``full_n`` and ``slots`` are
    ``_trace_sorted``'s test-only arguments."""
    spp = samples_per_pixel
    side, n = ray_layout(width, height, spp)
    if depth < 0:
        raise ValueError(f"bad depth {depth}")
    T = _sorted_tables(sph, tri, sub_bounds, sub_counts, grp_bounds,
                       top_bounds, top_ranges, root, ref_pts, node_orders,
                       node_keys, node_run_bounds, key_lo, key_hi,
                       sph_clusters=sph_clusters, top_order=top_order,
                       top_keys=top_keys)
    _check_tables(T, cam_vec, None)
    dev = sph.device
    if depth == 0:
        return torch.zeros((height, width, 3), dtype=_F32, device=dev), 0
    run = sorted_bounce_ref if plain else sorted_bounce_cuda
    geo = dict(n_rays=n, node_exit=node_exit, width=width, height=height,
               spp=spp, side=side, seed_word=rng.seed_word(seed))
    chunks, traced = _trace_sorted(run, T, cam_vec, geo, depth,
                                   full_n=full_n, slots=slots)
    mean = assemble_image(chunks, width=width, height=height, spp=spp,
                          side=side)
    # bounce 0 traces exactly the in-image rays
    return mean, width * height * spp + traced
