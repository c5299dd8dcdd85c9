"""K3, the binned per-bounce engine: host side, CUDA wrapper, plain version
and the driver.

``render_linear_binned`` renders a frame one bounce per launch.  Pass 0
generates the camera rays from their slot ids; every pass intersects
(spheres, then a front-to-back AABB walk over top nodes -> 128-column
groups -> 32-triangle sub-leaves of the sorted tables), shades, and picks
each new ray's next candidate top node, written as an int32 sort key
[top | 6-bit direction class | 9-bit origin cell] with a per-ray walk-exit
bound.  Between passes the rays are regrouped by key (``regroup``: a stable
``torch.sort`` and one gather of the 15 state planes), so that every warp
of the next pass holds rays bound for the same top.  ``bounce_caps`` keep
only the leading slots of the regrouped state (dead rays sort last); the
finished tails rejoin for the image, and an ``overflow`` output counts the
live rays a cap dropped.  The slot id rides state plane 13 (exact in f32
below 2^24), so pixel ids, random streams and the image assembly do not
depend on the order.

``binned_pass_cuda`` launches the hand-written CUDA kernel in
``raytracer_tpu_torch/csrc/wavefront_binned.cu``, which replaces one pass of
the TPU kernel ``raytracer_tpu/ops/pallas/wavefront_binned.py``
``_pass_call`` / ``_make_pass_kernel``.  A warp of 32 consecutive slots is
its culling unit, as the TPU's (block_rows x 128)-lane block was.  A warp
stages a passing top's sub-leaves through shared memory (K6's walk,
``top_staged_walk`` in path_common.cuh) and skips the closest hit when
none of its 32 slots is live; neither changes an output bit.
``binned_pass_ref`` is the same pass in plain PyTorch, vectorised over
rays: it takes each ray's closest hit a whole top node at a time, with ties
resolved in the kernel's visit order (the camera's top order on the primary
pass, the reference point's order per warp after it), and runs the
selection scans as the kernel does, warp votes included.  The pass wrapper
uses it only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.  ``LAUNCHES`` counts kernel launches.  The regroup and
the image assembly are plain torch on both paths (XLA glue in the JAX
package).

The JAX package's TPU tuning switches are not carried over: block_rows (the
tile is 16 rows of 128 slots, JAX's default), regroup granularities other
than per ray, gated_tris, debug_counts and the dbg_* probes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import tables
from ... import rng
from . import wavefront as wf

__all__ = ["LAUNCHES", "P_STATE", "TILE_ROWS", "SUPER", "SUPER_MIN_TOPS",
           "KEY_NOMESH", "KEY_DEAD", "tile_geometry", "run_bounds",
           "super_tables", "regroup", "PassTables", "binned_pass_cuda",
           "binned_pass_ref", "shard_lanes", "render_linear_binned"]

LAUNCHES = 0

LANES = 128
TILE_ROWS = 16                   # 128-slot rows per image tile
WARP = 32
# ray-state planes: origin, direction, throughput, radiance, alive, the
# slot id (exact in f32 below 2^24) and the walk-exit bound
(ST_OX, ST_OY, ST_OZ, ST_DX, ST_DY, ST_DZ, ST_TPR, ST_TPG, ST_TPB,
 ST_RR, ST_RG, ST_RB, ST_ALIVE, ST_SLOT, ST_EXITB) = range(15)
P_STATE = 15
# next-top selection scans SUPER consecutive tops as one union AABB from
# SUPER_MIN_TOPS tops on (a TPU-measured starting value)
SUPER = 16
SUPER_MIN_TOPS = 48
KEY_SUB_BITS = 15
KEY_NOMESH = 0x7FFE0000          # live ray, no candidate top
KEY_DEAD = 0x7FFFFFFF            # dead ray: sorts last

_F32 = torch.float32
_EXIT_MUL = float(np.float32(1.0005))
_EXIT_ADD = float(np.float32(1e-4))
_KEY_SPAN_MIN = np.float32(1e-6)
_FAR = float(np.float32(3e38))


def tile_geometry(width, height, spp):
    """Tile layout of the slots: each tile of TILE_ROWS * 128 slots is
    TILE_ROWS * 128 / spp pixels, as square as powers of two allow.
    Returns (TW, TH, ntx, nty, rows_total) as the JAX package's
    ``tile_geometry`` with block_rows=TILE_ROWS; raises for a spp that is
    not a power of two <= 128 or past 2^24 slots."""
    if spp & (spp - 1) or spp > LANES or spp < 1:
        raise ValueError("binned engine needs power-of-two spp <= 128")
    pix_blk = TILE_ROWS * LANES // spp
    lg = pix_blk.bit_length() - 1
    tw = 1 << ((lg + 1) // 2)
    th = pix_blk // tw
    ntx = -(-width // tw)
    nty = -(-height // th)
    rows_total = ntx * nty * TILE_ROWS
    if rows_total * LANES > (1 << 24):
        raise ValueError(
            f"binned engine ray count {rows_total * LANES} exceeds the 2^24 "
            f"f32 slot-id range; render in bands")
    return tw, th, ntx, nty, rows_total


def run_bounds(top_bounds: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Union bounding spheres of RUN-long slices of a visit order (the
    camera's), in float32 as ``_run_bounds_jnp``: (4, R8), row 3 r^2 or
    -1 for a run of empty tops."""
    n = top_bounds.shape[1]
    r8 = -(-n // tables.RUN)
    idx = order[0].long()
    pad = r8 * tables.RUN - n
    if pad:
        idx = torch.cat([idx, idx.new_zeros(pad)])
    c = top_bounds[0:3].t()[idx].reshape(r8, tables.RUN, 3)
    r2 = top_bounds[3][idx].reshape(r8, tables.RUN)
    valid = (r2 > 0.0) & (torch.arange(r8 * tables.RUN, device=idx.device)
                          .reshape(r8, tables.RUN) < n)
    r = torch.sqrt(torch.clamp_min(r2, 0.0))
    big = 1e30
    lo = torch.where(valid[..., None], c, big).min(dim=1).values
    hi = torch.where(valid[..., None], c, -big).max(dim=1).values
    ctr = (lo + hi) * 0.5
    rad = torch.where(valid, torch.linalg.vector_norm(
        c - ctr[:, None, :], dim=-1) + r, -1.0).max(dim=1).values
    rad = rad * float(np.float32(tables.BOUND_PAD)) + _EXIT_ADD
    row3 = torch.where(valid.any(dim=1), rad * rad, -1.0)
    return torch.cat([ctr.t(), row3[None, :]]).to(_F32).contiguous()


def super_tables(top_aabb: torch.Tensor):
    """(super_aabb (6, NS), top_aabb padded with empty boxes to NS * SUPER
    columns): the union AABB of each SUPER consecutive tops."""
    n = top_aabb.shape[1]
    n_super = -(-n // SUPER)
    pad = n_super * SUPER - n
    empty = torch.tensor([1.0, 1.0, 1.0, -1.0, -1.0, -1.0], dtype=_F32,
                         device=top_aabb.device)[:, None].expand(6, pad)
    top_p = torch.cat([top_aabb, empty], dim=1).contiguous()
    lo = top_p[0:3].reshape(3, n_super, SUPER).min(dim=2).values
    hi = top_p[3:6].reshape(3, n_super, SUPER).max(dim=2).values
    return torch.cat([lo, hi]).contiguous(), top_p


def regroup(state: torch.Tensor, keys: torch.Tensor, cap=None):
    """Rays in key order (a stable sort of the keys, one gather of the
    state planes): (the first ``cap`` slots, the rest or None)."""
    order = torch.sort(keys, stable=True).indices
    if cap is None or cap >= order.shape[0]:
        return state.index_select(1, order), None
    return (state.index_select(1, order[:cap]),
            state.index_select(1, order[cap:]))


class PassTables(NamedTuple):
    """What a pass reads, on the render's device (shapes as in
    ``tables.build_tri_sorted_tables``; order/keys (1, C) and crunb
    (4, R8) for the camera; supa/topap from ``super_tables``)."""
    sph: torch.Tensor
    sph_clusters: Optional[tuple]
    tri: torch.Tensor
    subn: torch.Tensor
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
    suba: torch.Tensor
    grpa: torch.Tensor
    topa: torch.Tensor
    supa: torch.Tensor
    topap: torch.Tensor


def _check_tables(T: PassTables, cam_vec, state):
    """Shapes, types, devices and contiguity of a pass's inputs (no device
    sync: the index ranges are ``_check_index_ranges``'s, once a frame)."""
    dev = T.sph.device
    chk = wf.check_tensor
    chk(T.sph, "sph", _F32, (tables.SPH_ROWS, None), dev)
    if T.sph_clusters is not None:
        nsc = T.sph_clusters[0].shape[-1]
        chk(T.sph_clusters[0], "sph_clusters bounds", _F32, (6, nsc), dev)
        chk(T.sph_clusters[1], "sph_clusters ranges", torch.int32, (2, nsc),
            dev)
    L = T.subn.shape[1] if T.subn.dim() == 2 else 0
    C = T.topr.shape[1] if T.topr.dim() == 2 else 0
    if T.sph.shape[1] < 1 or L < 1 or C < 1 or L % tables.GROUP_SUBS:
        raise ValueError(f"{T.sph.shape[1]} spheres, {L} sub-leaves and {C} "
                         f"tops do not make the binned tables")
    chk(T.tri, "tri", _F32, (tables.TRI_ROWS_PAD, L * tables.SUB), dev)
    chk(T.subn, "sub_counts", torch.int32, (1, L), dev)
    chk(T.topr, "top_ranges", torch.int32, (2, C), dev)
    chk(T.order, "top_order", torch.int32, (1, C), dev)
    chk(T.keys, "top_keys", _F32, (1, C), dev)
    chk(T.crunb, "camera run bounds", _F32, (4, -(-C // tables.RUN)), dev)
    nr = T.refp.shape[1] if T.refp.dim() == 2 else 0
    if nr < 1:
        raise ValueError("the binned tables need a reference point")
    chk(T.refp, "ref_pts", _F32, (4, nr), dev)
    chk(T.norder, "node_orders", torch.int32, (nr, C), dev)
    chk(T.nkeys, "node_keys", _F32, (nr, C), dev)
    chk(T.nrunb, "node_run_bounds", _F32, (4, nr * -(-C // tables.RUN)),
        dev)
    chk(T.root, "root", _F32, (4, 1), dev)
    chk(T.klo, "key_lo", _F32, (3,), dev)
    chk(T.khi, "key_hi", _F32, (3,), dev)
    chk(T.suba, "sub_aabb", _F32, (6, L), dev)
    chk(T.grpa, "grp_aabb", _F32, (6, L // tables.GROUP_SUBS), dev)
    chk(T.topa, "top_aabb", _F32, (6, C), dev)
    ns = -(-C // SUPER)
    chk(T.supa, "super_aabb", _F32, (6, ns), dev)
    chk(T.topap, "padded top_aabb", _F32, (6, ns * SUPER), dev)
    chk(cam_vec, "cam_vec", _F32, (12,), dev)
    if state is not None:
        n = state.shape[1] if state.dim() == 2 else 0
        chk(state, "state", _F32, (P_STATE, n), dev)
        if n % WARP:
            raise ValueError(f"state holds {n} slots, not whole warps")


def _check_index_ranges(sph, sph_clusters, subn, topr, n_groups, order,
                        norder):
    """Raise unless every index the kernel follows stays inside its table:
    sub-leaf counts, group ranges (a top spans at most ``TOP_GROUPS``
    groups: K3 and K6 stage a top's sub-leaves through a 32-bit mask),
    visit orders and sphere cluster ranges (one device sync).
    ``render_linear_binned`` and ``render_linear_sorted`` check their
    tables once a frame, before anything indexes with them."""
    C = topr.shape[1]
    span = topr[1] - topr[0]
    bad = ((subn.min() < 0) | (subn.max() > tables.SUB)
           | (topr.min() < 0) | (topr.max() > n_groups)
           | (span.min() < 0) | (span.max() > tables.TOP_GROUPS)
           | (order.min() < 0) | (order.max() >= C)
           | (norder.min() < 0) | (norder.max() >= C))
    if sph_clusters is not None:
        ranges = sph_clusters[1]
        bad = bad | (ranges.min() < 0) | (ranges.max() > sph.shape[1])
    if bool(bad):
        raise ValueError(f"sub counts, top ranges (at most "
                         f"{tables.TOP_GROUPS} groups a top), orders or "
                         f"sphere cluster ranges fall outside the tables")


def binned_pass_cuda(T: PassTables, cam_vec, state, *, n_slots, bounce,
                     primary, is_last, node_exit, use_super, width, height,
                     spp, tw, th, ntx, seed_word, samp_off, ty_off=0,
                     ty_stride=1):
    """One pass through K3 (the plain version for CPU tensors): returns
    (state [P_STATE, n] f32, keys [n] int32).  ``state`` is None on the
    primary pass, which generates ``n_slots`` camera rays.  The slots' tile
    row k is the global tile row ``ty_off + k * ty_stride``.  The wrapper
    checks shapes, types and devices; ``T``'s index ranges are checked
    once a frame by ``render_linear_binned``, so a pass enqueues without
    waiting for the device."""
    global LAUNCHES
    kw = dict(n_slots=n_slots, bounce=bounce, primary=primary,
              is_last=is_last, node_exit=node_exit, use_super=use_super,
              width=width, height=height, spp=spp, tw=tw, th=th, ntx=ntx,
              seed_word=seed_word, samp_off=samp_off, ty_off=ty_off,
              ty_stride=ty_stride)
    if T.sph.device.type == "cpu":
        return binned_pass_ref(T, cam_vec, state, **kw)
    if T.sph.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA tensors, got {T.sph.device}")
    _check_tables(T, cam_vec, None if primary else state)
    n = n_slots if primary else state.shape[1]
    if n % WARP or n < WARP:
        raise ValueError(f"{n} slots are not whole warps")
    from . import build
    lib = build.load()
    dev = T.sph.device
    out = torch.empty((P_STATE, n), dtype=_F32, device=dev)
    keys = torch.empty((n,), dtype=torch.int32, device=dev)
    sphc_b, sphc_r = T.sph_clusters or (None, None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        rc = lib.rt_binned_pass(
            ptr(T.sph), T.sph.shape[1], ptr(sphc_b), ptr(sphc_r),
            0 if sphc_b is None else sphc_b.shape[1],
            ptr(T.tri), ptr(T.subn), T.subn.shape[1], ptr(T.topr),
            T.topr.shape[1], ptr(T.order), ptr(T.keys), ptr(T.crunb),
            ptr(T.refp), T.refp.shape[1], ptr(T.norder), ptr(T.nkeys),
            ptr(T.nrunb), ptr(T.root), ptr(T.klo), ptr(T.khi),
            ptr(T.suba), ptr(T.grpa), ptr(T.topa), ptr(T.supa),
            ptr(T.topap), T.supa.shape[1], ptr(cam_vec),
            None if primary else ptr(state), ptr(out), ptr(keys), n,
            width, height, seed_word, bounce, samp_off, spp, tw, th, ntx,
            ty_off, ty_stride, int(primary), int(is_last), int(node_exit), int(use_super),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K3 (rt_binned_pass) launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 1
    return out, keys


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _warp_sum(x):
    """The kernel's __shfl_xor_sync butterfly sum over each 32 slots,
    in its order; every lane ends with the same value."""
    x = x.reshape(-1, WARP)
    lane = torch.arange(WARP, device=x.device)
    for off in (16, 8, 4, 2, 1):
        x = x + x[:, lane ^ off]
    return x.reshape(-1)


def _warp_any(m):
    return m.reshape(-1, WARP).any(dim=1).repeat_interleave(WARP)


def _aabb_entry(a, ray, inv):
    """Slab test of every ray against every box column of ``a`` (6, M):
    (tnear, tfar) [N, M]."""
    o, iv = ray[:3], inv
    t0 = [(a[k][None, :] - o[k][:, None]) * iv[k][:, None] for k in range(3)]
    t1 = [(a[3 + k][None, :] - o[k][:, None]) * iv[k][:, None]
          for k in range(3)]
    tnear = torch.maximum(
        torch.maximum(torch.minimum(t0[0], t1[0]),
                      torch.minimum(t0[1], t1[1])),
        torch.clamp_min(torch.minimum(t0[2], t1[2]), 0.0))
    tfar = torch.minimum(
        torch.minimum(torch.maximum(t0[0], t1[0]),
                      torch.maximum(t0[1], t1[1])),
        torch.maximum(t0[2], t1[2]))
    return tnear, tfar


def _slot_geometry(slot, *, width, height, spp, tw, th, ntx, seed_word,
                   samp_off, ty_off=0, ty_stride=1):
    """Slot id -> (active0, prow_c, pcol_c, pix_u, s_u) as the kernel
    decodes it; the slots' tile row k is the global tile row ``ty_off +
    k * ty_stride``."""
    lg_tile = (TILE_ROWS * LANES).bit_length() - 1
    t_idx = slot >> lg_tile
    sl = slot & (TILE_ROWS * LANES - 1)
    p = sl >> (spp.bit_length() - 1)
    s = sl & (spp - 1)
    ty_l = t_idx // ntx
    tx = t_idx - ty_l * ntx
    ty = ty_l * ty_stride + ty_off
    prow = ty * th + (p >> (tw.bit_length() - 1))
    pcol = tx * tw + (p & (tw - 1))
    active0 = (prow < height) & (pcol < width)
    prow_c = torch.clamp_max(prow, height - 1)
    pcol_c = torch.clamp_max(pcol, width - 1)
    pix_u = (prow_c * width + pcol_c) + rng.as_int32(seed_word, slot.device)
    return active0, prow_c, pcol_c, pix_u, s + samp_off


def camera_rays(cam_vec, pcol_c, prow_c, pix_u, s_u, active0, w1, h1):
    """The primary rays of a pass (``camera_ray`` of path_common.cuh at
    u = (col + jitter) / w1, v = (row + jitter) / h1; ``w1``, ``h1``
    ints): (ray, throughput, radiance, alive_f)."""
    dev = pix_u.device
    n = pix_u.shape[0]

    def full(v):
        return torch.full((n,), v, dtype=_F32, device=dev)

    cam = cam_vec.cpu().tolist()
    ju, jv, _ = rng.pcg3d(pix_u, s_u, 0)
    w1 = torch.tensor(float(w1), dtype=_F32, device=dev)
    h1 = torch.tensor(float(h1), dtype=_F32, device=dev)
    u = (pcol_c.to(_F32) + rng.random_f32_from_bits24(ju)) / w1
    v = (prow_c.to(_F32) + rng.random_f32_from_bits24(jv)) / h1
    dv = [cam[3 + k] + u * cam[6 + k] + v * cam[9 + k] - cam[k]
          for k in range(3)]
    dlen = torch.sqrt(dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2])
    ray = [full(cam[0]), full(cam[1]), full(cam[2]), dv[0] / dlen,
           dv[1] / dlen, dv[2] / dlen]
    return (ray, (full(1.0), full(1.0), full(1.0)),
            (full(0.0), full(0.0), full(0.0)),
            torch.where(active0, 1.0, 0.0).to(_F32))


def root_cap(root, ray, alive):
    """The culling cap of the root bound: each live ray's padded exit
    distance from the root bounding sphere, -BIG for rays that miss it
    (they never hold a walk open)."""
    ox, oy, oz, dx, dy, dz = ray
    rcx, rcy, rcz, rr2 = root[:, 0].cpu().tolist()
    ocx, ocy, ocz = ox - rcx, oy - rcy, oz - rcz
    rhb = ocx * dx + ocy * dy + ocz * dz
    rcc = ocx * ocx + ocy * ocy + ocz * ocz - rr2
    rdisc = rhb * rhb - rcc
    rexit = -rhb + torch.sqrt(torch.clamp_min(rdisc, 0.0))
    root_p = (rdisc >= 0.0) & (rexit > wf.T_MIN) & alive & (rr2 > 0.0)
    return torch.where(root_p, rexit * _EXIT_MUL + _EXIT_ADD, -wf.BIG)


def visit_positions(T, ray, alive_f, use_node):
    """Each ray's top visit order, as (row, pos): the ray walks row
    ``row[i]`` of the orders, where top ci comes at position
    ``pos[row[i], ci]``.  The camera's order, or with ``use_node`` the
    order of the reference point nearest the ray's warp's centroid of live
    origins (the kernels' butterfly sums)."""
    n, dev = alive_f.shape[0], alive_f.device
    if use_node:
        live = torch.clamp_min(_warp_sum(alive_f), 1.0)
        cen = [_warp_sum(o * alive_f) / live for o in ray[:3]]
        refp = T.refp
        dd = [refp[k][None, :] - cen[k][:, None] for k in range(3)]
        d2 = dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]
        d2 = torch.where(refp[3][None, :] > 0.0, d2, _FAR)
        row = torch.where(d2.min(dim=1).values < _FAR, d2.argmin(dim=1), 0)
        orders = T.norder.long()
    else:
        row = torch.zeros(n, dtype=torch.int64, device=dev)
        orders = T.order.long()
    pos = torch.empty_like(orders)
    pos.scatter_(1, orders, torch.arange(orders.shape[1], device=dev)
                 .expand_as(orders))
    return row, pos


def top_hits(T, ray, h, alive, t_cap, row, pos, passes):
    """Closest triangle hit over the sorted table, a top node at a time for
    the live rays whose cull test ``passes(ci, cull)`` (cull: min(t_best,
    t_cap)) holds; ties go to the kernels' visit order (``pos``).  Updates
    ``h`` in place."""
    n, dev = alive.shape[0], alive.device
    subn = T.subn[0].cpu().tolist()
    topr = T.topr.cpu().tolist()
    span = T.tri.shape[1]
    rank = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for ci in range(T.topr.shape[1]):
        cols = [torch.arange(li * tables.SUB, li * tables.SUB + subn[li],
                             device=dev)
                for g in range(topr[0][ci], topr[1][ci])
                for li in range(g * tables.GROUP_SUBS,
                                (g + 1) * tables.GROUP_SUBS) if subn[li]]
        if not cols:
            continue
        cull = torch.minimum(h[0], t_cap)
        sel = (passes(ci, cull) & alive).nonzero()[:, 0]
        if sel.numel():
            wf.tri_block_hits(T.tri, torch.cat(cols), ray, h, rank,
                              pos[row[sel], ci] * span, sel)


def binned_pass_ref(T: PassTables, cam_vec, state, *, n_slots, bounce,
                    primary, is_last, node_exit, use_super, width, height,
                    spp, tw, th, ntx, seed_word, samp_off, ty_off=0,
                    ty_stride=1):
    """K3's plain PyTorch version: same arguments and results as
    ``binned_pass_cuda``, on whatever device the tensors are."""
    _check_tables(T, cam_vec, None if primary else state)
    dev = T.sph.device
    n = n_slots if primary else state.shape[1]
    if n % WARP or n < WARP:
        raise ValueError(f"{n} slots are not whole warps")
    if primary:
        slot = torch.arange(n, dtype=torch.int32, device=dev)
    else:
        slot = state[ST_SLOT].to(torch.int32)
    active0, prow_c, pcol_c, pix_u, s_u = _slot_geometry(
        slot, width=width, height=height, spp=spp, tw=tw, th=th, ntx=ntx,
        seed_word=seed_word, samp_off=samp_off, ty_off=ty_off,
        ty_stride=ty_stride)

    def full(v):
        return torch.full((n,), v, dtype=_F32, device=dev)

    if primary:
        ray, tp, rad, alive_f = camera_rays(
            cam_vec, pcol_c, prow_c, pix_u, s_u, active0,
            max(width - 1, 1), max(height - 1, 1))
    else:
        ray = [state[k] for k in range(ST_OX, ST_DZ + 1)]
        tp = tuple(state[k] for k in (ST_TPR, ST_TPG, ST_TPB))
        rad = tuple(state[k] for k in (ST_RR, ST_RG, ST_RB))
        alive_f = state[ST_ALIVE]
    alive = alive_f > 0.5
    inv = [wf._inv_dir(d) for d in ray[3:]]

    h = wf.sphere_hits(T.sph.cpu().t().tolist(),
                       wf._host_clusters(T.sph_clusters), ray, alive)

    # the root-exit culling cap, and the previous selection's exit bound
    t_cap = root_cap(T.root, ray, alive)
    if not primary:
        t_cap = torch.minimum(t_cap, state[ST_EXITB])

    # each ray's top visit order: the camera's, or after the primary pass
    # with node_exit the order of the reference point nearest its warp's
    # centroid of live origins; the cull test is the top's AABB
    row, pos = visit_positions(T, ray, alive_f, node_exit and not primary)
    topa = T.topa.cpu().tolist()

    def passes(ci, cull):
        box = torch.tensor([[topa[k][ci]] for k in range(6)], dtype=_F32,
                           device=dev)
        tnear, tfar = _aabb_entry(box, ray, inv)
        return ((tnear <= tfar) & (tfar > wf.T_MIN)
                & (tnear <= cull[:, None]))[:, 0]

    top_hits(T, ray, h, alive, t_cap, row, pos, passes)
    wf.resolve_tri_normals(h)
    ray, tp, rad, cont = wf.scatter_bookkeep(ray, h, pix_u, s_u, bounce, tp,
                                             rad, alive)
    alive_f = torch.where(cont, 1.0, 0.0).to(_F32)
    planes = list(ray) + list(tp) + list(rad) + [alive_f, slot.to(_F32)]

    if is_last:
        return (torch.stack(planes + [full(0.0)]),
                torch.full((n,), KEY_DEAD, dtype=torch.int32, device=dev))

    # next-top selection: the nearest top AABB each new ray enters, and the
    # farthest exit over the tops (or supertops) it overlaps
    alive2 = cont
    niv = [wf._inv_dir(d) for d in ray[3:]]
    if use_super:
        tn_s, tf_s = _aabb_entry(T.supa, ray, niv)
        ok_s = (tn_s <= tf_s) & (tf_s > wf.T_MIN)
        exit_e = torch.where(ok_s, tf_s, -wf.BIG).max(dim=1).values
        exit_e = torch.clamp_min(exit_e, -wf.BIG)
        tn_c, tf_c = _aabb_entry(T.topap, ray, niv)
        ok_c = (tn_c <= tf_c) & (tf_c > wf.T_MIN)
        e_c = torch.where(ok_c, tn_c, wf.BIG)
        be, bc = full(wf.BIG), full(-1.0)
        for si in range(T.supa.shape[1]):
            guard = torch.where(alive2, be, -wf.BIG)
            descend = _warp_any(ok_s[:, si] & (tn_s[:, si] < guard))
            if not bool(descend.any()):
                continue
            for ci in range(si * SUPER, (si + 1) * SUPER):
                better = descend & (e_c[:, ci] < be)
                be = torch.where(better, e_c[:, ci], be)
                bc = torch.where(better, float(ci), bc)
        best_c = bc.to(torch.int32)
    else:
        tn_c, tf_c = _aabb_entry(T.topa, ray, niv)
        ok_c = (tn_c <= tf_c) & (tf_c > wf.T_MIN)
        exit_e = torch.clamp_min(
            torch.where(ok_c, tf_c, -wf.BIG).max(dim=1).values, -wf.BIG)
        e_c = torch.where(ok_c, tn_c, wf.BIG)
        best_e, arg = e_c.min(dim=1)
        best_c = torch.where(best_e < wf.BIG, arg, -1).to(torch.int32)
    found = best_c >= 0
    exitb = torch.where(found, exit_e * _EXIT_MUL + _EXIT_ADD, -wf.BIG)

    klo = T.klo.cpu().numpy()
    khi = T.khi.cpu().numpy()
    span_k = np.maximum(khi - klo, _KEY_SPAN_MIN)

    def q3(v, k):
        cell = (v - float(klo[k])) / torch.tensor(
            float(span_k[k]), dtype=_F32, device=dev) * 8.0
        return torch.clamp(cell, 0.0, 7.0).to(torch.int32)

    def qd(v):
        return torch.clamp((v + 1.0) * 2.0, 0.0, 3.0).to(torch.int32)

    ox, oy, oz, dx, dy, dz = ray
    cell = q3(ox, 0) * 64 + q3(oy, 1) * 8 + q3(oz, 2)
    sub_key = (qd(dx) * 16 + qd(dy) * 4 + qd(dz)) * 512 + cell
    key = torch.where(found, best_c * (1 << KEY_SUB_BITS) + sub_key,
                      KEY_NOMESH + sub_key)
    keys = torch.where(alive2, key, KEY_DEAD).to(torch.int32)
    return torch.stack(planes + [exitb]), keys


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def shard_lanes(width, height, spp, th, nty, tile_row_offset=0,
                tile_row_stride=1) -> int:
    """The in-image lanes of the tile rows ``tile_row_offset + k *
    tile_row_stride`` (k < nty): the live rays of their primary pass."""
    rows = sum(min(max(height - (tile_row_offset + k * tile_row_stride)
                       * th, 0), th) for k in range(nty))
    return rows * width * spp


def _pass_tables(sph, tri, sub_counts, top_bounds, top_ranges, root,
                 ref_pts, node_orders, node_keys, node_run_bounds, key_lo,
                 key_hi, sub_aabb, grp_aabb, top_aabb, *, sph_clusters=None,
                 top_order=None, top_keys=None) -> PassTables:
    """The pass tables for one camera: its order (table order with -inf
    keys, so no early exit, when none is given), its run bounds and the
    supertop boxes."""
    n_tops = top_bounds.shape[1]
    dev = top_bounds.device
    if top_order is None:
        top_order = torch.arange(n_tops, dtype=torch.int32,
                                 device=dev).reshape(1, n_tops)
        top_keys = torch.full((1, n_tops), float("-inf"), dtype=_F32,
                              device=dev)
    _check_index_ranges(sph, sph_clusters, sub_counts, top_ranges,
                        grp_aabb.shape[1], top_order, node_orders)
    supa, topap = super_tables(top_aabb)
    return PassTables(sph, sph_clusters, tri, sub_counts, top_ranges,
                      top_order, top_keys, run_bounds(top_bounds, top_order),
                      ref_pts, node_orders, node_keys, node_run_bounds, root,
                      key_lo, key_hi, sub_aabb, grp_aabb, top_aabb, supa,
                      topap)


def render_linear_binned(sph, tri, sub_bounds, sub_counts, grp_bounds,
                         top_bounds, top_ranges, root, ref_pts, node_orders,
                         node_keys, node_run_bounds, key_lo, key_hi,
                         sub_aabb, grp_aabb, top_aabb, cam_vec, *, width,
                         height, samples_per_pixel, depth, seed=0,
                         sample_offset=0, sph_clusters=None, top_order=None,
                         top_keys=None, node_exit=True, super_selection=None,
                         tile_row_offset=0, tile_row_stride=1,
                         shard_tile_rows=None, bounce_caps=None,
                         return_alive=False, plain=False):
    """Mean linear radiance [H, W, 3] + segment count through the binned
    pipeline (``render_linear_pallas_binned``'s arguments; tables from
    ``tables.pack_spheres`` and ``tables.build_tri_sorted_tables`` as
    tensors on one device; always the correct plane equation).

    ``sample_offset`` shifts the global sample index (a power-of-two part
    of a larger spp).  ``bounce_caps``: slot counts for bounces
    1..depth-1 (whole warps); with them a third output, an int read in
    the same sync as the segment count, counts the live rays the caps
    dropped (0: the frame is exact).  ``return_alive`` returns the live count of
    every bounce instead.  ``plain=True`` runs every pass through
    ``binned_pass_ref``.

    ``tile_row_offset`` / ``tile_row_stride`` / ``shard_tile_rows`` render
    an interleaved subset of tile rows (``parallel.sharding``): shard i of
    n passes (i, n, ceil(nty / n)) and owns the global tile rows i, i + n,
    ...; the result is then its [shard_tile_rows * TH, W, 3] rows, not
    cropped to the image (tile rows past it are dead lanes).  Per-pixel
    math depends only on the global (row, col), so the de-interleaved
    shards are the whole frame's pixels."""
    if depth < 1:
        raise ValueError("the binned engine needs depth >= 1")
    spp = samples_per_pixel
    tw, th, ntx, nty, rows_total = tile_geometry(width, height, spp)
    sharded = tile_row_stride != 1 or shard_tile_rows is not None
    if shard_tile_rows is not None:
        nty = shard_tile_rows
        rows_total = ntx * nty * TILE_ROWS
    if min(nty, tile_row_stride) < 1 or tile_row_offset < 0:
        raise ValueError(f"tile rows {tile_row_offset} + k * "
                         f"{tile_row_stride}, k < {nty}: not a subset")
    n_slots = rows_total * LANES
    T = _pass_tables(sph, tri, sub_counts, top_bounds, top_ranges, root,
                     ref_pts, node_orders, node_keys, node_run_bounds,
                     key_lo, key_hi, sub_aabb, grp_aabb, top_aabb,
                     sph_clusters=sph_clusters, top_order=top_order,
                     top_keys=top_keys)
    _check_tables(T, cam_vec, None)
    if super_selection is None:
        super_selection = top_bounds.shape[1] >= SUPER_MIN_TOPS
    run = binned_pass_ref if plain else binned_pass_cuda
    geo = dict(width=width, height=height, spp=spp, tw=tw, th=th, ntx=ntx,
               seed_word=rng.seed_word(seed), samp_off=sample_offset,
               ty_off=tile_row_offset, ty_stride=tile_row_stride)

    def one_pass(state, b):
        last = b == depth - 1
        return run(T, cam_vec, state, n_slots=n_slots, bounce=b,
                   primary=b == 0, is_last=last, node_exit=node_exit,
                   use_super=super_selection and not last, **geo)

    state, keys = one_pass(None, 0)
    # bounce 0 traces exactly this render's in-image lanes
    segments = shard_lanes(width, height, spp, th, nty, tile_row_offset,
                           tile_row_stride)
    alive_counts = [torch.tensor(float(segments), device=sph.device)]
    seg_t = torch.zeros((), dtype=_F32, device=sph.device)
    overflow = torch.zeros((), dtype=_F32, device=sph.device)
    tails = []
    for b in range(1, depth):
        alive_b = state[ST_ALIVE].sum()
        alive_counts.append(alive_b)
        seg_t = seg_t + alive_b
        cap = None
        if bounce_caps is not None and b - 1 < len(bounce_caps):
            cap = max((int(bounce_caps[b - 1]) // WARP) * WARP, WARP)
        state, tail = regroup(state, keys, cap)
        if tail is not None:
            tails.append(tail)
            overflow = overflow + tail[ST_ALIVE].sum()
        state, keys = one_pass(state, b)

    # image assembly: every slot's radiance back at its slot, the samples
    # of a pixel summed, tiles to rows
    if tails:
        state = torch.cat([state] + tails[::-1], dim=1)
    rgb = state[ST_RR:ST_RB + 1]
    if depth > 1:
        out = torch.empty_like(rgb)
        out[:, state[ST_SLOT].long()] = rgb
        rgb = out
    img = rgb.t().reshape(nty, ntx, TILE_ROWS * LANES // spp, spp, 3)
    img = img.sum(dim=3).reshape(nty, ntx, th, tw, 3)
    img = img.permute(0, 2, 1, 3, 4).reshape(nty * th, ntx * tw, 3)
    if not sharded:
        img = img[:height]
    mean = img[:, :width] * (1.0 / spp)
    if return_alive:
        return mean, segments + int(seg_t), [int(c) for c in alive_counts]
    if bounce_caps is not None:
        traced, dropped = torch.stack([seg_t, overflow]).tolist()
        return mean, segments + int(traced), int(dropped)
    return mean, segments + int(seg_t)
