"""Render engines and engine dispatch (port of ``raytracer_tpu/ops``).

``render_linear_fast`` renders the mean linear image of a frame through the
engine ``resolve_dispatch`` picks:

  * ``cuda`` -- K1, the hand-written fused CUDA kernel
    (``ops/cuda/wavefront.py``, ``csrc/wavefront.cu``): parity scenes,
    scenes under BINNED_MIN_TRIS triangles, and meshes of BINNED_MIN_TRIS
    to SORTED_MIN_TRIS triangles at a spp or shape the binned engine does
    not take;
  * ``cuda_binned`` -- K3, the binned per-bounce engine
    (``ops/cuda/wavefront_binned.py``, ``csrc/wavefront_binned.cu``):
    unbanded renders of exact-plane meshes of at least BINNED_MIN_TRIS
    triangles at a spp and shape ``binned_spp_ok`` takes (spp <= 128,
    under 2^24 ray slots per power-of-two part);
  * ``cuda_sorted`` -- K6, the sorted per-bounce engine
    (``ops/cuda/wavefront_sorted.py``, ``csrc/wavefront_sorted.cu``):
    unbanded renders of exact-plane meshes of at least SORTED_MIN_TRIS
    triangles that the binned engine does not take (spp > 128, unknown,
    or past 2^24 ray slots);
  * ``cuda_stream`` -- K4, the streamed big-mesh kernel
    (``ops/cuda/wavefront_stream.py``, ``csrc/wavefront_stream.cu``): the
    banded renders (a progress logger, as the CLI's) of those meshes, one
    launch per band, since the binned and sorted engines render whole
    reordered frames;
  * ``torch``, ``torch_binned``, ``torch_sorted``, ``torch_stream`` --
    their plain PyTorch versions, on the tensors' device.  ``auto`` on the
    CPU is ``torch``.

The gradient pass has engines of its own, named as in the JAX package
(``grad.make_loss_fn``): ``"pallas"`` is ``ops/diff.py``'s
``render_linear_diff``, K1 forward and K5 (``ops/cuda/wavefront_bwd.py``,
``csrc/wavefront_bwd.cu``) backward; ``"xla"`` is autograd through the
wavefront renderer ``render.render_linear``.

There is no silent fallback: a CUDA device gets the kernel or an error.
The binned engine's working-set caps are autotuned per (scene, camera,
shape) from one uncapped probe frame; each capped frame reads its overflow
guard in the sync that ends it and, when a cap dropped a live ray, renders
again uncapped (``flush_binned_overflow_checks`` counts such frames).
"""

from __future__ import annotations

import math
import warnings
import weakref

import numpy as np
import torch

from ..camera import Camera
from ..scene import Scene
from . import tables
from .cuda import wavefront
from .cuda import wavefront_binned as binned
from .cuda import wavefront_sorted as wso
from .cuda import wavefront_stream as stream

__all__ = ["CLUSTER_MIN_SPHERES", "CLUSTER_MIN_TRIS", "BINNED_MIN_TRIS",
           "SORTED_MIN_TRIS", "ENGINES", "binned_spp_ok", "resolve_dispatch",
           "scene_tables", "scene_sorted_tables", "scene_stream_tables",
           "render_linear_fast", "flush_binned_overflow_checks"]

# primitive counts from which K1 culls by cluster AABBs instead of scanning
# flat.  Starting values carried from the TPU kernel; to be measured again
# on the card.
CLUSTER_MIN_SPHERES = 64
CLUSTER_MIN_TRIS = 64
# triangle count from which an exact-plane scene goes to the binned engine
# (K3).  A crossover measured on a TPU v5e, carried as a starting value;
# chip_smoke.py measures K1 against K3 on the card.
BINNED_MIN_TRIS = 1024
# triangle count from which an exact-plane frame the binned engine does not
# take goes to the sorted engine (K6) instead of K1.  Measured on a TPU
# v5e (PERFSTUDY "sorted" study), carried as a starting value;
# chip_smoke.py measures K1 against K6 on the card at 1292 triangles.
SORTED_MIN_TRIS = 2048

ENGINES = ("auto", "cuda", "torch", "cuda_binned", "torch_binned",
           "cuda_sorted", "torch_sorted", "cuda_stream", "torch_stream")
_KERNEL_ENGINES = ("cuda", "cuda_binned", "cuda_sorted", "cuda_stream")
_BINNED = ("cuda_binned", "torch_binned")
_SORTED = ("cuda_sorted", "torch_sorted")
_STREAM = ("cuda_stream", "torch_stream")

# Packed tables are memoised on the identity of the scene (interactive
# camera moves and bench loops render the SAME scene every frame);
# ``pack_events`` counts the packing work actually done.
_TABLE_CACHE: dict = {}
pack_events = 0


def binned_spp_ok(samples_per_pixel, width=None, height=None) -> bool:
    """The binned engine takes 1..128 spp (a spp that is not a power of
    two renders as power-of-two parts, ``_binned_spp_parts``) and, when the
    shape is known, fewer than 2^24 ray slots per part (the slot id rides a
    float32 state plane)."""
    spp = samples_per_pixel
    if spp is None or not 1 <= spp <= 128:
        return False
    if width is not None and height is not None:
        for part in _binned_spp_parts(spp):
            try:
                binned.tile_geometry(width, height, part)
            except ValueError:
                return False
    return True


def _binned_spp_parts(spp: int):
    """Power-of-two decomposition of ``spp``, largest first: 50 -> (32, 16,
    2).  Each part renders on the global sample index, and the pre-mean
    images sum."""
    parts = []
    bit = 128
    while spp:
        if spp >= bit:
            parts.append(bit)
            spp -= bit
        else:
            bit >>= 1
    return tuple(parts)


def resolve_dispatch(scene: Scene, parity_plane_sign, engine: str = "auto",
                     device="cuda", *, samples_per_pixel=None, width=None,
                     height=None):
    """Resolve (engine, parity_plane_sign) for an unbanded render on
    ``device`` (``render_linear_fast`` turns the binned and sorted engines
    into the streamed ones for banded renders).

    ``engine="auto"``: on a CUDA device, for a scene with the correct plane
    equation, ``cuda_binned`` (K3) from BINNED_MIN_TRIS valid triangles at
    a spp (and shape, when given) that ``binned_spp_ok`` takes, else
    ``cuda_sorted`` (K6) from SORTED_MIN_TRIS triangles; ``cuda`` (K1)
    otherwise, and on the CPU ``torch`` (K1's plain version).  The JAX
    package's order (its ``ops/__init__.py:311-319``).
    A kernel engine on a CPU device raises.  ``parity_plane_sign=None``
    resolves per scene: reference scenes (``exact_planes=False``) get the
    reference's wrong-sign plane equation (common.rs:140-141), procedural
    and OBJ scenes the correct one.
    """
    device = torch.device(device)
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{ENGINES}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if parity_plane_sign is None:
        parity_plane_sign = not scene.exact_planes
    if engine == "auto":
        n_tris = int(scene.tri_valid.sum())
        spp_ok = binned_spp_ok(samples_per_pixel, width, height)
        if device.type != "cuda":
            engine = "torch"
        elif not parity_plane_sign and n_tris >= SORTED_MIN_TRIS:
            engine = "cuda_binned" if spp_ok else "cuda_sorted"
        elif not parity_plane_sign and n_tris >= BINNED_MIN_TRIS and spp_ok:
            engine = "cuda_binned"
        else:
            engine = "cuda"
    elif engine in _KERNEL_ENGINES and device.type != "cuda":
        raise ValueError(f"engine {engine!r} needs a CUDA device, got "
                         f"{device}")
    return engine, bool(parity_plane_sign)


def _cached(scene: Scene, key, build):
    """``build(host_scene)`` memoised on the scene's identity and ``key``;
    entries of dead scenes are dropped."""
    global pack_events
    key = (id(scene),) + key
    hit = _TABLE_CACHE.get(key)
    if hit is not None and hit[0]() is scene:
        return hit[1]
    pack_events += 1
    result = build(scene.numpy())
    for k in [k for k, v in _TABLE_CACHE.items() if v[0]() is None]:
        del _TABLE_CACHE[k]
    _TABLE_CACHE[key] = (weakref.ref(scene), result)
    return result


def _spheres(host, dev):
    """Sphere table and clusters (from CLUSTER_MIN_SPHERES valid spheres)."""
    perm = cl = None
    if int(np.sum(host.sphere_valid)) >= CLUSTER_MIN_SPHERES:
        perm, b, r = tables.cluster_spheres(host)
        cl = (dev(b), dev(r))
    return dev(tables.pack_spheres(host, perm=perm)), cl


def _to(device):
    device = torch.device(device)
    return lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)


def scene_tables(scene: Scene, parity_plane_sign: bool, device):
    """K1's tables for ``scene`` on ``device``, cached on the scene's
    identity: (sph, tri, sph_clusters, tri_clusters).

    Spheres are clustered from CLUSTER_MIN_SPHERES valid spheres.
    Triangles are clustered only with the correct plane equation: under
    ``parity_plane_sign`` bounce rays register hits at t values unrelated
    to the triangle's geometry, so no vertex-derived bound contains them.
    """
    dev = _to(device)

    def build(host):
        sph, sph_cl = _spheres(host, dev)
        tri_perm = tri_cl = None
        if (not parity_plane_sign
                and int(np.sum(host.tri_valid)) >= CLUSTER_MIN_TRIS):
            tri_perm, b, r = tables.cluster_triangles(host)
            tri_cl = (dev(b), dev(r))
        return (sph, dev(tables.pack_triangles(host, perm=tri_perm)), sph_cl,
                tri_cl)

    return _cached(scene, (bool(parity_plane_sign), str(torch.device(device))),
                   build)


def scene_sorted_tables(scene: Scene, device):
    """K3's tables on ``device``, cached on the scene's identity: (sph,
    sph_clusters) + the 16 tensors of ``tables.build_tri_sorted_tables``."""
    dev = _to(device)
    return _cached(scene, ("sorted", str(torch.device(device))), lambda h: (
        *_spheres(h, dev),
        *(dev(t) for t in tables.build_tri_sorted_tables(h))))


def scene_stream_tables(scene: Scene, device):
    """K4's tables on ``device``, cached on the scene's identity: (sph,
    sph_clusters, tri, leaf_bounds, leaf_counts, top_bounds, top_ranges,
    root, sub_bounds)."""
    dev = _to(device)
    return _cached(scene, ("stream", str(torch.device(device))), lambda h: (
        *_spheres(h, dev),
        *(dev(t) for t in stream.build_tri_stream_tables(h,
                                                         sub_bounds=True))))


def _camera_order(top_bounds, camera: Camera, device):
    """The camera's front-to-back top order and keys, on ``device``."""
    order, keys = stream.sorted_top_order(top_bounds.cpu().numpy(),
                                          camera.origin.cpu().numpy())
    return (torch.from_numpy(order).to(device),
            torch.from_numpy(keys).to(device))


# autotuned per-bounce working-set caps of the binned engine, keyed on
# (scene id, device, shape, spp part, camera bytes, plain); values carry a
# weakref to the scene so a recycled id() never inherits caps, and a new
# viewpoint re-probes
_BINNED_CAPS: dict = {}
# capped frames that dropped live rays since flush_binned_overflow_checks
_overflowed_frames = 0
# (camera bytes, top order, keys) per (scene, camera, device)
_BINNED_ORDER_CACHE: dict = {}


def flush_binned_overflow_checks() -> int:
    """How many capped frames dropped live rays since the last call (each
    was rendered again uncapped before it was returned); 0 certifies every
    capped frame exact.  Resets the count."""
    global _overflowed_frames
    bad, _overflowed_frames = _overflowed_frames, 0
    return bad


def _camera_top_order(scene: Scene, camera: Camera, top_bounds, device):
    """(camera bytes, top order, keys) of ``camera`` over the sorted
    tables' tops, cached per (scene, camera, device)."""
    okey = (id(scene), id(camera), str(torch.device(device)))
    hit = _BINNED_ORDER_CACHE.get(okey)
    if hit is not None and hit[0]() is scene and hit[1]() is camera:
        return hit[2]
    cam_bytes = tables.camera_vec(camera).cpu().numpy().tobytes()
    order, keys = _camera_order(top_bounds, camera, device)
    if len(_BINNED_ORDER_CACHE) > 64:
        _BINNED_ORDER_CACHE.clear()
    _BINNED_ORDER_CACHE[okey] = (weakref.ref(scene), weakref.ref(camera),
                                 (cam_bytes, order, keys))
    return cam_bytes, order, keys


def _render_sorted(scene: Scene, camera: Camera, *, width, height,
                   samples_per_pixel, depth, seed, device, plain):
    """Sorted-engine frame (K6, or its plain version): the sorted tables
    and the camera's top order from the caches ``_render_binned`` uses."""
    (sph, sph_cl, *sorted_t) = scene_sorted_tables(scene, device)
    _, order, keys = _camera_top_order(scene, camera, sorted_t[4], device)
    return wso.render_linear_sorted(
        sph, *sorted_t, tables.camera_vec(camera).to(device), width=width,
        height=height, samples_per_pixel=samples_per_pixel, depth=depth,
        seed=seed, sph_clusters=sph_cl, top_order=order, top_keys=keys,
        plain=plain)


def _render_binned(scene: Scene, camera: Camera, *, width, height,
                   samples_per_pixel, depth, seed, device, plain):
    """Binned-engine frame with autotuned caps and overflow checks
    (``ops/__init__.py:396-508`` of the JAX package).  A new (scene,
    camera, shape) renders one uncapped probe frame, exact by construction,
    that measures each bounce's live rays; later frames run with caps of
    1.15x those counts in whole warps.  A tripped guard (read in the
    frame's closing sync) warns, drops the caps and renders the same frame
    again uncapped.  A spp that is not a
    power of two renders as power-of-two parts on the global sample
    index."""
    (sph, sph_cl, *sorted_t) = scene_sorted_tables(scene, device)
    cv = tables.camera_vec(camera).to(device)
    cam_bytes, order, keys = _camera_top_order(scene, camera, sorted_t[4],
                                               device)
    common = dict(width=width, height=height, depth=depth, seed=seed,
                  sph_clusters=sph_cl, top_order=order, top_keys=keys,
                  plain=plain)

    def render(spp, offset, **kw):
        return binned.render_linear_binned(
            sph, *sorted_t, cv, samples_per_pixel=spp, sample_offset=offset,
            **common, **kw)

    def render_part(spp, offset):
        global _overflowed_frames
        if depth <= 1:
            return render(spp, offset)
        cap_key = (id(scene), str(torch.device(device)), width, height, spp,
                   depth, offset, cam_bytes, plain)
        hit = _BINNED_CAPS.get(cap_key)
        caps = hit[1] if hit is not None and hit[0]() is scene else None
        if caps is None:
            mean, segs, alive = render(spp, offset, return_alive=True)
            caps = tuple(max(binned.WARP, -(-math.ceil(c * 1.15)
                                             // binned.WARP) * binned.WARP)
                         for c in alive[1:])
            if len(_BINNED_CAPS) > 64:
                _BINNED_CAPS.clear()
            _BINNED_CAPS[cap_key] = (weakref.ref(scene), caps)
            return mean, segs
        mean, segs, dropped = render(spp, offset, bounce_caps=caps)
        if dropped:
            _overflowed_frames += 1
            _BINNED_CAPS.clear()
            warnings.warn(
                f"binned working-set caps overflowed ({dropped} live rays "
                f"dropped); caps invalidated: re-rendering this frame "
                f"uncapped", stacklevel=4)
            mean, segs = render(spp, offset)
        return mean, segs

    parts = _binned_spp_parts(samples_per_pixel)
    if len(parts) == 1:
        return render_part(parts[0], 0)
    total, segments, offset = None, 0, 0
    for spp in parts:
        mean, segs = render_part(spp, offset)
        piece = mean * float(spp)
        total = piece if total is None else total + piece
        segments += segs
        offset += spp
    return total * (1.0 / samples_per_pixel), segments


def _stream_call(scene, camera, device, plain):
    """(K4 or its plain version, its tables + camera vector, keywords)."""
    (sph, sph_cl, tri, leafb, leafn, topb, topr, root,
     subb) = scene_stream_tables(scene, device)
    order, keys = _camera_order(topb, camera, device)
    fn = (stream.render_linear_stream_ref if plain
          else stream.render_linear_stream_cuda)
    return fn, (sph, tri, leafb, leafn, topb, topr, root,
                tables.camera_vec(camera).to(device)), dict(
        sph_clusters=sph_cl, top_order=order, top_keys=keys,
        sub_bounds=subb)


def render_linear_fast(scene: Scene, camera: Camera, *, width: int,
                       height: int, samples_per_pixel: int, depth: int,
                       device, seed: int = 0,
                       parity_plane_sign: bool | None = None,
                       engine: str = "auto", progress=None):
    """Mean linear radiance [H, W, 3] (render row order) on ``device`` and
    the traced-segment count.

    progress: optional ``progress(rows_done, height)`` -- the reference's
    scanline logger hook (common.rs:328-330).  With it the image renders in
    row bands, the callback firing per band (the binned engines give way to
    the streamed ones); each pixel depends only on its global (row, col),
    so the banded image is bitwise the unbanded one.  A frame of depth 0
    (black) goes to K1 or its plain version: the binned engine traces at
    least one bounce.  Banded renders of the sorted engines go to the
    streamed ones too, as the JAX package does.
    """
    engine, parity_plane_sign = resolve_dispatch(
        scene, parity_plane_sign, engine, device,
        samples_per_pixel=samples_per_pixel, width=width, height=height)
    if engine in _BINNED + _SORTED + _STREAM and parity_plane_sign:
        raise ValueError(f"engine {engine!r} needs parity_plane_sign=False "
                         f"(its bound culling is unsound with the "
                         f"reference's plane sign)")
    banded = progress is not None and height > 1
    if engine in _BINNED + _SORTED and banded:
        engine = "cuda_stream" if engine.startswith("cuda") \
            else "torch_stream"
    if engine in _BINNED and depth < 1:
        engine = "cuda" if engine == "cuda_binned" else "torch"
    kw = dict(width=width, height=height,
              samples_per_pixel=samples_per_pixel, depth=depth, seed=seed)
    if engine in _BINNED:
        if not binned_spp_ok(samples_per_pixel, width, height):
            raise ValueError(
                f"engine {engine!r} needs samples_per_pixel <= 128 and "
                f"fewer than 2^24 ray slots (slot ids ride a float32 state "
                f"plane)")
        return _render_binned(scene, camera, device=device,
                              plain=engine == "torch_binned", **kw)
    if engine in _SORTED:
        return _render_sorted(scene, camera, device=device,
                              plain=engine == "torch_sorted", **kw)
    if engine in _STREAM:
        render, args, extra = _stream_call(scene, camera, device,
                                           engine == "torch_stream")
    else:
        render = (wavefront.render_linear_cuda if engine == "cuda"
                  else wavefront.render_linear_ref)
        sph, tri, sph_cl, tri_cl = scene_tables(scene, parity_plane_sign,
                                                device)
        args = (sph, tri, tables.camera_vec(camera).to(device))
        extra = dict(parity_plane_sign=parity_plane_sign, sph_clusters=sph_cl,
                     tri_clusters=tri_cl)
    if not banded:
        return render(*args, **kw, **extra)
    return _render_banded(render, args, progress=progress, **kw, **extra)


def _render_banded(render, args, *, height, progress, **kw):
    """Row-banded render for progress reporting: at most 16 equal bands,
    each one launch with ``shard_rows=band``; rows past the image in the
    tail band are dead lanes."""
    band = max(1, -(-height // 16))
    pieces = []
    segments = 0
    for r0 in range(0, height, band):
        rows_here = min(band, height - r0)
        mean, segs = render(*args, height=height, shard_rows=band,
                            row_offset=r0, **kw)
        pieces.append(mean[:rows_here])
        segments += segs
        progress(r0 + rows_here, height)
    return torch.cat(pieces, dim=0), segments
