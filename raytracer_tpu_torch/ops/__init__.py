"""Render engines and engine dispatch (port of ``raytracer_tpu/ops``).

``render_linear_fast`` renders the mean linear image of a frame through the
engine ``resolve_dispatch`` picks:

  * ``cuda``  -- K1, the hand-written fused CUDA kernel
    (``ops/cuda/wavefront.py``, ``csrc/wavefront.cu``);
  * ``torch`` -- K1's plain PyTorch version, on the tensors' device.

The gradient pass has engines of its own, named as in the JAX package
(``grad.make_loss_fn``): ``"pallas"`` is ``ops/diff.py``'s
``render_linear_diff``, K1 forward and K5 (``ops/cuda/wavefront_bwd.py``,
``csrc/wavefront_bwd.cu``) backward; ``"xla"`` is autograd through the
wavefront renderer ``render.render_linear``.

The JAX package's binned, streamed and sorted engines are not ported yet,
so every scene, however many triangles it has, goes to K1.  There is no
silent fallback: a CUDA device gets the kernel or an error.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..camera import Camera
from ..scene import Scene
from . import tables
from .cuda import wavefront

__all__ = ["CLUSTER_MIN_SPHERES", "CLUSTER_MIN_TRIS", "ENGINES",
           "resolve_dispatch", "scene_tables", "render_linear_fast"]

# primitive counts from which K1 culls by cluster AABBs instead of scanning
# flat.  Starting values carried from the TPU kernel; to be measured again
# on the card.
CLUSTER_MIN_SPHERES = 64
CLUSTER_MIN_TRIS = 64

ENGINES = ("auto", "cuda", "torch")

# Packed tables are memoised on the identity of the scene (interactive
# camera moves and bench loops render the SAME scene every frame);
# ``pack_events`` counts the packing work actually done.
_TABLE_CACHE: dict = {}
pack_events = 0


def resolve_dispatch(scene: Scene, parity_plane_sign, engine: str = "auto",
                     device="cuda"):
    """Resolve (engine, parity_plane_sign) for a render on ``device``.

    ``engine="auto"`` is ``"cuda"`` (K1) on a CUDA device and ``"torch"``
    (K1's plain version) on the CPU; an explicit ``"cuda"`` on a CPU device
    raises.  ``parity_plane_sign=None`` resolves per scene: reference
    scenes (``exact_planes=False``) get the reference's wrong-sign plane
    equation (common.rs:140-141), procedural scenes the correct one.  Only
    K1 is ported, so no scene goes to a binned, streamed or sorted engine.
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
        engine = "cuda" if device.type == "cuda" else "torch"
    elif engine == "cuda" and device.type != "cuda":
        raise ValueError(f"engine 'cuda' needs a CUDA device, got {device}")
    return engine, bool(parity_plane_sign)


def scene_tables(scene: Scene, parity_plane_sign: bool, device):
    """K1's tables for ``scene`` on ``device``, cached on the scene's
    identity: (sph, tri, sph_clusters, tri_clusters).

    Spheres are clustered from CLUSTER_MIN_SPHERES valid spheres.
    Triangles are clustered only with the correct plane equation: under
    ``parity_plane_sign`` bounce rays register hits at t values unrelated
    to the triangle's geometry, so no vertex-derived bound contains them.
    """
    global pack_events
    device = torch.device(device)
    key = (id(scene), bool(parity_plane_sign), str(device))
    hit = _TABLE_CACHE.get(key)
    if hit is not None and hit[0]() is scene:
        return hit[1]
    pack_events += 1
    host = scene.numpy()

    def dev(a):
        return torch.from_numpy(a).to(device)

    sph_perm = tri_perm = sph_cl = tri_cl = None
    if int(np.sum(host.sphere_valid)) >= CLUSTER_MIN_SPHERES:
        sph_perm, b, r = tables.cluster_spheres(host)
        sph_cl = (dev(b), dev(r))
    if (not parity_plane_sign
            and int(np.sum(host.tri_valid)) >= CLUSTER_MIN_TRIS):
        tri_perm, b, r = tables.cluster_triangles(host)
        tri_cl = (dev(b), dev(r))
    result = (dev(tables.pack_spheres(host, perm=sph_perm)),
              dev(tables.pack_triangles(host, perm=tri_perm)), sph_cl, tri_cl)
    for k in [k for k, v in _TABLE_CACHE.items() if v[0]() is None]:
        del _TABLE_CACHE[k]
    _TABLE_CACHE[key] = (weakref.ref(scene), result)
    return result


def render_linear_fast(scene: Scene, camera: Camera, *, width: int,
                       height: int, samples_per_pixel: int, depth: int,
                       device, seed: int = 0,
                       parity_plane_sign: bool | None = None,
                       engine: str = "auto", progress=None):
    """Mean linear radiance [H, W, 3] (render row order) on ``device`` and
    the traced-segment count.

    progress: optional ``progress(rows_done, height)`` -- the reference's
    scanline logger hook (common.rs:328-330).  With it the image renders in
    row bands, the callback firing per band; each pixel depends only on its
    global (row, col), so the banded image is bitwise the unbanded one.
    """
    engine, parity_plane_sign = resolve_dispatch(
        scene, parity_plane_sign, engine, device)
    render = (wavefront.render_linear_cuda if engine == "cuda"
              else wavefront.render_linear_ref)
    sph, tri, sph_cl, tri_cl = scene_tables(scene, parity_plane_sign, device)
    cv = tables.camera_vec(camera).to(device)
    kw = dict(width=width, height=height,
              samples_per_pixel=samples_per_pixel, depth=depth, seed=seed,
              parity_plane_sign=parity_plane_sign, sph_clusters=sph_cl,
              tri_clusters=tri_cl)
    if progress is None or height <= 1:
        return render(sph, tri, cv, **kw)
    return _render_banded(render, sph, tri, cv, progress=progress, **kw)


def _render_banded(render, sph, tri, cv, *, height, progress, **kw):
    """Row-banded render for progress reporting: at most 16 equal bands,
    each one launch with ``shard_rows=band``; rows past the image in the
    tail band are dead lanes."""
    band = max(1, -(-height // 16))
    pieces = []
    segments = 0
    for r0 in range(0, height, band):
        rows_here = min(band, height - r0)
        mean, segs = render(sph, tri, cv, height=height, shard_rows=band,
                            row_offset=r0, **kw)
        pieces.append(mean[:rows_here])
        segments += segs
        progress(r0 + rows_here, height)
    return torch.cat(pieces, dim=0), segments
