"""Sharded rendering: rays across a mesh, scene replicated (port of
``raytracer_tpu/parallel/sharding.py``).

Every shard traces an interleaved subset of the frame on its own device
with the one-device code, and the shards' pieces are gathered and
de-interleaved into the whole image.  Per-pixel results depend only on the
global pixel (or row) id, so the image is the one-device image, bit for
bit.  The interleave keeps the shards' work balanced: sky rows retire in a
bounce or two while ground and glass rows run every bounce, so contiguous
bands balance badly (``tests/test_torch_scaling.py``).

  * ``render_linear_sharded``: the wavefront renderer
    (``render.accumulate_samples``), pixels i, i + n, ... on shard i,
    padding pixels as dead lanes; differentiable.
  * ``render_linear_sharded_fast``: the kernels (``ops.resolve_dispatch``)
    on rows i, i + n, ... (K1, K4) or 16-row tile rows i, i + n, ... (K3);
    forward only.
  * ``render_linear_diff_sharded``: K1 + K5 (or K2 + K5s) per shard on
    rows i, i + n, ...; differentiable.

The scene's gradients are summed over the shards.  In one process each
shard's scene is a differentiable ``.to(device)`` of the caller's, and
autograd sums the cotangents.  Across processes (``mesh.group``), the
scene's and camera's differentiable tensors pass once through an identity
whose backward ``all_reduce``s their cotangent, and the image is an
``all_gather`` whose backward keeps this rank's rows; every rank returns the
whole image, and the segment count is summed over the group.

The shards of one process run one after another: the kernel wrappers
return the segment count as a Python int, a device sync per shard.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from .. import ops, rng
from ..camera import Camera
from ..ops import diff as diff_mod
from ..ops import tables
from ..ops.cuda import wavefront
from ..ops.cuda import wavefront_binned as binned
from ..render import Options, accumulate_samples, finalize_image
from ..scene import Scene
from .mesh import Mesh, make_mesh, pad_to_multiple

__all__ = ["render_linear_sharded", "render_linear_sharded_fast",
           "render_linear_diff_sharded", "ray_trace_sharded"]

_BINNED = ("cuda_binned", "torch_binned")


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _comm_device(mesh: Mesh) -> torch.device:
    """Where the group's collectives run: the mesh's device under NCCL,
    the CPU under gloo."""
    import torch.distributed as dist
    if dist.get_backend(mesh.group) == "nccl":
        return mesh.device
    return torch.device("cpu")


class _GatherShards(torch.autograd.Function):
    """Every rank's block of shards, concatenated in rank order; the
    backward keeps this rank's block of the cotangent."""

    @staticmethod
    def forward(ctx, local, mesh):
        import torch.distributed as dist
        ctx.rank, ctx.world = mesh.rank, mesh.world_size
        x = local.detach().to(_comm_device(mesh)).contiguous()
        blocks = [torch.empty_like(x) for _ in range(ctx.world)]
        dist.all_gather(blocks, x, group=mesh.group)
        return torch.cat(blocks).to(local.device)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[0] // ctx.world
        return g[ctx.rank * n:(ctx.rank + 1) * n], None


class _SumGrads(torch.autograd.Function):
    """The identity, whose backward sums the cotangent over the group."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        x = g.detach().to(_comm_device(ctx.mesh), copy=True).contiguous()
        dist.all_reduce(x, group=ctx.mesh.group)
        return x.to(g.device), None


def _gather(mesh: Mesh, pieces) -> torch.Tensor:
    """The shards' pieces [n, ...] on the mesh's device, in shard order."""
    local = torch.stack([p.to(mesh.device) for p in pieces])
    if mesh.group is None:
        return local
    return _GatherShards.apply(local, mesh)


def _sum_over_group(mesh: Mesh, value: int) -> int:
    if mesh.group is None:
        return value
    import torch.distributed as dist
    t = torch.tensor([value], dtype=torch.int64, device=_comm_device(mesh))
    dist.all_reduce(t, group=mesh.group)
    return int(t.item())


def _grad_summed(scene: Scene, camera: Camera, mesh: Mesh
                 ) -> Tuple[Scene, Camera]:
    """The scene and camera whose differentiable tensors sum their
    gradients over the group: one flat ``_SumGrads`` for all of them, so
    every rank's backward makes the same single ``all_reduce``."""
    if mesh.group is None:
        return scene, camera
    slots = [(obj, f.name) for obj in (scene, scene.materials, camera)
             for f in dataclasses.fields(obj)
             if isinstance(getattr(obj, f.name), torch.Tensor)
             and getattr(obj, f.name).requires_grad]
    if not slots:
        return scene, camera
    ts = [getattr(o, k) for o, k in slots]
    dev = ts[0].device
    flat = _SumGrads.apply(torch.cat([t.reshape(-1).to(dev) for t in ts]),
                           mesh)
    new = {}
    at = 0
    for (o, k), t in zip(slots, ts):
        new.setdefault(id(o), {})[k] = \
            flat[at:at + t.numel()].reshape(t.shape).to(t.device)
        at += t.numel()
    mats = dataclasses.replace(scene.materials,
                               **new.get(id(scene.materials), {}))
    scene = dataclasses.replace(scene, materials=mats,
                                **new.get(id(scene), {}))
    camera = dataclasses.replace(camera, **new.get(id(camera), {}))
    return scene, camera


# ---------------------------------------------------------------------------
# Per-device copies of a replicated scene
# ---------------------------------------------------------------------------

# (id, device) -> (weakref to the original, its copy on the device): the
# table caches key on a scene's identity, so a frame must find the same
# copy as the last one did, not pack its tables again
_DEVICE_COPIES: dict = {}


def _on(x, device: torch.device):
    """A scene or camera on ``device``: itself when it is there, else its
    copy, made once and kept while ``x`` lives."""
    if x.device == device:
        return x
    key = (id(x), str(device))
    hit = _DEVICE_COPIES.get(key)
    if hit is not None and hit[0]() is x:
        return hit[1]
    for k in [k for k, v in _DEVICE_COPIES.items() if v[0]() is None]:
        del _DEVICE_COPIES[k]
    with torch.no_grad():
        copy = x.to(device)
    _DEVICE_COPIES[key] = (weakref.ref(x), copy)
    return copy


# ---------------------------------------------------------------------------
# The wavefront renderer, pixel-interleaved
# ---------------------------------------------------------------------------

def render_linear_sharded(scene: Scene, camera: Camera, *, mesh: Mesh,
                          width: int, height: int, samples_per_pixel: int,
                          depth: int, parity_plane_sign: bool = True,
                          seed: int = 0):
    """Sharded ``render.render_linear``: mean radiance [H, W, 3] on the
    mesh's device and the segment count.  Shard i traces pixels i, i + n,
    ... (padding pixels past the frame are dead lanes).  Differentiable
    in the scene's and camera's tensors, the gradients summed over the
    shards."""
    n = mesh.size
    npix = height * width
    npad = pad_to_multiple(npix, n)
    scene, camera = _grad_summed(scene, camera, mesh)
    seed_word = rng.seed_word(seed)
    sums, segments = [], 0
    for shard in mesh.local_shards():
        dev = shard.device
        pix = torch.arange(shard.index, npad, n, dtype=torch.int32,
                           device=dev)
        safe = torch.clamp_max(pix, npix - 1)
        img_sum, segs = accumulate_samples(
            scene.to(dev), camera.to(dev), safe // width, safe % width,
            width, height, samples_per_pixel, depth, parity_plane_sign,
            seed_word, active=pix < npix)
        sums.append(img_sum)
        segments += segs
    # element k of shard i's piece is pixel k * n + i: de-interleave
    img_sum = _gather(mesh, sums).transpose(0, 1).reshape(npad, 3)
    mean = img_sum[:npix] * (1.0 / samples_per_pixel)
    return mean.reshape(height, width, 3), _sum_over_group(mesh, segments)


# ---------------------------------------------------------------------------
# The kernels: rows (K1, K4) and tile rows (K3)
# ---------------------------------------------------------------------------

def _rows_gathered(mesh: Mesh, pieces, rows_per: int, width: int,
                   height: int) -> torch.Tensor:
    """Shard i's rows k hold global row k * n + i: back in row order."""
    n = mesh.size
    img = _gather(mesh, pieces).transpose(0, 1)
    return img.reshape(n * rows_per, width, 3)[:height]


def _sharded_binned(scene, camera, mesh: Mesh, plain: bool, *, width,
                    height, samples_per_pixel, depth, seed):
    """K3 on interleaved tile rows, uncapped (the caps of
    ``ops._BINNED_CAPS`` belong to whole frames); a spp that is not a
    power of two renders as ``ops._binned_spp_parts`` on the global sample
    index, summed as the one-device engine sums them."""
    n = mesh.size
    calls = []
    for shard in mesh.local_shards():
        dev = shard.device
        s, c = _on(scene, dev), _on(camera, dev)
        sph, sph_cl, *sorted_t = ops.scene_sorted_tables(s, dev)
        order, keys = ops._camera_order(sorted_t[4], c, dev)
        calls.append((shard.index, (sph, *sorted_t,
                                    tables.camera_vec(c).to(dev)),
                      dict(sph_clusters=sph_cl, top_order=order,
                           top_keys=keys)))
    parts = ops._binned_spp_parts(samples_per_pixel)
    total, segments, offset = None, 0, 0
    for part in parts:
        _, th, _, nty, _ = binned.tile_geometry(width, height, part)
        nty_per = pad_to_multiple(nty, n) // n
        means = []
        for index, args, extra in calls:
            mean, segs = binned.render_linear_binned(
                *args, width=width, height=height, samples_per_pixel=part,
                depth=depth, seed=seed, sample_offset=offset,
                tile_row_offset=index, tile_row_stride=n,
                shard_tile_rows=nty_per, plain=plain, **extra)
            means.append(mean)
            segments += segs
        # shard i's tile-row block k holds global tile row k * n + i
        mean = _gather(mesh, means).reshape(n, nty_per, th, width, 3)
        mean = mean.transpose(0, 1).reshape(n * nty_per * th, width,
                                            3)[:height]
        if len(parts) == 1:
            total = mean
        else:
            piece = mean * float(part)
            total = piece if total is None else total + piece
        offset += part
    if len(parts) > 1:
        total = total * (1.0 / samples_per_pixel)
    return total, _sum_over_group(mesh, segments)


def render_linear_sharded_fast(scene: Scene, camera: Camera, *, mesh: Mesh,
                               width: int, height: int,
                               samples_per_pixel: int, depth: int,
                               parity_plane_sign: Optional[bool] = None,
                               seed: int = 0, engine: str = "auto"):
    """Sharded render through the engine ``ops.resolve_dispatch`` picks on
    the mesh's device: (mean radiance [H, W, 3], segment count).

    K1 (``cuda``, or ``torch`` on the CPU) and K4 (``cuda_stream`` /
    ``torch_stream``) render rows i, i + n, ... on shard i; K3
    (``cuda_binned`` / ``torch_binned``) renders tile rows i, i + n, ...,
    uncapped.  The sorted engine takes the binned one where
    ``ops.binned_spp_ok`` holds and the streamed one elsewhere (the sorted
    engine is not sharded).  ``engine="xla"`` is the wavefront renderer,
    ``render_linear_sharded``.  Forward only: for gradients use
    ``render_linear_diff_sharded`` or ``render_linear_sharded``."""
    if engine == "xla":
        pps = (not scene.exact_planes if parity_plane_sign is None
               else parity_plane_sign)
        return render_linear_sharded(
            scene, camera, mesh=mesh, width=width, height=height,
            samples_per_pixel=samples_per_pixel, depth=depth,
            parity_plane_sign=pps, seed=seed)
    engine, pps = ops.resolve_dispatch(
        scene, parity_plane_sign, engine, mesh.device,
        samples_per_pixel=samples_per_pixel, width=width, height=height)
    if engine in ("cuda_sorted", "torch_sorted"):
        kind = ("binned" if ops.binned_spp_ok(samples_per_pixel, width,
                                              height) else "stream")
        engine = engine.split("_")[0] + "_" + kind
    if engine not in ("cuda", "torch") and pps:
        raise ValueError(f"engine {engine!r} needs parity_plane_sign=False "
                         f"(its bound culling is unsound with the "
                         f"reference's plane sign)")
    if engine in _BINNED and depth < 1:
        engine = "cuda" if engine == "cuda_binned" else "torch"
    kw = dict(width=width, height=height,
              samples_per_pixel=samples_per_pixel, depth=depth, seed=seed)
    if engine in _BINNED:
        if not ops.binned_spp_ok(samples_per_pixel, width, height):
            raise ValueError(f"engine {engine!r} needs samples_per_pixel "
                             f"<= 128 and fewer than 2^24 ray slots")
        return _sharded_binned(scene, camera, mesh,
                               engine == "torch_binned", **kw)
    n = mesh.size
    rows_per = pad_to_multiple(height, n) // n
    means, segments = [], 0
    for shard in mesh.local_shards():
        dev = shard.device
        s, c = _on(scene, dev), _on(camera, dev)
        if engine in ("cuda_stream", "torch_stream"):
            render, args, extra = ops._stream_call(s, c, dev,
                                                   engine == "torch_stream")
        else:
            render = (wavefront.render_linear_cuda if engine == "cuda"
                      else wavefront.render_linear_ref)
            sph, tri, sph_cl, tri_cl = ops.scene_tables(s, pps, dev)
            args = (sph, tri, tables.camera_vec(c).to(dev))
            extra = dict(parity_plane_sign=pps, sph_clusters=sph_cl,
                         tri_clusters=tri_cl)
        mean, segs = render(*args, **kw, **extra, shard_rows=rows_per,
                            row_offset=shard.index, row_stride=n)
        means.append(mean)
        segments += segs
    return (_rows_gathered(mesh, means, rows_per, width, height),
            _sum_over_group(mesh, segments))


# ---------------------------------------------------------------------------
# The differentiable kernels, row-interleaved
# ---------------------------------------------------------------------------

def render_linear_diff_sharded(scene: Scene, camera: Camera, *, mesh: Mesh,
                               width: int, height: int,
                               samples_per_pixel: int, depth: int,
                               seed: int = 0,
                               parity_plane_sign: bool = True,
                               tri_cull=None) -> torch.Tensor:
    """Differentiable sharded render through the kernels: mean linear
    radiance [H, W, 3] on the mesh's device.  Shard i runs
    ``ops.diff.render_linear_diff`` on rows i, i + n, ... (K1 forward and
    K5 backward, or K2 and K5s past the table budget); the scene's and
    camera's gradients are summed over the shards.  JAX's ``interpret``
    and ``bwd_engine`` keywords have no counterpart: the port's
    ``render_linear_diff`` runs the plain versions on CPU tensors and has
    one backward, the kernel's."""
    n = mesh.size
    rows_per = pad_to_multiple(height, n) // n
    scene, camera = _grad_summed(scene, camera, mesh)
    means = [diff_mod.render_linear_diff(
        scene.to(shard.device), camera.to(shard.device), width=width,
        height=height, samples_per_pixel=samples_per_pixel, depth=depth,
        seed=seed, parity_plane_sign=parity_plane_sign, tri_cull=tri_cull,
        shard_rows=rows_per, row_offset=shard.index, row_stride=n)
        for shard in mesh.local_shards()]
    return _rows_gathered(mesh, means, rows_per, width, height)


def ray_trace_sharded(scene: Scene, camera: Camera, width: int, height: int,
                      options: Options | None = None,
                      mesh: Mesh | None = None) -> Tuple[np.ndarray, int]:
    """Sharded ``render.ray_trace``: the u8 RGBA framebuffer [H, W, 4]
    (flipped) and the segment count, through the same engine dispatch
    (``Options.logger`` is not called: a sharded frame is not banded).
    ``mesh`` defaults to every device of ``options.device``'s type."""
    options = options or Options()
    mesh = mesh or make_mesh(device=options.device)
    mean, segments = render_linear_sharded_fast(
        scene, camera, mesh=mesh, width=width, height=height,
        samples_per_pixel=options.samples_per_pixel,
        depth=options.max_ray_bounces,
        parity_plane_sign=options.parity_plane_sign, seed=options.seed,
        engine=options.engine)
    return finalize_image(mean).cpu().numpy(), int(segments)
