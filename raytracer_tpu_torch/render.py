"""Render front: options, the wavefront renderer, the forward
``ray_trace`` entry point and the framebuffer finish (port of
``raytracer_tpu/render.py`` without its parity renderer).

``render_linear`` is the wavefront path tracer in plain PyTorch (the JAX
package's ``"xla"`` engine): all pixels' rays for one sample form one batch,
a Python loop runs the bounces and the samples on whatever device the
tensors are, and dead rays are masked, not compacted.  Autograd through it
is the independent gradient K5 is held against.  The semantics of
``ray_color`` (common.rs:263-285) are kept: throughput starts at 1 and is
multiplied by the colour of each scattering hit; a terminal hit (emission,
absorbed metal) adds throughput x colour and stops; a miss adds
throughput x the sky gradient; rays that run out of bounces add black.

``ray_trace`` renders through ``ops.render_linear_fast`` (K1, or K3 / K4
for big meshes) on ``Options.device`` and turns the mean linear image into
the reference's u8 framebuffer with ``finalize_image``
(common.rs:334-356).  The sequential
parity renderer of the JAX package is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import intersect, maths, rng
from . import materials as materials_mod
from .camera import Camera
from .scene import Scene

__all__ = ["Options", "trace_rays", "accumulate_samples", "render_linear",
           "finalize_image", "ray_trace"]

SKY_A = (1.0, 1.0, 1.0)
SKY_B = (0.5, 0.7, 1.0)
_SITE_JITTER = 0        # pcg3d draw site of the camera jitter


@dataclasses.dataclass(frozen=True)
class Options:
    """Render options (common.rs:288-317).

    ``device`` is where the render runs: "cuda" (the kernels, the default)
    or "cpu" (their plain versions).  Nothing falls back from one to the
    other.  ``engine`` is "auto" (``ops.resolve_dispatch``) or one of
    ``ops.ENGINES``: "cuda" (K1), "cuda_binned" (K3), "cuda_sorted" (K6),
    "cuda_stream" (K4), or "torch", "torch_binned", "torch_sorted",
    "torch_stream" (their plain versions).
    ``positive_is_up`` is stored but never read, like the reference's.
    ``logger(rows_done, height)`` is the reference's progress hook
    (common.rs:292,328-330); with one set the render runs in row bands, with
    bitwise the same output.
    """
    samples_per_pixel: int = 32     # default, common.rs:311
    max_ray_bounces: int = 8        # default, common.rs:312
    positive_is_up: bool = True
    # None = resolve per scene (ops.resolve_dispatch)
    parity_plane_sign: Optional[bool] = None
    seed: int = rng.DEFAULT_SEED
    engine: str = "auto"
    logger: Optional[Callable[[int, int], None]] = None
    device: str = "cuda"


def _sky_color(direction: torch.Tensor) -> torch.Tensor:
    """Background gradient (common.rs:277-280); renormalises the direction
    as the reference does (``ray.direction.normalize().y()``)."""
    t = 0.5 * (maths.normalize(direction)[..., 1] + 1.0)
    a = torch.tensor(SKY_A, dtype=torch.float32, device=direction.device)
    b = torch.tensor(SKY_B, dtype=torch.float32, device=direction.device)
    return maths.lerp(a, b, t)


def _bounce_step(scene: Scene, pack: intersect.ScenePack, pix_id, sample_id,
                 parity_plane_sign: bool, carry, bounce_idx: int):
    """One wavefront bounce: intersect, scatter, update the masks.

    carry: (origin [B, 3], direction [B, 3], throughput [B, 3],
    result [B, 3], alive [B] bool, segments int)."""
    origin, direction, throughput, result, alive, segments = carry
    segments = segments + int(alive.sum())
    hit = intersect.closest_hit_batch(origin, direction, scene, pack,
                                      parity_plane_sign=parity_plane_sign)
    bx, by, bz = rng.uniform_bilateral3(pix_id, sample_id, 1 + bounce_idx)
    rand_unit = materials_mod.random_unit_sphere(bx, by, bz)
    sc = materials_mod.scatter(scene.materials, hit.mat, direction,
                               hit.normal, rand_unit)
    miss = (alive & ~hit.hit)[:, None]
    terminal = (alive & hit.hit & sc.terminal)[:, None]
    bounce = alive & hit.hit & ~sc.terminal
    b3 = bounce[:, None]
    result = result + torch.where(miss, throughput * _sky_color(direction),
                                  0.0)
    result = result + torch.where(terminal, throughput * sc.color, 0.0)
    throughput = torch.where(b3, throughput * sc.color, throughput)
    origin = torch.where(b3, hit.position, origin)
    direction = torch.where(b3, sc.direction, direction)
    return origin, direction, throughput, result, bounce, segments


def trace_rays(scene: Scene, pack: intersect.ScenePack, origin, direction,
               pix_id, sample_id, depth: int, parity_plane_sign: bool = True,
               active=None):
    """ray_color (common.rs:263-285) for a whole wavefront.

    ``active``: optional [B] bool of rays that trace at all (padding lanes
    start dead).  Returns (radiance [B, 3], segments int: live rays
    intersected, summed over bounces).  The loop stops once every ray is
    dead, which changes nothing: dead rays add nothing."""
    B = origin.shape[0]
    dev = origin.device
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    carry = (origin, direction,
             torch.ones((B, 3), dtype=torch.float32, device=dev),
             torch.zeros((B, 3), dtype=torch.float32, device=dev),
             active, 0)
    for b in range(depth):
        if not bool(carry[4].any()):
            break
        carry = _bounce_step(scene, pack, pix_id, sample_id,
                             parity_plane_sign, carry, b)
    return carry[3], carry[5]


def _sample_wavefront(scene: Scene, pack: intersect.ScenePack,
                      camera: Camera, rows, cols, width: int, height: int,
                      depth: int, parity_plane_sign: bool, seed_word: int,
                      sample_idx: int, active=None):
    """Generate and trace one sample's wavefront over the given pixels,
    jittered as common.rs:335-336: u = (col + rand) / (width - 1),
    v = (row + rand) / (height - 1), rows in render (unflipped) order."""
    dev = rows.device
    pix_id = (rows * width + cols) + rng.as_int32(seed_word, dev)
    ur, vr = rng.uniform2(pix_id, sample_idx, _SITE_JITTER)
    # divide by device tensors: PyTorch's CUDA divide by a Python scalar
    # multiplies by its reciprocal
    w1 = torch.tensor(float(width - 1), dtype=torch.float32, device=dev)
    h1 = torch.tensor(float(height - 1), dtype=torch.float32, device=dev)
    u = (cols.to(torch.float32) + ur) / w1
    v = (rows.to(torch.float32) + vr) / h1
    origin, direction = camera.cast_rays(u, v)
    return trace_rays(scene, pack, origin, direction, pix_id, sample_idx,
                      depth, parity_plane_sign, active=active)


def accumulate_samples(scene: Scene, camera: Camera, rows, cols, width: int,
                       height: int, samples_per_pixel: int, depth: int,
                       parity_plane_sign: bool, seed_word: int, active=None):
    """Sum of per-sample radiance over a pixel subset ``rows``/``cols``
    ([B] int32): (radiance_sum [B, 3], segments int)."""
    pack = intersect.pack_scene(scene)
    img_sum = torch.zeros((rows.shape[0], 3), dtype=torch.float32,
                          device=rows.device)
    segments = 0
    for s in range(samples_per_pixel):
        radiance, segs = _sample_wavefront(
            scene, pack, camera, rows, cols, width, height, depth,
            parity_plane_sign, seed_word, s, active=active)
        img_sum = img_sum + radiance
        segments += segs
    return img_sum, segments


def render_linear(scene: Scene, camera: Camera, *, width: int, height: int,
                  samples_per_pixel: int, depth: int,
                  parity_plane_sign: bool = True, seed: int = 0):
    """Mean linear radiance [height, width, 3] (render row order, not yet
    flipped) and the traced-segment count, on the scene's device.  This is
    the differentiable quantity: gamma and the u8 cast live in
    ``finalize_image``."""
    dev = scene.device
    rows = torch.arange(height, dtype=torch.int32,
                        device=dev).repeat_interleave(width)
    cols = torch.arange(width, dtype=torch.int32, device=dev).repeat(height)
    img_sum, segments = accumulate_samples(
        scene, camera, rows, cols, width, height, samples_per_pixel, depth,
        parity_plane_sign, rng.seed_word(seed))
    mean = img_sum * (1.0 / samples_per_pixel)
    return mean.reshape(height, width, 3), segments


def finalize_image(mean_linear: torch.Tensor, flip: bool = True
                   ) -> torch.Tensor:
    """sqrt gamma, x255.999, Rust's saturating u8 cast (clamp, NaN -> 0),
    vertical flip, alpha=255 (common.rs:343-356).  [H, W, 3] mean radiance
    in render row order -> [H, W, 4] uint8."""
    x = mean_linear.to(torch.float32)
    rgb = torch.sqrt(torch.maximum(x, torch.zeros_like(x))) * 255.999
    rgb = torch.where(torch.isnan(rgb), 0.0, torch.clamp(rgb, 0.0, 255.0))
    rgb = rgb.to(torch.uint8)
    alpha = torch.full(rgb.shape[:-1] + (1,), 255, dtype=torch.uint8,
                       device=rgb.device)
    img = torch.cat([rgb, alpha], dim=-1)
    return torch.flip(img, dims=[0]) if flip else img


def ray_trace(scene: Scene, camera: Camera, width: int, height: int,
              options: Options | None = None) -> Tuple[np.ndarray, int]:
    """The reference's ``ray_trace`` entry point (common.rs:320): a u8 RGBA
    framebuffer [height, width, 4] (flipped, ready to write) and the
    traced-segment count."""
    options = options or Options()
    from . import ops
    mean, segments = ops.render_linear_fast(
        scene, camera, width=width, height=height,
        samples_per_pixel=options.samples_per_pixel,
        depth=options.max_ray_bounces, device=options.device,
        seed=options.seed, parity_plane_sign=options.parity_plane_sign,
        engine=options.engine, progress=options.logger)
    return finalize_image(mean).cpu().numpy(), int(segments)
