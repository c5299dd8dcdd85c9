"""Render front: options, the wavefront renderer, the forward
``ray_trace`` entry point, the framebuffer finish and the sequential parity
renderer (port of ``raytracer_tpu/render.py``).

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
(common.rs:334-356).

``render_parity`` / ``ray_trace_parity`` replicate the reference render bit
for bit: ONE xorshift32 stream in raster order, each sample a step over
device tensors (``closest_hit_exact``, ``scatter_exact``) that branches
with ``torch.where`` and never syncs; on ``cuda`` the step is captured
once as a CUDA graph and replayed a sample at a time.  Only tiny
configurations are meant for it.
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
           "finalize_image", "ray_trace", "render_parity", "ray_trace_parity"]

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


# ---------------------------------------------------------------------------
# Sequential parity renderer -- exact xorshift32 stream, raster order
# ---------------------------------------------------------------------------

def render_parity(scene: Scene, camera: Camera, *, width: int, height: int,
                  samples_per_pixel: int, depth: int,
                  seed: int = rng.DEFAULT_SEED,
                  parity_plane_sign: bool = True,
                  device="cuda") -> torch.Tensor:
    """The reference render's per-sample radiance [height, width, spp, 3]
    on ``device``, bit for bit: ONE xorshift32 stream (seed 2547549,
    random.rs:8-9) consumed in raster order -- u jitter, v jitter
    (common.rs:335-336), then 3 bilateral draws per diffuse / metal scatter
    (common.rs:32-38, materials.rs:44,56), nothing for dielectric, emission
    or a miss -- exactly as the JAX package's scan consumes it
    (``raytracer_tpu/render.py:264``).  Every bounce of the depth runs,
    masked once the path is done.

    One sample is one step over device buffers (the stream state, the
    sample index, the radiance array) with no host sync.  On the CPU the
    step runs once a sample; on CUDA it is captured once as a CUDA graph
    and replayed once a sample, so a sample costs one launch from the host
    instead of one launch per operation."""
    dev = torch.device(device)
    with torch.inference_mode():
        step, buffers = _parity_step(
            scene.to(dev), camera.to(dev), width, height, samples_per_pixel,
            depth, seed, parity_plane_sign)
        colors = buffers[-1]
        n = colors.shape[0]
        if dev.type == "cuda":
            graph = _capture(step, buffers, dev)
            for _ in range(n):
                graph.replay()
        else:
            for _ in range(n):
                step()
        return colors.reshape(height, width, samples_per_pixel, 3)


def _capture(step, buffers, dev) -> "torch.cuda.CUDAGraph":
    """``step`` as a CUDA graph: its buffers are updated in place, so a
    replay is one more sample.  One warm-up step on a side stream first
    (every kernel loaded before the capture), its writes then undone."""
    saved = [b.clone() for b in buffers]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step()
        for b, v in zip(buffers, saved):
            b.copy_(v)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(dev), torch.cuda.graph(graph):
        step()
    return graph


def _parity_step(scene, camera, width, height, samples_per_pixel, depth,
                 seed, parity_plane_sign):
    """The per-sample step of ``render_parity`` over a scene and camera on
    one device, and the buffers it updates in place: the stream state [1],
    the sample index [1] and the radiance array [n, 3]."""
    dev = scene.device
    pack = intersect.exact_pack(scene)
    mtab = materials_mod.material_table(scene.materials)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    # divisors are device tensors: a CUDA divide by a Python scalar
    # multiplies by its reciprocal
    w1, h1 = f32(float(width - 1)), f32(float(height - 1))
    sky_a, sky_b = f32(SKY_A), f32(SKY_B)
    origin, llc = camera.origin, camera.lower_left_corner
    state = rng.as_int32(seed, dev).reshape(1)
    index = torch.zeros(1, dtype=torch.int64, device=dev)
    colors = torch.zeros((height * width * samples_per_pixel, 3),
                         dtype=torch.float32, device=dev)

    def step():
        # raster order: row -> column -> sample (common.rs:327-334)
        pixel = torch.div(index, samples_per_pixel, rounding_mode="floor")
        row = torch.div(pixel, width, rounding_mode="floor")
        col = pixel - row * width
        st = rng.xorshift32(state)
        u = (rng.random_f32_from_bits(st) + col.to(torch.float32)) / w1
        st = rng.xorshift32(st)
        v = (rng.random_f32_from_bits(st) + row.to(torch.float32)) / h1
        # Camera::cast_ray (camera.rs:84-89), normalised as maths.rs:111-118
        raw = ((llc + u * camera.horizontal) + v * camera.vertical) - origin
        o, d = origin, raw / maths.sqrt_rn(intersect.dot3(raw, raw))
        throughput = torch.ones(3, device=dev)
        result = torch.zeros(3, device=dev)
        done = torch.zeros(1, dtype=torch.bool, device=dev)
        for _ in range(depth):
            hit = intersect._closest_hit_exact(o, d, pack, parity_plane_sign)
            row_m = materials_mod._material_row(mtab, hit.mat)
            live = hit.hit & ~done
            # diffuse and metal draw 3 values (kinds 0, 1: materials.rs:44,56)
            will_draw = live & (row_m[0] <= 1.0)
            s1 = rng.xorshift32(st)
            s2 = rng.xorshift32(s1)
            s3 = rng.xorshift32(s2)
            st = torch.where(will_draw, s3, st)
            bits = rng.random_f32_from_bits(torch.cat([s1, s2, s3]))
            raw = bits * 2.0 - 1.0
            sc = materials_mod._scatter_exact(
                row_m, d, hit.normal, materials_mod._unit_rows(raw, raw))
            miss = ~(hit.hit | done)
            terminal = live & sc.terminal
            cont = live & ~sc.terminal
            # the sky lerp (common.rs:277-280) on the renormalised direction
            t = 0.5 * (d[1] / maths.sqrt_rn(intersect.dot3(d, d)) + 1.0)
            sky = sky_a * (1.0 - t) + sky_b * t
            result = torch.where(miss, throughput * sky, result)
            result = torch.where(terminal, throughput * sc.color, result)
            throughput = torch.where(cont, throughput * sc.color, throughput)
            o = torch.where(cont, hit.position, o)
            d = torch.where(cont, sc.direction, d)
            done = done | miss | terminal
        # a path out of bounces keeps result 0 (black, common.rs:284)
        colors.index_copy_(0, index, result[None])
        state.copy_(st)
        index.add_(1)

    return step, (state, index, colors)


def ray_trace_parity(scene: Scene, camera: Camera, width: int, height: int,
                     samples_per_pixel: int, depth: int,
                     seed: int = rng.DEFAULT_SEED,
                     parity_plane_sign: bool = True,
                     device="cuda") -> np.ndarray:
    """Full parity render to a u8 RGBA framebuffer [height, width, 4]
    (flipped), with the reference's accumulation arithmetic
    (common.rs:334-356) on the host: the float32 sum in sample order,
    * (1/spp), sqrt, * 255.999, and Rust's saturating cast (NaN -> 0)."""
    colors = render_parity(
        scene, camera, width=width, height=height,
        samples_per_pixel=samples_per_pixel, depth=depth, seed=seed,
        parity_plane_sign=parity_plane_sign, device=device)
    colors = colors.cpu().numpy()  # [H, W, spp, 3]
    h, w, spp, _ = colors.shape
    inv = np.float32(1.0) / np.float32(spp)
    acc = np.zeros((h, w, 3), np.float32)
    for s in range(spp):
        acc = acc + colors[:, :, s, :]
    rgb = np.sqrt(acc * inv) * np.float32(255.999)
    rgb = np.where(np.isnan(rgb), 0.0, np.clip(rgb, 0.0, 255.0))
    rgb = rgb.astype(np.uint8)
    a = np.full((h, w, 1), 255, np.uint8)
    img = np.concatenate([rgb, a], axis=-1)
    return img[::-1]
