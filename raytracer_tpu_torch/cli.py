"""CLI driver -- the reference binary's entry point (port of
``raytracer_tpu/cli.py``).

Mirrors main.rs: ``samples=N`` / ``ray_depth=N`` (defaults 50 / 8), unknown
arguments abort, the scene's parsed camera is replaced by a look-at camera
(origin (0,0,0) -> (0,0,-1), up Y, vfov pi/2, aspect 1.77778), width 400,
height = width / aspect, output ``image.ppm``.

Extensions: ``scene=PATH``, ``obj=PATH`` (an OBJ mesh framed into the
view over a ground sphere, correct plane equation: meshes of at least
``ops.BINNED_MIN_TRIS`` triangles render through the streamed kernel K4,
one launch per row band of the scanline logger), ``width=N``, ``out=PATH``
(.ppm or .png), ``seed=N``, ``use_scene_camera=1`` and
``device=cuda|cpu`` (default cuda: the CUDA kernels; without a GPU the CLI
exits with an error rather than render on the CPU), ``parity=1`` (the
sequential parity renderer, bit-exact against the reference algorithm, at
the reference's seed, on ``device``; no ``[stats]`` line).
"""

from __future__ import annotations

import math
import sys
import time

import torch

from . import parser as parser_mod
from .camera import Camera
from .image import write_png, write_ppm
from .models import default_world_source
from .models import obj as obj_mod
from .render import Options, ray_trace, ray_trace_parity
from .scene import DIFFUSE, build_materials, build_scene

__all__ = ["get_arguments", "main"]

_INT_KEYS = ("samples", "ray_depth", "width", "seed", "parity",
             "use_scene_camera")
_STR_KEYS = ("scene", "out", "obj", "device")


def get_arguments(argv):
    """main.rs:23-45 -- samples=N / ray_depth=N (+ extensions)."""
    samples_per_pixel = 50
    max_ray_bounces = 8
    extras = {}
    for argument in argv:
        key, sep, rest = argument.partition("=")
        if sep and key in _INT_KEYS:
            _, value = parser_mod.parse_int(rest)
            if key == "samples":
                samples_per_pixel = value
            elif key == "ray_depth":
                max_ray_bounces = value
            else:
                extras[key] = value
        elif sep and key in _STR_KEYS:
            extras[key] = rest
        else:
            # main.rs:40 panics on unknown arguments
            raise SystemExit(f"Unknown argument '{argument}'")
    return samples_per_pixel, max_ray_bounces, extras


def _obj_scene(path: str):
    """An OBJ mesh framed into the CLI camera's view: scaled to 0.9 across
    its widest extent, centred at z = -1.5 over a ground sphere, with the
    correct plane equation (OBJ scenes make no reference-parity claim)."""
    with open(path) as f:
        src = f.read()
    lo, hi = obj_mod.obj_bounds(obj_mod.parse_obj(src, 0))
    extent = float(max(max(h - l for h, l in zip(hi, lo)), 1e-6))
    s = 0.9 / extent
    c = [(h + l) * 0.5 * s for h, l in zip(hi, lo)]
    tris = obj_mod.parse_obj(src, 0, scale=s,
                             translate=(-c[0], -c[1] + 0.05, -c[2] - 1.5))
    mats = build_materials([(DIFFUSE, (0.75, 0.45, 0.3), 0.0, 1.0),
                            (DIFFUSE, (0.8, 0.8, 0.0), 0.0, 1.0)])
    return build_scene([((0.0, -100.5, -1.0), 100.0, 1)], tris, mats,
                       exact_planes=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    samples, depth, extras = get_arguments(argv)
    device = extras.get("device", "cuda")
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"device must be cuda or cpu, got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("device=cuda but no CUDA GPU is available; pass "
                         "device=cpu to render with the plain PyTorch "
                         "version")
    print(f"Using:\n* Samples per pixel: {samples}\n* Max ray depth: {depth}",
          file=sys.stderr)

    if "obj" in extras:
        scene = _obj_scene(extras["obj"])
        world = None
    else:
        if "scene" in extras:
            world = parser_mod.parse_world(extras["scene"])
        else:
            world = parser_mod.parse_input(default_world_source())
        scene = world.to_scene()

    if world is not None and extras.get("use_scene_camera"):
        camera = world.to_camera()
        aspect = float(camera.aspect_ratio())
    else:
        # main.rs:86-88 -- the CLI ignores the parsed camera
        aspect = 1.77778
        camera = Camera.new_look_at((0.0, 0.0, 0.0), (0.0, 0.0, -1.0),
                                    (0.0, 1.0, 0.0), math.pi / 2.0, aspect)

    image_width = int(extras.get("width", 400))      # main.rs:91
    image_height = int(image_width / aspect)         # main.rs:92

    t0 = time.perf_counter()
    if extras.get("parity"):
        fb = ray_trace_parity(scene, camera, image_width, image_height,
                              samples, depth, device=device)
        segments = None
    else:
        from .utils.profiling import ScanlineLogger
        # main.rs:51 wires the scanline logger to stderr in the CLI
        opts = Options(samples_per_pixel=samples, max_ray_bounces=depth,
                       seed=int(extras.get("seed", Options().seed)),
                       logger=ScanlineLogger(), device=device)
        fb, segments = ray_trace(scene, camera, image_width, image_height,
                                 opts)
    dt = time.perf_counter() - t0

    out = extras.get("out", "image.ppm")
    print(" Done!\nWriting image...", file=sys.stderr, end="")
    if out.endswith(".png"):
        write_png(fb, out)
    else:
        write_ppm(fb, out)
    print("          Done!", file=sys.stderr)
    if segments is not None:
        print(f"[stats] {segments} ray segments in {dt:.3f}s on {device} "
              f"({segments / dt / 1e6:.1f} Mrays/s incl. first-use build)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
