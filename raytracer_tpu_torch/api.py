"""Embedding (render-service) API (port of ``raytracer_tpu/api.py``).

Mirror of the reference's C ABI surface (lib.rs): ``load_world``
(lib.rs:38-46), ``render`` (lib.rs:50-57, 16 spp / 8 bounces on the
interactive path) and ``move_camera_position`` (lib.rs:60-63), plus the
``RenderSession`` loop of the GUI.  Renders run on the device the options
name; the packed scene tables are cached across frames, so a camera move
re-renders without re-packing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import image as image_mod
from .camera import Camera
from .parser import ParsedWorld, parse_input
from .render import Options, finalize_image, ray_trace
from .scene import Scene

__all__ = ["WorldHandle", "load_world", "FFI_DEFAULT_OPTIONS", "render",
           "move_camera_position", "RenderSession"]


@dataclasses.dataclass
class WorldHandle:
    """Opaque world handle (lib.rs:29-33): scene + the DSL's camera."""
    scene: Scene
    camera: Camera
    parsed: Optional[ParsedWorld] = None


def load_world(source: str | bytes, device="cpu") -> WorldHandle:
    """lib.rs:38-46 -- parse a (possibly NUL-terminated) DSL source into a
    handle whose scene and camera live on ``device``."""
    if isinstance(source, bytes):
        source = source.split(b"\x00", 1)[0].decode("utf-8")
    parsed = parse_input(source)
    return WorldHandle(scene=parsed.to_scene(device=device),
                       camera=parsed.to_camera(device=device), parsed=parsed)


# lib.rs:51 hardcodes Options::new(16, 8, None, true) for the FFI render
FFI_DEFAULT_OPTIONS = Options(samples_per_pixel=16, max_ray_bounces=8)


def render(handle: WorldHandle, width: int, height: int,
           options: Options | None = None) -> np.ndarray:
    """lib.rs:50-57 -- render into a fresh RGBA8 framebuffer [H, W, 4]."""
    fb, _segments = ray_trace(handle.scene, handle.camera, width, height,
                              options or FFI_DEFAULT_OPTIONS)
    return fb


def move_camera_position(handle: WorldHandle, x: float, y: float, z: float
                         ) -> WorldHandle:
    """lib.rs:60-63 -- a ``new_at`` camera at the offset origin with the
    same aspect ratio, in a new handle."""
    return dataclasses.replace(handle,
                               camera=handle.camera.moved_by((x, y, z)))


class RenderSession:
    """Interactive render loop: keypress -> move_camera -> frame
    (GameView.swift:198-219, 323-334), rendering on ``device``.

    ``progressive=True``: after a camera move the first frame has the base
    spp, and every further ``frame()`` with the camera still accumulates
    another batch of samples (fresh streams via the seed) up to
    ``max_samples``.  A move resets the accumulator.
    """

    def __init__(self, source: Optional[str], width: int, height: int,
                 options: Options | None = None, *, device,
                 progressive: bool = False,
                 max_samples: Optional[int] = None,
                 handle: Optional[WorldHandle] = None):
        self.handle = handle if handle is not None else load_world(source)
        self.width = width
        self.height = height
        self.options = dataclasses.replace(
            options or FFI_DEFAULT_OPTIONS, device=str(torch.device(device)))
        self.progressive = progressive
        self.max_samples = (max_samples if max_samples is not None
                            else self.options.samples_per_pixel * 16)
        self._dirty = True
        self._frame: Optional[np.ndarray] = None
        self._accum: Optional[np.ndarray] = None
        self._accum_spp = 0

    @classmethod
    def from_world(cls, scene, camera, width: int, height: int,
                   options: Options | None = None, *, device,
                   progressive: bool = False,
                   max_samples: Optional[int] = None) -> "RenderSession":
        """Session over a prebuilt scene instead of DSL source."""
        return cls(None, width, height, options, device=device,
                   progressive=progressive, max_samples=max_samples,
                   handle=WorldHandle(scene=scene, camera=camera))

    def resolved_engine(self) -> str:
        """The engine ``ops.resolve_dispatch`` picks for this session's
        frames (its scene, device, spp and shape), so a caller can see that
        an OBJ-scale scene takes the binned engine."""
        from . import ops
        engine, _ = ops.resolve_dispatch(
            self.handle.scene, self.options.parity_plane_sign,
            self.options.engine, self.options.device,
            samples_per_pixel=self.options.samples_per_pixel,
            width=self.width, height=self.height)
        return engine

    @property
    def samples_accumulated(self) -> int:
        """spp the current frame represents."""
        if not self.progressive:
            return self.options.samples_per_pixel
        return self._accum_spp

    def move_camera(self, dx: float, dy: float, dz: float) -> None:
        self.handle = move_camera_position(self.handle, dx, dy, dz)
        self._dirty = True

    def _accumulate_batch(self) -> None:
        from . import ops
        spp = self.options.samples_per_pixel
        batch = self._accum_spp // spp
        mean, _segs = ops.render_linear_fast(
            self.handle.scene, self.handle.camera, width=self.width,
            height=self.height, samples_per_pixel=spp,
            depth=self.options.max_ray_bounces, device=self.options.device,
            parity_plane_sign=self.options.parity_plane_sign,
            seed=self.options.seed + batch, engine=self.options.engine)
        mean = mean.cpu().numpy().astype(np.float64)
        self._accum = mean * spp if self._accum is None \
            else self._accum + mean * spp
        self._accum_spp += spp
        self._frame = finalize_image(torch.from_numpy(
            (self._accum / self._accum_spp).astype(np.float32))).numpy()

    def frame(self) -> np.ndarray:
        """Dirty-flag render; in progressive mode each clean-camera call
        refines the image by one sample batch up to max_samples."""
        if self._dirty or self._frame is None:
            self._accum = None
            self._accum_spp = 0
            if self.progressive:
                self._accumulate_batch()
            else:
                self._frame = render(self.handle, self.width, self.height,
                                     self.options)
            self._dirty = False
        elif self.progressive and self._accum_spp < self.max_samples:
            self._accumulate_batch()
        return self._frame

    def save(self, path: str) -> None:
        if path.endswith(".png"):
            image_mod.write_png(self.frame(), path)
        else:
            image_mod.write_ppm(self.frame(), path)
