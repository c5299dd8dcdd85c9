"""Observability: throughput accounting and the scanline logger (port of
``raytracer_tpu/utils/profiling.py``).

Rays/s here is traced segments over seconds, the definition ``bench.py``
uses.  Device work is asynchronous, so ``timed_render`` synchronises a CUDA
device on entry and exit and times with the host clock in between.
``trace`` records a block under ``torch.profiler`` (the JAX package's
``jax.profiler`` capture) and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import tempfile
import time
from typing import Iterator

import torch

__all__ = ["RenderStats", "timed_render", "trace", "ScanlineLogger"]


@dataclasses.dataclass
class RenderStats:
    """Throughput accounting for one or more renders."""
    seconds: float = 0.0
    segments: int = 0          # rays actually traced (live rays per bounce)
    paths: int = 0             # camera samples (W*H*spp)
    renders: int = 0

    @property
    def rays_per_sec(self) -> float:
        return self.segments / self.seconds if self.seconds else 0.0

    @property
    def paths_per_sec(self) -> float:
        return self.paths / self.seconds if self.seconds else 0.0

    def merge(self, other: "RenderStats") -> "RenderStats":
        return RenderStats(self.seconds + other.seconds,
                           self.segments + other.segments,
                           self.paths + other.paths,
                           self.renders + other.renders)

    def __str__(self) -> str:
        return (f"{self.renders} render(s): {self.seconds:.3f}s, "
                f"{self.segments/1e6:.1f}M segments "
                f"({self.rays_per_sec/1e6:.1f} Mrays/s, "
                f"{self.paths_per_sec/1e6:.2f} Mpaths/s)")


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed_render(width: int, height: int, samples_per_pixel: int,
                 device=None) -> Iterator[RenderStats]:
    """Time one render; fill ``stats.segments`` inside the block:

        with timed_render(W, H, spp, device="cuda") as stats:
            img, stats.segments = render_linear_fast(..., device="cuda")
    """
    stats = RenderStats(paths=width * height * samples_per_pixel, renders=1)
    _sync(device)
    t0 = time.perf_counter()
    yield stats
    _sync(device)
    stats.seconds = time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str | None = None) -> Iterator[str]:
    """``torch.profiler`` capture around a block (CPU activity, and CUDA's
    when a GPU is there); yields ``log_dir`` (default
    ``raytracer_tpu_torch_trace`` under the temporary directory) and
    writes the Chrome trace ``trace_<pid>_<ns>.json`` there when the block
    ends (open it in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(),
                               "raytracer_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        with prof:
            yield log_dir
    finally:
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class ScanlineLogger:
    """The reference's progress logger (common.rs:328-330): writes
    ``\\rScanline: {:<4}`` counting down as row bands complete.  Set it as
    ``Options.logger``; ``ray_trace`` then renders in row bands."""

    def __init__(self, stream=None):
        self.stream = stream if stream is not None else sys.stderr

    def __call__(self, rows_done: int, height: int) -> None:
        self.stream.write(f"\rScanline: {height - rows_done:<4}")
        self.stream.flush()
