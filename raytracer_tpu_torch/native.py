"""ctypes bindings to the native C++ runtime (``native/raytracer_core.cpp``).

Port of ``raytracer_tpu/native.py``.  The native library is the embedding
layer for C/C++/Swift hosts (the C ABI of ``native/raytracer_tpu.h``).  From
Python it serves as (a) a CPU render engine whose parity mode is
bit-identical to the oracle, and (b) a fast PPM writer.

The library is built the way the CUDA kernels are (``ops/cuda/build.py``),
not with ``make``: ``load_library`` compiles the source with the host C++
compiler (``$CXX``, else ``g++``) and exactly ``native/Makefile``'s flags
into ``build/raytracer_tpu_torch/native/<hash of sources and flags>/``,
writing a temporary file and renaming it into place, so concurrent builds
(and the JAX package's own ``make`` build in ``native/``) never share a
half-written file.  The sources in ``native/`` are read, never written.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

__all__ = ["RtColorU8", "RtFramebuffer", "RtRenderOptions",
           "NativeUnavailable", "CXX_FLAGS", "compiler", "library_path",
           "build_library", "load_library", "NativeWorld",
           "write_ppm_native"]

ROOT = Path(__file__).resolve().parents[1]
NATIVE_DIR = ROOT / "native"
SOURCES = (NATIVE_DIR / "raytracer_core.cpp", NATIVE_DIR / "raytracer_tpu.h")
BUILD_ROOT = ROOT / "build" / "raytracer_tpu_torch" / "native"
LIB_NAME = "libraytracer_tpu.so"

# native/Makefile:7-8 (CXXFLAGS, then LDFLAGS' -shared): -ffp-contract=off
# and no -ffast-math keep every float operation separately rounded, which
# bit parity with the oracle needs
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
             "-fno-fast-math", "-ffp-contract=off", "-pthread", "-shared")


class RtColorU8(ctypes.Structure):
    _fields_ = [("r", ctypes.c_uint8), ("g", ctypes.c_uint8),
                ("b", ctypes.c_uint8), ("a", ctypes.c_uint8)]


class RtFramebuffer(ctypes.Structure):
    _fields_ = [("width", ctypes.c_size_t), ("height", ctypes.c_size_t),
                ("pixels", ctypes.POINTER(RtColorU8))]


class RtRenderOptions(ctypes.Structure):
    _fields_ = [("samples_per_pixel", ctypes.c_int32),
                ("max_ray_bounces", ctypes.c_int32),
                ("seed", ctypes.c_uint32),
                ("parity", ctypes.c_int32),
                ("num_threads", ctypes.c_int32)]


class NativeUnavailable(RuntimeError):
    """The library cannot be had: no host C++ compiler to build it."""


def compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` from PATH."""
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise NativeUnavailable(f"no C++ compiler: {cxx!r} is not on PATH "
                                f"(set CXX)")
    return found


def library_path() -> Path:
    """Where this checkout's library is built: the hash covers the
    sources and the flags, so an edit rebuilds."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build_library() -> Path:
    """Compile the library unless this exact build exists; return its
    path.  A compiler that fails raises with its output."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = compiler()
    lib.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        tmp_lib = Path(tmp) / LIB_NAME
        cmd = [cxx, *CXX_FLAGS, str(SOURCES[0]), "-o", str(tmp_lib)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp_lib, lib)
    return lib


@functools.cache
def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.rt_load_world.argtypes = [ctypes.c_char_p]
    lib.rt_load_world.restype = ctypes.c_void_p
    lib.rt_load_world_n.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.rt_load_world_n.restype = ctypes.c_void_p
    lib.rt_destroy_world.argtypes = [ctypes.c_void_p]
    lib.rt_destroy_world.restype = None
    lib.rt_render.argtypes = [RtFramebuffer, ctypes.c_void_p,
                              ctypes.POINTER(RtRenderOptions)]
    lib.rt_render.restype = ctypes.c_int
    lib.rt_move_camera_position.argtypes = [ctypes.c_void_p, ctypes.c_float,
                                            ctypes.c_float, ctypes.c_float]
    lib.rt_move_camera_position.restype = None
    lib.rt_camera_position.argtypes = [ctypes.c_void_p, ctypes.c_float * 3]
    lib.rt_camera_position.restype = None
    lib.rt_write_ppm.argtypes = [ctypes.POINTER(RtFramebuffer),
                                 ctypes.c_char_p]
    lib.rt_write_ppm.restype = ctypes.c_int
    lib.rt_last_error.argtypes = []
    lib.rt_last_error.restype = ctypes.c_char_p
    lib.rt_version.argtypes = []
    lib.rt_version.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """Build if needed and load the library once per process, with every
    entry point's C signature declared."""
    return _load(str(build_library()))


class NativeWorld:
    """Pythonic wrapper over the C ABI's world handle."""

    def __init__(self, source: str):
        self._lib = load_library()
        data = source.encode("utf-8")
        self._handle = self._lib.rt_load_world_n(data, len(data))
        if not self._handle:
            raise ValueError(
                f"parse error: {self._lib.rt_last_error().decode()}")

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.rt_destroy_world(self._handle)
            self._handle = None

    def render(self, width: int, height: int, samples_per_pixel: int = 16,
               max_ray_bounces: int = 8, seed: int = 0, parity: bool = True,
               num_threads: int = 0) -> np.ndarray:
        """Render to an RGBA8 [H, W, 4] array (vertically flipped, ready).
        ``seed`` 0 is the reference's 2547549; ``num_threads`` (0: every
        host core) parallelises only the fast mode: parity is one stream."""
        buf = np.zeros((height, width, 4), np.uint8)
        fb = RtFramebuffer(width, height,
                           buf.ctypes.data_as(ctypes.POINTER(RtColorU8)))
        opts = RtRenderOptions(samples_per_pixel, max_ray_bounces, seed,
                               1 if parity else 0, num_threads)
        rc = self._lib.rt_render(fb, self._handle, ctypes.byref(opts))
        if rc != 0:
            raise RuntimeError(
                f"render failed: {self._lib.rt_last_error().decode()}")
        return buf

    def move_camera(self, dx: float, dy: float, dz: float) -> None:
        self._lib.rt_move_camera_position(self._handle, dx, dy, dz)

    def camera_position(self) -> np.ndarray:
        out = (ctypes.c_float * 3)()
        self._lib.rt_camera_position(self._handle, out)
        return np.array(out, np.float32)


def write_ppm_native(framebuffer: np.ndarray, path: str) -> None:
    """The C ABI's P3 writer (byte-identical to image.rs:59-81) for an
    RGBA8 [H, W, 4] framebuffer."""
    lib = load_library()
    fb = np.ascontiguousarray(framebuffer, np.uint8)
    if fb.ndim != 3 or fb.shape[2] != 4:
        raise ValueError(f"framebuffer must be [H, W, 4] uint8, got "
                         f"{fb.shape}")
    cfb = RtFramebuffer(fb.shape[1], fb.shape[0],
                        fb.ctypes.data_as(ctypes.POINTER(RtColorU8)))
    rc = lib.rt_write_ppm(ctypes.byref(cfb), os.fsencode(path))
    if rc != 0:
        raise RuntimeError(f"native PPM write failed: "
                           f"{lib.rt_last_error().decode()}")
