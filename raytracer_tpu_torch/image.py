"""Framebuffer image I/O (numpy only).

Port of ``raytracer_tpu/image.py``: the framebuffer is a numpy
``[H, W, 4] uint8`` array; ``write_ppm`` writes the reference's ASCII P3
output (image.rs:59-81: header, alpha dropped, one "r g b" triplet per line),
to a file through the native C writer (``native.write_ppm_native``).
"""

from __future__ import annotations

import struct
import sys
import zlib
from typing import Optional

import numpy as np

__all__ = ["new_framebuffer", "format_ppm", "write_ppm", "read_ppm",
           "png_bytes", "write_png"]


def new_framebuffer(width: int, height: int) -> np.ndarray:
    """Framebuffer::new (image.rs:16-20): zero-initialised RGBA8."""
    return np.zeros((height, width, 4), np.uint8)


def _checked(framebuffer) -> np.ndarray:
    fb = np.asarray(framebuffer)
    if fb.ndim != 3 or fb.shape[2] not in (3, 4) or fb.dtype != np.uint8:
        raise ValueError(f"framebuffer must be [H, W, 3|4] uint8, got "
                         f"{fb.shape} {fb.dtype}")
    return fb


def format_ppm(framebuffer: np.ndarray) -> str:
    """The P3 text of an RGBA8 (or RGB) framebuffer (image.rs:59-81),
    formatted with C-level numpy string ops, not a per-pixel loop."""
    fb = _checked(framebuffer)
    height, width = fb.shape[:2]
    dec = np.char.mod("%d", fb[:, :, :3].reshape(-1, 3))
    rows = np.char.add(np.char.add(
        np.char.add(dec[:, 0], " "), np.char.add(dec[:, 1], " ")), dec[:, 2])
    return f"P3\n{width} {height}\n255\n" + "\n".join(rows.tolist()) + "\n"


def write_ppm(framebuffer: np.ndarray, path: Optional[str] = None) -> None:
    """ASCII P3, alpha dropped, one triplet per line; ``path=None`` writes
    to stdout like the reference's ``None`` arm.

    A file is written by the native C writer (byte-equal to
    ``format_ppm``, ``tests/test_torch_native.py``); ``format_ppm`` writes
    it only where the native library cannot be had (no compiler:
    ``NativeUnavailable``).  Any other error of the library propagates."""
    fb = _checked(framebuffer)
    if path is None:
        sys.stdout.write(format_ppm(fb))
        return
    from . import native
    if fb.shape[2] == 3:
        fb = np.concatenate(
            [fb, np.full(fb.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    try:
        native.write_ppm_native(fb, path)
        return
    except native.NativeUnavailable:
        pass
    with open(path, "w") as f:
        f.write(format_ppm(fb))


def read_ppm(path: str) -> np.ndarray:
    """Read an ASCII P3 PPM back into an RGBA8 [H, W, 4] array (alpha=255)."""
    tokens = []
    with open(path, "r") as f:
        for line in f:
            tokens.extend(line.split("#", 1)[0].split())
    if not tokens or tokens[0] != "P3":
        raise ValueError(f"not an ASCII PPM (P3) file: {path}")
    width, height, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    if maxval != 255:
        raise ValueError(f"unsupported max color value {maxval}")
    rgb = np.array(tokens[4:4 + width * height * 3], np.uint8).reshape(
        height, width, 3)
    a = np.full((height, width, 1), 255, np.uint8)
    return np.concatenate([rgb, a], axis=-1)


def png_bytes(framebuffer: np.ndarray) -> bytes:
    """Minimal dependency-free PNG encoder (RGBA8) -> bytes."""
    fb = np.asarray(framebuffer)
    if fb.dtype != np.uint8:   # accept [0,1] float images for quick viewing
        fb = (np.clip(fb, 0.0, 1.0) * 255.999).astype(np.uint8)
    if fb.shape[2] == 3:
        a = np.full(fb.shape[:2] + (1,), 255, np.uint8)
        fb = np.concatenate([fb, a], axis=-1)
    height, width = fb.shape[:2]
    raw = b"".join(b"\x00" + fb[r].tobytes() for r in range(height))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(framebuffer: np.ndarray, path: str) -> None:
    """Minimal dependency-free PNG writer (RGBA8), for quick viewing."""
    with open(path, "wb") as f:
        f.write(png_bytes(framebuffer))
