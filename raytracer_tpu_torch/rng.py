"""Deterministic random numbers, two ways (port of ``raytracer_tpu/rng.py``).

1. ``xorshift32`` / ``XorShift32`` -- the reference's ONE sequential stream
   (seed 2547549, random.rs:8-30), consumed in raster order by the oracle
   and the sequential parity renderer (``render.ray_trace_parity``), with
   the same ``u32 / u32::MAX`` float mapping (``random_f32_from_bits``,
   random.rs:15-17).
2. ``pcg3d`` -- the counter-based hash of the fast render path (the
   public-domain hash of Jarzynski & Olano, "Hash Functions for GPU
   Rendering", JCGT 2020): three 32-bit counters map to three 32-bit words,
   so every (pixel, sample, bounce) draws from its own stream with no state
   to thread.  The caller's seed is folded into the counters.

Words are held in ``torch.int32`` and wrap like C's ``unsigned``: torch's
``uint32`` has no ``+`` and no ``>>``, and an ``int32`` right shift is
arithmetic, so every shift is masked back to a logical one.  The bits equal
the JAX package's ``uint32`` words exactly (two's complement reinterpretation).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "DEFAULT_SEED", "SEED_MIX", "U32_MAX_F32", "as_int32", "as_uint32",
    "seed_word", "xorshift32", "random_f32_from_bits", "XorShift32", "pcg3d",
    "random_f32_from_bits24", "uniform2", "uniform3", "uniform_bilateral3",
]

# random.rs:9 -- NonZeroU32::new(2547549)
DEFAULT_SEED = 2547549
# seed -> counter offset multiplier (render.py / wavefront.py _SEED_MIX)
SEED_MIX = 0x85EBCA6B

_MASK32 = 0xFFFFFFFF
# ``x as f32 / u32::MAX as f32``: u32::MAX rounds to 2^32 in float32
U32_MAX_F32 = np.float32(np.uint32(0xFFFFFFFF))
# f32(1 / (2^24 - 1)), the constant rng.py:130 multiplies by
INV_2_24_M1 = float(np.float32(1.0 / 16777215.0))


def _wrap_int(v: int) -> int:
    """A Python int mod 2^32, as the signed int32 with the same bits."""
    v &= _MASK32
    return v - (1 << 32) if v >= (1 << 31) else v


def as_int32(v, device=None) -> torch.Tensor:
    """Counters (Python int, numpy or torch array of any int type) as int32
    tensors holding the same low 32 bits."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.int32:
            return v if device is None else v.to(device)
        return (v.to(torch.int64) & _MASK32).to(torch.int32).to(
            device or v.device)
    arr = np.asarray(v)
    if arr.dtype.kind not in "iub":
        raise TypeError(f"counters must be integers, got {arr.dtype}")
    arr = (arr.astype(np.int64) & _MASK32).astype(np.uint32).view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device or "cpu")


def as_uint32(words: torch.Tensor) -> np.ndarray:
    """int32 words -> numpy uint32 with the same bits (for comparisons)."""
    return words.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def seed_word(seed: int) -> int:
    """uint32(seed) * 0x85EBCA6B mod 2^32 (render.py:214, wavefront.py:993)."""
    return ((seed & _MASK32) * SEED_MIX) & _MASK32


def _srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 words."""
    return (x >> n) & ((1 << (32 - n)) - 1)


def xorshift32(state: torch.Tensor) -> torch.Tensor:
    """One xorshift32 step (random.rs:22-30) on int32 words."""
    x = as_int32(state)
    x = x ^ (x << 13)
    x = x ^ _srl(x, 17)
    x = x ^ (x << 5)
    return x


def random_f32_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """int32 words as their unsigned values in float32 (one
    round-to-nearest, as Rust's ``u32 as f32``), over ``U32_MAX_F32``: a
    uniform in [0, 1] (random.rs:15-17)."""
    u = (as_int32(bits).to(torch.int64) & _MASK32).to(torch.float32)
    return u / float(U32_MAX_F32)


class XorShift32:
    """Stateful host clone of the reference ``Random`` (numpy scalars), for
    the oracle and tests; the device path threads its state as a tensor."""

    def __init__(self, seed: int = DEFAULT_SEED):
        if seed == 0:
            raise ValueError("xorshift32 needs a non-zero seed")
        self.state = np.uint32(seed)

    def next_u32(self) -> np.uint32:
        v = int(self.state)
        v ^= (v << 13) & _MASK32
        v ^= v >> 17
        v ^= (v << 5) & _MASK32
        self.state = np.uint32(v)
        return self.state

    def random_f32(self) -> np.float32:
        """[0, 1] -- random.rs:15-17."""
        return np.float32(np.float32(self.next_u32()) / U32_MAX_F32)

    def random_bilateral_f32(self) -> np.float32:
        """[-1, 1] -- random.rs:19-21."""
        return np.float32(self.random_f32() * np.float32(2.0)
                          - np.float32(1.0))


def pcg3d(v0, v1, v2):
    """pcg3d hash: three 32-bit counters -> three 32-bit words (int32)."""
    dev = next((v.device for v in (v0, v1, v2)
                if isinstance(v, torch.Tensor)), None)
    x, y, z = (as_int32(v, dev) for v in (v0, v1, v2))
    x, y, z = torch.broadcast_tensors(x, y, z)
    mul = 1664525
    add = 1013904223
    x = x * mul + add
    y = y * mul + add
    z = z * mul + add
    x = x + y * z
    y = y + z * x
    z = z + x * y
    x = x ^ _srl(x, 16)
    y = y ^ _srl(y, 16)
    z = z ^ _srl(z, 16)
    x = x + y * z
    y = y + z * x
    z = z + x * y
    return x, y, z


def random_f32_from_bits24(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1] from the top 24 bits: (bits >> 8) * f32(1 / (2^24 - 1))."""
    return _srl(as_int32(bits), 8).to(torch.float32) * INV_2_24_M1


def uniform3(v0, v1, v2):
    """Three independent uniforms in [0, 1] from three counters."""
    a, b, c = pcg3d(v0, v1, v2)
    return (random_f32_from_bits24(a), random_f32_from_bits24(b),
            random_f32_from_bits24(c))


def uniform_bilateral3(v0, v1, v2):
    """Three independent uniforms in [-1, 1] (random.rs:19-21 mapping)."""
    a, b, c = uniform3(v0, v1, v2)
    return a * 2.0 - 1.0, b * 2.0 - 1.0, c * 2.0 - 1.0


def uniform2(v0, v1, v2):
    """Two uniforms in [0, 1] (third word discarded)."""
    a, b, _ = pcg3d(v0, v1, v2)
    return random_f32_from_bits24(a), random_f32_from_bits24(b)
