"""Colour utilities (port of ``raytracer_tpu/color.py``; reference:
color.rs).

Colours are ``[..., 3]`` float32 tensors (the reference's alpha is a
constant 1.0 per sample); the u8 conversion is the reference's sqrt gamma,
255.999 scale and truncation (common.rs:343-356).  No render path uses
these: ``render.finalize_image`` is the framebuffer finish.
"""

from __future__ import annotations

import torch

__all__ = ["color", "lerp_with_alpha", "to_u8", "from_u8"]

_F32 = torch.float32


def color(r, g, b) -> torch.Tensor:
    """Color::new, alpha implied 1.0 (color.rs:21-23)."""
    return torch.stack([torch.as_tensor(r, dtype=_F32),
                        torch.as_tensor(g, dtype=_F32),
                        torch.as_tensor(b, dtype=_F32)], dim=-1)


def lerp_with_alpha(a, b, t) -> torch.Tensor:
    """color.rs:39-47: the reference's 'lerp' MULTIPLIES the two scaled
    colours instead of adding them (a quirk, kept; unused by the render
    path).  ``t`` rounds to float32 first, as in the JAX package."""
    t = torch.as_tensor(t, dtype=_F32)
    return (a * (1.0 - t)) * (b * t)


def to_u8(rgb_linear_mean, clip: bool = True) -> torch.Tensor:
    """sqrt gamma, x255.999 and a truncating u8 cast (common.rs:343-356)."""
    x = torch.as_tensor(rgb_linear_mean, dtype=_F32)
    x = torch.sqrt(torch.clamp_min(x, 0.0)) * 255.999
    if clip:
        x = torch.clamp(x, 0.0, 255.0)
    return x.to(torch.uint8)


def from_u8(rgb_u8) -> torch.Tensor:
    """The inverse mapping (approximate): u8 -> linear radiance."""
    x = torch.as_tensor(rgb_u8).to(_F32) / 255.999
    return x * x
