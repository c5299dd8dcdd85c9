"""Branchless material scatter over a wavefront of rays.

Port of ``raytracer_tpu/materials.py`` (the wavefront half): all four
scatter rules of the reference (materials.rs:30-102) are evaluated for the
whole batch and selected with masks, and every step is differentiable by
autograd.

  * diffuse    -- normal + random_unit_sphere, degenerate sums fall back to
                  the normal (materials.rs:42-52);
  * metal      -- reflect + fuzz * random_unit_sphere, absorbed when the
                  result leaves through the surface (materials.rs:54-63);
  * dielectric -- ALWAYS refracts (the reference's Schlick term is
                  commented out), with the front-face test
                  ``dot(dir, normal) >= 0`` selecting (-n, 1/ir) over
                  (n, ir) (materials.rs:26-28, 65-97);
  * emission   -- terminal (materials.rs:100-102).

``scatter_exact`` and ``draws_random`` belong to the parity renderer and
come with it.
"""

from __future__ import annotations

import dataclasses

import torch

from . import maths
from .scene import DIELECTRIC, DIFFUSE, EMISSION, METAL, Materials

__all__ = ["ScatterData", "random_unit_sphere", "scatter"]


@dataclasses.dataclass(frozen=True)
class ScatterData:
    """Batched ScatterData (materials.rs:14-17)."""
    color: torch.Tensor      # [B, 3] attenuation (or emission) colour
    direction: torch.Tensor  # [B, 3] unit next direction (if not terminal)
    terminal: torch.Tensor   # [B] bool: the reference's next_ray is None


def _safe_normalize(v: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    """normalize(v), or ``fallback`` where |v| == 0, with no NaN in the
    value or the cotangent (the double-where pattern)."""
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    zero = sq == 0.0
    inv = torch.rsqrt(torch.where(zero, torch.ones_like(sq), sq))
    return torch.where(zero, fallback, v * inv)


def random_unit_sphere(bx, by, bz) -> torch.Tensor:
    """common.rs:32-38: a cube sample in [-1, 1]^3 normalised onto the
    sphere's surface (corner-biased, not rejection-sampled).  This exact
    distribution is part of image parity."""
    return maths.normalize(torch.stack([bx, by, bz], dim=-1))


def scatter(materials: Materials, mat_idx: torch.Tensor,
            ray_direction: torch.Tensor, normal: torch.Tensor,
            rand_unit: torch.Tensor) -> ScatterData:
    """MaterialType::scatter for the whole batch.

    mat_idx [B] int rows of the material table; ray_direction [B, 3] unit
    incoming directions; normal [B, 3] unit normals at the hits; rand_unit
    [B, 3] unit-sphere samples (one per ray for this bounce).
    """
    mat_idx = mat_idx.long()
    kind = materials.kind[mat_idx]
    albedo = materials.color[mat_idx]
    fuzz = materials.fuzz[mat_idx][:, None]
    ir = materials.ir[mat_idx]

    dif_raw = normal + rand_unit
    degenerate = maths.near_zero(dif_raw)[:, None]
    dif_dir = torch.where(degenerate, normal,
                          _safe_normalize(dif_raw, normal))

    met_raw = maths.reflect(ray_direction, normal) + fuzz * rand_unit
    met_keep = maths.dot(met_raw, normal) >= 0.0
    met_dir = _safe_normalize(met_raw, normal)

    inside = maths.dot(ray_direction, normal) >= 0.0
    n_eff = torch.where(inside[:, None], -normal, normal)
    ratio = torch.where(inside, 1.0 / ir, ir)
    die_dir = _safe_normalize(maths.refract(ray_direction, n_eff, ratio),
                              n_eff)

    is_dif = (kind == DIFFUSE)[:, None]
    is_met = kind == METAL
    is_die = kind == DIELECTRIC
    is_emi = kind == EMISSION
    color = torch.where(is_die[:, None], torch.ones_like(albedo), albedo)
    direction = torch.where(
        is_dif, dif_dir,
        torch.where(is_met[:, None], met_dir,
                    torch.where(is_die[:, None], die_dir, normal)))
    return ScatterData(color=color, direction=direction,
                       terminal=is_emi | (is_met & ~met_keep))
