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

``scatter_exact`` (one ray, the reference's exact operation order) and
``draws_random`` serve the sequential parity renderer.
"""

from __future__ import annotations

import dataclasses

import torch

from . import maths
from .intersect import EPS8, dot3
from .scene import DIELECTRIC, DIFFUSE, EMISSION, METAL, Materials

__all__ = ["ScatterData", "random_unit_sphere", "scatter", "scatter_exact",
           "draws_random"]


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


def material_table(materials: Materials) -> torch.Tensor:
    """[M, 6] float32 rows (kind, r, g, b, fuzz, ir): one gather reads all
    of a hit's material (the kind codes 0-3 are exact in float32)."""
    return torch.cat([materials.kind.to(torch.float32)[:, None],
                      materials.color, materials.fuzz[:, None],
                      materials.ir[:, None]], dim=1)


def _material_row(table: torch.Tensor, mat: torch.Tensor):
    """(kind, albedo, fuzz, ir) of the material a [1] device index names,
    by a gather (indexing by a 0-d tensor would sync on the host)."""
    return torch.index_select(table, 0, mat.view(1).long())[0].split(
        (1, 3, 1, 1))


def _unit_rows(v: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    """Each row v / sqrt(|v|^2) (maths.rs:111-118), or ``fallback``'s row
    where |v|^2 is 0."""
    sq = dot3(v, v)[..., None]
    zero = sq == 0.0
    return torch.where(zero, fallback, v / maths.sqrt_rn(
        torch.where(zero, torch.ones_like(sq), sq)))


def _scatter_exact(row, ray_direction, normal, rand_unit) -> ScatterData:
    kind, albedo, fuzz, ir = row
    dif_raw = normal + rand_unit
    degenerate = (dif_raw.abs() < EPS8).all()       # maths.rs:46-49
    # reflect: v - 2 (v.n) n (maths.rs:26-28); v.n is also the front-face
    # test (materials.rs:26-28)
    dn = dot3(ray_direction, normal)
    met_raw = (ray_direction - (dn * 2.0) * normal) + fuzz * rand_unit
    inside = dn >= 0.0
    n_eff = torch.where(inside, -normal, normal)
    ratio = torch.where(inside, torch.ones_like(ir) / ir, ir)
    # refract (maths.rs:31-36): eta (uv + cos n) - sqrt(|1 - |r_perp|^2|) n
    cos_theta = dot3(-ray_direction, n_eff)
    r_perp = ratio * (ray_direction + cos_theta * n_eff)
    r_par = -maths.sqrt_rn((1.0 - dot3(r_perp, r_perp)).abs()) * n_eff
    # the three candidate directions normalised at once
    dif_dir, met_dir, die_dir = _unit_rows(
        torch.stack([dif_raw, met_raw, r_perp + r_par]),
        torch.stack([normal, normal, n_eff])).unbind(0)
    met_keep = dot3(met_raw, normal) >= 0.0

    is_met = kind == METAL
    is_die = kind == DIELECTRIC
    color = torch.where(is_die, torch.ones_like(albedo), albedo)
    direction = torch.where(
        kind == DIFFUSE, torch.where(degenerate, normal, dif_dir),
        torch.where(is_met, met_dir, torch.where(is_die, die_dir, normal)))
    return ScatterData(color=color, direction=direction,
                       terminal=(kind == EMISSION) | (is_met & ~met_keep))


def scatter_exact(materials: Materials, mat_idx: torch.Tensor,
                  ray_direction: torch.Tensor, normal: torch.Tensor,
                  rand_unit: torch.Tensor) -> ScatterData:
    """Single-ray ``scatter`` (shapes [3] / 0-d) with the reference's
    per-scalar operation order (``raytracer_tpu/materials.py:112``), every
    dot product added left to right, for the sequential parity renderer.
    All four rules are evaluated and selected by the device index
    ``mat_idx``, with no host sync.  A dielectric of ``ir 0`` hit from
    inside refracts by 1/0 and gives the reference's NaN direction."""
    sc = _scatter_exact(_material_row(material_table(materials), mat_idx),
                        ray_direction, normal, rand_unit)
    return ScatterData(color=sc.color, direction=sc.direction,
                       terminal=sc.terminal.reshape(()))


def draws_random(materials: Materials, mat_idx: torch.Tensor
                 ) -> torch.Tensor:
    """True where the reference's scatter draws the 3 stream values of
    random_unit_sphere (diffuse and metal, materials.rs:44,56); dielectric
    and emission draw nothing."""
    kind = _material_row(material_table(materials), mat_idx)[0]
    return ((kind == DIFFUSE) | (kind == METAL)).reshape(())
