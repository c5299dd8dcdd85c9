"""3-vector math on ``[..., 3]`` float32 tensors.

Port of ``raytracer_tpu/maths.py``: everything works on tensors whose last
axis has length 3, with the reference's semantics (maths.rs) -- ``normalize``
divides by sqrt(|v|^2) with no epsilon, cross products are never
renormalised (NVec3::cross, maths.rs:131-137), ``refract`` takes the ``abs``
under its square root (maths.rs:31-36).  Everything is differentiable by
autograd; ``safe_sqrt`` keeps the cotangent finite at zero.
"""

from __future__ import annotations

import torch

__all__ = ["vec3", "dot", "cross", "length", "length_squared", "normalize",
           "near_zero", "reflect", "refract", "project", "lerp", "safe_sqrt",
           "sqrt_rn"]


class _SafeSqrt(torch.autograd.Function):
    """sqrt whose derivative is 0 (not inf) at x <= 0: the counterpart of
    the JAX package's ``safe_sqrt`` custom JVP (maths.py:33-55)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        positive = x > 0
        dydx = torch.where(positive,
                           0.5 / torch.where(positive, y, torch.ones_like(y)),
                           torch.zeros_like(y))
        return dydx * g


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt with the primal of ``torch.sqrt`` and a zero cotangent at
    x <= 0, so exactly-zero inputs on masked or grazing lanes (refract's
    ``sqrt(abs(1 - |r_perp|^2))``) never turn a zero cotangent into NaN."""
    return _SafeSqrt.apply(x)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded once to nearest, as IEEE (and the
    reference's ``f32::sqrt``) defines it, on any device: PyTorch's
    vectorised float32 sqrt on the CPU is off by one ulp on ~0.7% of
    inputs, while float64's, rounded to float32, is exact (53 >= 2 * 24 +
    2 bits).  CUDA's float32 sqrt is IEEE's (nvcc's default
    -prec-sqrt=true), so there it is taken directly."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def vec3(x, y, z, dtype=torch.float32, device=None) -> torch.Tensor:
    """Build a [3] vector (or stacked [..., 3] when the args are tensors)."""
    parts = [torch.as_tensor(c, dtype=dtype, device=device)
             for c in (x, y, z)]
    return torch.stack(torch.broadcast_tensors(*parts), dim=-1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product over the last axis (maths.rs:82,125)."""
    return torch.sum(a * b, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product in the reference's arithmetic form (maths.rs:88-94)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, -(ax * bz - az * bx), ax * by - ay * bx], dim=-1)


def length_squared(v: torch.Tensor) -> torch.Tensor:
    return dot(v, v)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(length_squared(v))


def normalize(v: torch.Tensor) -> torch.Tensor:
    """v / sqrt(|v|^2), no epsilon (maths.rs:111-118)."""
    return v / length(v)[..., None]


def near_zero(v: torch.Tensor, s: float = 1e-8) -> torch.Tensor:
    """All components below ``s`` in magnitude (maths.rs:46-49)."""
    return torch.all(v.abs() < s, dim=-1)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """v - 2 (v.n) n (maths.rs:26-28)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: torch.Tensor, n: torch.Tensor, etai_over_etat
            ) -> torch.Tensor:
    """Snell refraction in the reference's form (maths.rs:31-36):
    ``cos = (-uv).n`` unclamped, ``r_perp = eta (uv + cos n)``,
    ``r_par = -sqrt(|1 - |r_perp|^2|) n`` -- the ``abs`` turns total
    internal reflection into a sign flip, as the reference does."""
    eta = torch.as_tensor(etai_over_etat, dtype=uv.dtype,
                          device=uv.device)[..., None]
    cos_theta = dot(-uv, n)[..., None]
    r_out_perp = eta * (uv + cos_theta * n)
    r_out_parallel = -safe_sqrt(
        (1.0 - length_squared(r_out_perp)).abs())[..., None] * n
    return r_out_perp + r_out_parallel


def project(v: torch.Tensor, onto: torch.Tensor) -> torch.Tensor:
    """Project v onto the line spanned by ``onto`` (maths.rs:21-23)."""
    return (dot(onto, v) / length_squared(onto))[..., None] * onto


def lerp(a, b, t) -> torch.Tensor:
    """a*(1-t) + b*t, t broadcast over the vector axis (common.rs:26-29)."""
    t = torch.as_tensor(t)[..., None]
    return a * (1.0 - t) + b * t
