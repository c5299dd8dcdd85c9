"""3x3 matrix operations on ``[..., 3, 3]`` tensors, rows on the last but
one axis (port of ``raytracer_tpu/mat3.py``; reference: mat3.rs:7-131).

Product, transpose, determinant, cofactor, adjugate and the Cramer-rule
inverse, batched over leading axes.  The reference's ``mul_vec3`` is a stub
that returns its argument (mat3.rs:52-54); here, as in the JAX package, it
is the real product (the stub backed only a commented-out triangle path,
common.rs:195-219).
"""

from __future__ import annotations

import torch

__all__ = ["identity", "mat3", "mul", "mul_vec3", "mul_scalar", "transpose",
           "det", "cofactor", "adjugate", "inverse"]


def mat3(r1, r2, r3) -> torch.Tensor:
    """Stack three [..., 3] row vectors into a [..., 3, 3] matrix."""
    return torch.stack([torch.as_tensor(r1), torch.as_tensor(r2),
                        torch.as_tensor(r3)], dim=-2)


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(3, dtype=dtype, device=device)


def mul(a, b) -> torch.Tensor:
    """Matrix product (mat3.rs:31-51)."""
    return torch.matmul(a, b)


def mul_vec3(a, v) -> torch.Tensor:
    """Matrix-vector product, the corrected semantics (module doc)."""
    return torch.matmul(a, v[..., None])[..., 0]


def mul_scalar(a, s) -> torch.Tensor:
    return a * s


def transpose(a) -> torch.Tensor:
    """mat3.rs:125-131."""
    return torch.swapaxes(a, -1, -2)


def _cof_entries(a):
    r1, r2, r3 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    x, y, z = 0, 1, 2
    c11 = r2[..., y] * r3[..., z] - r3[..., y] * r2[..., z]
    c12 = -(r2[..., x] * r3[..., z] - r3[..., x] * r2[..., z])
    c13 = r2[..., x] * r3[..., y] - r3[..., x] * r2[..., y]
    c21 = -(r1[..., y] * r3[..., z] - r3[..., y] * r1[..., z])
    c22 = r1[..., x] * r3[..., z] - r3[..., x] * r1[..., z]
    c23 = -(r1[..., x] * r3[..., y] - r3[..., x] * r1[..., y])
    c31 = r1[..., y] * r2[..., z] - r2[..., y] * r1[..., z]
    c32 = -(r1[..., x] * r2[..., z] - r2[..., x] * r1[..., z])
    c33 = r1[..., x] * r2[..., y] - r2[..., x] * r1[..., y]
    return c11, c12, c13, c21, c22, c23, c31, c32, c33


def cofactor(a) -> torch.Tensor:
    """Cofactor matrix (mat3.rs:57-77)."""
    c11, c12, c13, c21, c22, c23, c31, c32, c33 = _cof_entries(a)
    return mat3(torch.stack([c11, c12, c13], dim=-1),
                torch.stack([c21, c22, c23], dim=-1),
                torch.stack([c31, c32, c33], dim=-1))


def adjugate(a) -> torch.Tensor:
    """Transposed cofactor matrix (mat3.rs:78-80)."""
    return transpose(cofactor(a))


def det(a) -> torch.Tensor:
    """Determinant by first-row expansion (mat3.rs:118-122)."""
    c11, c12, c13, *_ = _cof_entries(a)
    r1 = a[..., 0, :]
    return r1[..., 0] * c11 + r1[..., 1] * c12 + r1[..., 2] * c13


def inverse(a, *, default=None):
    """Cramer-rule inverse (mat3.rs:82-116): (inv [..., 3, 3], valid [...]).

    Where the reference returns ``None`` (det == 0), the inverse is
    ``default`` (the identity unless given) and ``valid`` is False."""
    adj = adjugate(a)
    d = det(a)
    valid = d != 0.0
    safe_d = torch.where(valid, d, torch.ones_like(d))
    inv = adj * (1.0 / safe_d)[..., None, None]
    if default is None:
        default = identity(a.dtype, a.device)
    default = torch.as_tensor(default, dtype=a.dtype, device=a.device)
    return torch.where(valid[..., None, None], inv, default), valid
