"""Golden oracle: scalar NumPy re-derivation of the reference renderer.

A copy of ``raytracer_tpu/oracle.py`` (the port cannot import the JAX
package), held equal to it by ``tests/test_torch_parity.py``.  It
re-derives the reference's algorithm in straight-line float32 NumPy, one
sample at a time, consuming a single sequential xorshift32 stream in raster
order exactly like ``common.rs:320-361``; every step cites the reference
line it mirrors.  It is the ground truth of the port's parity renderer
(``render.ray_trace_parity``) and of the native engine (``native.py``).

It is deliberately slow (scalar Python): use tiny configs.  All arithmetic
is float32; NumPy 2.x NEP-50 weak promotion keeps ``np.float32 <op>
python-float`` in float32, matching Rust f32 IEEE ops.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .rng import XorShift32

f32 = np.float32

# material type codes (shared with the device scene encoding)
DIFFUSE, METAL, DIELECTRIC, EMISSION = 0, 1, 2, 3


def _v(x, y, z):
    return np.array([x, y, z], dtype=np.float32)


def _dot(a, b):
    # maths.rs:82 — x*x' + y*y' + z*z'
    return f32(a[0] * b[0] + a[1] * b[1] + a[2] * b[2])


def _cross(a, b):
    # maths.rs:88-94
    return _v(
        a[1] * b[2] - a[2] * b[1],
        -(a[0] * b[2] - a[2] * b[0]),
        a[0] * b[1] - a[1] * b[0],
    )


def _normalize(a):
    # maths.rs:111-118 — divide by sqrt(len^2), no epsilon
    length = f32(np.sqrt(_dot(a, a)))
    return a / length


def _near_zero(a):
    # maths.rs:46-49
    s = f32(1e-8)
    return abs(a[0]) < s and abs(a[1]) < s and abs(a[2]) < s


def _reflect(v, n):
    # maths.rs:26-28
    return v - f32(2.0) * _dot(v, n) * n


def _refract(uv, n, etai_over_etat):
    # maths.rs:31-36
    cos_theta = _dot(-uv, n)
    r_out_perp = f32(etai_over_etat) * (uv + cos_theta * n)
    r_out_parallel = f32(-np.sqrt(np.abs(f32(1.0) - _dot(r_out_perp, r_out_perp)))) * n
    return r_out_perp + r_out_parallel


def _random_unit_sphere(rng: XorShift32):
    # common.rs:32-38 — normalized cube sample, draw order x, y, z
    x = rng.random_bilateral_f32()
    y = rng.random_bilateral_f32()
    z = rng.random_bilateral_f32()
    return _normalize(_v(x, y, z))


@dataclasses.dataclass
class OMaterial:
    kind: int
    color: np.ndarray = dataclasses.field(default_factory=lambda: _v(0, 0, 0))
    fuzz: float = 0.0      # metal only (materials.rs:9)
    ir: float = 1.0        # dielectric only (materials.rs:10)


@dataclasses.dataclass
class OSphere:
    center: np.ndarray
    radius: float
    material: OMaterial


@dataclasses.dataclass
class OTriangle:
    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    material: OMaterial

    @property
    def normal(self):
        # Triangle::new (common.rs:116-123): unit normal from edge cross
        a = self.v1 - self.v0
        b = self.v2 - self.v0
        return _normalize(_cross(a, b))


@dataclasses.dataclass
class OCamera:
    """Camera as origin + viewport plane (camera.rs:8-15)."""
    origin: np.ndarray
    lower_left_corner: np.ndarray
    horizontal: np.ndarray
    vertical: np.ndarray

    @staticmethod
    def new_at(origin, aspect_ratio):
        # camera.rs:21-33 — viewport height 2.0, focal length 1.0
        viewport_height = f32(2.0)
        viewport_width = f32(aspect_ratio) * viewport_height
        focal_length = f32(1.0)
        horizontal = _v(viewport_width, 0.0, 0.0)
        vertical = _v(0.0, viewport_height, 0.0)
        llc = np.asarray(origin, np.float32) - _v(
            viewport_width / f32(2.0), viewport_height / f32(2.0), focal_length
        )
        return OCamera(np.asarray(origin, np.float32), llc, horizontal, vertical)

    @staticmethod
    def new_with_vertical_fov(origin, vertical_fov, aspect_ratio):
        # camera.rs:34-48
        h = f32(np.tan(f32(vertical_fov) / f32(2.0)))
        viewport_height = f32(2.0) * h
        viewport_width = f32(aspect_ratio) * viewport_height
        focal_length = f32(1.0)
        horizontal = _v(viewport_width, 0.0, 0.0)
        vertical = _v(0.0, viewport_height, 0.0)
        llc = np.asarray(origin, np.float32) - _v(
            viewport_width / f32(2.0), viewport_height / f32(2.0), focal_length
        )
        return OCamera(np.asarray(origin, np.float32), llc, horizontal, vertical)

    @staticmethod
    def new_look_at(origin, look_at, up, vertical_fov, aspect_ratio):
        # camera.rs:49-69.  NVec3::cross is new_unchecked (maths.rs:131-137),
        # so u and v are NOT renormalized — preserved here.
        origin = np.asarray(origin, np.float32)
        look_at = np.asarray(look_at, np.float32)
        up = np.asarray(up, np.float32)
        assert not _near_zero(origin - look_at), "Origin and look_at must differ!"
        viewport_height = f32(2.0) * f32(np.tan(f32(vertical_fov) / f32(2.0)))
        viewport_width = viewport_height * f32(aspect_ratio)
        w = _normalize(origin - look_at)
        u = _cross(up, w)          # unnormalized (unchecked)
        v = _cross(w, u)           # unnormalized (unchecked)
        assert abs(v[1]) > 1e-8, "Origin and look_at can't have the same z-coordinate."
        horizontal = u * viewport_width
        vertical = v * viewport_height
        llc = origin - horizontal / f32(2.0) - vertical / f32(2.0) - w
        return OCamera(origin, llc, horizontal, vertical)

    def cast_ray(self, s, t):
        # camera.rs:84-89
        direction = _normalize(
            self.lower_left_corner + f32(s) * self.horizontal
            + f32(t) * self.vertical - self.origin
        )
        return self.origin, direction

    def aspect_ratio(self):
        # camera.rs:70-72
        return f32(self.horizontal[0] / self.vertical[1])

    def position(self):
        return self.origin


@dataclasses.dataclass
class OWorld:
    spheres: List[OSphere]
    triangles: List[OTriangle]  # single concatenated "mesh"


def _sphere_hit(sphere: OSphere, origin, direction, t_min, t_max):
    """common.rs:60-98 — half-b quadratic.  a == 1.0 exactly because the
    reference calls NVec3::length_squared() which is hardcoded to 1.0
    (maths.rs:127-128)."""
    oc = origin - sphere.center
    a = f32(1.0)
    half_b = _dot(oc, direction)
    c = _dot(oc, oc) - f32(sphere.radius) * f32(sphere.radius)
    discriminant = half_b * half_b - a * c
    if discriminant < 0.0:
        return None
    dsqrt = f32(np.sqrt(discriminant))
    root1 = (-half_b - dsqrt) / a
    root2 = (-half_b + dsqrt) / a
    # strict (t_min, t_max) filter, then min (common.rs:88-92)
    candidates = [r for r in (root1, root2) if t_min < r < t_max]
    if not candidates:
        return None
    t = min(candidates)
    position = origin + direction * t
    normal = _normalize((position - sphere.center) / f32(sphere.radius))
    return (t, position, normal, sphere.material)


def _triangle_hit(tri: OTriangle, origin, direction, t_min, t_max,
                  parity_plane_sign=True):
    """common.rs:124-166 — plane intersection + 3 edge tests.

    ``parity_plane_sign=True`` reproduces the reference's plane equation
    ``t = (n.origin + d) / (n.dir)`` with ``d = n.v0`` (common.rs:140-141),
    whose sign is only correct for origin == 0; False uses the standard
    ``t = (d - n.origin) / (n.dir)``.
    """
    v0, v1, v2 = tri.v0, tri.v1, tri.v2
    a = v1 - v0
    b = v2 - v0
    n = _cross(a, b)  # NOT normalized (common.rs:131-133)

    cos_angle_and_length = _dot(n, direction)
    if -1e-8 < cos_angle_and_length < 1e-8:  # common.rs:135-138
        return None

    d = _dot(n, v0)
    if parity_plane_sign:
        t = (_dot(n, origin) + d) / cos_angle_and_length   # common.rs:140-141
    else:
        t = (d - _dot(n, origin)) / cos_angle_and_length
    # NON-strict bounds: equality passes (common.rs:142)
    if t < t_min or t > t_max:
        return None

    p = origin + direction * t

    # Edge tests (common.rs:147-163): reject on strict < 0
    e0 = v1 - v0
    if _dot(n, _cross(e0, p - v0)) < 0.0:
        return None
    e1 = v2 - v1
    if _dot(n, _cross(e1, p - v1)) < 0.0:
        return None
    e2 = v0 - v2
    if _dot(n, _cross(e2, p - v2)) < 0.0:
        return None

    return (t, p, tri.normal, tri.material)


def _world_hit(world: OWorld, origin, direction, parity_plane_sign=True):
    """common.rs:237-258 — spheres first, then mesh, t_min = 0.001."""
    closest = f32(np.inf)
    hit = None
    for sphere in world.spheres:
        h = _sphere_hit(sphere, origin, direction, f32(0.001), closest)
        if h is not None:
            closest = h[0]
            hit = h
    # Mesh::hit (common.rs:178-223): linear scan, strict < running closest
    mesh_closest = f32(np.inf)
    for tri in world.triangles:
        h = _triangle_hit(tri, origin, direction, f32(0.001), closest,
                          parity_plane_sign)
        if h is not None and h[0] < mesh_closest:
            mesh_closest = h[0]
            hit = h
    return hit


def ray_color(origin, direction, world: OWorld, rng: XorShift32, depth: int,
              parity_plane_sign=True):
    """common.rs:263-285 — iterative bounce loop.  Returns rgb (alpha is
    always 1.0: Color::new sets a=1, mul_with_alpha of ones stays 1)."""
    final_color = _v(1.0, 1.0, 1.0)
    for _ in range(depth):
        hit = _world_hit(world, origin, direction, parity_plane_sign)
        if hit is not None:
            t, position, normal, material = hit
            color, next_dir = _scatter(material, direction, position, normal, rng)
            if next_dir is not None:
                final_color = final_color * color
                origin, direction = position, next_dir
            else:
                return final_color * color     # terminal (common.rs:273-275)
        else:
            # sky lerp (common.rs:277-280)
            tsky = f32(0.5) * (_normalize(direction)[1] + f32(1.0))
            sky = _v(1.0, 1.0, 1.0) * (f32(1.0) - tsky) + _v(0.5, 0.7, 1.0) * tsky
            return final_color * sky
    return _v(0.0, 0.0, 0.0)                   # exhausted -> black (common.rs:284)


def _scatter(material: OMaterial, direction, position, normal, rng: XorShift32):
    """materials.rs:30-102.  Returns (color rgb, next_direction or None)."""
    if material.kind == DIFFUSE:
        # materials.rs:42-52
        scatter = normal + _random_unit_sphere(rng)
        if _near_zero(scatter):
            return material.color, normal
        return material.color, _normalize(scatter)
    if material.kind == METAL:
        # materials.rs:54-63 — fuzz sample drawn even when fuzz == 0
        reflected = _reflect(direction, normal)
        d = reflected + f32(material.fuzz) * _random_unit_sphere(rng)
        if _dot(d, normal) >= 0.0:             # hit_front_face, materials.rs:26-28
            return material.color, _normalize(d)
        return material.color, None            # absorbed -> terminal
    if material.kind == DIELECTRIC:
        # materials.rs:65-97 — always refracts (Schlick commented out)
        if _dot(direction, normal) >= 0.0:
            n, ratio = -normal, f32(1.0) / f32(material.ir)
        else:
            n, ratio = normal, f32(material.ir)
        refracted = _refract(direction, n, ratio)
        return _v(1.0, 1.0, 1.0), _normalize(refracted)
    # EMISSION — materials.rs:100-102: terminal
    return material.color, None


def ray_trace(world: OWorld, camera: OCamera, width: int, height: int,
              samples_per_pixel: int, max_ray_bounces: int,
              seed: int | None = None, parity_plane_sign=True) -> np.ndarray:
    """common.rs:320-361 — the reference's scanline/sample loop.

    Returns a u8 RGBA image [height, width, 4] with the reference's vertical
    flip (row stored at height-row-1, common.rs:351) already applied.
    """
    rng = XorShift32() if seed is None else XorShift32(seed)
    fb = np.zeros((height, width, 4), dtype=np.uint8)
    inv_spp = f32(1.0) / f32(samples_per_pixel)
    for row in range(height):
        for column in range(width):
            acc = _v(0.0, 0.0, 0.0)
            acc_a = f32(0.0)
            for _ in range(samples_per_pixel):
                # jitter draw order: u then v (common.rs:335-336)
                u = (f32(column) + rng.random_f32()) / f32(width - 1)
                v = (f32(row) + rng.random_f32()) / f32(height - 1)
                origin, direction = camera.cast_ray(u, v)
                rgb = ray_color(origin, direction, world, rng,
                                max_ray_bounces, parity_plane_sign)
                acc = acc + rgb
                acc_a = acc_a + f32(1.0)       # alpha accumulates 1 per sample
            # sqrt gamma, x255.999, truncating u8 cast (common.rs:343-356)
            r = f32(np.sqrt(acc[0] * inv_spp)) * f32(255.999)
            g = f32(np.sqrt(acc[1] * inv_spp)) * f32(255.999)
            b = f32(np.sqrt(acc[2] * inv_spp)) * f32(255.999)
            a = acc_a * inv_spp * f32(255.999)
            fb[height - row - 1, column] = (
                _as_u8(r), _as_u8(g), _as_u8(b), _as_u8(a))
    return fb


def _as_u8(v) -> np.uint8:
    """Rust's saturating ``as u8`` float cast (common.rs:352-355): truncate
    toward zero, clamp to [0, 255], and NaN -> 0 (a NaN color reaches here
    when scene values like ir=0 poison the math; NaN *t* values never hit
    the reference's panicking comparator because the range filter at
    common.rs:90-91 is false for NaN)."""
    if not v > 0.0:  # False for NaN
        return np.uint8(0)
    if v > 255.0:
        return np.uint8(255)
    return np.uint8(int(v))
