"""Scene builders (port of ``raytracer_tpu/models/builders.py``).

Same scenes, same numpy arithmetic and the same numpy random streams as the
JAX package's builders, producing the port's tensor ``Scene``/``Camera`` on
the ``device`` each builder is given.  ``obj_mesh_scene`` loads its meshes
through the port's ``models/obj.py``.

``default_world_source`` is the reference's bundled scene DSL
(``/root/reference/raytracer/src/world.txt``) reproduced as data (it is the
de-facto golden fixture, SURVEY.md §4); ``ffi_example_source`` is the
embedded scene from ``examples/c_raytracer.rs:15-45`` — the only in-repo
exercise of the triangle path.  The procedural scenes implement the
BASELINE.json configs (random spheres, mesh scene, Cornell-style spheres).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from .. import parser as parser_mod
from ..camera import Camera
from ..scene import (DIFFUSE, METAL, DIELECTRIC, EMISSION, Scene,
                     build_materials, build_scene)

# raytracer/src/world.txt (identical copy bundled in the macOS app)
DEFAULT_WORLD_SOURCE = """\
camera origin 0.0 0.0 0.0 aspect 1.77778;

material RED_DIFFUSE     : Diffuse color 1.0 0.0 0.0;
material GREEN_DIFFUSE   : Diffuse color 0.0 1.0 0.0;
material BLUE_DIFFUSE    : Diffuse color 0.0 0.0 1.0;
material GROUND_MATERIAL : Diffuse color 0.8 0.8 0.0;
material BALL_MATERIAL   : Diffuse color 0.7 0.3 0.3;

material METAL_MATERIAL_1 : Metal color 0.8 0.8 0.8 fuzz 0.3;
material METAL_MATERIAL_2 : Metal color 0.8 0.6 0.2 fuzz 1.0;

material MIRROR : Metal color 0.9 0.9 0.9 fuzz 0.0;
material GLASS  : Dielectric ir 1.5;

sphere center  0.0 -100.5 -1.0  radius 100.0 material GROUND_MATERIAL;

sphere center  0.0  0.0  -1.0  radius 0.5   material BALL_MATERIAL;
sphere center -1.0  0.0  -1.0  radius 0.5   material METAL_MATERIAL_1;
sphere center  1.0  0.0  -1.0  radius 0.5   material GLASS;

sphere center  0.0  1.0  -2.0  radius 0.5   material MIRROR;

sphere center -3.0  2.0  -3.0  radius 0.5   material RED_DIFFUSE;
sphere center  0.0  2.0  -3.0  radius 0.5   material GREEN_DIFFUSE;
sphere center  3.0  2.0  -3.0  radius 0.5   material BLUE_DIFFUSE;
"""

# examples/c_raytracer.rs:15-45 — default world + 2 triangles
FFI_EXAMPLE_SOURCE = DEFAULT_WORLD_SOURCE + """
triangle v0 -0.1 -0.1 -0.5  v1 0.1 -0.1 -0.5  v2 -0.1 0.1 -0.5  material RED_DIFFUSE;
triangle v0 -0.1  0.1 -0.5  v1 0.1 -0.1 -0.5  v2  0.1 0.1 -0.5  material GREEN_DIFFUSE;
"""


def default_world_source() -> str:
    return DEFAULT_WORLD_SOURCE


def ffi_example_source() -> str:
    return FFI_EXAMPLE_SOURCE


def default_world() -> parser_mod.ParsedWorld:
    """The reference's bundled 8-sphere scene."""
    return parser_mod.parse_input(DEFAULT_WORLD_SOURCE)


def ffi_example_world() -> parser_mod.ParsedWorld:
    """Default world + the 2 FFI-example triangles."""
    return parser_mod.parse_input(FFI_EXAMPLE_SOURCE)


def sphere_and_ground() -> parser_mod.ParsedWorld:
    """BASELINE.json PR1 config: single diffuse sphere + ground sphere."""
    src = """\
camera origin 0.0 0.0 0.0 aspect 1.0;
material BALL   : Diffuse color 0.5 0.5 0.5;
material GROUND : Diffuse color 0.8 0.8 0.0;
sphere center 0.0 0.0 -1.0 radius 0.5 material BALL;
sphere center 0.0 -100.5 -1.0 radius 100.0 material GROUND;
"""
    return parser_mod.parse_input(src)


def random_spheres(n: int = 484, seed: int = 7, device="cpu"
                   ) -> Tuple[Scene, Camera]:
    """Ray-tracing-in-one-weekend style random sphere field
    (BASELINE.json config 2: ~500 spheres, lambert/metal/glass)."""
    rng = np.random.default_rng(seed)
    mats = [
        (DIFFUSE, (0.5, 0.5, 0.5), 0.0, 1.0),   # ground
        (DIELECTRIC, (1.0, 1.0, 1.0), 0.0, 1.5),
        (DIFFUSE, (0.4, 0.2, 0.1), 0.0, 1.0),
        (METAL, (0.7, 0.6, 0.5), 0.0, 1.0),
    ]
    spheres = [
        ((0.0, -1000.0, 0.0), 1000.0, 0),
        ((0.0, 1.0, 0.0), 1.0, 1),
        ((-4.0, 1.0, 0.0), 1.0, 2),
        ((4.0, 1.0, 0.0), 1.0, 3),
    ]
    side = int(math.ceil(math.sqrt(n)))
    count = 0
    for a in range(-side // 2, side - side // 2):
        for b in range(-side // 2, side - side // 2):
            if count >= n:
                break
            center = (a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random())
            if np.linalg.norm(np.array(center) - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            choose = rng.random()
            if choose < 0.8:
                albedo = tuple((rng.random(3) * rng.random(3)).tolist())
                mats.append((DIFFUSE, albedo, 0.0, 1.0))
            elif choose < 0.95:
                albedo = tuple((0.5 + 0.5 * rng.random(3)).tolist())
                mats.append((METAL, albedo, 0.5 * rng.random(), 1.0))
            else:
                mats.append((DIELECTRIC, (1.0, 1.0, 1.0), 0.0, 1.5))
            spheres.append((center, 0.2, len(mats) - 1))
            count += 1
    scene = build_scene(spheres, [], build_materials(mats, device),
                        exact_planes=True)
    cam = Camera.new_look_at((13.0, 2.0, 3.0), (0.0, 0.0, 0.0),
                             (0.0, 1.0, 0.0), math.radians(20.0), 1.0,
                             device=device)
    return scene, cam


def cornell_spheres(device="cpu") -> Tuple[Scene, Camera]:
    """Cornell-style sphere box (BASELINE north-star scene): diffuse walls
    approximated with giant spheres, an emissive ceiling light, one glass and
    one metal ball.  Uses the Emission material (materials.rs:11) that the
    reference supports but never ships a scene for."""
    mats = [
        (DIFFUSE, (0.73, 0.73, 0.73), 0.0, 1.0),  # white
        (DIFFUSE, (0.65, 0.05, 0.05), 0.0, 1.0),  # red
        (DIFFUSE, (0.12, 0.45, 0.15), 0.0, 1.0),  # green
        (EMISSION, (4.0, 4.0, 4.0), 0.0, 1.0),    # light
        (DIELECTRIC, (1.0, 1.0, 1.0), 0.0, 1.5),
        (METAL, (0.8, 0.85, 0.88), 0.0, 1.0),
    ]
    R = 1000.0
    box = 1.0
    spheres = [
        ((0.0, -R - box, 0.0), R, 0),       # floor
        ((0.0, R + box, 0.0), R, 0),        # ceiling
        ((0.0, 0.0, -R - 2 * box), R, 0),   # back
        ((-R - box, 0.0, 0.0), R, 1),       # left (red)
        ((R + box, 0.0, 0.0), R, 2),        # right (green)
        ((0.0, box + 0.45, -1.0), 0.5, 3),  # light (pokes through ceiling)
        ((-0.45, -box + 0.35, -1.3), 0.35, 4),
        ((0.45, -box + 0.35, -0.9), 0.35, 5),
    ]
    scene = build_scene(spheres, [], build_materials(mats, device),
                        exact_planes=True)
    cam = Camera.new_with_vertical_fov((0.0, 0.0, 1.4), math.radians(60.0),
                                       1.0, device=device)
    return scene, cam


def cube_mesh(center=(0.0, 0.0, -1.0), half: float = 0.3,
              material: int = 0) -> List[Tuple]:
    """12-triangle axis-aligned cube (raytracer/TODO.txt:7 'simple models')."""
    cx, cy, cz = center
    h = half
    p = [(cx + sx * h, cy + sy * h, cz + sz * h)
         for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    # p index bits: x<<2 | y<<1 | z  with -1->0, 1->1
    faces = [
        (0, 1, 3, 2),  # -x
        (4, 6, 7, 5),  # +x
        (0, 4, 5, 1),  # -y
        (2, 3, 7, 6),  # +y
        (0, 2, 6, 4),  # -z
        (1, 5, 7, 3),  # +z
    ]
    tris = []
    for a, b, c, d in faces:
        tris.append((p[a], p[b], p[c], material))
        tris.append((p[a], p[c], p[d], material))
    return tris


def icosphere_mesh(center=(0.0, 0.0, -1.0), radius: float = 0.5,
                   material: int = 0, subdivisions: int = 2) -> List[Tuple]:
    """Subdivided icosahedron (~20*4^s triangles) for the mesh-scene config
    (BASELINE.json config 3 wants ~10k tris at s=3-4)."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = [
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
    ]
    verts = [np.array(v, np.float64) / np.linalg.norm(v) for v in verts]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    for _ in range(subdivisions):
        new_faces = []
        cache = {}

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = verts[i] + verts[j]
                m = m / np.linalg.norm(m)
                verts.append(m)
                cache[key] = len(verts) - 1
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc),
                          (ab, bc, ca)]
        faces = new_faces

    center = np.array(center, np.float64)
    tris = []
    for a, b, c in faces:
        va = tuple((verts[a] * radius + center).tolist())
        vb = tuple((verts[b] * radius + center).tolist())
        vc = tuple((verts[c] * radius + center).tolist())
        tris.append((va, vb, vc, material))
    return tris


def mesh_scene(subdivisions: int = 3, device="cpu") -> Tuple[Scene, Camera]:
    """Triangle-mesh scene (BASELINE.json config 3): an icosphere over a
    ground sphere, brute-force (BVH-free) intersect."""
    mats = [
        (DIFFUSE, (0.7, 0.3, 0.3), 0.0, 1.0),
        (DIFFUSE, (0.8, 0.8, 0.0), 0.0, 1.0),
        (METAL, (0.8, 0.8, 0.8), 0.1, 1.0),
    ]
    tris = icosphere_mesh((0.0, 0.0, -1.2), 0.5, 0, subdivisions)
    tris += cube_mesh((-1.1, -0.1, -1.4), 0.25, 2)
    spheres = [((0.0, -100.5, -1.0), 100.0, 1)]
    # procedural mesh: no reference-parity claim -> correct plane equation
    scene = build_scene(spheres, tris, build_materials(mats, device),
                        exact_planes=True)
    cam = Camera.new_at((0.0, 0.0, 0.0), 1.77778, device=device)
    return scene, cam


def obj_mesh_scene(n_target_tris: int = 10240, device="cpu"
                   ) -> Tuple[Scene, Camera]:
    """~10k-triangle OBJ scene (BASELINE.json config 3 at its stated scale:
    "low-poly OBJ, ~10k tris").

    Two subdivision-4 icospheres (5120 triangles each) round-tripped
    through the OBJ text format, so the scene exercises ``models.obj`` end
    to end rather than feeding procedural arrays straight in.
    """
    from . import obj as obj_mod

    mats = [
        (DIFFUSE, (0.7, 0.3, 0.3), 0.0, 1.0),
        (DIFFUSE, (0.8, 0.8, 0.0), 0.0, 1.0),
        (METAL, (0.85, 0.85, 0.9), 0.05, 1.0),
    ]
    # a unit icosphere asset, serialized to OBJ once and instanced twice
    unit = icosphere_mesh((0.0, 0.0, 0.0), 1.0, 0, 4)
    asset = obj_mod.dump_obj(unit)
    tris = obj_mod.parse_obj(asset, 0, scale=0.45,
                             translate=(-0.6, 0.0, -1.4))
    tris += obj_mod.parse_obj(asset, 2, scale=0.45,
                              translate=(0.6, 0.0, -1.4))
    if len(tris) > n_target_tris:
        raise ValueError(f"{len(tris)} triangles exceed {n_target_tris}")
    spheres = [((0.0, -100.5, -1.0), 100.0, 1)]
    # OBJ-loaded mesh: no reference-parity claim -> correct plane equation
    scene = build_scene(spheres, tris, build_materials(mats, device),
                        exact_planes=True)
    cam = Camera.new_at((0.0, 0.0, 0.0), 1.77778, device=device)
    return scene, cam
