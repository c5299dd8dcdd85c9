"""Scene model: structure-of-arrays tensor dataclasses.

Port of ``raytracer_tpu/scene.py``.  Primitive geometry lives in dense
tensors (one per field) with integer material ids into a material table;
``sphere_valid`` / ``tri_valid`` mark padding rows that never hit.  Every
tensor of a scene lies on one device, named by ``Scene.device`` and changed
only by ``Scene.to``.  ``Scene.numpy`` gives the host arrays the table
packers (``ops.tables``) read.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import maths

__all__ = ["DIFFUSE", "METAL", "DIELECTRIC", "EMISSION", "Materials",
           "Scene", "HostScene", "build_materials", "build_scene",
           "scene_from_arrays", "triangle_normals"]

# Material kind codes (materials.rs:7-12 enum order)
DIFFUSE, METAL, DIELECTRIC, EMISSION = 0, 1, 2, 3

_MAT_FIELDS = ("kind", "color", "fuzz", "ir")
_GEOM_FIELDS = ("sphere_center", "sphere_radius", "sphere_mat",
                "sphere_valid", "tri_v0", "tri_v1", "tri_v2", "tri_mat",
                "tri_valid")


@dataclasses.dataclass(frozen=True)
class Materials:
    """Material table, one row per named material (materials.rs:7-12)."""
    kind: torch.Tensor    # [M] int32 -- DIFFUSE/METAL/DIELECTRIC/EMISSION
    color: torch.Tensor   # [M, 3] f32 -- albedo / emission colour
    fuzz: torch.Tensor    # [M] f32 -- metal only
    ir: torch.Tensor      # [M] f32 -- dielectric only

    @property
    def count(self) -> int:
        return self.kind.shape[0]

    @property
    def device(self) -> torch.device:
        return self.kind.device

    def to(self, device) -> "Materials":
        return Materials(*(getattr(self, f).to(device)
                           for f in _MAT_FIELDS))


@dataclasses.dataclass(frozen=True)
class HostScene:
    """A scene's fields as numpy arrays (same names as ``Scene``)."""
    sphere_center: np.ndarray
    sphere_radius: np.ndarray
    sphere_mat: np.ndarray
    sphere_valid: np.ndarray
    tri_v0: np.ndarray
    tri_v1: np.ndarray
    tri_v2: np.ndarray
    tri_mat: np.ndarray
    tri_valid: np.ndarray
    mat_kind: np.ndarray
    mat_color: np.ndarray
    mat_fuzz: np.ndarray
    mat_ir: np.ndarray
    exact_planes: bool

    def numpy(self) -> "HostScene":
        return self


@dataclasses.dataclass(frozen=True)
class Scene:
    """Full world: spheres + triangles + material table (common.rs:227-230).

    ``exact_planes`` is True for scenes with no reference-parity claim
    (procedural meshes): engine dispatch then uses the correct triangle
    plane equation when ``parity_plane_sign=None``.
    """
    sphere_center: torch.Tensor   # [S, 3] f32
    sphere_radius: torch.Tensor   # [S] f32
    sphere_mat: torch.Tensor      # [S] int32
    sphere_valid: torch.Tensor    # [S] bool
    tri_v0: torch.Tensor          # [T, 3] f32
    tri_v1: torch.Tensor          # [T, 3] f32
    tri_v2: torch.Tensor          # [T, 3] f32
    tri_mat: torch.Tensor         # [T] int32
    tri_valid: torch.Tensor       # [T] bool
    materials: Materials
    exact_planes: bool = False

    @property
    def num_spheres(self) -> int:
        return self.sphere_center.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sphere_center.device

    def to(self, device) -> "Scene":
        return Scene(*(getattr(self, f).to(device) for f in _GEOM_FIELDS),
                     materials=self.materials.to(device),
                     exact_planes=self.exact_planes)

    def numpy(self) -> HostScene:
        """All fields on the host, for the table packers."""
        def h(t):
            return t.detach().cpu().numpy()
        m = self.materials
        return HostScene(*(h(getattr(self, f)) for f in _GEOM_FIELDS),
                         mat_kind=h(m.kind), mat_color=h(m.color),
                         mat_fuzz=h(m.fuzz), mat_ir=h(m.ir),
                         exact_planes=self.exact_planes)


def build_materials(rows: Sequence[Tuple[int, Sequence[float], float, float]],
                    device="cpu") -> Materials:
    """rows: (kind, rgb, fuzz, ir) per material."""
    if not rows:
        rows = [(DIFFUSE, (0.0, 0.0, 0.0), 0.0, 1.0)]
    kind = np.array([r[0] for r in rows], np.int32)
    color = np.array([r[1] for r in rows], np.float32).reshape(len(rows), 3)
    fuzz = np.array([r[2] for r in rows], np.float32)
    ir = np.array([r[3] for r in rows], np.float32)
    return Materials(*(torch.from_numpy(a).to(device)
                       for a in (kind, color, fuzz, ir)))


def build_scene(spheres, triangles, materials: Materials, *,
                pad_spheres_to: int | None = None,
                pad_triangles_to: int | None = None,
                exact_planes: bool = False, device=None) -> Scene:
    """Build a Scene from host-side primitive lists.

    spheres: (center, radius, material_index) triples (parser.rs:237-269).
    triangles: (v0, v1, v2, material_index) (parser.rs:272-310).
    Padding rows are marked invalid and never hit.  The scene lands on
    ``device`` (default: the materials' device).
    """
    device = materials.device if device is None else torch.device(device)
    ns, nt = len(spheres), len(triangles)
    ps = max(pad_spheres_to or ns, ns, 1)
    pt = max(pad_triangles_to or nt, nt, 1)

    sc = np.zeros((ps, 3), np.float32)
    sr = np.ones((ps,), np.float32)
    sm = np.zeros((ps,), np.int32)
    sv = np.zeros((ps,), bool)
    for i, (c, r, m) in enumerate(spheres):
        sc[i], sr[i], sm[i], sv[i] = c, r, m, True

    t0 = np.zeros((pt, 3), np.float32)
    t1 = np.zeros((pt, 3), np.float32)
    t2 = np.zeros((pt, 3), np.float32)
    tm = np.zeros((pt,), np.int32)
    tv = np.zeros((pt,), bool)
    for i, (v0, v1, v2, m) in enumerate(triangles):
        t0[i], t1[i], t2[i], tm[i], tv[i] = v0, v1, v2, m, True

    return Scene(*(torch.from_numpy(a).to(device)
                   for a in (sc, sr, sm, sv, t0, t1, t2, tm, tv)),
                 materials=materials.to(device), exact_planes=exact_planes)


def scene_from_arrays(arrays: Dict[str, np.ndarray], *, exact_planes: bool,
                      device) -> Scene:
    """A Scene from numpy arrays keyed by the JAX ``Scene``'s field names
    plus ``materials.kind`` / ``.color`` / ``.fuzz`` / ``.ir``."""
    def t(key, dtype):
        return torch.from_numpy(
            np.array(arrays[key], dtype, order="C")).to(device)
    geom_types = {"sphere_center": np.float32, "sphere_radius": np.float32,
                  "sphere_mat": np.int32, "sphere_valid": bool,
                  "tri_v0": np.float32, "tri_v1": np.float32,
                  "tri_v2": np.float32, "tri_mat": np.int32,
                  "tri_valid": bool}
    mats = Materials(t("materials.kind", np.int32),
                     t("materials.color", np.float32),
                     t("materials.fuzz", np.float32),
                     t("materials.ir", np.float32))
    return Scene(*(t(f, geom_types[f]) for f in _GEOM_FIELDS),
                 materials=mats, exact_planes=exact_planes)


def triangle_normals(scene: Scene) -> torch.Tensor:
    """Unit normal per triangle [T, 3], Triangle::new semantics
    (common.rs:116-123): a zero-area triangle keeps its zero normal."""
    n = maths.cross(scene.tri_v1 - scene.tri_v0, scene.tri_v2 - scene.tri_v0)
    ln = maths.safe_sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    return n / torch.where(ln == 0.0, torch.ones_like(ln), ln)
