"""Wavefront OBJ mesh loading (port of ``raytracer_tpu/models/obj.py``).

The reference has no mesh file format -- its triangles come from the scene
DSL (``parser.rs:272-310``) or inline FFI sources.  OBJ is the bulk-geometry
on-ramp: ``load_obj`` returns triangle vertex lists ready for
``scene.build_scene``, with polygon faces fan-triangulated.  Plain Python,
so the triangles equal the JAX package's exactly.

Supported subset (sufficient for low-poly assets):
  * ``v x y z``           -- vertex positions (extra components ignored)
  * ``f i j k [l ...]``   -- faces; 1-based, negative (relative) indices,
                             and ``v/vt/vn`` slash syntax all accepted
  * everything else (vt/vn/usemtl/o/g/s/mtllib, comments) is skipped

All triangles take a single material id (the DSL's named-material binding
has no OBJ equivalent); pass distinct ids per call to mix materials.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["ObjError", "parse_obj", "load_obj", "dump_obj", "obj_bounds"]

Tri = Tuple[Tuple[float, float, float], Tuple[float, float, float],
            Tuple[float, float, float], int]


class ObjError(ValueError):
    """Malformed OBJ content (bad vertex/face syntax, index out of range)."""


def parse_obj(source: str, material: int = 0, *,
              scale: float = 1.0,
              translate: Sequence[float] = (0.0, 0.0, 0.0)) -> List[Tri]:
    """Parse OBJ text into ``[(v0, v1, v2, material), ...]`` triangles.

    ``scale`` then ``translate`` are applied to every vertex (uniform scale
    about the origin), so one asset can be instanced at several positions
    and sizes.
    """
    tx, ty, tz = (float(t) for t in translate)
    s = float(scale)
    verts: List[Tuple[float, float, float]] = []
    tris: List[Tri] = []
    for lineno, raw in enumerate(source.splitlines(), start=1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            if len(parts) < 4:
                raise ObjError(f"line {lineno}: vertex needs 3 coordinates")
            try:
                x, y, z = (float(p) for p in parts[1:4])
            except ValueError as e:
                raise ObjError(f"line {lineno}: bad vertex number") from e
            verts.append((x * s + tx, y * s + ty, z * s + tz))
        elif tag == "f":
            if len(parts) < 4:
                raise ObjError(f"line {lineno}: face needs >=3 vertices")
            idx = []
            for p in parts[1:]:
                head = p.split("/", 1)[0]
                try:
                    i = int(head)
                except ValueError as e:
                    raise ObjError(f"line {lineno}: bad face index {p!r}") \
                        from e
                if i < 0:                       # relative (from end)
                    i = len(verts) + i
                else:
                    i = i - 1                   # OBJ is 1-based
                if not 0 <= i < len(verts):
                    raise ObjError(
                        f"line {lineno}: face index {p!r} out of range")
                idx.append(i)
            v0 = verts[idx[0]]
            for a, b in zip(idx[1:-1], idx[2:]):   # fan triangulation
                tris.append((v0, verts[a], verts[b], material))
    return tris


def load_obj(path: str, material: int = 0, *, scale: float = 1.0,
             translate: Sequence[float] = (0.0, 0.0, 0.0)) -> List[Tri]:
    """``parse_obj`` over a file path."""
    with open(path, "r", encoding="utf-8") as f:
        return parse_obj(f.read(), material, scale=scale,
                         translate=translate)


def dump_obj(tris: Sequence[Tri]) -> str:
    """Serialize triangles back to OBJ text (deduplicated vertices).

    Inverse of ``parse_obj`` up to vertex ordering; used to round-trip
    procedural meshes (icospheres, cubes) into standalone assets.
    """
    vid = {}
    verts: List[Tuple[float, float, float]] = []
    faces = []
    for v0, v1, v2, _mat in tris:
        face = []
        for v in (v0, v1, v2):
            key = (float(v[0]), float(v[1]), float(v[2]))
            if key not in vid:
                vid[key] = len(verts)
                verts.append(key)
            face.append(vid[key] + 1)
        faces.append(face)
    out = ["# raytracer_tpu mesh"]
    out += [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in verts]
    out += [f"f {a} {b} {c}" for a, b, c in faces]
    return "\n".join(out) + "\n"


def obj_bounds(tris: Sequence[Tri]) -> Tuple[np.ndarray, np.ndarray]:
    """(min_xyz, max_xyz) over all triangle vertices."""
    vs = np.asarray([v for t in tris for v in t[:3]], np.float64)
    return vs.min(axis=0), vs.max(axis=0)
