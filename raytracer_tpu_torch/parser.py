"""Scene-DSL parser (port of ``raytracer_tpu/parser.py``).

The JAX package's parser cannot be imported without JAX (its package
``__init__`` imports JAX), so this is a copy; tests hold the two to the same
fields and the same ``ParseError`` kinds.

Re-derivation of the reference's hand-rolled zero-copy recursive-descent
parser (``/root/reference/raytracer/src/parser.rs``), preserving its grammar
(parser.rs:326-335) and its quirks:

  program  :  <camera> (<material>)* (<sphere>)* (<triangle>)*     (strict order)
  camera   :  camera origin <f32> <f32> <f32> aspect <f32> ;
  material :  material <name> : <type> ;
  type     :  <diffuse> | <metal> | <dielectric> | <emission>*
  diffuse  :  Diffuse color <f32> <f32> <f32>
  metal    :  Metal color <f32> <f32> <f32> fuzz <f32>
  dielectric : Dielectric ir <f32>
  emission :  Emission color <f32> <f32> <f32>          (*extension: the
              reference's material enum has Emission, materials.rs:11, but its
              grammar omits it, parser.rs:175-234 — added here)
  sphere   :  sphere center <f32> <f32> <f32> radius <f32> material <name> ;
  triangle :  triangle v0 ... v1 ... v2 ... material <name> ;

Quirks preserved: ``//`` line comments only at the statement boundaries the
reference skips them (parser.rs:342,353-358,362-367,370-375); floats are
``-?digits[.digits]`` with no exponent and need >= 3 chars of remaining input
(parser.rs:107-133); ints are unsigned digit runs (parser.rs:90-104);
identifiers are ``[A-Za-z0-9_]+`` (parser.rs:59-62); the camera production
builds a ``new_at`` camera (parser.rs:162); unknown trailing input is a syntax
error (parser.rs:377-378).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import scene as scene_mod
from .camera import Camera
from .oracle import OCamera, OMaterial, OSphere, OTriangle, OWorld
from .scene import DIFFUSE, METAL, DIELECTRIC, EMISSION, Scene


class ParseError(Exception):
    """parser.rs:10-18 error enum, collapsed to one exception with a kind."""

    def __init__(self, kind: str, detail: str = ""):
        self.kind = kind
        super().__init__(f"{kind}{': ' + detail if detail else ''}")


COULDNT_OPEN_FILE = "CouldntOpenFile"
MISSING_CAMERA = "MissingCamera"
WRONG_SYNTAX = "WrongSyntax"
DIDNT_START_WITH = "DidntStartWith"
NOT_A_I32 = "NotAI32"
NOT_A_F32 = "NotAF32"


# --- combinators (parser.rs:54-142) ---------------------------------------

def skip_whitespace(source: str) -> str:
    i = 0
    while i < len(source) and source[i].isspace():
        i += 1
    return source[i:]


def get_identifier(source: str) -> Tuple[str, str]:
    """parser.rs:59-62 — returns (rest, identifier)."""
    i = 0
    while i < len(source) and (source[i].isalnum() or source[i] == "_"):
        i += 1
    return source[i:], source[:i]


def find(source: str, target: str) -> str:
    """parser.rs:65-77 — source from the start of the first match."""
    idx = source.find(target)
    if idx < 0:
        raise ParseError(DIDNT_START_WITH, f"no {target!r}")
    return source[idx:]


def starts_with(source: str, target: str) -> str:
    """parser.rs:81-88 — source after the prefix, or raise."""
    if source.startswith(target):
        return source[len(target):]
    raise ParseError(DIDNT_START_WITH, target)


def parse_int(source: str) -> Tuple[str, int]:
    """parser.rs:90-104 — unsigned digit run."""
    i = 0
    while i < len(source) and source[i].isdigit():
        i += 1
    try:
        value = int(source[:i])
    except ValueError:
        raise ParseError(NOT_A_I32, source[:8])
    return source[i:], value


def parse_float(source: str) -> Tuple[str, float]:
    """parser.rs:107-133 — ``-?digits[.digits]``, no exponent; requires at
    least 3 chars of remaining input (a reference quirk, parser.rs:112-114)."""
    if len(source) < 3:
        raise ParseError(NOT_A_F32, source)
    i = 0
    if source[0] == "-":
        i = 1
    found_dot = False
    while i < len(source):
        c = source[i]
        if c.isdigit():
            i += 1
        elif c == ".":
            if found_dot:
                raise ParseError(NOT_A_F32, source[:8])
            found_dot = True
            i += 1
        else:
            break
    try:
        value = float(source[:i])
    except ValueError:
        raise ParseError(NOT_A_F32, source[:8])
    return source[i:], value


def parse_vec3(source: str) -> Tuple[str, Tuple[float, float, float]]:
    """parser.rs:135-142."""
    source, x = parse_float(source)
    source = skip_whitespace(source)
    source, y = parse_float(source)
    source = skip_whitespace(source)
    source, z = parse_float(source)
    return source, (x, y, z)


def skip_comment(source: str) -> str:
    """parser.rs:313-323 — ``//`` to end of line, repeatable."""
    while source.startswith("//"):
        rest = source[2:]
        idx = rest.find("\n")
        if idx < 0:
            raise ParseError(WRONG_SYNTAX, "comment without newline")
        source = rest[idx + 1:]
    return source


# --- productions ----------------------------------------------------------

@dataclasses.dataclass
class ParsedMaterial:
    kind: int
    color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    fuzz: float = 0.0
    ir: float = 1.0


@dataclasses.dataclass
class ParsedWorld:
    """Host-side parse result; convert with .to_scene() / .to_camera(), or
    .to_oracle() for the golden oracle."""
    camera_origin: Tuple[float, float, float]
    camera_aspect: float
    materials: List[ParsedMaterial]
    material_names: Dict[str, int]
    spheres: List[Tuple[Tuple[float, float, float], float, int]]
    triangles: List[Tuple[Tuple[float, float, float], Tuple[float, float, float],
                          Tuple[float, float, float], int]]

    def to_scene(self, device="cpu", **pad_kwargs) -> Scene:
        mats = scene_mod.build_materials(
            [(m.kind, m.color, m.fuzz, m.ir) for m in self.materials],
            device=device)
        return scene_mod.build_scene(self.spheres, self.triangles, mats,
                                     **pad_kwargs)

    def to_camera(self, device="cpu") -> Camera:
        """The DSL camera production is a new_at camera (parser.rs:162)."""
        return Camera.new_at(self.camera_origin, self.camera_aspect,
                             device=device)

    def to_oracle(self) -> Tuple[OCamera, OWorld]:
        """The oracle's camera and world (``oracle.ray_trace(world,
        camera, ...)`` takes them in the other order)."""
        omats = [OMaterial(kind=m.kind, color=np.array(m.color, np.float32),
                           fuzz=m.fuzz, ir=m.ir)
                 for m in self.materials]
        ospheres = [OSphere(np.array(c, np.float32), r, omats[m])
                    for (c, r, m) in self.spheres]
        otris = [OTriangle(np.array(v0, np.float32), np.array(v1, np.float32),
                           np.array(v2, np.float32), omats[m])
                 for (v0, v1, v2, m) in self.triangles]
        return (OCamera.new_at(np.array(self.camera_origin, np.float32),
                               self.camera_aspect),
                OWorld(ospheres, otris))


def parse_camera(source: str) -> Optional[Tuple[str, Tuple[float, float, float], float]]:
    """parser.rs:145-167 — ``camera origin x y z aspect a ;``."""
    try:
        source = starts_with(source, "camera")
    except ParseError:
        return None
    source = skip_whitespace(source)
    source = starts_with(source, "origin")
    source = skip_whitespace(source)
    source, origin = parse_vec3(source)
    source = skip_whitespace(source)
    source = starts_with(source, "aspect")
    source = skip_whitespace(source)
    source, aspect = parse_float(source)
    source = skip_whitespace(source)
    source = starts_with(source, ";")
    return source, origin, aspect


def parse_material(source: str) -> Optional[Tuple[str, str, ParsedMaterial]]:
    """parser.rs:175-234 (+ Emission extension)."""
    try:
        source = starts_with(source, "material")
    except ParseError:
        return None
    source = skip_whitespace(source)
    source, name = get_identifier(source)
    source = skip_whitespace(source)
    source = starts_with(source, ":")
    source = skip_whitespace(source)

    for keyword, kind in (("Diffuse", DIFFUSE), ("Emission", EMISSION)):
        try:
            rest = starts_with(source, keyword)
        except ParseError:
            continue
        rest = skip_whitespace(rest)
        rest = starts_with(rest, "color")
        rest = skip_whitespace(rest)
        rest, c = parse_vec3(rest)
        rest = skip_whitespace(rest)
        rest = starts_with(rest, ";")
        return rest, name, ParsedMaterial(kind=kind, color=c)

    try:
        rest = starts_with(source, "Metal")
    except ParseError:
        rest = None
    if rest is not None:
        rest = skip_whitespace(rest)
        rest = starts_with(rest, "color")
        rest = skip_whitespace(rest)
        rest, c = parse_vec3(rest)
        rest = skip_whitespace(rest)
        rest = starts_with(rest, "fuzz")
        rest = skip_whitespace(rest)
        rest, fz = parse_float(rest)
        rest = skip_whitespace(rest)
        rest = starts_with(rest, ";")
        return rest, name, ParsedMaterial(kind=METAL, color=c, fuzz=fz)

    try:
        rest = starts_with(source, "Dielectric")
    except ParseError:
        rest = None
    if rest is not None:
        rest = skip_whitespace(rest)
        rest = starts_with(rest, "ir")
        rest = skip_whitespace(rest)
        rest, ir = parse_float(rest)
        rest = skip_whitespace(rest)
        rest = starts_with(rest, ";")
        return rest, name, ParsedMaterial(kind=DIELECTRIC, ir=ir)

    raise ParseError(WRONG_SYNTAX, "unknown material type")


def parse_sphere(source: str, materials: Dict[str, int]):
    """parser.rs:237-269."""
    try:
        source = starts_with(source, "sphere")
    except ParseError:
        return None
    source = skip_whitespace(source)
    source = starts_with(source, "center")
    source = skip_whitespace(source)
    source, c = parse_vec3(source)
    source = skip_whitespace(source)
    source = starts_with(source, "radius")
    source = skip_whitespace(source)
    source, r = parse_float(source)
    source = skip_whitespace(source)
    source = starts_with(source, "material")
    source = skip_whitespace(source)
    source, name = get_identifier(source)
    source = skip_whitespace(source)
    source = starts_with(source, ";")
    if name not in materials:
        raise ParseError(WRONG_SYNTAX, f"unknown material {name!r}")
    return source, (c, r, materials[name])


def parse_triangle(source: str, materials: Dict[str, int]):
    """parser.rs:272-310."""
    try:
        source = starts_with(source, "triangle")
    except ParseError:
        return None
    verts = []
    for label in ("v0", "v1", "v2"):
        source = skip_whitespace(source)
        source = starts_with(source, label)
        source = skip_whitespace(source)
        source, v = parse_vec3(source)
        verts.append(v)
    source = skip_whitespace(source)
    source = starts_with(source, "material")
    source = skip_whitespace(source)
    source, name = get_identifier(source)
    source = skip_whitespace(source)
    source = starts_with(source, ";")
    if name not in materials:
        raise ParseError(WRONG_SYNTAX, f"unknown material {name!r}")
    return source, (verts[0], verts[1], verts[2], materials[name])


def parse_input(source: str) -> ParsedWorld:
    """parser.rs:336-382 — strict section order camera -> materials ->
    spheres -> triangles; trailing garbage is a syntax error."""
    # Null-terminated sources (the FFI path, lib.rs:38-40, and the C example's
    # explicit trailing \x00, examples/c_raytracer.rs:44) end at the NUL.
    nul = source.find("\x00")
    if nul >= 0:
        source = source[:nul]

    materials: List[ParsedMaterial] = []
    names: Dict[str, int] = {}
    spheres = []
    triangles = []

    source = skip_comment(source)
    cam = parse_camera(source)
    if cam is None:
        raise ParseError(MISSING_CAMERA)
    source, cam_origin, cam_aspect = cam
    source = skip_whitespace(source)

    source = skip_comment(source)
    while True:
        result = parse_material(source)
        if result is None:
            break
        source, name, mat = result
        names[name] = len(materials)
        materials.append(mat)
        source = skip_whitespace(source)
        source = skip_comment(source)

    while True:
        result = parse_sphere(source, names)
        if result is None:
            break
        source, sph = result
        spheres.append(sph)
        source = skip_whitespace(source)
        source = skip_comment(source)

    while True:
        result = parse_triangle(source, names)
        if result is None:
            break
        source, tri = result
        triangles.append(tri)
        source = skip_whitespace(source)
        source = skip_comment(source)

    if source:
        raise ParseError(WRONG_SYNTAX, source[:32])

    return ParsedWorld(cam_origin, cam_aspect, materials, names,
                       spheres, triangles)


def parse_world(path: str) -> ParsedWorld:
    """parser.rs:47-52, minus its hardcoded absolute path: reads the scene
    file at ``path`` and parses it."""
    try:
        with open(path, "r") as f:
            source = f.read()
    except OSError:
        raise ParseError(COULDNT_OPEN_FILE, path)
    return parse_input(source)
