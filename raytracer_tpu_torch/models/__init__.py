"""Scene "model zoo": builders for the benchmark and test scenes and the
OBJ loader (port of ``raytracer_tpu/models``)."""

from . import obj
from .builders import (
    DEFAULT_WORLD_SOURCE,
    FFI_EXAMPLE_SOURCE,
    default_world,
    default_world_source,
    ffi_example_world,
    ffi_example_source,
    sphere_and_ground,
    random_spheres,
    cornell_spheres,
    cube_mesh,
    icosphere_mesh,
    mesh_scene,
    obj_mesh_scene,
)
from .obj import ObjError, dump_obj, load_obj, obj_bounds, parse_obj

__all__ = [
    "DEFAULT_WORLD_SOURCE", "FFI_EXAMPLE_SOURCE", "default_world",
    "default_world_source", "ffi_example_world", "ffi_example_source",
    "sphere_and_ground", "random_spheres", "cornell_spheres", "cube_mesh",
    "icosphere_mesh", "mesh_scene", "obj_mesh_scene", "obj", "ObjError",
    "parse_obj", "load_obj", "dump_obj", "obj_bounds",
]
