"""C-ABI drift check of the port's own ctypes bindings, a twin of
``tests/test_abi.py``: every struct layout and ``rt_*`` signature that
``raytracer_tpu_torch/native.py`` declares must match
``native/raytracer_tpu.h``, the single source of truth.  The header parser
is ``tests/test_abi.py``'s own (its helper functions compiled from that
file's source with the port's structs in scope, so the JAX package's
bindings are not the ones checked)."""

import ast
import ctypes
import re
from pathlib import Path

import pytest

from raytracer_tpu_torch import native

ROOT = Path(__file__).resolve().parents[1]
HEADER = ROOT / "native" / "raytracer_tpu.h"
STRUCTS = {
    "RtColorU8": native.RtColorU8,
    "RtFramebuffer": native.RtFramebuffer,
    "RtRenderOptions": native.RtRenderOptions,
}


def _parser():
    path = ROOT / "tests" / "test_abi.py"
    tree = ast.parse(path.read_text())
    names = ("SCALAR", "_strip_comments", "_ctype_for", "_parse_functions",
             "_parse_struct_fields", "_same_type")
    body = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name in names)
            or (isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) in names)]
    ns = {"ctypes": ctypes, "re": re, "STRUCTS": STRUCTS}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"),
         ns)
    return ns


P = _parser()


@pytest.fixture(scope="module")
def header_src():
    return P["_strip_comments"](HEADER.read_text())


@pytest.mark.parametrize("name", sorted(STRUCTS))
def test_struct_fields_match_header(header_src, name):
    declared = P["_parse_struct_fields"](header_src, name)
    assert list(STRUCTS[name]._fields_) == declared


def test_every_header_function_is_bound(header_src):
    assert sorted(P["_parse_functions"](header_src)) == [
        "rt_camera_position", "rt_destroy_world", "rt_last_error",
        "rt_load_world", "rt_load_world_n", "rt_move_camera_position",
        "rt_render", "rt_version", "rt_write_ppm"]


def test_ctypes_bindings_match_header(header_src):
    try:
        lib = native.load_library()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    same = P["_same_type"]
    for name, (ret, argtypes) in P["_parse_functions"](header_src).items():
        fn = getattr(lib, name)
        if ret is None:
            assert fn.restype is None, name
        else:
            assert same(fn.restype, ret), (name, fn.restype, ret)
        bound = list(fn.argtypes or [])
        assert len(bound) == len(argtypes), name
        for i, (b, h) in enumerate(zip(bound, argtypes)):
            assert same(b, h), f"{name} arg {i}: bound {b} != header {h}"
