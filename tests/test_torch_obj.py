"""The port's OBJ loader (raytracer_tpu_torch.models.obj), obj_mesh_scene
and the CLI's ``obj=`` against the JAX package's: parsed triangles, dumps
and bounds equal, the same errors, the OBJ-10k scene's arrays equal, and
the CLI framebuffer of an OBJ file on the CPU within 1 LSB of the JAX
CLI's (a value within 1e-5 of a truncation boundary may round either
way)."""

import numpy as np
import pytest

from raytracer_tpu import cli as jcli
from raytracer_tpu import image as jimage
import raytracer_tpu as rt
from raytracer_tpu.models import obj as jobj
import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import cli, image
from raytracer_tpu_torch.models import obj

SOURCES = {
    "slash_syntax": ("# two triangles\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                     "f 1/1/1 2/2/2 3/3/3\nf 1 3 4\n"),
    "quad_fan": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n",
    "relative": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n",
    "extra_tags": ("mtllib a.mtl\no thing\ng grp\ns off\nusemtl m\nvt 0 0\n"
                   "vn 0 0 1\nv 0 0 0 1\nv 1 0 0\nv 0 1 0\nf 1 2 3\n"),
    "icosphere": None,
}


def _source(name):
    if SOURCES[name] is not None:
        return SOURCES[name]
    return jobj.dump_obj(rt.models.icosphere_mesh((0.0, 0.0, 0.0), 1.0, 0, 2))


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_parse_dump_bounds_match_jax(name):
    src = _source(name)
    kw = dict(scale=0.37, translate=(0.5, -0.25, -1.5))
    tris = obj.parse_obj(src, 3, **kw)
    assert tris == jobj.parse_obj(src, 3, **kw)
    assert obj.dump_obj(tris) == jobj.dump_obj(tris)
    for a, b in zip(obj.obj_bounds(tris), jobj.obj_bounds(tris)):
        assert np.array_equal(a, b)
    assert obj.parse_obj(obj.dump_obj(tris)) == jobj.parse_obj(
        jobj.dump_obj(tris))


@pytest.mark.parametrize("bad", ["v 1 2\n", "v a b c\n", "v 0 0 0\nf 1 2\n",
                                 "v 0 0 0\nf 1 2 9\n", "v 0 0 0\nf 1 x 1\n"])
def test_errors_match_jax(bad):
    with pytest.raises(obj.ObjError) as ours:
        obj.parse_obj(bad)
    with pytest.raises(jobj.ObjError) as theirs:
        jobj.parse_obj(bad)
    assert str(ours.value) == str(theirs.value)
    assert isinstance(ours.value, ValueError)


def test_load_obj_reads_a_file(tmp_path):
    path = tmp_path / "m.obj"
    path.write_text(_source("icosphere"))
    assert obj.load_obj(str(path), 1, scale=2.0) == jobj.load_obj(
        str(path), 1, scale=2.0)


def test_obj_mesh_scene_matches_jax():
    ts, tc = rtt.models.obj_mesh_scene()
    js, jc = rt.models.obj_mesh_scene()
    th, jh = ts.numpy(), js
    assert ts.num_triangles == 10240 and ts.exact_planes
    for f in ("sphere_center", "sphere_radius", "sphere_mat", "sphere_valid",
              "tri_v0", "tri_v1", "tri_v2", "tri_mat", "tri_valid"):
        assert np.array_equal(getattr(th, f), np.asarray(getattr(jh, f))), f
    for f in ("kind", "color", "fuzz", "ir"):
        assert np.array_equal(getattr(th, f"mat_{f}"),
                              np.asarray(getattr(jh.materials, f))), f
    for f in ("origin", "lower_left_corner", "horizontal", "vertical"):
        assert np.array_equal(getattr(tc, f).numpy(),
                              np.asarray(getattr(jc, f))), f
    with pytest.raises(ValueError):
        rtt.models.obj_mesh_scene(n_target_tris=100)


def test_cli_obj_matches_jax_cli(tmp_path, capsys):
    path = tmp_path / "sphere.obj"
    path.write_text(_source("icosphere"))
    args = ["width=32", "samples=2", "ray_depth=3", f"obj={path}"]
    ours, theirs = tmp_path / "port.ppm", tmp_path / "jax.ppm"
    assert cli.main(args + [f"out={ours}", "device=cpu"]) == 0
    assert jcli.main(args + [f"out={theirs}"]) == 0
    got, want = image.read_ppm(str(ours)), jimage.read_ppm(str(theirs))
    assert got.shape == want.shape == (17, 32, 4)
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1
    assert got[..., :3].std() > 1.0
    assert "ray segments" in capsys.readouterr().err


def test_cli_obj_scene_matches_jax(tmp_path):
    path = tmp_path / "sphere.obj"
    path.write_text(_source("icosphere"))
    ours, theirs = cli._obj_scene(str(path)).numpy(), jcli._obj_scene(
        str(path))
    assert ours.exact_planes and theirs.exact_planes
    for f in ("sphere_center", "sphere_radius", "tri_v0", "tri_v1", "tri_v2",
              "tri_mat"):
        assert np.array_equal(getattr(ours, f),
                              np.asarray(getattr(theirs, f))), f
