"""The mesh engines' host tables in the port against the JAX package's:
the sorted tables (K3) and the streamed tables (K4) bit for bit, the
camera's top order bit for bit, the camera run bounds within 1e-6 (float32
norms in two frameworks) and the supertop AABBs bit for bit, on
mesh_scene(2), mesh_scene(3), obj_mesh_scene() and the bench's 164k-triangle
scene (the one scene past SUPER_MIN_TOPS tops)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu.ops.pallas import wavefront_sorted as jso
from raytracer_tpu.ops.pallas import wavefront_stream as jst
import raytracer_tpu_torch as rtt
from raytracer_tpu_torch.ops import tables
from raytracer_tpu_torch.ops.cuda import wavefront_binned as wb
from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws


def _big(mod):
    """bench.py:132-146: two subdivision-6 icospheres, 163,840 triangles."""
    from importlib import import_module
    b = import_module(f"{mod.__name__}.models.builders")
    s = import_module(f"{mod.__name__}.scene")
    tris = (b.icosphere_mesh((-0.6, 0.0, -1.4), 0.45, 0, 6)
            + b.icosphere_mesh((0.6, 0.0, -1.2), 0.45, 2, 6))
    mats = s.build_materials([(s.DIFFUSE, (0.7, 0.3, 0.3), 0.0, 1.0),
                              (s.DIFFUSE, (0.8, 0.8, 0.0), 0.0, 1.0),
                              (s.METAL, (0.85, 0.85, 0.9), 0.05, 1.0)])
    scene = s.build_scene([((0.0, -100.5, -1.0), 100.0, 1)], tris, mats,
                          exact_planes=True)
    return scene, mod.Camera.new_at((0.0, 0.0, 0.0), 1.77778)


SCENES = {
    "mesh_scene(2)": lambda m: m.models.mesh_scene(2),
    "mesh_scene(3)": lambda m: m.models.mesh_scene(3),
    "obj_mesh_scene": lambda m: m.models.obj_mesh_scene(),
    "164k": _big,
}


@pytest.fixture(scope="module")
def built():
    """name -> (port scene, port camera, JAX scene, JAX camera)."""
    return {name: (*make(rtt), *make(rt)) for name, make in SCENES.items()}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sorted_tables_bitwise(built, name):
    ts, _, js, _ = built[name]
    got = tables.build_tri_sorted_tables(ts)
    want = jso.build_tri_sorted_tables(js)
    assert len(got) == len(want) == 16
    for k, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


@pytest.mark.parametrize("name", sorted(SCENES))
def test_stream_tables_bitwise(built, name):
    ts, _, js, _ = built[name]
    got = ws.build_tri_stream_tables(ts)
    want = jst.build_tri_stream_tables(js)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


@pytest.mark.parametrize("name", sorted(SCENES))
def test_camera_order_run_and_super_bounds(built, name):
    ts, tc, js, jc = built[name]
    sorted_t = tables.build_tri_sorted_tables(ts)
    order, keys = ws.sorted_top_order(sorted_t[4], tc.origin.numpy())
    jorder, jkeys = jst.sorted_top_order(sorted_t[4], np.asarray(jc.origin))
    assert np.array_equal(order, jorder) and np.array_equal(keys, jkeys)

    topb = torch.from_numpy(sorted_t[4])
    got = wb.run_bounds(topb, torch.from_numpy(order)).numpy()
    want = np.asarray(jso._run_bounds_jnp(jnp.asarray(sorted_t[4]),
                                          jnp.asarray(order)))
    assert got.shape == want.shape == (4, -(-topb.shape[1] // tables.RUN))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    # the supertop boxes as render_linear_pallas_binned builds them
    top_aabb = jnp.asarray(sorted_t[15])
    n = top_aabb.shape[1]
    n_super = -(-n // wb.SUPER)
    pad = n_super * wb.SUPER - n
    top_p = jnp.pad(top_aabb, ((0, 0), (0, pad)))
    if pad:
        top_p = top_p + jnp.concatenate(
            [jnp.zeros((6, n), top_aabb.dtype),
             jnp.tile(jnp.asarray([[1.], [1.], [1.], [-1.], [-1.], [-1.]],
                                  top_aabb.dtype), (1, pad))], axis=1)
    want_super = jnp.concatenate(
        [top_p[0:3].reshape(3, n_super, wb.SUPER).min(axis=2),
         top_p[3:6].reshape(3, n_super, wb.SUPER).max(axis=2)], axis=0)
    supa, topap = wb.super_tables(torch.from_numpy(sorted_t[15]))
    assert np.array_equal(supa.numpy(), np.asarray(want_super))
    assert np.array_equal(topap.numpy(), np.asarray(top_p))


def test_table_sizes_of_the_bench_scenes(built):
    """Sub-leaves / groups / tops / reference points and leaves / tops."""
    sizes = {}
    for name, (ts, *_rest) in built.items():
        s = tables.build_tri_sorted_tables(ts)
        st = ws.build_tri_stream_tables(ts)
        sizes[name] = (s[1].shape[1], s[3].shape[1], s[4].shape[1],
                       s[7].shape[1], st[1].shape[1], st[3].shape[1])
    assert sizes == {"mesh_scene(2)": (32, 8, 1, 1, 4, 1),
                     "mesh_scene(3)": (64, 16, 2, 1, 16, 2),
                     "obj_mesh_scene": (512, 128, 16, 4, 128, 16),
                     "164k": (8192, 2048, 256, 64, 2048, 256)}
    assert sizes["164k"][2] >= wb.SUPER_MIN_TOPS > sizes["obj_mesh_scene"][2]


def test_tables_take_a_host_scene(built):
    ts, *_ = built["mesh_scene(2)"]
    a = tables.build_tri_sorted_tables(ts)
    b = tables.build_tri_sorted_tables(ts.numpy())
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert tables.TRI_ROWS_PAD == 24 and a[0].shape[0] == 24
