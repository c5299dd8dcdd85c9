"""The binned engine's plain version (raytracer_tpu_torch.ops.cuda.
wavefront_binned, every pass through binned_pass_ref) against the JAX
package's binned engine in interpret mode, mirroring
tests/test_pallas_binned.py.  Bar: equal segment counts and max|diff| <=
1e-4 with the median <= 1e-6 (the looser max allows XLA:CPU's multiply-add
contraction; measured here: at most 1.2e-7).  Then, bit for bit and
port-only: the supertop scan, node_exit and generous caps change nothing,
tiny caps raise the overflow guard, the binned image equals K1's plain
version's; ``render_linear_fast``'s probe, caps and overflow checks; and
the dispatch table, decided for a CUDA device without one."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu import ops as jops
from raytracer_tpu.ops.pallas import wavefront as jwf
from raytracer_tpu.ops.pallas import wavefront_binned as jbn
from raytracer_tpu.ops.pallas import wavefront_sorted as jso
from raytracer_tpu.ops.pallas.wavefront_stream import sorted_top_order
import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import api, ops
from raytracer_tpu_torch.ops import tables
from raytracer_tpu_torch.ops.cuda import wavefront as wfc
from raytracer_tpu_torch.ops.cuda import wavefront_binned as wb

MAX_ERR, MEDIAN_ERR = 1e-4, 1e-6


def _scenes(name):
    if name == "default_world":
        return (rtt.models.default_world().to_scene(),
                rtt.models.default_world().to_camera(),
                rt.models.default_world().to_scene(),
                rt.models.default_world().to_camera())
    sub = int(name[-1])
    return (*rtt.models.mesh_scene(sub), *rt.models.mesh_scene(sub))


def _port(scene, cam, **kw):
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in tables.build_tri_sorted_tables(scene)]
    o, k = sorted_top_order(t[4].numpy(), cam.origin.numpy())
    return wb.render_linear_binned(
        torch.from_numpy(tables.pack_spheres(scene)), *t,
        tables.camera_vec(cam), top_order=torch.from_numpy(o),
        top_keys=torch.from_numpy(k), plain=True, **kw)


def _jax(scene, cam, **kw):
    t = [jnp.asarray(a) for a in jso.build_tri_sorted_tables(scene)]
    o, k = sorted_top_order(np.asarray(t[4]), np.asarray(cam.origin))
    return jbn.render_linear_pallas_binned(
        jnp.asarray(jwf.pack_spheres(scene)), *t, jwf.camera_vec(cam),
        interpret=True, top_order=jnp.asarray(o), top_keys=jnp.asarray(k),
        ray_regroup_bounces=kw["depth"] - 1, **kw)


CASES = {
    # name: (scene, W, H, spp, depth, sample_offset)
    "mesh2_64x48_2spp_depth4": ("mesh_scene2", 64, 48, 2, 4, 0),
    "mesh3_32x24_2spp_depth3": ("mesh_scene3", 32, 24, 2, 3, 0),
    "mesh2_37x21_odd_depth1": ("mesh_scene2", 37, 21, 1, 1, 0),
    "sphere_only_24x16": ("default_world", 24, 16, 2, 3, 0),
    "part_2spp_offset0": ("mesh_scene2", 40, 24, 2, 3, 0),
    "part_1spp_offset2": ("mesh_scene2", 40, 24, 1, 3, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_binned_interpret(case):
    name, W, H, spp, depth, offset = CASES[case]
    ts, tc, js, jc = _scenes(name)
    kw = dict(width=W, height=H, samples_per_pixel=spp, depth=depth, seed=4,
              sample_offset=offset)
    got, segs = _port(ts, tc, **kw)
    want, wsegs = _jax(js, jc, **kw)
    want = np.asarray(want)
    assert got.shape == want.shape == (H, W, 3)
    d = np.abs(got.numpy() - want)
    assert segs == int(wsegs)
    assert d.max() <= MAX_ERR and np.median(d) <= MEDIAN_ERR


@pytest.fixture(scope="module")
def mesh2():
    scene, cam = rtt.models.mesh_scene(2)
    kw = dict(width=48, height=32, samples_per_pixel=2, depth=4, seed=6)
    return scene, cam, kw, _port(scene, cam, **kw)


@pytest.mark.parametrize("variant", [dict(super_selection=True),
                                     dict(super_selection=False),
                                     dict(node_exit=False)])
def test_selection_and_exit_variants_bitwise(mesh2, variant):
    scene, cam, kw, (ref, segs) = mesh2
    got, gsegs = _port(scene, cam, **kw, **variant)
    assert torch.equal(got, ref) and gsegs == segs


def test_generous_caps_bitwise_exact(mesh2):
    scene, cam, kw, (ref, segs) = mesh2
    got, gsegs, overflow = _port(scene, cam, **kw,
                                 bounce_caps=(10_000, 10_000, 10_000))
    assert overflow == 0
    assert torch.equal(got, ref) and gsegs == segs


def test_tiny_caps_raise_overflow_guard(mesh2):
    scene, cam, kw, _ = mesh2
    _, _, overflow = _port(scene, cam, **kw, bounce_caps=(32, 32, 32))
    assert isinstance(overflow, int) and overflow > 0


def test_live_counts_and_segments(mesh2):
    scene, cam, kw, (ref, segs) = mesh2
    _, asegs, alive = _port(scene, cam, **kw, return_alive=True)
    assert asegs == segs == sum(alive) and len(alive) == kw["depth"]
    assert alive[0] == 48 * 32 * 2 and alive[1] > 0


def test_equals_k1_plain_version(mesh2):
    scene, cam, kw, (ref, segs) = mesh2
    k1, k1segs = wfc.render_linear_ref(
        torch.from_numpy(tables.pack_spheres(scene)),
        torch.from_numpy(tables.pack_triangles(scene)),
        tables.camera_vec(cam), parity_plane_sign=False, **kw)
    assert torch.equal(k1, ref) and k1segs == segs


def test_pass_wrapper_on_cpu_tensors_runs_plain_version(mesh2):
    scene, cam, kw, (ref, segs) = mesh2
    before = wb.LAUNCHES
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in tables.build_tri_sorted_tables(scene)]
    got = wb.render_linear_binned(
        torch.from_numpy(tables.pack_spheres(scene)), *t,
        tables.camera_vec(cam), **kw)
    assert wb.LAUNCHES == before
    assert torch.equal(got[0], ref) and got[1] == segs


def test_tile_geometry_gates_and_matches_jax():
    for args in ((64, 48, 2), (37, 21, 1), (512, 512, 4), (512, 288, 32)):
        assert wb.tile_geometry(*args) == jbn.tile_geometry(*args, 16)
    for bad in ((64, 48, 3), (64, 48, 256), (1024, 1024, 32)):
        with pytest.raises(ValueError):
            wb.tile_geometry(*bad)


def test_spp_gate_and_parts_match_jax():
    for spp in (None, 0, 1, 3, 4, 50, 64, 100, 128, 129, 256):
        assert ops.binned_spp_ok(spp) == jops.binned_spp_ok(spp)
        for w, h in ((512, 512), (1024, 1024), (64, 36)):
            assert ops.binned_spp_ok(spp, w, h) == \
                jops.binned_spp_ok(spp, w, h), (spp, w, h)
    for spp in (1, 3, 50, 100, 127, 128):
        assert ops._binned_spp_parts(spp) == jops._binned_spp_parts(spp)
    assert ops.BINNED_MIN_TRIS == jops.BINNED_MIN_TRIS


def _big_scene():
    from raytracer_tpu_torch.models.builders import icosphere_mesh
    from raytracer_tpu_torch.scene import DIFFUSE, build_materials, \
        build_scene
    tris = (icosphere_mesh((-0.6, 0.0, -1.4), 0.45, 0, 6)
            + icosphere_mesh((0.6, 0.0, -1.2), 0.45, 0, 6))
    return build_scene([((0.0, -100.5, -1.0), 100.0, 0)], tris,
                       build_materials([(DIFFUSE, (0.7, 0.3, 0.3), 0.0,
                                         1.0)]), exact_planes=True)


def test_dispatch_on_a_cuda_device():
    """Decided for device="cuda" without a GPU: nothing is rendered."""
    shape = dict(samples_per_pixel=4, width=512, height=512)
    meshes = [rtt.models.mesh_scene(3)[0], rtt.models.obj_mesh_scene()[0],
              _big_scene()]
    for scene in meshes:
        assert ops.resolve_dispatch(scene, None, "auto", "cuda", **shape) \
            == ("cuda_binned", False)
        # past 128 spp: the sorted engine from SORTED_MIN_TRIS triangles,
        # K1 under it (mesh_scene(3): 1292)
        past = ("cuda" if int(scene.tri_valid.sum()) < ops.SORTED_MIN_TRIS
                else "cuda_sorted")
        assert ops.resolve_dispatch(
            scene, None, "auto", "cuda", **dict(shape, samples_per_pixel=256)
        ) == (past, False)
        assert ops.resolve_dispatch(scene, True, "auto", "cuda", **shape) \
            == ("cuda", True)
        assert ops.resolve_dispatch(scene, None, "auto", "cpu", **shape) \
            == ("torch", False)
    assert [int(s.tri_valid.sum()) >= ops.SORTED_MIN_TRIS
            for s in meshes] == [False, True, True]
    small = rtt.models.mesh_scene(2)[0]
    ffi = rtt.models.ffi_example_world().to_scene()
    for scene in (small, ffi):
        assert ops.resolve_dispatch(scene, None, "auto", "cuda",
                                    **shape)[0] == "cuda"
    for engine in ("cuda_binned", "cuda_stream"):
        with pytest.raises(ValueError, match="CUDA device"):
            ops.resolve_dispatch(small, None, engine, "cpu")
    with pytest.raises(ValueError, match="parity_plane_sign"):
        ops.render_linear_fast(small, rtt.models.mesh_scene(2)[1], width=8,
                               height=8, samples_per_pixel=1, depth=1,
                               device="cpu", engine="torch_binned",
                               parity_plane_sign=True)
    session = api.RenderSession.from_world(
        meshes[1], rtt.models.obj_mesh_scene()[1], 512, 288,
        rtt.Options(samples_per_pixel=4, max_ray_bounces=4), device="cuda")
    assert session.resolved_engine() == "cuda_binned"


def test_render_linear_fast_probe_caps_and_overflow(monkeypatch):
    scene, cam = rtt.models.mesh_scene(2)
    ops.flush_binned_overflow_checks()
    ops._BINNED_CAPS.clear()
    shape = dict(width=32, height=24, samples_per_pixel=2, depth=3,
                 device="cpu", engine="torch_binned")
    calls = []
    real = wb.render_linear_binned

    def spy(*a, **k):
        calls.append(k.get("bounce_caps"))
        return real(*a, **k)

    monkeypatch.setattr(wb, "render_linear_binned", spy)
    probe, psegs = ops.render_linear_fast(scene, cam, seed=1, **shape)
    capped, csegs = ops.render_linear_fast(scene, cam, seed=1, **shape)
    assert calls[0] is None and calls[1] is not None
    assert all(c % wb.WARP == 0 for c in calls[1])
    assert torch.equal(probe, capped) and psegs == csegs
    assert ops.flush_binned_overflow_checks() == 0
    # a moved camera renders a new probe
    ops.render_linear_fast(scene, cam.moved_by((0.0, 0.1, 0.0)), seed=1,
                           **shape)
    assert calls[2] is None
    # 3 spp renders as parts 2 + 1 on the global sample index
    whole, segs = ops.render_linear_fast(
        scene, cam, seed=1, **dict(shape, samples_per_pixel=3))
    k1, k1segs = ops.render_linear_fast(
        scene, cam, seed=1, **dict(shape, samples_per_pixel=3,
                                   engine="torch"))
    assert segs == k1segs
    assert float((whole - k1).abs().max()) <= 1e-6


def test_overflow_trips_warning_and_rerender(monkeypatch):
    scene, cam = rtt.models.mesh_scene(2)
    ops.flush_binned_overflow_checks()
    ops._BINNED_CAPS.clear()
    shape = dict(width=32, height=24, samples_per_pixel=2, depth=3,
                 device="cpu", engine="torch_binned", seed=2)
    want, wsegs = ops.render_linear_fast(scene, cam, **shape)   # the probe
    for key in ops._BINNED_CAPS:
        ops._BINNED_CAPS[key] = (ops._BINNED_CAPS[key][0], (32, 32))
    with pytest.warns(UserWarning, match="overflowed"):
        got, segs = ops.render_linear_fast(scene, cam, **shape)
    assert torch.equal(got, want) and segs == wsegs
    assert not ops._BINNED_CAPS
    assert ops.flush_binned_overflow_checks() == 1
    assert ops.flush_binned_overflow_checks() == 0


@pytest.mark.parametrize("bad", ["order", "sub_counts", "dtype"])
def test_bad_inputs_raise(mesh2, bad):
    scene, cam, kw, _ = mesh2
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in tables.build_tri_sorted_tables(scene)]
    o, k = sorted_top_order(t[4].numpy(), cam.origin.numpy())
    extra = dict(top_order=torch.from_numpy(o), top_keys=torch.from_numpy(k))
    if bad == "order":
        extra["top_order"] = extra["top_order"] + 1
    elif bad == "sub_counts":
        t[2] = t[2] + 40
    else:
        t[0] = t[0].double()
    with pytest.raises((TypeError, ValueError)):
        wb.render_linear_binned(torch.from_numpy(tables.pack_spheres(scene)),
                                *t, tables.camera_vec(cam), **kw, **extra)
