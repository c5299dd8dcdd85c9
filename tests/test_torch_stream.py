"""K4's plain version (raytracer_tpu_torch.ops.cuda.wavefront_stream)
against the JAX package's streamed kernel in interpret mode, mirroring
tests/test_pallas_stream.py: equal segment counts and max|diff| <= 1e-4
with the median <= 1e-6 (the bar of the binned engine's tests; measured:
at most 1.2e-7 on these cases), on mesh_scene(2) and mesh_scene(3), in the
camera's order and in table order, whole and banded.  Port-only: bands are
bitwise the whole render's rows, the wrapper takes the plain version for
CPU tensors, K4's plain version equals K1's plain version on a mesh, and
``render_linear_fast`` routes banded mesh renders to it."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu.ops.pallas import wavefront as jwf
from raytracer_tpu.ops.pallas import wavefront_stream as jst
import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import ops
from raytracer_tpu_torch.ops import tables
from raytracer_tpu_torch.ops.cuda import wavefront as wfc
from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws

MAX_ERR, MEDIAN_ERR = 1e-4, 1e-6


def _port_args(scene, cam):
    st = [torch.from_numpy(t) for t in ws.build_tri_stream_tables(scene)]
    return (torch.from_numpy(tables.pack_spheres(scene)), *st,
            tables.camera_vec(cam))


def _orders(topb, origin):
    o, k = ws.sorted_top_order(np.asarray(topb), np.asarray(origin))
    return o, k


CASES = {
    # name: (subdivisions, W, H, spp, depth, camera order, band)
    "mesh2_64x48_ordered": (2, 64, 48, 2, 4, True, None),
    "mesh2_64x48_table_order": (2, 64, 48, 2, 3, False, None),
    "mesh2_band_rows_10_17": (2, 64, 48, 2, 4, True, (8, 10, 1)),
    "mesh2_rows_1_4_7": (2, 64, 48, 1, 3, True, (16, 1, 3)),
    "mesh3_32x24": (3, 32, 24, 1, 3, True, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_stream_interpret(case):
    sub, W, H, spp, depth, ordered, band = CASES[case]
    ts, tc = rtt.models.mesh_scene(sub)
    js, jc = rt.models.mesh_scene(sub)
    args = _port_args(ts, tc)
    jt = [jnp.asarray(t) for t in jst.build_tri_stream_tables(js)]
    kw = dict(width=W, height=H, samples_per_pixel=spp, depth=depth, seed=2)
    tkw, jkw = {}, {}
    if ordered:
        o, k = _orders(args[4], tc.origin)
        tkw = dict(top_order=torch.from_numpy(o), top_keys=torch.from_numpy(k))
        jkw = dict(top_order=jnp.asarray(o), top_keys=jnp.asarray(k))
    if band:
        rows, r0, stride = band
        kw.update(shard_rows=rows, row_offset=r0, row_stride=stride)
    got, segs = ws.render_linear_stream_ref(*args, **kw, **tkw)
    want, wsegs = jst.render_linear_pallas_stream(
        jnp.asarray(jwf.pack_spheres(js)), *jt, jwf.camera_vec(jc),
        interpret=True, **kw, **jkw)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    d = np.abs(got.numpy() - want)
    assert segs == int(wsegs)
    assert d.max() <= MAX_ERR and np.median(d) <= MEDIAN_ERR


@pytest.fixture(scope="module")
def mesh2():
    scene, cam = rtt.models.mesh_scene(2)
    args = _port_args(scene, cam)
    o, k = _orders(args[4], cam.origin)
    return scene, cam, args, dict(top_order=torch.from_numpy(o),
                                  top_keys=torch.from_numpy(k))


KW = dict(width=40, height=24, samples_per_pixel=2, depth=4, seed=7)


def test_bands_bitwise_match_whole_rows(mesh2):
    _, _, args, order = mesh2
    whole, wsegs = ws.render_linear_stream_ref(*args, **KW, **order)
    total = 0
    for r0 in range(0, KW["height"], 5):
        part, segs = ws.render_linear_stream_ref(
            *args, **KW, **order, shard_rows=5, row_offset=r0)
        rows = min(5, KW["height"] - r0)
        assert torch.equal(part[:rows], whole[r0:r0 + rows])
        assert not part[rows:].any()
        total += segs
    assert total == wsegs


def test_camera_order_and_table_order_agree(mesh2):
    _, _, args, order = mesh2
    a = ws.render_linear_stream_ref(*args, **KW, **order)
    b = ws.render_linear_stream_ref(*args, **KW)
    assert torch.equal(a[0], b[0]) and a[1] == b[1]


def test_equals_k1_plain_version_on_a_mesh(mesh2):
    scene, cam, args, order = mesh2
    k4 = ws.render_linear_stream_ref(*args, **KW, **order)
    k1 = wfc.render_linear_ref(
        torch.from_numpy(tables.pack_spheres(scene)),
        torch.from_numpy(tables.pack_triangles(scene)),
        tables.camera_vec(cam), parity_plane_sign=False, **KW)
    assert torch.equal(k4[0], k1[0]) and k4[1] == k1[1]


def test_cuda_wrapper_on_cpu_tensors_runs_plain_version(mesh2):
    _, _, args, order = mesh2
    before = ws.LAUNCHES
    got = ws.render_linear_stream_cuda(*args, **KW, **order)
    want = ws.render_linear_stream_ref(*args, **KW, **order)
    assert torch.equal(got[0], want[0]) and got[1] == want[1]
    assert ws.LAUNCHES == before


@pytest.mark.parametrize("bad", ["rows", "leaves", "order", "counts",
                                 "dtype", "shape"])
def test_bad_inputs_raise(mesh2, bad):
    _, _, args, order = mesh2
    args, kw = list(args), dict(KW, **order)
    if bad == "rows":
        args[1] = args[1][:21].contiguous()
    elif bad == "leaves":
        args[2] = args[2][:, :2].contiguous()
    elif bad == "order":
        kw["top_order"] = kw["top_order"] + 5
    elif bad == "counts":
        args[3] = args[3] + 200
    elif bad == "dtype":
        args[0] = args[0].double()
    else:
        kw["samples_per_pixel"] = 0
    with pytest.raises((TypeError, ValueError)):
        ws.render_linear_stream_ref(*args, **kw)


def test_banded_binned_render_goes_to_the_streamed_engine(monkeypatch):
    scene, cam = rtt.models.mesh_scene(2)
    calls = []
    real = ws.render_linear_stream_ref

    def spy(*a, **k):
        calls.append(k.get("row_offset"))
        return real(*a, **k)

    monkeypatch.setattr(ws, "render_linear_stream_ref", spy)
    shape = dict(width=24, height=20, samples_per_pixel=2, depth=3,
                 device="cpu", seed=1)
    progress = []
    banded, bsegs = ops.render_linear_fast(
        scene, cam, engine="torch_binned",
        progress=lambda r, h: progress.append(r), **shape)
    assert calls == list(range(0, 20, 2)) and progress[-1] == 20
    calls.clear()
    whole, segs = ops.render_linear_fast(scene, cam, engine="torch_stream",
                                         **shape)
    assert calls == [None]
    assert torch.equal(banded, whole) and bsegs == segs


def test_stream_tables_cached():
    scene, _ = rtt.models.mesh_scene(2)
    t1 = ops.scene_stream_tables(scene, "cpu")
    n = ops.pack_events
    t2 = ops.scene_stream_tables(scene, "cpu")
    assert ops.pack_events == n and t1[2] is t2[2]
