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
                                 "dtype", "shape", "sub_bounds", "fanout"])
def test_bad_inputs_raise(mesh2, bad):
    _, _, args, order = mesh2
    args, kw = list(args), dict(KW, **order)
    if bad == "sub_bounds":
        kw["sub_bounds"] = args[2].contiguous()     # one column a leaf
    elif bad == "fanout":                           # a top of 9 leaves
        scene, cam = rtt.models.obj_mesh_scene()
        args = list(_port_args(scene, cam))
        o, k = _orders(args[4], cam.origin)
        kw.update(top_order=torch.from_numpy(o), top_keys=torch.from_numpy(k))
        args[5] = args[5].clone()
        args[5][1, 0] = args[5][0, 0] + ws.TOP_FANOUT + 1
    elif bad == "rows":
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


def test_range_check_runs_again_after_an_in_place_change(mesh2):
    """The bands of a frame skip the index-range check of tables checked
    last; an in-place change to them is checked again."""
    _, _, args, order = mesh2
    args = [a.clone() for a in args]
    ws.render_linear_stream_ref(*args, **KW, **order, shard_rows=4)
    ws.render_linear_stream_ref(*args, **KW, **order, shard_rows=4,
                                row_offset=4)
    args[3] += 200                                   # leaf counts, in place
    with pytest.raises(ValueError):
        ws.render_linear_stream_ref(*args, **KW, **order, shard_rows=4)


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


# ---------------------------------------------------------------------------
# The redesigned kernel's host side: sub-leaf bounds, thread layout, sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mesh2", "mesh3", "obj10k"])
def test_sub_leaf_bounds(name):
    """Each leaf's 32-column sub-leaves: every valid triangle's vertices
    inside its sub-leaf's sphere (float32, the leaf bounds' slack), empty
    sub-leaves marked empty, the sub-leaves' columns summing to the leaf
    count; the JAX-equal tables unchanged by the extra output."""
    scene = (rtt.models.obj_mesh_scene()[0] if name == "obj10k"
             else rtt.models.mesh_scene(int(name[-1]))[0])
    plain = ws.build_tri_stream_tables(scene)
    *rest, subb = ws.build_tri_stream_tables(scene, sub_bounds=True)
    for a, b in zip(plain, rest):
        np.testing.assert_array_equal(a, b)
    leaf_counts = plain[2][0]
    assert subb.shape == (4, ws.SUBS * leaf_counts.shape[0])
    assert subb.dtype == np.float32
    h = scene.numpy()
    v = [np.asarray(a, np.float64) for a in (h.tri_v0, h.tri_v1, h.tri_v2)]
    verts = np.stack(v).astype(np.float32)
    vidx = np.nonzero(np.asarray(h.tri_valid))[0]
    cen = (v[0] + v[1] + v[2]) / 3.0       # the table build's split
    perm, slices = tables._median_split_order(cen[vidx], ws.LEAF)
    ids = vidx[perm]
    assert sum(e - s for s, e in slices) == len(vidx)
    for k, n in enumerate(leaf_counts):
        cols = [min(max(n - j * ws.SUB, 0), ws.SUB) for j in range(ws.SUBS)]
        assert sum(cols) == n
        s0 = slices[k][0] if slices else 0
        for j, c in enumerate(cols):
            b = subb[:, k * ws.SUBS + j]
            if c == 0:
                assert b[3] < 0.0
                continue
            assert b[3] > 0.0
            mem = ids[s0 + j * ws.SUB:s0 + j * ws.SUB + c]
            d = verts[:, mem, :] - b[None, None, 0:3]
            assert ((d * d).sum(-1) <= b[3]).all()


@pytest.mark.parametrize("spp", [1, 3, 16, 17, 64])
@pytest.mark.parametrize("width,rows", [(512, 18), (37, 18), (5, 3)])
def test_thread_layout_covers_each_pixel_sample_once(spp, width, rows):
    """K4's (pixel, sample) threads visit every sample of every pixel of a
    band exactly once (a ragged CLI band: 18 rows; widths off the tile),
    a warp's lanes of one pixel hold consecutive samples, and each chunk
    holds run samples."""
    lay = ws.thread_layout(width, rows, spp)
    row, col, sample, live = ws.layout_samples(width, rows, spp)
    assert lay.run * lay.tile_w * lay.tile_h == 32
    assert lay.blocks * ws.WARPS_PER_BLOCK >= lay.n_tiles
    hits = np.zeros((rows, width, spp), np.int64)
    np.add.at(hits, (row[live], col[live], sample[live]), 1)
    assert (hits == 1).all()
    lanes = np.arange(32).reshape(32 // lay.run, lay.run)
    for w in (0, lay.n_tiles - 1):
        for c in range(lay.chunks):
            for group in lanes:
                assert len({(row[w, c, g], col[w, c, g]) for g in group}) == 1
                assert (np.diff(sample[w, c, group]) == 1).all()


def test_thread_layout_fills_a_cli_band():
    lay = ws.thread_layout(512, 18, 16)
    assert lay.run == 16 and (lay.tile_w, lay.tile_h) == (2, 1)
    assert lay.n_tiles * 32 == 512 * 18 * 16 == 147456


@pytest.mark.parametrize("spp", [1, 3, 16, 17, 64])
def test_pixel_sum_is_k1_sample_order_sum(spp):
    """The kernel's sample-order pixel sum over its lanes, bitwise K1's
    plain acc = acc + c over samples 0 .. spp - 1."""
    width, rows = 13, 7
    r = np.random.default_rng(spp)
    v = r.uniform(0.0, 3.0, (rows, width, spp)).astype(np.float32)
    v[r.uniform(size=v.shape) < 0.2] = 0.0
    row, col, sample, live = ws.layout_samples(width, rows, spp)
    lanes = np.full(row.shape, np.nan, np.float32)   # dead lanes: never read
    lanes[live] = v[row[live], col[live], sample[live]]
    got = ws.pixel_sum_ref(torch.from_numpy(lanes), width, rows, spp)
    want = torch.zeros((rows, width), dtype=torch.float32)
    for s in range(spp):
        want = want + torch.from_numpy(v[:, :, s])
    assert torch.equal(got, want)
