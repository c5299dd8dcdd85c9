"""The host side of K1's and K5's (pixel, sample) thread layout and triangle
walk at the main path's shapes: the headline frame (512x512, 64 spp:
runs of 16, 4 chunks a thread), a CLI band (512 wide, 18 rows from row 270
of 287, 64 spp), the gradient passes (256x256, 8 spp: the default world's
and OBJ-10k's) and a ragged band (row_stride > 1, a spp off the run).
Every (pixel, sample) is traced once, the image's sample-order sum across
a pixel's lanes is bitwise the per-pixel loop's (acc = acc + c over samples
0 .. spp - 1 from 0.0), and the launch arguments the wrappers pass (the
layout, the walk and the chunk count of the one-level leaves) are the
ones the tables call for.  The kernels run only on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import ops
from raytracer_tpu_torch.ops import diff
from raytracer_tpu_torch.ops.cuda import wavefront as wf
from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws

# (width, height, spp, shard_rows, row_offset, row_stride)
SHAPES = {"headline 512x512 64spp": (512, 512, 64, 512, 0, 1),
          "CLI band 18 rows from 270 of 287, 64spp": (512, 287, 64, 18, 270,
                                                      1),
          "gradient pass 256x256 8spp": (256, 256, 8, 256, 0, 1),
          "band 23 rows, stride 9, 20spp": (200, 200, 20, 23, 5, 9)}
# tiles handled at once: keeps each check's arrays near 8M lanes
TILE_STEP = 1 << 16


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_layout_covers_each_pixel_sample_once(name):
    width, height, spp, rows, r0, stride = SHAPES[name]
    lay = ws.thread_layout(width, rows, spp)
    assert lay.run == min(16, 1 << (spp - 1).bit_length())
    assert lay.chunks * lay.run >= spp > (lay.chunks - 1) * lay.run
    assert lay.run * lay.tile_w * lay.tile_h == 32
    assert lay.blocks * ws.WARPS_PER_BLOCK >= lay.n_tiles
    row, col, sample, live = ws.layout_samples(width, rows, spp)
    seen = np.zeros(rows * width * spp, np.int8)
    for t0 in range(0, lay.n_tiles, TILE_STEP):
        t = slice(t0, t0 + TILE_STEP)
        ok = live[t]
        idx = ((row[t][ok] * width + col[t][ok]) * spp
               + sample[t][ok]).astype(np.int64)
        np.add.at(seen, idx, 1)
    assert (seen == 1).all()
    # the band's rows in the frame: distinct, inside it where the kernels
    # trace (prow < height)
    prow = r0 + np.arange(rows) * stride
    assert len(np.unique(prow)) == rows
    inside = prow < height
    if name.startswith("CLI"):
        assert inside.sum() == 17 and not inside[-1]
    elif name.startswith("band"):
        assert inside.any() and not inside.all()
    else:
        assert inside.all()
        assert lay.n_tiles * lay.chunks * 32 == width * height * spp


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_image_lane_sum_is_the_per_pixel_sample_order_sum(name):
    """A pixel's radiance summed across its lanes in sample order
    (pixel_sum_run's plain model) is bit for bit the per-pixel loop's,
    signed zeros included, then scaled by inv_spp once."""
    width, _, spp, rows, _, _ = SHAPES[name]
    r = np.random.default_rng(spp * 1000 + rows)
    x = r.exponential(1.0, (rows, width, spp)).astype(np.float32)
    x *= np.float32(10.0) ** r.integers(-4, 3, x.shape).astype(np.float32)
    x[r.uniform(size=x.shape) < 0.05] = 0.0
    row, col, sample, live = ws.layout_samples(width, rows, spp)
    lanes = np.full(row.shape, np.nan, np.float32)     # dead: never read
    for t0 in range(0, row.shape[0], TILE_STEP):
        t = slice(t0, t0 + TILE_STEP)
        ok = live[t]
        lanes[t][ok] = x[row[t][ok], col[t][ok], sample[t][ok]]
    got = ws.pixel_sum_ref(torch.from_numpy(lanes), width, rows, spp)
    del lanes
    want = torch.zeros((rows, width), dtype=torch.float32)
    xt = torch.from_numpy(x)
    for s in range(spp):
        want = want + xt[:, :, s]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    inv = wf._inv_spp(spp)
    assert torch.equal(got * inv, want * inv)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_layout_args_are_thread_layouts(name):
    """K1's and K5's layout arguments, in the C entry points' order, are
    thread_layout's figures (K2 and K5s pass the same)."""
    width, _, spp, rows, _, _ = SHAPES[name]
    lay = ws.thread_layout(width, rows, spp)
    assert wf.layout_args(width, rows, spp) == (
        lay.run, lay.tile_w, lay.tile_h, lay.tiles_x, lay.n_tiles,
        lay.blocks)


def _world_tables(name, parity):
    w = getattr(rtt.models, name)()
    return ops.scene_tables(w.to_scene(), parity, "cpu")


def test_tri_walk_of_the_main_path_tables():
    """The walk each main-path table set launches: the sphere-only worlds'
    single padding column none, the FFI world's triangles flat, a mesh's
    clusters the one-level walk in 2 chunks of 32 (leaves of <= 64)."""
    _, tri, _, tcl = _world_tables("default_world", True)
    assert tri.shape[1] == 1 and tcl is None
    assert wf.tri_walk(tri, None) == (wf.WALK_NONE, 0)
    _, tri, _, tcl = _world_tables("ffi_example_world", True)
    assert tcl is None and wf.tri_walk(tri, None) == (wf.WALK_FLAT, 0)
    scene, _ = rtt.models.mesh_scene(2)
    _, tri, _, tcl = ops.scene_tables(scene, False, "cpu")
    most = int((tcl[1][1] - tcl[1][0]).max())
    assert 32 < most <= 64
    assert wf.tri_walk(tri, tcl) == (wf.WALK_LEAVES, 2)


def test_tri_walk_rechecks_a_padding_column_changed_in_place():
    """One padding column is checked once (its version cached); a real
    triangle written into it, or another one-column table, is checked
    again, and more than one column is always the flat scan."""
    _, tri, _, _ = _world_tables("default_world", True)
    pad = tri.clone()
    assert wf.tri_walk(pad, None)[0] == wf.WALK_NONE
    pad[2, 0] = 1.0                      # a plane normal: it may hit
    assert wf.tri_walk(pad, None)[0] == wf.WALK_FLAT
    pad[2, 0] = -0.0
    assert wf.tri_walk(pad, None)[0] == wf.WALK_NONE
    other = torch.zeros_like(pad)
    other[0, 0] = float("nan")
    assert wf.tri_walk(other, None)[0] == wf.WALK_FLAT
    assert wf.tri_walk(torch.zeros(pad.shape[0], 2), None)[0] == wf.WALK_FLAT


@pytest.mark.parametrize("leaf", [16, 64, 128])
def test_tri_walk_chunks_of_the_gradient_pass_leaves(leaf):
    """The one-level walk over build_tri_cull's leaves (the OBJ-10k pass's
    64, and forced 16 and 128): chunks = ceil(largest leaf / 32), and a
    mask of 64 / chunks leaves holds every chunk of each."""
    scene, _ = rtt.models.obj_mesh_scene() if leaf == 64 else \
        rtt.models.mesh_scene(3)
    cull = diff.build_tri_cull(scene, leaf)
    with torch.no_grad():
        t = diff.walk_tables(scene, cull)
    walk, chunks = wf.tri_walk(t["packed"], t["clusters"])
    most = int(np.diff(cull.ranges, axis=0).max())
    assert walk == wf.WALK_LEAVES and most <= leaf
    assert chunks == -(-most // wf.CHUNK)
    group = 64 // chunks
    assert group * chunks <= 64 and group >= 1
    # each leaf's chunks start at its first packed column, the last one
    # ending inside the table
    starts, ends = cull.ranges
    for k in range(chunks):
        c0 = starts + k * wf.CHUNK
        n = np.clip(ends - c0, 0, wf.CHUNK)
        assert (c0 + n <= t["packed"].shape[1]).all()


def test_tri_walk_rejects_a_cluster_past_64_chunks():
    tri = torch.zeros(21, 4096)
    bounds = torch.zeros(6, 2)
    ranges = torch.tensor([[0, 2049], [2049, 4096]], dtype=torch.int32).T
    ranges = ranges.contiguous()
    with pytest.raises(ValueError, match="cluster holds 2049"):
        wf.tri_walk(tri, (bounds, ranges))
    ok = torch.tensor([[0, 2048], [2048, 4096]], dtype=torch.int32)
    assert wf.tri_walk(tri, (bounds, ok.T.contiguous())) == (
        wf.WALK_LEAVES, 64)
