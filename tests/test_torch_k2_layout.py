"""The host side of K2's and K5s's (pixel, sample) thread layout at the
big-mesh gradient pass's shapes (bench.py:184-222: 256x256 at 4 and 8 spp)
and on a ragged band (row_offset / row_stride, a spp off the run): every
(pixel, sample) traced once, and the camera-lane sum across a pixel's
lanes bitwise K5's per-pixel loop (cam_acc = cam_acc + x over samples 0 ..
spp - 1 from 0.0).  The kernels run only on the card; these check the
layout and the sum order they follow (``wavefront_stream.thread_layout``,
``layout_samples``, ``pixel_sum_ref``)."""

import numpy as np
import pytest
import torch

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch.ops import diff
from raytracer_tpu_torch.ops.cuda import wavefront as wf
from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws

# (width, height, spp, shard_rows, row_offset, row_stride)
SHAPES = {"256x256 4spp": (256, 256, 4, 256, 0, 1),
          "256x256 8spp": (256, 256, 8, 256, 0, 1),
          "band 37 rows, stride 7, 3spp": (256, 256, 3, 37, 3, 7),
          "band 9 rows of 41 wide, 8spp": (41, 256, 8, 9, 250, 1)}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_gradient_pass_layout_covers_each_pixel_sample_once(name):
    width, height, spp, rows, r0, stride = SHAPES[name]
    lay = ws.thread_layout(width, rows, spp)
    row, col, sample, live = ws.layout_samples(width, rows, spp)
    assert lay.run * lay.tile_w * lay.tile_h == 32
    assert lay.blocks * ws.WARPS_PER_BLOCK >= lay.n_tiles
    hits = np.zeros((rows, width, spp), np.int64)
    np.add.at(hits, (row[live], col[live], sample[live]), 1)
    assert (hits == 1).all()
    # the band's rows in the frame: distinct, inside it only where the
    # kernels trace (prow < height)
    prow = r0 + row[live] * stride
    assert len(np.unique(r0 + np.arange(rows) * stride)) == rows
    inside = prow < height
    assert inside.any()
    if name.startswith("256x256"):
        assert inside.all() and lay.n_tiles * 32 == width * height * spp


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_camera_lane_sum_is_k5_sample_order_sum(name):
    """The 12 camera cotangents of each pixel summed across its lanes in
    sample order (pixel_sum_run's plain model), bit for bit K5's per-pixel
    loop, signed zeros included."""
    width, _, spp, rows, _, _ = SHAPES[name]
    r = np.random.default_rng(spp + rows)
    x = r.normal(0.0, 1.0, (12, rows, width, spp)).astype(np.float32)
    x *= np.float32(10.0) ** r.integers(-6, 3, x.shape).astype(np.float32)
    x[r.uniform(size=x.shape) < 0.1] = -0.0
    row, col, sample, live = ws.layout_samples(width, rows, spp)
    for k in range(12):
        lanes = np.full(row.shape, np.nan, np.float32)   # dead: never read
        lanes[live] = x[k][row[live], col[live], sample[live]]
        got = ws.pixel_sum_ref(torch.from_numpy(lanes), width, rows, spp)
        want = torch.zeros((rows, width), dtype=torch.float32)
        for s in range(spp):
            want = want + torch.from_numpy(x[k, :, :, s])
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_stream_launch_args_take_the_layout_and_the_sub_leaf_boxes():
    """The K2 / K5s launch arguments: the walk's tables in the C entry
    points' order, thread_layout's figures, and without sub-leaf boxes each
    sub-leaf given its leaf's box."""
    scene, _ = rtt.models.mesh_scene(3)
    cull = diff.build_tri_cull(scene, 16)
    with torch.no_grad():
        t = diff.walk_tables(scene, cull, True)
    C, Ct = cull.ranges.shape[1], t["tops"][0].shape[1]
    for subs in (t["subs"], None):
        walk, lay, used = wf.stream_launch_args(
            t["aligned"], t["clusters"], t["tops"], subs, width=256,
            shard_rows=256, samples_per_pixel=4)
        assert walk[4] == C and walk[7] == Ct
        assert walk[0] == t["aligned"].data_ptr()
        assert walk[3] == used.data_ptr()
        assert lay == tuple(ws.thread_layout(256, 256, 4)[:5]) + (
            ws.thread_layout(256, 256, 4).blocks,)
        want = (t["subs"] if subs is not None else
                t["clusters"][0].repeat_interleave(wf.LEAF_SUBS, dim=1))
        assert torch.equal(used, want)
    assert wf.TOP_LEAVES_MAX * wf.LEAF_SUBS == 64
    assert int((t["tops"][1][1] - t["tops"][1][0]).max()) <= \
        wf.TOP_LEAVES_MAX
