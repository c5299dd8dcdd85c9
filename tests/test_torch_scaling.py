"""Work balance of the port's shard assignments on 8 CPU shards: a twin of
tests/test_scaling.py.

A sharded frame's wall clock on n cards is the slowest shard's, so the
share of the work each shard gets bounds the scaling efficiency:
``efficiency <= mean(work_i) / max(work_i)`` with work = traced segments,
which a CPU run counts exactly.  The interleaved pixel assignment of
``parallel.render_linear_sharded`` keeps the default world within 85%
balance; contiguous bands (sky against ground) do measurably worse.  The
same holds for the kernels' interleaved rows (K1's plain version)."""

import pytest
import torch

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import ops, render, rng
from raytracer_tpu_torch.parallel.mesh import pad_to_multiple

W, H, SPP, D = 128, 128, 2, 8
N = 8


@pytest.fixture(scope="module")
def world_scene():
    w = rtt.models.default_world()
    return w.to_scene(), w.to_camera()


def _segments(scene, cam, pix):
    _, s = render.accumulate_samples(scene, cam, pix // W, pix % W, W, H,
                                     SPP, D, True, rng.seed_word(0))
    return s


def _balance(segs):
    return (sum(segs) / len(segs)) / max(segs)


@pytest.fixture(scope="module")
def wavefront_segments(world_scene):
    scene, cam = world_scene
    pix_all = torch.arange(H * W, dtype=torch.int32)
    chunk = pad_to_multiple(H, N) // N * W
    return {
        "interleaved": [_segments(scene, cam, pix_all[i::N])
                        for i in range(N)],
        "contiguous": [_segments(scene, cam,
                                 pix_all[i * chunk:(i + 1) * chunk])
                       for i in range(N)]}


class TestLoadBalance:
    def test_interleaved_assignment_meets_85pct(self, wavefront_segments):
        assert _balance(wavefront_segments["interleaved"]) >= 0.85

    def test_interleaved_beats_contiguous(self, wavefront_segments):
        # contiguous bands are the naive split and under-balance on
        # sky-against-ground scenes
        assert (_balance(wavefront_segments["interleaved"])
                > _balance(wavefront_segments["contiguous"]))

    def test_interleaved_rows_balance_the_kernel(self, world_scene):
        # K1's row interleave (render_linear_sharded_fast) at the same
        # frame, against contiguous row bands
        scene, cam = world_scene
        sph, tri, scl, tcl = ops.scene_tables(scene, True, "cpu")
        args = (sph, tri, ops.tables.camera_vec(cam))
        kw = dict(width=W, height=H, samples_per_pixel=SPP, depth=D,
                  sph_clusters=scl, tri_clusters=tcl, shard_rows=H // N)
        from raytracer_tpu_torch.ops.cuda.wavefront import render_linear_ref
        inter = [render_linear_ref(*args, **kw, row_offset=i, row_stride=N)[1]
                 for i in range(N)]
        bands = [render_linear_ref(*args, **kw, row_offset=i * H // N)[1]
                 for i in range(N)]
        assert _balance(inter) >= 0.85 and _balance(inter) > _balance(bands)
