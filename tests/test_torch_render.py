"""The port's render front (finalize_image, ray_trace, dispatch, table cache,
profiling) against the JAX package.  finalize_image must be byte-equal;
end-to-end framebuffers may differ by 1 LSB, because a value within 1e-5 of
a truncation boundary may round either way."""

import io

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu.utils.profiling import ScanlineLogger as JLogger
import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import ops
from raytracer_tpu_torch.render import finalize_image
from raytracer_tpu_torch.utils import profiling


@pytest.mark.parametrize("flip", [True, False])
def test_finalize_image_byte_equal(flip):
    r = np.random.default_rng(0)
    x = r.uniform(-0.5, 1.5, size=(9, 7, 3)).astype(np.float32)
    x[0, 0] = [np.nan, -np.inf, np.inf]
    x[1, 1] = [0.0, -0.0, 1.0]
    x[2, :, 0] = np.float32(0.999) + np.arange(7, dtype=np.float32) * 1e-4
    got = finalize_image(torch.from_numpy(x), flip=flip)
    want = rt.finalize_image(jnp.asarray(x), flip=flip)
    assert got.dtype == torch.uint8 and got.shape == (9, 7, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


WORLDS = ["default_world", "ffi_example_world"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("logger", [False, True])
def test_ray_trace_within_one_lsb_of_jax(world, logger):
    tw, jw = getattr(rtt.models, world)(), getattr(rt.models, world)()
    sink = io.StringIO()
    topts = rtt.Options(samples_per_pixel=4, max_ray_bounces=8,
                        device="cpu",
                        logger=profiling.ScanlineLogger(sink) if logger
                        else None)
    jopts = rt.Options(samples_per_pixel=4, max_ray_bounces=8,
                       logger=JLogger(io.StringIO()) if logger else None)
    fb, segs = rtt.ray_trace(tw.to_scene(), tw.to_camera(), 32, 18, topts)
    want, wsegs = rt.ray_trace(jw.to_scene(), jw.to_camera(), 32, 18, jopts)
    assert fb.shape == (18, 32, 4) and fb.dtype == np.uint8
    assert int(np.abs(fb.astype(int) - want.astype(int)).max()) <= 1
    assert segs == wsegs
    if logger:
        assert sink.getvalue().endswith("Scanline: 0   ")


def test_banded_ray_trace_bitwise_equals_unbanded():
    w = rtt.models.ffi_example_world()
    scene, cam = w.to_scene(), w.to_camera()
    kw = dict(samples_per_pixel=2, max_ray_bounces=4, device="cpu")
    a, sa = rtt.ray_trace(scene, cam, 20, 35, rtt.Options(**kw))
    b, sb = rtt.ray_trace(scene, cam, 20, 35, rtt.Options(
        logger=profiling.ScanlineLogger(io.StringIO()), **kw))
    np.testing.assert_array_equal(a, b)
    assert sa == sb


def test_tables_cached_across_frames():
    w = rtt.models.default_world()
    scene, cam = w.to_scene(), w.to_camera()
    opts = rtt.Options(samples_per_pixel=1, max_ray_bounces=2, device="cpu")
    before = ops.pack_events
    rtt.ray_trace(scene, cam, 8, 4, opts)
    rtt.ray_trace(scene, cam.moved_by((0.1, 0.0, 0.0)), 8, 4, opts)
    assert ops.pack_events == before + 1
    rtt.ray_trace(w.to_scene(), cam, 8, 4, opts)     # a new scene object
    assert ops.pack_events == before + 2


def test_scene_tables_cluster_thresholds():
    scene, _ = rtt.models.random_spheres(n=96, seed=11)
    sph, tri, scl, tcl = ops.scene_tables(scene, False, "cpu")
    assert scl is not None and tcl is None
    mesh, _ = rtt.models.mesh_scene(subdivisions=2)
    assert ops.scene_tables(mesh, False, "cpu")[3] is not None
    # triangle culling is unsound with the reference's plane sign
    assert ops.scene_tables(mesh, True, "cpu")[3] is None
    small = rtt.models.default_world().to_scene()
    assert ops.scene_tables(small, True, "cpu")[2:] == (None, None)


def test_resolve_dispatch():
    ref_scene = rtt.models.default_world().to_scene()
    mesh, _ = rtt.models.mesh_scene(subdivisions=1)
    assert ops.resolve_dispatch(ref_scene, None, "auto", "cpu") == (
        "torch", True)
    assert ops.resolve_dispatch(mesh, None, "auto", "cpu") == (
        "torch", False)
    assert ops.resolve_dispatch(mesh, True, "auto", "cuda") == (
        "cuda", True)
    assert ops.resolve_dispatch(ref_scene, False, "torch", "cuda") == (
        "torch", False)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.resolve_dispatch(ref_scene, None, "cuda", "cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        ops.resolve_dispatch(ref_scene, None, "pallas", "cpu")


@pytest.mark.parametrize("engine", ops.ENGINES[1:])
def test_options_docstring_names_every_engine(engine):
    """``Options``' docstring lists every engine a caller may name, each
    quoted as it is passed."""
    assert f'"{engine}"' in rtt.Options.__doc__


def test_cuda_engine_on_cpu_raises_instead_of_rendering():
    w = rtt.models.default_world()
    with pytest.raises(ValueError, match="CUDA device"):
        rtt.ray_trace(w.to_scene(), w.to_camera(), 8, 4, rtt.Options(
            samples_per_pixel=1, engine="cuda", device="cpu"))
    assert rtt.Options().device == "cuda"


def test_timed_render_and_stats():
    w = rtt.models.default_world()
    scene, cam = w.to_scene(), w.to_camera()
    with profiling.timed_render(8, 4, 2, device="cpu") as stats:
        _, stats.segments = ops.render_linear_fast(
            scene, cam, width=8, height=4, samples_per_pixel=2, depth=3,
            device="cpu")
    assert stats.paths == 64 and stats.segments >= 64
    assert stats.seconds > 0 and stats.rays_per_sec > 0
    both = stats.merge(stats)
    assert both.renders == 2 and both.segments == 2 * stats.segments
    assert "Mrays/s" in str(both)


def test_scanline_logger_matches_jax():
    a, b = io.StringIO(), io.StringIO()
    for rows in (18, 36, 288):
        profiling.ScanlineLogger(a)(rows, 288)
        JLogger(b)(rows, 288)
    assert a.getvalue() == b.getvalue()
